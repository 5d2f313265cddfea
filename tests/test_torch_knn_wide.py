"""B3's and B9's knn grid (csrc/knn_conv.cu over conv_fwd_wide.cuh, the f32
chain; B9 with its finalize in the weight stages) as plain PyTorch:
nn/trunk_convs.py knn_conv_tiled_plain and knn_conv_fin_tiled_plain (the
conv computed by walking knn_tile_plan's blocks of g_k atoms and their
64-pair tiles), and the host's plan and choice of atoms per block
(knn_plan_words, knn_row_groups) on the f32 plan, with and without the
finalize.

Checks: at g_k in {the rule's pick, 1, 5, 32}, the tiled models against
knn_conv_plain / knn_conv_fin_plain and against the JAX package's
make_knn_conv_t (f32) and make_knn_conv(fin=) in interpret mode; atoms
without a valid slot give rows of exactly 0 (B3) and the LayerNorm's 0e
bias alone (B9); the plans at flagship width (layer 5 of the 3dbs bucket)
equal their region sums (fwd_plan, conv_fwd_wide.cuh); the row groups fit
the card's shared memory and depend on the shapes alone. The small system
is tests/test_torch_bf16_wide.py's (NS 8, NV 4, na 200, B = 2, a ragged
16-slot neighbour list; sample 1 has a masked atom), with non-trivial
LayerNorm parameters for the finalize. Tolerance: f32 against f32 with
sums in another order, max|err| <= 1e-5 of max|ref|, as
tests/test_torch_rowmajor.py holds the plain versions. Torch and JAX on
the CPU, one torch thread.
"""
import jax
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_tpu.nn import pallas_conv_t as PT
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.utils.checkpoint import params_from_numpy

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

NS, NV = 8, 4
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
SH = "1x0e+1x1o+1x2e"
SED, GSN, CROSS_CUT, KNN_STOP, K = 16, 16, 9.0, 4.0, 16
NL, NA, B = 20, 200, 2
TOL = 1e-5
# the small system's sizes, as _knn_ints gives them for B3
KNN_INTS = dict(batch=B, n=NA, k=K, din=20, dout=72, ns=NS, he=NS, hf=3 * NS, nw=32, kdim=34,
                gs_n=GSN, bf16_chain=0, out_dim=0, n_slots=0, mix_numel=0)
# flagship width at layer 5, the 3dbs bucket; B9's finalize there
FLAGSHIP = dict(n=1024, k=16, din=168, dout=624, ns=48, he=48, hf=144, nw=288, kdim=68, gs_n=32,
                bf16_chain=0, out_dim=0, n_slots=0, mix_numel=0)
FLAGSHIP_FIN = dict(FLAGSHIP, out_dim=168, n_slots=4, mix_numel=7776)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def system():
    """tests/test_torch_bf16_wide.py's two samples (sample 1: a masked atom
    5) with JAX-initialised weights, the atom conv's finalize (LayerNorm
    weight and bias perturbed), and per sample a 16-slot neighbour list
    over the atoms within 5 A (ragged: 0 to 16 valid slots an atom)."""
    rng = np.random.default_rng(13)
    cs = JL.make_conv_spec(IN, SH, OUT, "sep")
    din = cs.dw.in1.dim
    atm_pos = (rng.normal(size=(NA, 3)) * 7).astype(np.float32)
    rng.normal(size=(NL, 3))  # the ligand's positions in the bf16 system
    samples = []
    for i in range(B):
        # the ligand draws of the bf16 system keep its atoms' random stream
        rng.normal(size=3)
        rng.random(NL)
        atm_mask = (rng.random(NA) > 0.1).astype(np.float32)
        rng.random(NA)
        if i == 1:
            atm_mask[5] = 0.0
        rng.normal(size=(NL, din))
        s = dict(atm_pos=atm_pos, atm_x=rng.normal(size=(NA, din)).astype(np.float32),
                 atm_mask=atm_mask, temb=rng.normal(size=SED).astype(np.float32))
        s["atm_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["atm_x"]))
        samples.append(s)
    ks = iter(jax.random.split(jax.random.PRNGKey(9), 16))
    params = {"emb_cross": JL.mlp_init(next(ks), SED + GSN, NS),
              "emb_atom": JL.mlp_init(next(ks), SED + GSN, NS)}
    for t in ("al", "la", "atom"):
        tp = JL.tp_conv_init(next(ks), cs, 3 * NS)
        params[f"fc_{t}"] = tp["fc"]
    ln = tp["ln"]
    params["mix_atom"] = tp["mix"]
    params["ln_atom"] = {  # non-trivial LayerNorm parameters
        "weight": ln["weight"] * (1.0 + 0.1 * jax.random.normal(next(ks), ln["weight"].shape)),
        "mean_shift": ln["mean_shift"],
        "bias": ln["bias"] + 0.05 * jax.random.normal(next(ks), ln["bias"].shape)}
    params = jax.tree.map(np.asarray, params)
    pcs = TL.make_conv_spec(IN, SH, OUT)
    c_knn = TC.ConvConsts(pcs.dw, NS, SED, KNN_STOP, GSN)

    def st(k):
        return torch.from_numpy(np.stack([s[k] for s in samples])).float()

    p = params_from_numpy(params, device="cpu")
    pos, mask = st("atm_pos"), st("atm_mask")
    idx, valid = TL.knn_edges(pos, pos, mask, mask, k=K, cutoff=5.0, exclude_self=True)
    knn_args = (c_knn, pos, st("atm_cm"), mask, idx, valid.float(), st("temb"),
                {"emb": p["emb_atom"], "fc": p["fc_atom"]})
    fin_args = (c_knn, TC.FinConsts(pcs), *knn_args[1:7],
                {**knn_args[7], "mix": p["mix_atom"], "ln": p["ln_atom"]})
    return cs, samples, params, knn_args, fin_args


GROUPS = [TC.knn_row_groups(KNN_INTS, 132), 1, 5, 32]


def test_small_system_has_ragged_lists_and_dead_atoms(system):
    knn_args, fin_args = system[3], system[4]
    per_atom = knn_args[5].sum(-1)
    assert int(per_atom.min()) == 0 and int(per_atom.max()) == K
    assert float(per_atom[1, 5]) == 0.0
    c, fin = knn_args[0], fin_args[1]
    assert (KNN_INTS["din"], KNN_INTS["dout"], KNN_INTS["nw"], KNN_INTS["kdim"]) == (
        c.din, c.dout, c.spec.weight_numel, c.tables[0].shape[1])
    dims = (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1])
    assert TC._knn_ints(c, dims, B, NA, K, False) == KNN_INTS
    assert TC._knn_ints(c, dims, B, NA, K, False, fin) == dict(
        KNN_INTS, out_dim=fin.out_dim, n_slots=len(fin.spec.out.items),
        mix_numel=fin.spec.lin.weight_numel)
    # the rule's pick is not one of the forced groups
    assert GROUPS[0] not in GROUPS[1:]


@pytest.fixture(scope="module")
def jax_kernels(system):
    """Per sample, the JAX package's kernels in interpret mode:
    make_knn_conv_t's sums (f32) and make_knn_conv(fin=)'s finalized rows."""
    cs, samples, params, knn_args, _ = system
    kw = dict(din=cs.dw.in1.dim, ns=NS, sed=SED, gs_n=GSN, gs_stop=KNN_STOP, k=K,
              interpret=True)
    knn_t = PT.make_knn_conv_t(cs.dw, **kw)
    knn_fin = PC.make_knn_conv(cs.dw, fin=cs, **kw)
    idx, valid = knn_args[4].numpy().astype(np.int32), knn_args[5].numpy()
    p = {"emb": params["emb_atom"], "fc": params["fc_atom"]}
    pf = {**p, "mix": params["mix_atom"], "ln": params["ln_atom"]}
    out = []
    for b, s in enumerate(samples):
        a = (s["atm_pos"], s["atm_cm"], s["atm_mask"], idx[b], valid[b], s["temb"])
        out.append((np.asarray(knn_t(*a, p)), np.asarray(knn_fin(*a, pf))))
    return out


def _bias_rows(fin, ln_bias):
    """The finalize of zero sums: the LayerNorm's 0e bias, zeros elsewhere
    (the 0e slot comes first in the ladder)."""
    out = torch.zeros(fin.out_dim)
    out[: ln_bias.shape[0]] = ln_bias
    return out


@pytest.mark.parametrize("g_k", GROUPS)
def test_knn_tiled_model_matches_plain_and_jax_kernel(system, jax_kernels, g_k):
    knn_args = system[3]
    got = TC.knn_conv_tiled_plain(*knn_args, g_k)
    assert _rel(got.numpy(), TC.knn_conv_plain(*knn_args).numpy()) <= TOL
    for b in range(B):
        err = _rel(got[b].numpy(), jax_kernels[b][0])
        print(f"sample {b}: tiled f32 vs JAX make_knn_conv_t {err:.2e}")
        assert err <= TOL
    # atoms without a valid slot: rows of exactly 0
    dead = knn_args[5].sum(-1) == 0
    assert bool(dead.any()) and not got[dead].any()


@pytest.mark.parametrize("g_k", GROUPS)
def test_knn_fin_tiled_model_matches_plain_and_jax_kernel(system, jax_kernels, g_k):
    fin_args = system[4]
    fin, valid, p = fin_args[1], fin_args[6], fin_args[8]
    got = TC.knn_conv_fin_tiled_plain(*fin_args, g_k)
    assert got.shape == (B, NA, fin.out_dim)
    assert _rel(got.numpy(), TC.knn_conv_fin_plain(*fin_args).numpy()) <= TOL
    for b in range(B):
        err = _rel(got[b].numpy(), jax_kernels[b][1])
        print(f"sample {b}: tiled f32 + finalize vs JAX make_knn_conv(fin=) {err:.2e}")
        assert err <= TOL
    # atoms without a valid slot: the finalize of zero sums, the 0e bias alone
    dead = valid.sum(-1) == 0
    bias = _bias_rows(fin, p["ln"]["bias"])
    assert bool(dead.any())
    torch.testing.assert_close(got[dead], bias.expand(int(dead.sum()), -1), rtol=0, atol=1e-7)


def test_knn_plans_equal_their_region_sums_at_flagship_width():
    """fwd_plan's regions at layer 5 in 4-byte words, reckoned by hand: p1
    max(he, hf, kdim) x 68, p2 max(gs_n, 3 ns, nw) x 68, sh 9 x 68, ws the
    two 16-row weight stages of 9 x 32 columns (9,216; they hold the 32
    staged source rows of 168, and B9's 19 x 168 output rows and 19 x 4 x 8
    statistics), ck 612, misc 264; per atom 624 sums and 16 list slots. The
    bf16 plan's w and cb tiles and staged rows are 34 words a row, so p2 is
    the edge input's 144 x 68."""
    f32_fixed, per_atom = 9792 + 19584 + 612 + 9216 + 612 + 264, 624 + 16
    bf16_fixed = 9792 + 9792 + 612 + 9216 + 612 + 264
    for g in (1, 10, 19, 24, 28):
        for ints in (FLAGSHIP, FLAGSHIP_FIN):
            assert TC.knn_plan_words(dict(ints, batch=16), g) == f32_fixed + per_atom * g
        assert TC.knn_plan_words(dict(FLAGSHIP, batch=16, bf16_chain=1), g) == (
            bf16_fixed + per_atom * g)
    assert TC.knn_plan_words(dict(FLAGSHIP, batch=16), 19) * 4 == 208960
    assert TC.knn_plan_words(dict(FLAGSHIP_FIN, batch=16), 19) * 4 == 208960
    assert TC.knn_plan_words(dict(FLAGSHIP, batch=16), 24) * 4 == 221760
    assert TC.knn_plan_words(dict(FLAGSHIP, batch=16, bf16_chain=1), 19) * 4 == 169792
    # 28 atoms fit the f32 plan, 29 and 32 do not
    assert TC.knn_plan_words(dict(FLAGSHIP, batch=16), 28) <= TC.SMEM_WORDS
    assert TC.knn_plan_words(dict(FLAGSHIP, batch=16), 29) > TC.SMEM_WORDS
    assert TC.knn_plan_words(dict(FLAGSHIP_FIN, batch=16), 32) > TC.SMEM_WORDS
    # a finalize whose rows outgrow the weight stages takes more words
    big = dict(FLAGSHIP_FIN, batch=16, out_dim=600, n_slots=8)
    assert TC.knn_plan_words(big, 19) > TC.knn_plan_words(dict(FLAGSHIP_FIN, batch=16), 19)


@pytest.mark.parametrize("ints", [FLAGSHIP, FLAGSHIP_FIN], ids=["B3", "B9"])
def test_knn_row_groups_fit_the_shared_memory_and_follow_the_shapes(ints):
    """The f32 plan holds at most 28 atoms a block at flagship width, so the
    rule's pick is the bf16 plan's up to B = 16 (5, 10, 19) and 27 at B =
    64 (the bf16 plan: 32); a function of the shapes alone."""
    got = {bsz: TC.knn_row_groups(dict(ints, batch=bsz), 132) for bsz in (1, 4, 16, 64)}
    assert got == {1: 5, 4: 10, 16: 19, 64: 27}
    for bsz, g in got.items():
        assert TC.knn_plan_words(dict(ints, batch=bsz), g) <= TC.SMEM_WORDS
    assert TC.knn_row_groups(dict(ints, batch=64, bf16_chain=1), 132) == 32
    # the same shapes give the same group, whatever else the call sees
    assert TC.knn_row_groups(dict(ints, batch=16, extra=1), 132) == got[16]
    assert TC.knn_row_groups(dict(ints, batch=16), 264) < got[16]
    with pytest.raises(ValueError):
        TC.knn_row_groups(dict(ints, batch=16, nw=900, hf=900), 132)
