"""B8's grid (csrc/pair_conv.cu pair_conv_fin_wide_kernel over
conv_fwd_wide.cuh's f32 chain, the finalize in the weight stages) as plain
PyTorch: nn/trunk_convs.py pair_conv_fin_tiled_plain (the conv computed by
walking pair_tile_plan's blocks of g_p ligand rows and their 64-pair tiles,
the bond features as the edge input's extra rows, then finalized), and the
host's plan and choice of rows per block (pair_plan_words, pair_row_groups).

Checks: at g_p in {the rule's pick, 1, 5, 48}, the tiled model against
pair_conv_fin_plain and against the JAX package's make_pair_conv(fin=) in
interpret mode; rows without a valid pair give the LayerNorm's 0e bias
alone; the plan's tiles hold exactly the valid pairs, row by row; the plan
at flagship width (layer 5 of the 3dbs bucket) equals its region sums
(fwd_plan, conv_fwd_wide.cuh); the row groups fit the card's shared memory
and depend on the shapes alone. The small system: NS 8, NV 4 (a layer whose
out_dim > din), nl 40, B = 3 (sample 2 without ligand rows), a ragged bond
chain with bonds stretched beyond the cutoff, JAX-initialised weights with
non-trivial LayerNorm parameters. Tolerance: f32 against f32 with sums in
another order, max|err| <= 1e-5 of max|ref|, as tests/test_torch_rowmajor.py
holds the plain versions. Torch and JAX on the CPU, one torch thread.
"""
import jax
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
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
SED, GSN, EDIM, CUT = 16, 16, 6, 4.0
NL, B = 40, 3
TOL = 1e-5
# flagship width at layer 5 of the 3dbs bucket, B8's finalize there
FLAGSHIP = dict(nt=128, nsrc=128, din=168, dout=624, nb=10, ns=48, he=48, hf=144, nw=288,
                kdim=68, gs_n=32, out_dim=168, n_slots=4, mix_numel=7776)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def system():
    """Numpy samples, JAX parameters, and the port's B8 arguments."""
    rng = np.random.default_rng(21)
    cs = JL.make_conv_spec(IN, SH, OUT, "sep")
    din = cs.dw.in1.dim
    samples = []
    for i in range(B):
        pos = (rng.normal(size=(NL, 3)) * 2.5).astype(np.float32)
        mask = (rng.random(NL) > 0.15).astype(np.float32)
        mask[30:] = 0.0  # padded rows at the end, as the buckets pad
        if i == 2:
            mask[:] = 0.0
        bond_mask = np.zeros((NL, NL), np.float32)
        bond_feat = np.zeros((NL, NL, EDIM), np.float32)
        for a in range(NL - 1):
            if rng.random() < 0.7:
                bond_mask[a, a + 1] = bond_mask[a + 1, a] = 1.0
                bond_feat[a, a + 1] = bond_feat[a + 1, a] = rng.normal(size=EDIM)
        pos[7] = pos[4] + np.array([0.0, CUT + 2.0, 0.0], np.float32)  # a bond beyond the cutoff
        bond_mask[4, 7] = bond_mask[7, 4] = 1.0
        bond_feat[4, 7] = bond_feat[7, 4] = rng.normal(size=EDIM)
        x = rng.normal(size=(NL, din)).astype(np.float32)
        s = dict(pos=pos, mask=mask, bond_mask=bond_mask, bond_feat=bond_feat,
                 cm=np.asarray(PC.cm_from_irreps(cs.dw.in1, x)),
                 temb=rng.normal(size=SED).astype(np.float32))
        d = np.sqrt(((pos[None] - pos[:, None]) ** 2).sum(-1) + 1e-12)
        m = (((d <= CUT) & ~np.eye(NL, dtype=bool)) | (bond_mask > 0)) & (mask[:, None] > 0) \
            & (mask[None] > 0)
        s["cnt"] = np.maximum(m.sum(1), 1).astype(np.float32)
        samples.append(s)
    ks = iter(jax.random.split(jax.random.PRNGKey(5), 8))
    tp = JL.tp_conv_init(next(ks), cs, 3 * NS)
    ln = tp["ln"]
    params = {**TC.pair_params(JL.mlp_init(next(ks), EDIM + SED + GSN, NS), tp["fc"]),
              "mix": tp["mix"], "ln": {  # non-trivial LayerNorm parameters
                  "weight": ln["weight"] * (1.0 + 0.1 * jax.random.normal(next(ks),
                                                                          ln["weight"].shape)),
                  "mean_shift": ln["mean_shift"],
                  "bias": ln["bias"] + 0.05 * jax.random.normal(next(ks), ln["bias"].shape)}}
    params = jax.tree.map(np.asarray, params)
    pcs = TL.make_conv_spec(IN, SH, OUT)
    c = TC.ConvConsts(pcs.dw, NS, SED, CUT, GSN)

    def st(k):
        return torch.from_numpy(np.stack([s[k] for s in samples])).float()

    pos, mask, zero = st("pos"), st("mask"), torch.zeros(B, NL)
    args = (c, TC.FinConsts(pcs), pos, pos, st("cm"), st("cm"), mask, mask, zero, zero, st("temb"),
            CUT, params_from_numpy(params, device="cpu"), st("bond_feat"), st("bond_mask"),
            st("cnt"))
    return cs, samples, params, args


def _ints(args):
    c, fin, nb = args[0], args[1], args[13].shape[-1]
    dims = (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1])
    return TC._pair_ints(c, dims, B, NL, NL, nb, fin)


@pytest.fixture(scope="module")
def jax_kernel(system):
    """Per sample, the JAX package's make_pair_conv(fin=) in interpret mode."""
    cs, samples, params, _ = system
    conv = PC.make_pair_conv(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=CUT, gs_n=GSN,
                             edge_extra=EDIM, exclude_self=True, cab_on_src=True,
                             interpret=True, fin=cs)
    zl = np.zeros(NL, np.float32)
    return [np.asarray(conv(s["pos"], s["pos"], s["cm"], s["cm"], s["mask"], s["mask"], zl, zl,
                            s["temb"], CUT, params, s["bond_feat"], s["bond_mask"], cnt=s["cnt"]))
            for s in samples]


def test_small_system_has_ragged_rows_and_dead_rows(system):
    *_, args = system
    plan_ints = _ints(args)
    assert (plan_ints["din"], plan_ints["dout"], plan_ints["nb"]) == (20, 72, EDIM)
    assert plan_ints["out_dim"] > plan_ints["din"]
    ok = TC.pair_valid(args[2], args[3], args[6], args[7], args[9],
                       TC._cutoffs(CUT, B, args[2].device), args[14])
    per_row = ok.sum(-1)
    assert int(per_row[:2, :30].max()) > 0 and int(per_row[2].sum()) == 0
    assert bool((per_row[:, 30:] == 0).all())
    # bonded pairs beyond the cutoff are valid pairs
    assert bool(ok[0, 4, 7]) and bool(ok[1, 7, 4])


GROUPS = ["rule", 1, 5, 48]


@pytest.mark.parametrize("g_p", GROUPS)
def test_pair_fin_tiled_model_matches_plain_and_jax_kernel(system, jax_kernel, g_p):
    cs, _, params, args = system
    g = TC.pair_row_groups(dict(_ints(args), batch=B), 132) if g_p == "rule" else g_p
    if g_p == "rule":
        assert g not in GROUPS[1:]
    got = TC.pair_conv_fin_tiled_plain(*args, g)
    fin = args[1]
    assert got.shape == (B, NL, fin.out_dim)
    assert _rel(got.numpy(), TC.pair_conv_fin_plain(*args).numpy()) <= TOL
    for b in range(B):
        err = _rel(got[b].numpy(), jax_kernel[b])
        print(f"g_p {g} sample {b}: tiled f32 + finalize vs JAX make_pair_conv(fin=) {err:.2e}")
        assert err <= TOL
    # rows without a valid pair: the finalize of zero sums, the 0e bias alone
    bias = torch.zeros(fin.out_dim)
    ln_b = torch.tensor(params["ln"]["bias"])
    bias[: ln_b.shape[0]] = ln_b
    dead = got[2]
    torch.testing.assert_close(dead, bias.expand(NL, -1), rtol=0, atol=1e-7)


@pytest.mark.parametrize("g_p", [1, 3, 7, 48])
def test_pair_tile_plan_holds_the_valid_pairs_row_by_row(system, g_p):
    *_, args = system
    plan = TC.pair_tile_plan(args[2], args[3], args[6], args[7], args[9], CUT, args[14], g_p)
    assert len(plan) == B * -(-NL // g_p)
    ok = TC.pair_valid(args[2], args[3], args[6], args[7], args[9],
                       TC._cutoffs(CUT, B, args[2].device), args[14])
    for i, blk in enumerate(plan):
        assert (blk.b, blk.t0) == (i // -(-NL // g_p), (i % -(-NL // g_p)) * g_p)
        pairs = torch.cat(blk.tiles["pair"]) if blk.tiles["pair"] else torch.zeros(0, 2)
        assert all(len(t) == TC.WIDE_TILE for t in blk.tiles["pair"][:-1])
        want = torch.nonzero(ok[blk.b, blk.t0 : blk.t0 + g_p])
        want[:, 0] += blk.t0
        assert pairs.tolist() == want.tolist()


def test_pair_plan_equals_its_region_sums_at_flagship_width():
    """fwd_plan's regions at layer 5 in 4-byte words, reckoned by hand: p1
    max(he, hf, kdim) x 68 = 9,792, p2 max(gs_n + nb, 3 ns, nw) x 68 =
    19,584 (it holds the 7,776 mix weights), sh 9 x 68, ws the two 16-row
    weight stages of 9 x 32 columns (9,216; they hold the 32 staged source
    rows of 168, and up to 46 rows of the finalize's 168 outputs and 4 x 8
    statistics), ck 612, misc 264; per ligand row 624 sums and 128 list
    slots."""
    fixed, per_row = 9792 + 19584 + 612 + 9216 + 612 + 264, 624 + 128
    for g in (1, 4, 8, 16, 23):
        assert TC.pair_plan_words(dict(FLAGSHIP, batch=16), g) == fixed + per_row * g
    assert TC.pair_plan_words(dict(FLAGSHIP, batch=16), 8) * 4 == 184384
    # 23 rows fit the shared memory, 24 do not
    assert TC.pair_plan_words(dict(FLAGSHIP, batch=16), 23) <= TC.SMEM_WORDS
    assert TC.pair_plan_words(dict(FLAGSHIP, batch=16), 24) > TC.SMEM_WORDS
    # a finalize whose rows outgrow the weight stages takes more words
    big = dict(FLAGSHIP, batch=16, out_dim=600, n_slots=8)
    assert TC.pair_plan_words(big, 16) > TC.pair_plan_words(dict(FLAGSHIP, batch=16), 16)


def test_pair_row_groups_fit_the_shared_memory_and_follow_the_shapes():
    """At flagship width the rule picks 2, 3, 8 and 16 rows at B = 1, 4, 16
    and 64 on 132 SMs: a function of the shapes alone, no more rows on more
    SMs, never more than the shared memory holds, and an error where not one
    row fits."""
    got = {bsz: TC.pair_row_groups(dict(FLAGSHIP, batch=bsz), 132) for bsz in (1, 4, 16, 64)}
    assert got == {1: 2, 4: 3, 16: 8, 64: 16}
    for bsz, g in got.items():
        assert TC.pair_plan_words(dict(FLAGSHIP, batch=bsz), g) <= TC.SMEM_WORDS
    assert TC.pair_row_groups(dict(FLAGSHIP, batch=16, extra=1), 132) == got[16]
    assert TC.pair_row_groups(dict(FLAGSHIP, batch=16), 264) <= got[16]
    # the largest plan that fits caps the rows: 2 where a row holds 8,000 sums
    assert TC.pair_plan_words(dict(FLAGSHIP, dout=8000), 3) > TC.SMEM_WORDS
    assert TC.pair_row_groups(dict(FLAGSHIP, batch=16, dout=8000), 132) == 2
    with pytest.raises(ValueError):
        TC.pair_row_groups(dict(FLAGSHIP, batch=16, nw=900, hf=900), 132)
