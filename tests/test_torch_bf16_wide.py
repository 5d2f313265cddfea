"""B11-cross's and B11-knn's block and tile plans (csrc/cross_conv.cu and
csrc/knn_conv.cu over conv_fwd_wide.cuh with the bf16 chain) as plain
PyTorch: nn/trunk_convs.py cross_tile_plan and knn_tile_plan (which targets
a block owns, how its valid candidates fall into 64-pair tiles in candidate
order), cross_conv_tiled_plain(bf16_chain=True) and knn_conv_tiled_plain
(the conv computed by walking that plan, each tile's messages through the
bf16 chain), and the host's choice of rows per block (cross_row_groups on
the bf16 plan, knn_row_groups, knn_plan_words).

Checks: every valid pair of both plans lands in exactly one tile of the
block owning its target, in candidate order, and nothing else does; the
row groups fit the card's shared memory and depend on the shapes alone;
the tiled bf16 models against cross_conv_plain / knn_conv_plain
(bf16_chain=True) and against the JAX package's make_cross_conv_t /
make_knn_conv_t(dw_dtype='bfloat16') in interpret mode, on the small system
of tests/test_torch_cross_wide.py (NS 8, NV 4, nl 20, na 200, B = 2) with
neighbour lists over its atoms. Tolerances are tests/test_torch_bf16.py's:
max|err| <= 2e-3 * max|ref| (two implementations that round at the same
points differ where f32 sums taken in another order cross a bf16 rounding
boundary), and the f32 model's distance to the JAX bf16 kernel, the
control, must lie beyond it. Torch and JAX on the CPU, one torch thread.
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
TOL = 2e-3
# the small system's widths, as the kernels' sizes (B11-cross's CROSS_INTS;
# B11-knn's _knn_ints)
INTS = dict(batch=B, nl=NL, na=NA, din=20, dout=72, ns=NS, he=NS, hf=3 * NS, nw=32, kdim=34,
            gs_n=GSN, out_dim=0, n_slots=0, mix_numel=0)
BF_INTS = dict(INTS, bf16_chain=1)
KNN_INTS = dict(batch=B, n=NA, k=K, din=20, dout=72, ns=NS, he=NS, hf=3 * NS, nw=32, kdim=34,
                gs_n=GSN)
# flagship width at layer 5, the 3dbs bucket
FLAGSHIP = dict(nl=128, na=1024, din=168, dout=624, ns=48, he=48, hf=144, nw=288, kdim=68,
                gs_n=32, out_dim=0, n_slots=0, mix_numel=0)
FLAGSHIP_KNN = dict(n=1024, k=16, din=168, dout=624, ns=48, he=48, hf=144, nw=288, kdim=68,
                    gs_n=32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def system():
    """tests/test_torch_cross_wide.py's two samples (sample 0: a masked
    ligand row 3 and a ligand row 7 far from every atom, no CA/CB atom;
    sample 1: a masked atom 5) with JAX-initialised weights, and per sample
    a 16-slot neighbour list over the atoms within 5 A (ragged: 0 to 16
    valid slots an atom)."""
    rng = np.random.default_rng(13)
    cs = JL.make_conv_spec(IN, SH, OUT, "sep")
    din = cs.dw.in1.dim
    atm_pos = (rng.normal(size=(NA, 3)) * 7).astype(np.float32)
    lig0 = (rng.normal(size=(NL, 3)) * 3).astype(np.float32)
    samples = []
    for i in range(B):
        lig_pos = lig0 + np.float32(i) * rng.normal(size=3).astype(np.float32) * 2.0
        lig_mask = (rng.random(NL) > 0.1).astype(np.float32)
        atm_mask = (rng.random(NA) > 0.1).astype(np.float32)
        lig_mask[7] = 1.0
        cab = (rng.random(NA) > 0.85).astype(np.float32)
        if i == 0:
            lig_pos[7] = np.float32(500.0)  # beyond every cutoff
            lig_mask[3] = 0.0
            cab[:] = 0.0
        else:
            atm_mask[5] = 0.0
        cut = np.float32(CROSS_CUT - 1.5 * i)
        d_c = np.linalg.norm(atm_pos[None] - lig_pos[:, None] + 1e-12, axis=-1)
        m_c = ((cab[None, :] > 0) | (d_c <= cut)) & (lig_mask[:, None] > 0) & (atm_mask[None] > 0)
        s = dict(lig_pos=lig_pos, atm_pos=atm_pos, lig_x=rng.normal(size=(NL, din)).astype(
            np.float32), atm_x=rng.normal(size=(NA, din)).astype(np.float32), lig_mask=lig_mask,
            atm_mask=atm_mask, cab=cab, temb=rng.normal(size=SED).astype(np.float32), cut=cut,
            mask=m_c)
        s["lig_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["lig_x"]))
        s["atm_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["atm_x"]))
        samples.append(s)
    ks = iter(jax.random.split(jax.random.PRNGKey(9), 16))
    params = {"emb_cross": JL.mlp_init(next(ks), SED + GSN, NS),
              "emb_atom": JL.mlp_init(next(ks), SED + GSN, NS)}
    for t in ("al", "la", "atom"):
        params[f"fc_{t}"] = JL.tp_conv_init(next(ks), cs, 3 * NS)["fc"]
    params = jax.tree.map(np.asarray, params)
    pcs = TL.make_conv_spec(IN, SH, OUT)
    c = TC.ConvConsts(pcs.dw, NS, SED, CROSS_CUT, GSN)
    c_knn = TC.ConvConsts(pcs.dw, NS, SED, KNN_STOP, GSN)

    def st(k):
        return torch.from_numpy(np.stack([s[k] for s in samples])).float()

    p = params_from_numpy(params, device="cpu")
    args = (c, st("lig_pos"), st("atm_pos"), st("lig_cm"), st("atm_cm"), st("lig_mask"),
            st("atm_mask"), st("cab"), st("temb"), st("cut"), p["emb_cross"], p["fc_al"],
            p["fc_la"])
    idx, valid = TL.knn_edges(args[2], args[2], args[6], args[6], k=K, cutoff=5.0,
                              exclude_self=True)
    knn_args = (c_knn, args[2], args[4], args[6], idx, valid.float(), args[8],
                {"emb": p["emb_atom"], "fc": p["fc_atom"]})
    return cs, samples, params, args, knn_args


def test_small_system_has_ragged_neighbour_lists(system):
    valid = system[4][5]
    per_atom = valid.sum(-1)
    assert int(per_atom.min()) == 0 and int(per_atom.max()) == K
    assert (KNN_INTS["din"], KNN_INTS["dout"], KNN_INTS["nw"], KNN_INTS["kdim"]) == (
        system[4][0].din, system[4][0].dout, system[4][0].spec.weight_numel,
        system[4][0].tables[0].shape[1])


@pytest.mark.parametrize("groups", [TC.cross_row_groups(BF_INTS, 132), (1, 3), (2, 7)])
def test_every_valid_cross_pair_lands_in_one_tile_of_its_targets_block(system, groups):
    _, samples, _, args, _ = system
    g_l, g_a = groups
    blocks = TC.cross_tile_plan(args[1], args[2], args[5], args[6], args[7], args[9], g_l, g_a)
    want_order = [("al", b, t0) for b in range(B) for t0 in range(0, NL, g_l)]
    want_order += [("la", b, t0) for b in range(B) for t0 in range(0, NA, g_a)]
    assert [(k.kind, k.b, k.t0) for k in blocks] == want_order
    seen = {"al": [], "la": []}
    for blk in blocks:
        tiles = blk.tiles[blk.kind]
        assert all(0 < tile.shape[0] <= TC.WIDE_TILE for tile in tiles)
        assert all(tile.shape[0] == TC.WIDE_TILE for tile in tiles[:-1])
        pairs = [tuple(p) for tile in tiles for p in tile.tolist()]
        assert all(blk.t0 <= t < blk.t0 + blk.g for t, _ in pairs)
        seen[blk.kind] += [(blk.b, t, s) for t, s in pairs]
    for b, s in enumerate(samples):
        m = s["mask"]
        want = {"al": [(b, t, a) for t in range(NL) for a in range(NA) if m[t, a]],
                "la": [(b, a, t) for a in range(NA) for t in range(NL) if m[t, a]]}
        for tag, pairs in want.items():
            assert [p for p in seen[tag] if p[0] == b] == pairs, tag


@pytest.mark.parametrize("g_k", [TC.knn_row_groups(KNN_INTS, 132), 1, 5, 32])
def test_every_valid_knn_slot_lands_in_one_tile_of_its_atoms_block(system, g_k):
    idx, valid = system[4][4], system[4][5]
    blocks = TC.knn_tile_plan(idx, valid, g_k)
    assert [(k.kind, k.b, k.t0, k.g) for k in blocks] == [
        ("knn", b, t0, g_k) for b in range(B) for t0 in range(0, NA, g_k)]
    seen = []
    for blk in blocks:
        tiles = blk.tiles["knn"]
        assert all(0 < tile.shape[0] <= TC.WIDE_TILE for tile in tiles)
        assert all(tile.shape[0] == TC.WIDE_TILE for tile in tiles[:-1])
        pairs = [tuple(p) for tile in tiles for p in tile.tolist()]
        assert all(blk.t0 <= t < blk.t0 + g_k for t, _ in pairs)
        seen += [(blk.b, t, s) for t, s in pairs]
    # atom-major, then slot order; only the valid slots
    want = [(b, t, int(idx[b, t, j])) for b in range(B) for t in range(NA) for j in range(K)
            if valid[b, t, j]]
    assert seen == want
    # the masked atom 5 of sample 1 owns no slot and is no atom's neighbour
    assert not any(p[0] == 1 and 5 in p[1:] for p in seen)


def test_row_groups_fit_the_shared_memory_and_follow_the_shapes():
    """B11-cross's la blocks take CROSS_ATOM_ROWS atoms at flagship width
    (the bf16 plan's half-size w and cb tiles: B1's take 22); B11-knn's g_k
    minimises the mean tiles per SM plus one block, grows with the batch
    and fits the 227 KB of an SM; both are functions of the shapes alone,
    and a block that cannot fit is refused."""
    for bsz, want in ((1, (1, 32)), (4, (1, 32)), (16, (4, 32))):
        n = dict(FLAGSHIP, batch=bsz)
        bf = dict(n, bf16_chain=1)
        assert TC.cross_row_groups(bf, 132) == want
        assert TC.cross_plan_words(bf, *want) <= TC.SMEM_WORDS
        assert TC.cross_row_groups(n, 132)[1] < TC.CROSS_ATOM_ROWS
        assert TC.cross_plan_words(bf, *want) < TC.cross_plan_words(n, *want)
    got = {bsz: TC.knn_row_groups(dict(FLAGSHIP_KNN, batch=bsz), 132) for bsz in (1, 4, 16, 64)}
    assert got == {1: 5, 4: 10, 16: 19, 64: 32}
    for bsz, g in got.items():
        assert TC.knn_plan_words(dict(FLAGSHIP_KNN, batch=bsz), g) <= TC.SMEM_WORDS
    assert TC.knn_plan_words(dict(FLAGSHIP_KNN, batch=16), 19) * 4 == 169792
    # the same shapes give the same groups, whatever else the call sees
    assert TC.knn_row_groups(dict(FLAGSHIP_KNN, batch=16), 132) == got[16]
    # more SMs: smaller blocks
    assert TC.knn_row_groups(dict(FLAGSHIP_KNN, batch=16), 264) < got[16]
    # the small system: every group fits
    assert TC.knn_plan_words(KNN_INTS, TC.KNN_ATOM_ROWS) <= TC.SMEM_WORDS
    with pytest.raises(ValueError):
        TC.knn_row_groups(dict(FLAGSHIP_KNN, batch=16, nw=900, hf=900), 132)
    with pytest.raises(ValueError):
        TC.cross_row_groups(dict(FLAGSHIP, batch=16, nw=1800, bf16_chain=1), 132)


@pytest.fixture(scope="module")
def jax_bf16(system):
    """Per sample, the JAX package's bf16 kernels in interpret mode:
    make_cross_conv_t's (al, la) and make_knn_conv_t's sums."""
    cs, samples, params, _, knn_args = system
    kw = dict(din=cs.dw.in1.dim, ns=NS, sed=SED, gs_n=GSN, interpret=True, dw_dtype="bfloat16")
    cross = PT.make_cross_conv_t(cs.dw, gs_stop=CROSS_CUT, **kw)
    knn = PT.make_knn_conv_t(cs.dw, gs_stop=KNN_STOP, k=K, **kw)
    idx, valid = knn_args[4].numpy(), knn_args[5].numpy()
    out = []
    for b, s in enumerate(samples):
        al, la = cross(s["lig_pos"], s["atm_pos"], s["lig_cm"], s["atm_cm"], s["lig_mask"],
                       s["atm_mask"], s["cab"], s["temb"], s["cut"], params["emb_cross"],
                       params["fc_al"], params["fc_la"])
        nb = knn(s["atm_pos"], s["atm_cm"], s["atm_mask"], idx[b], valid[b], s["temb"],
                 {"emb": params["emb_atom"], "fc": params["fc_atom"]})
        out.append((np.asarray(al), np.asarray(la), np.asarray(nb)))
    return out


@pytest.mark.parametrize("groups", [TC.cross_row_groups(BF_INTS, 132), (1, 3), (2, 7)])
def test_cross_bf16_tiled_model_matches_plain_and_jax_kernel(system, jax_bf16, groups):
    args = system[3]
    al, la = TC.cross_conv_tiled_plain(*args, groups=groups, bf16_chain=True)
    al0, la0 = TC.cross_conv_plain(*args, bf16_chain=True)
    assert _rel(al.numpy(), al0.numpy()) <= TOL and _rel(la.numpy(), la0.numpy()) <= TOL
    f32 = TC.cross_conv_tiled_plain(*args, groups=groups)
    for b in range(B):
        for got, ctl, w in zip((al, la), f32, jax_bf16[b][:2]):
            err, c_err = _rel(got[b].numpy(), w), _rel(ctl[b].numpy(), w)
            print(f"sample {b}: tiled bf16 vs JAX bf16 kernel {err:.2e}, f32 (control) {c_err:.2e}")
            assert err <= TOL < c_err
    # rows without a pair are exactly 0: ligand rows 3 and 7 of sample 0,
    # atom 5 of sample 1
    assert not al[0, [3, 7]].any() and not la[1, 5].any()


@pytest.mark.parametrize("g_k", [TC.knn_row_groups(KNN_INTS, 132), 1, 32])
def test_knn_bf16_tiled_model_matches_plain_and_jax_kernel(system, jax_bf16, g_k):
    knn_args = system[4]
    valid = knn_args[5]
    got = TC.knn_conv_tiled_plain(*knn_args, g_k, bf16_chain=True)
    assert _rel(got.numpy(), TC.knn_conv_plain(*knn_args, bf16_chain=True).numpy()) <= TOL
    f32 = TC.knn_conv_tiled_plain(*knn_args, g_k)
    assert _rel(f32.numpy(), TC.knn_conv_plain(*knn_args).numpy()) <= 1e-5
    for b in range(B):
        want = jax_bf16[b][2]
        err, c_err = _rel(got[b].numpy(), want), _rel(f32[b].numpy(), want)
        print(f"sample {b}: tiled bf16 vs JAX bf16 kernel {err:.2e}, f32 (control) {c_err:.2e}")
        assert err <= TOL < c_err
    # atoms without a valid slot are exactly 0
    dead = valid.sum(-1) == 0
    assert bool(dead.any()) and not got[dead].any()
