"""B1's and B7's block and tile plan (csrc/cross_conv.cu over
conv_fwd_wide.cuh) as plain PyTorch: nn/trunk_convs.py cross_tile_plan
(which targets an al or la block owns, how its valid candidates fall into
64-pair tiles in candidate order), cross_conv_tiled_plain and
cross_conv_fin_tiled_plain (the conv computed by walking that plan, each
pair's message by wide_tile_plain on the kernel's folded edge inputs), and
the host's choice of rows per block (cross_row_groups, cross_plan_words).

Checks: every valid cross pair of both directions lands in exactly one tile
of the block owning its target, in candidate order, and nothing else does;
masked rows and rows with no pair come out as zeros (B1) and as the
LayerNorm biases (B7); the tiled model within 1e-5 of max|ref| of
cross_conv_plain / cross_conv_fin_plain and of the JAX package's twin
(nn/pallas_conv.py make_cross_twin, without and with fin=, as
tests/test_torch_rowmajor.py runs it) on a small system (NS 8, NV 4, nl 20,
na 200, out_dim > din), B = 2, at the groups cross_row_groups picks and at
others; the groups follow the batch and the shared-memory plan fits the
card at flagship width. Torch and JAX on the CPU, one torch thread.
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
SED, GSN, CROSS_CUT = 16, 16, 9.0
NL, NA, B = 20, 200, 2
TOL = 1e-5
# the small system's widths, as the kernel's CROSS_INTS (B1: no finalize)
INTS = dict(batch=B, nl=NL, na=NA, din=20, dout=72, ns=NS, he=NS, hf=3 * NS, nw=32, kdim=34,
            gs_n=GSN, out_dim=0, n_slots=0, mix_numel=0)
# flagship width at layer 5 (ns 48, 288 TP weights, 624 message columns,
# 7,776 mix weights), the 3dbs bucket
FLAGSHIP = dict(nl=128, na=1024, din=168, dout=624, ns=48, he=48, hf=144, nw=288, kdim=68,
                gs_n=32)
FLAGSHIP_FIN = dict(out_dim=168, n_slots=4, mix_numel=7776)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def system():
    """Two samples (numpy, for JAX) and the port's batched arguments:
    sample 0 has a masked ligand row (3) and a ligand row far from every
    atom with no CA/CB atom in the sample (7: no pair), sample 1 a masked
    atom (5); JAX-initialised weights with perturbed LayerNorms."""
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
            mask=m_c, cnt=[m_c.sum(1).astype(np.float32), m_c.sum(0).astype(np.float32)])
        s["lig_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["lig_x"]))
        s["atm_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["atm_x"]))
        samples.append(s)
    ks = iter(jax.random.split(jax.random.PRNGKey(9), 16))
    params = {"emb_cross": JL.mlp_init(next(ks), SED + GSN, NS)}
    for t in ("al", "la"):
        tp = JL.tp_conv_init(next(ks), cs, 3 * NS)
        ln = tp["ln"]
        params[f"fc_{t}"] = tp["fc"]
        params[f"fin_{t}"] = {"mix": tp["mix"], "ln": {
            "weight": ln["weight"] * (1.0 + 0.1 * jax.random.normal(next(ks), ln["weight"].shape)),
            "mean_shift": ln["mean_shift"],
            "bias": ln["bias"] + 0.05 * jax.random.normal(next(ks), ln["bias"].shape)}}
    params = jax.tree.map(np.asarray, params)
    pcs = TL.make_conv_spec(IN, SH, OUT)
    c = TC.ConvConsts(pcs.dw, NS, SED, CROSS_CUT, GSN)
    fin = TC.FinConsts(pcs)

    def st(k):
        return torch.from_numpy(np.stack([s[k] for s in samples])).float()

    p = params_from_numpy(params, device="cpu")
    args = (c, st("lig_pos"), st("atm_pos"), st("lig_cm"), st("atm_cm"), st("lig_mask"),
            st("atm_mask"), st("cab"), st("temb"), st("cut"), p["emb_cross"], p["fc_al"],
            p["fc_la"])
    cnt = [torch.from_numpy(np.stack([s["cnt"][i] for s in samples])) for i in range(2)]
    fin_args = (c, fin, *args[1:], p["fin_al"], p["fin_la"], *cnt)
    return cs, samples, params, args, fin_args


def test_small_system_ints_match_the_spec(system):
    c = system[3][0]
    assert (INTS["din"], INTS["dout"], INTS["nw"], INTS["kdim"]) == (
        c.din, c.dout, c.spec.weight_numel, c.tables[0].shape[1])


@pytest.mark.parametrize("groups", [TC.cross_row_groups(INTS, 132), (1, 3), (4, 32)])
def test_every_valid_pair_lands_in_one_tile_of_its_targets_block(system, groups):
    _, samples, _, args, _ = system
    g_l, g_a = groups
    blocks = TC.cross_tile_plan(args[1], args[2], args[5], args[6], args[7], args[9], g_l, g_a)
    # grid order: every sample's al blocks, then the la blocks
    want_order = [("al", b, t0) for b in range(B) for t0 in range(0, NL, g_l)]
    want_order += [("la", b, t0) for b in range(B) for t0 in range(0, NA, g_a)]
    assert [(k.kind, k.b, k.t0) for k in blocks] == want_order
    seen = {"al": [], "la": []}
    for blk in blocks:
        assert list(blk.tiles) == [blk.kind]
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
            # candidate order within each block, blocks in target order
            assert [p for p in seen[tag] if p[0] == b] == pairs, tag
    # the far row and the masked row own no pair, and are no atom's source
    assert not any(p[1] in (3, 7) for p in seen["al"] if p[0] == 0)
    assert not any(p[2] in (3, 7) for p in seen["la"] if p[0] == 0)
    assert not any(p[1] == 5 for p in seen["la"] if p[0] == 1)


@pytest.mark.parametrize("fin", [False, True], ids=["B1", "B7"])
@pytest.mark.parametrize("groups", [TC.cross_row_groups(INTS, 132), (1, 3), (2, 7)])
def test_tiled_model_matches_plain_and_jax_twin(system, groups, fin):
    cs, samples, params, args, fin_args = system
    if fin:
        al, la = TC.cross_conv_fin_tiled_plain(*fin_args, groups=groups)
        al0, la0 = TC.cross_conv_fin_plain(*fin_args)
    else:
        al, la = TC.cross_conv_tiled_plain(*args, groups=groups)
        al0, la0 = TC.cross_conv_plain(*args)
    assert _rel(al.numpy(), al0.numpy()) <= TOL and _rel(la.numpy(), la0.numpy()) <= TOL
    twin = PC.make_cross_twin(cs.dw, din=cs.dw.in1.dim, ns=NS, sed=SED, gs_stop=CROSS_CUT,
                              gs_n=GSN, fin=cs if fin else None)
    kw = {}
    for b, s in enumerate(samples):
        if fin:
            kw = dict(fin_al=params["fin_al"], fin_la=params["fin_la"], cnt_al=s["cnt"][0],
                      cnt_la=s["cnt"][1])
        al_j, la_j = twin(s["lig_pos"], s["atm_pos"], s["lig_cm"], s["atm_cm"], s["lig_mask"],
                          s["atm_mask"], s["cab"], s["temb"], s["cut"], params["emb_cross"],
                          params["fc_al"], params["fc_la"], **kw)
        assert _rel(al[b].numpy(), al_j) <= TOL and _rel(la[b].numpy(), la_j) <= TOL
    # rows without a pair: the masked ligand row 3 and the far row 7 of
    # sample 0, the masked atom 5 of sample 1; B1 zero, B7 the 0e bias
    rows = ((al, 0, (3, 7), "fin_al"), (la, 1, (5,), "fin_la"))
    for out, b, idx, tag in rows:
        for r in idx:
            want = torch.zeros(out.shape[-1])
            if fin:
                bias = torch.tensor(np.array(params[tag]["ln"]["bias"]))
                want[: bias.shape[0]] = bias
            assert torch.allclose(out[b, r], want, atol=1e-7)


def test_row_groups_follow_the_batch_and_fit_the_shared_memory():
    """g_l grows with the batch (al blocks no longer than the SMs' mean
    share of the grid's tiles, from nl / 4 real rows); g_a is as large as the
    plan holds; at flagship width B1's and B7's blocks fit the 227 KB of an
    SM (B7's finalize rows in the weight stages: the same atoms per block),
    and a block that cannot fit is refused."""
    for fin in ({}, FLAGSHIP_FIN):
        n = {**FLAGSHIP, "out_dim": 0, "n_slots": 0, "mix_numel": 0, **fin}
        got = {bsz: TC.cross_row_groups(dict(n, batch=bsz), 132) for bsz in (1, 4, 8, 16)}
        assert got == {1: (1, 23), 4: (1, 23), 8: (2, 23), 16: (4, 22)}
        for bsz, (g_l, g_a) in got.items():
            words = TC.cross_plan_words(dict(n, batch=bsz), g_l, g_a)
            assert words <= TC.SMEM_WORDS < TC.cross_plan_words(dict(n, batch=bsz), g_l, g_a + 1)
        assert TC.cross_plan_words(dict(n, batch=16), 4, 22) * 4 == 231616
    # more SMs or a smaller bucket: smaller ligand groups
    assert TC.cross_row_groups(dict(FLAGSHIP, batch=16, nl=32, out_dim=0, n_slots=0,
                                    mix_numel=0), 132)[0] == 1
    # the small system: every atom group fits, capped at CROSS_ATOM_ROWS
    assert TC.cross_row_groups(INTS, 132) == (1, TC.CROSS_ATOM_ROWS)
    with pytest.raises(ValueError):
        TC.cross_row_groups(dict(FLAGSHIP, batch=16, nw=900, out_dim=0, n_slots=0,
                                 mix_numel=0), 132)
