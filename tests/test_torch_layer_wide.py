"""B10's block and tile plan (csrc/layer_conv.cu, conv_fwd_wide.cuh) as plain
PyTorch: nn/layer_conv.py layer_tile_plan (which targets a block owns, how
each conv's valid candidates fall into 64-pair tiles in candidate order) and
layer_conv_tiled_plain (the layer computed by walking that plan, each pair's
message by trunk_convs.pair_chain_plain and the TP on the kernel's folded
edge inputs).

Checks: every valid pair of every conv lands in exactly one tile of the
block owning its target, in candidate order, and nothing else does; ligand
rows with no pair and padded (masked) rows own no pair and come out as
their residual plus the LayerNorm biases; the tiled model's output within
1e-5 of max|ref| of layer_conv_plain and of the JAX package's layer twin
(nn/pallas_layer.py make_layer_conv(...).twin, as tests/test_torch_rowmajor.py
runs it) on a small layer (NS 8, NV 4, nl 20, na 200, K 8, out_dim > din),
B = 2, at the kernel's row groups and at others; the shared-memory plan at
flagship width fits the card. Torch and JAX on the CPU, one torch thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_tpu.nn import pallas_layer as PL
from diffbindfr_torch.nn import layer_conv as LC
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
SED, GSN = 16, 16
LIG_CUT, CROSS_CUT, ATOM_CUT = 6.0, 9.0, 4.5
K, EDIM, NL, NA, B = 8, 6, 20, 200, 2
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def system():
    """Two samples (numpy, for JAX) and the port's batched tensors: sample 0
    has a masked ligand row (3) and a ligand row far from everything (7: no
    pair of any conv), sample 1 a masked atom (5); JAX-initialised weights
    with perturbed LayerNorms."""
    rng = np.random.default_rng(11)
    cs = JL.make_conv_spec(IN, SH, OUT, "sep")
    din = cs.dw.in1.dim
    atm_pos = (rng.normal(size=(NA, 3)) * 7).astype(np.float32)
    lig0 = (rng.normal(size=(NL, 3)) * 3).astype(np.float32)
    bond_mask = np.zeros((NL, NL), np.float32)
    bond_feat = np.zeros((NL, NL, EDIM), np.float32)
    for _ in range(NL - 1):
        a, b = rng.integers(0, NL, 2)
        if a != b and 7 not in (a, b):
            bond_mask[a, b] = bond_mask[b, a] = 1.0
            bond_feat[a, b] = bond_feat[b, a] = rng.normal(size=EDIM).astype(np.float32)
    samples = []
    for i in range(B):
        lig_pos = lig0 + np.float32(i) * rng.normal(size=3).astype(np.float32) * 2.0
        lig_mask = (rng.random(NL) > 0.1).astype(np.float32)
        atm_mask = (rng.random(NA) > 0.1).astype(np.float32)
        lig_mask[7] = 1.0
        if i == 0:
            lig_pos[7] = np.float32(500.0)  # beyond every cutoff
            lig_mask[3] = 0.0
        else:
            atm_mask[5] = 0.0
        cab = (rng.random(NA) > 0.85).astype(np.float32)
        if i == 0:
            cab[:] = 0.0  # the far row has no CA/CB pair either
        idx, valid = JL.knn_edges(jnp.asarray(atm_pos), jnp.asarray(atm_pos),
                                  jnp.asarray(atm_mask), jnp.asarray(atm_mask), K, ATOM_CUT,
                                  exclude_self=True)
        idx, valid = np.asarray(idx), np.asarray(valid).astype(np.float32)
        cut = np.float32(CROSS_CUT - 1.5 * i)
        d_ll = np.linalg.norm(lig_pos[None] - lig_pos[:, None] + 1e-12, axis=-1)
        m_ll = ((d_ll <= LIG_CUT) & ~np.eye(NL, dtype=bool)) | (bond_mask > 0)
        m_ll &= (lig_mask[:, None] > 0) & (lig_mask[None, :] > 0)
        d_c = np.linalg.norm(atm_pos[None] - lig_pos[:, None] + 1e-12, axis=-1)
        m_c = ((cab[None, :] > 0) | (d_c <= cut)) & (lig_mask[:, None] > 0) & (atm_mask[None] > 0)
        s = dict(lig_pos=lig_pos, atm_pos=atm_pos, lig_x=rng.normal(size=(NL, din)).astype(
            np.float32), atm_x=rng.normal(size=(NA, din)).astype(np.float32), lig_mask=lig_mask,
            atm_mask=atm_mask, cab=cab, temb=rng.normal(size=SED).astype(np.float32), cut=cut,
            bond_feat=bond_feat, bond_mask=bond_mask, idx=idx, valid=valid,
            cnt=[m_ll.sum(1).astype(np.float32), m_c.sum(1).astype(np.float32),
                 m_c.sum(0).astype(np.float32), valid.sum(1)])
        s["lig_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["lig_x"]))
        s["atm_cm"] = np.asarray(PC.cm_from_irreps(cs.dw.in1, s["atm_x"]))
        samples.append(s)
    ks = iter(jax.random.split(jax.random.PRNGKey(5), 32))
    params = {"emb_lig": JL.mlp_init(next(ks), EDIM + SED + GSN, NS),
              "emb_cross": JL.mlp_init(next(ks), SED + GSN, NS),
              "emb_atom": JL.mlp_init(next(ks), SED + GSN, NS)}
    for t in ("lig", "al", "la", "atom"):
        tp = JL.tp_conv_init(next(ks), cs, 3 * NS)
        ln = tp["ln"]
        params[f"fc_{t}"], params[f"mix_{t}"] = tp["fc"], tp["mix"]
        params[f"ln_{t}"] = {
            "weight": ln["weight"] * (1.0 + 0.1 * jax.random.normal(next(ks), ln["weight"].shape)),
            "mean_shift": ln["mean_shift"],
            "bias": ln["bias"] + 0.05 * jax.random.normal(next(ks), ln["bias"].shape)}
    params = jax.tree.map(np.asarray, params)
    pcs = TL.make_conv_spec(IN, SH, OUT)
    lc = LC.LayerConsts(pcs, TC.ConvConsts(pcs.dw, NS, SED, LIG_CUT, GSN),
                        TC.ConvConsts(pcs.dw, NS, SED, CROSS_CUT, GSN),
                        TC.ConvConsts(pcs.dw, NS, SED, ATOM_CUT, GSN))

    def st(k, dtype=torch.float32):
        return torch.from_numpy(np.stack([s[k] for s in samples])).to(dtype)

    t = {k: st(k) for k in ("lig_pos", "atm_pos", "lig_cm", "atm_cm", "lig_mask", "atm_mask",
                            "cab", "temb", "cut", "bond_feat", "bond_mask", "valid")}
    t["idx"] = st("idx", torch.int64)
    cnt = [torch.from_numpy(np.stack([s["cnt"][i] for s in samples])).float() for i in range(4)]
    args = (lc, t["lig_pos"], t["atm_pos"], t["lig_cm"], t["atm_cm"], t["lig_mask"],
            t["atm_mask"], t["cab"], t["temb"], t["cut"], t["bond_feat"], t["bond_mask"],
            t["idx"], t["valid"], *cnt, params_from_numpy(params, device="cpu"))
    return cs, samples, params, args


def _plan(args, groups):
    lc, lp, ap, _, _, lm, am, cab, _, cut, _, bm, idx, valid = args[:14]
    return LC.layer_tile_plan(lp, ap, lm, am, cab, lc.lig.gs_stop, cut, bm, idx, valid, *groups)


@pytest.mark.parametrize("groups", [(LC.LIG_ROWS, LC.ATOM_ROWS), (1, 3), (8, 64)])
def test_every_valid_pair_lands_in_one_tile_of_its_targets_block(system, groups):
    _, samples, _, args = system
    g_l, g_a = groups
    blocks = _plan(args, groups)
    # grid order: every sample's ligand-row blocks, then the atom-row blocks
    want_order = [("lig", b, t0) for b in range(B) for t0 in range(0, NL, g_l)]
    want_order += [("atom", b, t0) for b in range(B) for t0 in range(0, NA, g_a)]
    assert [(k.kind, k.b, k.t0) for k in blocks] == want_order
    seen = {tag: [] for tag in ("lig", "al", "la", "atom")}
    for blk in blocks:
        for tag, tiles in blk.tiles.items():
            assert all(0 < tile.shape[0] <= LC.WIDE_TILE for tile in tiles)
            assert all(tile.shape[0] == LC.WIDE_TILE for tile in tiles[:-1])
            pairs = [tuple(p) for tile in tiles for p in tile.tolist()]
            assert all(blk.t0 <= t < blk.t0 + blk.g for t, _ in pairs)
            seen[tag] += [(blk.b, t, s) for t, s in pairs]
    for b, s in enumerate(samples):
        d_ll = np.linalg.norm(s["lig_pos"][None] - s["lig_pos"][:, None] + 1e-12, axis=-1)
        d_c = np.linalg.norm(s["atm_pos"][None] - s["lig_pos"][:, None] + 1e-12, axis=-1)
        lm, am = s["lig_mask"] > 0, s["atm_mask"] > 0
        want = {"lig": [(b, t, u) for t in range(NL) for u in range(NL) if lm[t] and lm[u] and (
                    (d_ll[t, u] <= LIG_CUT and t != u) or s["bond_mask"][t, u] > 0)],
                "al": [(b, t, a) for t in range(NL) for a in range(NA) if lm[t] and am[a] and (
                    s["cab"][a] > 0 or d_c[t, a] <= s["cut"])],
                "la": [(b, a, t) for a in range(NA) for t in range(NL) if lm[t] and am[a] and (
                    s["cab"][a] > 0 or d_c[t, a] <= s["cut"])],
                "atom": [(b, t, int(s["idx"][t, j])) for t in range(NA) for j in range(K)
                         if s["valid"][t, j] > 0]}
        for tag, pairs in want.items():
            got = [p for p in seen[tag] if p[0] == b]
            # candidate order within each block, blocks in target order
            assert got == pairs, tag
        # the far row and the masked row own no pair of either conv
        for row in ((7, 3) if b == 0 else ()):
            assert not any(p[1] == row for tag in ("lig", "al") for p in seen[tag] if p[0] == b)


@pytest.mark.parametrize("groups", [(LC.LIG_ROWS, LC.ATOM_ROWS), (1, 3)])
def test_tiled_model_matches_layer_plain_and_jax_twin(system, groups):
    cs, samples, params, args = system
    lig, atm = LC.layer_conv_tiled_plain(*args, groups=groups)
    lig0, atm0 = LC.layer_conv_plain(*args)
    assert _rel(lig.numpy(), lig0.numpy()) <= TOL and _rel(atm.numpy(), atm0.numpy()) <= TOL
    layer = PL.make_layer_conv(cs, din=cs.dw.in1.dim, ns=NS, sed=SED, lig_gs_stop=LIG_CUT,
                               cross_gs_stop=CROSS_CUT, atom_gs_stop=ATOM_CUT, gs_n=GSN,
                               lig_edge_dim=EDIM, k=K, interpret=True)
    lc = args[0]
    for b, s in enumerate(samples):
        lig_j, atm_j = layer.twin(s["lig_pos"], s["atm_pos"], s["lig_cm"], s["atm_cm"],
                                  s["lig_mask"], s["atm_mask"], s["cab"], s["temb"], s["cut"],
                                  s["bond_feat"], s["bond_mask"], s["idx"], s["valid"],
                                  *s["cnt"], params)
        assert _rel(lig[b].numpy(), lig_j) <= TOL and _rel(atm[b].numpy(), atm_j) <= TOL
    # rows without a pair: residual + the two 0e LayerNorm biases (the far
    # row 7, and the masked row 3, of sample 0)
    p = args[-1]
    out = lc.fin.out_dim
    for row in (3, 7):
        want = torch.nn.functional.pad(args[3][0, row], (0, out - lc.lig.din))
        want[: NS] += p["ln_lig"]["bias"] + p["ln_al"]["bias"]
        assert torch.allclose(lig[0, row], want, atol=1e-6)


def test_block_plan_fits_the_shared_memory():
    """The kernel's shared-memory plan (mirrored by plan_words) at flagship
    width, layer 5 (ns 48, 288 TP weights, 624 message columns, 7,776 mix
    weights): 4 ligand rows and 16 atoms a block fit the 227 KB of an SM;
    a wider layer gets fewer atoms, and one that cannot fit is refused."""
    ints = dict(ns=48, hf=144, nw=288, kdim=68, din=168, dout=624, out_dim=168, mix_numel=7776,
                n_slots=4, gs_n=32, nb=10, he_lig=48, he_cross=48, he_atom=48, nl=128, na=1024,
                k=16)
    assert LC.row_groups(ints) == (4, 16)
    assert LC.plan_words(ints, 4, 16) * 4 == 229440 <= LC.SMEM_WORDS * 4
    wide = dict(ints, dout=1200)
    g_l, g_a = LC.row_groups(wide)
    assert g_a < 16 and LC.plan_words(wide, g_l, g_a) <= LC.SMEM_WORDS
    with pytest.raises(ValueError):
        LC.row_groups(dict(ints, nw=900))
