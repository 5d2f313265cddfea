"""B4's decomposition (csrc/cross_bwd.cu, conv_bwd_wide.cuh, abt_gemm.cuh) as
plain PyTorch, against autograd through the plain cross conv.

On CPU tensors trunk_convs.cross_bwd runs cross_bwd_plain, the model of what
the kernels do: one list of the valid (ligand, atom) pairs in ligand-major
order with an atom-major permutation, per direction the feature-major rows
of the pair pass, those rows contracted over every pair into each parameter
gradient with its bias rows (db1_eff per sample segment), and the pairs'
node rows summed per ligand row and, through the permutation, per atom.
Here that is held to torch.autograd.grad through cross_conv_plain at the
small config of the score net (ns=8, nv=4, 2 layers), every feature and
parameter gradient within 1e-5 of max|ref|, where the plain version may take
the model's decision at a ReLU pre-activation within f32 rounding of 0
(nn/relu_ties.py). Also: the pair list against a brute-force scan, the
wide pass's packed path tables against the TP's own gradients, the
contraction's indicator rows and split rule. Torch only, ~5 s.
"""
import numpy as np
import pytest
import torch

from diffbindfr_torch.models import score_net as sn
from diffbindfr_torch.nn import contraction as C
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

CFG = sn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
TOL = 1e-5


def _consts(layer):
    return sn._kernel_consts(CFG)[layer][1]


def _system(layer, bsz, seed, nl=12, na=70, empty=()):
    """Seeded numpy inputs of the cross conv at `layer`: positions, masks
    (samples in `empty` have no valid ligand row), cab flags, features,
    time embedding, cutoffs and the three MLPs."""
    rng = np.random.default_rng(seed)
    c = _consts(layer)
    ns, sed, gsn, wn = c.ns, c.sed, c.gs_n, c.spec.weight_numel

    def f(*shape, sc=1.0):
        return torch.from_numpy((rng.normal(size=shape) * sc).astype(np.float32))

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.3), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.3), "b": f(o, sc=0.1)}}

    lig_mask = torch.from_numpy((rng.random((bsz, nl)) > 0.2).astype(np.float32))
    for b in empty:
        lig_mask[b] = 0
    return dict(
        c=c, lig_pos=f(bsz, nl, 3, sc=2.5), atm_pos=f(bsz, na, 3, sc=5.0),
        lig_x=f(bsz, nl, c.din), atm_x=f(bsz, na, c.din), lig_mask=lig_mask,
        atm_mask=torch.from_numpy((rng.random((bsz, na)) > 0.1).astype(np.float32)),
        cab=torch.from_numpy((rng.random((bsz, na)) > 0.85).astype(np.float32)),
        temb=f(bsz, sed), cut=torch.from_numpy(rng.uniform(4.5, 7.0, bsz).astype(np.float32)),
        emb=mlp(sed + gsn, ns, ns), fc_al=mlp(3 * ns, 3 * ns, wn), fc_la=mlp(3 * ns, 3 * ns, wn))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _mlp_leaves(m):
    return {k: {"w": _leaf(v["w"]), "b": _leaf(v["b"])} for k, v in m.items()}


def _flat(m):
    return [m[k][q] for k in ("l1", "l2") for q in ("w", "b")]


def _model_grads(S, args, leaves, g_al, g_la):
    """The leaves' gradients by cross_bwd on CPU tensors (the plain model),
    mapped to the parameter tree as _CrossConvFn.backward maps the kernel's:
    through the folded edge input (_prep_edge)."""
    data, lx, ax, w_in, beff, *w = TC._cross_inputs(*args)
    d_lig, d_atm, ga, gl = TC.cross_bwd(data, lx.detach(), ax.detach(), w_in.detach(),
                                        beff.detach(), [t.detach() for t in w], g_al, g_la)
    edge = [ga[k] + gl[k] for k in ("w_in", "beff", "w2", "b2")]
    fc = [gr[k] for gr in (ga, gl) for k in ("wf1", "bf1", "wf2", "bf2")]
    return torch.autograd.grad([lx, ax, w_in, beff, *w], leaves, [d_lig, d_atm, *edge, *fc],
                               allow_unused=True)


CASES = {"layer0_B2": (0, 2, 1, ()), "layer1_B2": (1, 2, 2, ()),
         "layer1_B3_empty_sample": (1, 3, 3, (1,)), "layer1_B1_no_pairs": (1, 1, 4, (0,))}


@pytest.mark.parametrize("case", list(CASES))
def test_decomposition_matches_autograd_through_plain(case):
    layer, bsz, seed, empty = CASES[case]
    S = _system(layer, bsz, seed, empty=empty)
    lx, ax = _leaf(S["lig_x"]), _leaf(S["atm_x"])
    emb, fa, fb = _mlp_leaves(S["emb"]), _mlp_leaves(S["fc_al"]), _mlp_leaves(S["fc_la"])
    args = (S["c"], S["lig_pos"], S["atm_pos"], lx, ax, S["lig_mask"], S["atm_mask"], S["cab"],
            S["temb"], S["cut"], emb, fa, fb)
    leaves = [lx, ax] + _flat(emb) + _flat(fa) + _flat(fb)
    gen = torch.Generator().manual_seed(seed)
    out = TC.cross_conv_plain(*args)
    gs = [torch.randn(o.shape, generator=gen) for o in out]
    before = dict(TC.launches)
    got = [torch.zeros_like(x) if g is None else g
           for g, x in zip(_model_grads(S, args, leaves, *gs), leaves)]
    assert TC.launches == before  # the CPU path launches no kernel
    if not any(o.requires_grad for o in out):  # no valid pair: autograd's gradients are all 0
        assert bsz == 1 and all(not bool(g.abs().max()) for g in got)
        return
    ties = ReluTies(TC.cross_conv_plain, args, leaves, gs)
    raw, final, flips = ties.check(got, TOL)
    print(case, "max|err|/max|ref|", " ".join(f"{e:.1e}" for e in raw), "ties", len(flips))
    assert max(final) <= TOL, (raw, final, flips)


def test_pair_list_is_ligand_major_with_an_atom_major_permutation():
    S = _system(1, 3, 5, empty=(2,))
    cut = S["cut"]
    pl, pa, pb, sample_off, lig_off, atm_off, perm = TC.cross_pairs_plain(
        S["lig_pos"], S["atm_pos"], S["lig_mask"], S["atm_mask"], S["cab"], cut)
    bsz, nl, na = S["lig_x"].shape[0], S["lig_x"].shape[1], S["atm_x"].shape[1]
    lp, ap = S["lig_pos"].numpy(), S["atm_pos"].numpy()
    want = []
    for b in range(bsz):
        for l in range(nl):
            for a in range(na):
                v = ap[b, a] - lp[b, l]
                d = np.float32(np.sqrt(np.float32(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) +
                                       np.float32(1e-12)))
                ok = (S["cab"][b, a] > 0 or d <= cut[b].item()) and S["lig_mask"][b, l] > 0 \
                    and S["atm_mask"][b, a] > 0
                if ok:
                    want.append((b, l, a))
    got = list(zip(pb.tolist(), pl.tolist(), pa.tolist()))
    assert got == want and len(want) > 0
    assert sample_off.tolist() == [sum(1 for w in want if w[0] < b) for b in range(bsz + 1)]
    assert lig_off.tolist() == [sum(1 for w in want if w[0] * nl + w[1] < i)
                                for i in range(bsz * nl + 1)]
    # perm walks the list atom by atom, list order kept within an atom
    key = [(pb[i].item(), pa[i].item(), i) for i in perm.tolist()]
    assert key == sorted(key)
    assert atm_off.tolist() == [sum(1 for w in want if w[0] * na + w[2] < i)
                                for i in range(bsz * na + 1)]


@pytest.mark.parametrize("layer", [0, 1])
def test_wide_tables_give_the_tp_gradients(layer):
    """The packed tables the wide pass reads (ConvConsts.wide_tables), walked
    as conv_bwd_wide.cuh walks them, give _tp_bwd_plain's dw and dx, and
    those are autograd's through the depthwise TP of the forward."""
    c = _consts(layer)
    rng = np.random.default_rng(layer)
    n, kdim = 5, c.tables[0].shape[1]
    x, cb = torch.tensor(rng.normal(size=(n, c.din)), dtype=torch.float64), \
        torch.tensor(rng.normal(size=(n, kdim)), dtype=torch.float64)
    w, g = torch.tensor(rng.normal(size=(n, c.spec.weight_numel)), dtype=torch.float64), \
        torch.tensor(rng.normal(size=(n, c.dout)), dtype=torch.float64)
    dw, dx = TC._tp_bwd_plain(c, x, cb, w, g)
    w_meta, in_off, in_ent = c.wide_tables
    xn, cbn, wn, gn = (t.numpy() for t in (x, cb, w, g))
    tdw, tdx = np.zeros_like(dw.numpy()), np.zeros_like(dx.numpy())
    for j, (a0, mul, o0, packed) in enumerate(w_meta):
        cb0, d1, d3 = packed & 0xffff, (packed >> 16) & 0xff, packed >> 24
        for k in range(d3):
            z = sum(xn[:, a0 + i * mul] * cbn[:, cb0 + i * d3 + k] for i in range(d1))
            tdw[:, j] += gn[:, o0 + k * mul] * z
    for col in range(c.din):
        for o0, mul, wi, packed in in_ent[in_off[col]:in_off[col + 1]]:
            cb0, d3 = packed & 0xffff, packed >> 16
            s = sum(gn[:, o0 + k * mul] * cbn[:, cb0 + k] for k in range(d3))
            tdx[:, col] += wn[:, wi] * s
    np.testing.assert_allclose(dw.numpy(), tdw, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dx.numpy(), tdx, rtol=1e-12, atol=1e-12)
    # the forward message out[s3 + k mul + u] = w[u] sum_i x[i, u] cb[i, k]
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = torch.zeros(n, c.dout, dtype=torch.float64)
    for m in c.path_metas:
        d1, d3, mul = m["d1"], m["d3"], m["mul"]
        xp = xr[:, m["s1"]: m["s1"] + d1 * mul].unflatten(-1, (d1, mul))
        cp = cb[:, m["cb_off"]: m["cb_off"] + d1 * d3].unflatten(-1, (d1, d3))
        z = torch.einsum("pim,pik->pkm", xp, cp) * wr[:, None, m["w_off"]: m["w_off"] + mul]
        out = out.index_add(1, torch.arange(m["s3"], m["s3"] + d3 * mul), z.flatten(1))
    adx, adw = torch.autograd.grad(out, [xr, wr], g)
    np.testing.assert_allclose(dw.numpy(), adw.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dx.numpy(), adx.numpy(), rtol=1e-12, atol=1e-12)


def test_contraction_indicator_rows_and_splits():
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.normal(size=(5, 37)), dtype=torch.float64)
    b = torch.tensor(rng.normal(size=(3, 37)), dtype=torch.float64)
    seg = torch.tensor([0, 10, 10, 37])
    out = C.contract_plain(a, b, seg)
    assert out.shape == (8, 3)
    np.testing.assert_allclose(out[:5].numpy(), (a @ b.T).numpy(), rtol=1e-12)
    for r, (lo, hi) in enumerate(zip(seg[:-1].tolist(), seg[1:].tolist())):
        np.testing.assert_allclose(out[5 + r].numpy(), b[:, lo:hi].sum(1).numpy(), atol=1e-12)
    np.testing.assert_allclose(C.contract_plain(a, b)[5].numpy(), b.sum(1).numpy(), rtol=1e-12)
    # chunks fill the block slots once; never more chunks than K slices, never 0
    assert C.max_splits(C.tiles(480, 144), 1024, 132) == 11  # P3-abt: 24 tiles, 264 slots
    assert C.max_splits(24, 40, 132) == 2 and C.max_splits(300, 10 ** 6, 132) == 1
    assert C.max_splits(0, 0, 132) == 1
