"""Hand-written CUDA trunk-conv kernels against their plain versions, on
the card: the forward kernels B1-B3, the backward kernels B4-B6 (autograd
through the wrappers against autograd through the plain versions), the
finalize kernels B7-B9 and the whole-layer kernel B10 (forward, and the
gradients of their plain-recompute backward), the bf16-chain kernels B11
(forward against their plain bf16 versions, backward equal to the f32
wrappers'), the kernel path's error for gradients it does not give
(positions, time embedding, cutoff), the probes' kernels P2-P4, the split-K
contraction at ragged shapes, and B4 at a ragged pair count (bit-identical
across two calls) and with no valid pair. Marked
`cuda`: skipped (with a reason) where no GPU is present. Imports no JAX, so
it runs on the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: f32 sums in another order, max|err| <= 1e-4 * max|ref| forward
(B11: <= 1.5e-3, below the f32 kernels' distance to the same reference; the
bf16 chain's rounding of a TP weight or cb entry that the two f32 MLP
orders put on either side of a bf16 rounding boundary moves one term by one
bf16 unit);
every gradient max|err| <= 5e-4 * max|ref|, where the plain version may
take the kernel's decision at a ReLU pre-activation within f32 rounding of 0
and nowhere else (nn/relu_ties.py).
"""
import functools
import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layer_conv as LC
from diffbindfr_torch.nn import layers as L
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

NS, NV, SED, GSN = 8, 4, 16, 16
LADDER = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _system(dev, nt=24, nsrc=300, bsz=3, seed=0):
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(LADDER, "1x0e+1x1o+1x2e", LADDER)
    din, wn = cs.dw.in1.dim, cs.dw.weight_numel

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    def bern(p, *shape):
        return torch.tensor(rng.random(shape) < p, dtype=torch.float32, device=dev)

    return dict(
        cs=cs, tgt_pos=f(bsz, nt, 3, sc=3), src_pos=f(bsz, nsrc, 3, sc=6),
        tgt_x=f(bsz, nt, din), src_x=f(bsz, nsrc, din), tgt_mask=bern(0.85, bsz, nt),
        src_mask=bern(0.9, bsz, nsrc), cab=bern(0.2, bsz, nsrc), temb=f(bsz, SED),
        emb=mlp(SED + GSN, NS, NS), fc_a=mlp(3 * NS, 3 * NS, wn), fc_b=mlp(3 * NS, 3 * NS, wn),
        pair_w1=f(10 + SED + GSN, NS, sc=0.2), f=f, bern=bern)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
def test_cross_kernel_matches_plain(dev):
    S = _system(dev)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN)
    cut = torch.tensor([6.5, 5.2, 8.0], device=dev)
    args = (c, S["tgt_pos"], S["src_pos"], S["tgt_x"], S["src_x"], S["tgt_mask"],
            S["src_mask"], S["cab"], S["temb"], cut, S["emb"], S["fc_a"], S["fc_b"])
    before = TC.launches["cross_conv"]
    al, la = TC.cross_conv(*args)
    torch.cuda.synchronize()
    assert TC.launches["cross_conv"] == before + 1
    al0, la0 = TC.cross_conv_plain(*args)
    assert _rel(al, al0) <= 1e-4 and _rel(la, la0) <= 1e-4


@pytest.mark.cuda
def test_pair_kernel_matches_plain(dev):
    S = _system(dev, nt=40, nsrc=40)
    f, bern = S["f"], S["bern"]
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 5.0, GSN)
    bsz, nl = S["tgt_x"].shape[:2]
    pos = f(bsz, nl, 3, sc=2.5)
    bm = bern(0.1, bsz, nl, nl)
    bf = f(bsz, nl, nl, 10) * bm[..., None]
    p = {"emb_w1": S["pair_w1"], "emb_b1": S["emb"]["l1"]["b"], "emb_w2": S["emb"]["l2"]["w"],
         "emb_b2": S["emb"]["l2"]["b"], "fc_w1": S["fc_a"]["l1"]["w"],
         "fc_b1": S["fc_a"]["l1"]["b"], "fc_w2": S["fc_a"]["l2"]["w"],
         "fc_b2": S["fc_a"]["l2"]["b"]}
    zero = torch.zeros(bsz, nl, device=dev)
    args = (c, pos, pos, S["tgt_x"], S["tgt_x"], S["tgt_mask"], S["tgt_mask"], zero, zero,
            S["temb"], 5.0, p, bf, bm)
    got = TC.pair_conv(*args)
    torch.cuda.synchronize()
    assert _rel(got, TC.pair_conv_plain(*args)) <= 1e-4


@pytest.mark.cuda
def test_knn_kernel_matches_plain(dev):
    S = _system(dev, nt=10)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 4.0, GSN)
    pos = S["f"](*S["src_pos"].shape, sc=2.0)
    idx, valid = L.knn_edges(pos, pos, S["src_mask"], S["src_mask"], k=16, cutoff=4.0,
                             exclude_self=True)
    args = (c, pos, S["src_x"], S["src_mask"], idx, valid.float(), S["temb"],
            {"emb": S["emb"], "fc": S["fc_a"]})
    got = TC.knn_conv(*args)
    torch.cuda.synchronize()
    assert _rel(got, TC.knn_conv_plain(*args)) <= 1e-4


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_parameters(dev):
    S = _system(dev)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN)
    bad = {"l1": S["fc_a"]["l1"], "l2": {"w": S["fc_a"]["l2"]["w"][:, :-1],
                                         "b": S["fc_a"]["l2"]["b"][:-1]}}
    with pytest.raises(ValueError):
        TC.cross_conv(c, S["tgt_pos"], S["src_pos"], S["tgt_x"], S["src_x"], S["tgt_mask"],
                      S["src_mask"], S["cab"], S["temb"], 6.0, S["emb"], bad, S["fc_b"])


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _grad_close(plain, args, leaves, gs, got, tol=5e-4):
    raw, final, flips = ReluTies(plain, args, leaves, gs).check(got, tol)
    assert max(final) <= tol, (raw, final, flips)


def _mlp_leaves(m):
    return {k: {"w": _leaf(v["w"]), "b": _leaf(v["b"])} for k, v in m.items()}


def _flat(m):
    return [m[k][q] for k in ("l1", "l2") for q in ("w", "b")]


@pytest.mark.cuda
def test_cross_backward_kernel_matches_plain(dev):
    S = _system(dev)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN)
    cut = torch.tensor([6.5, 5.2, 8.0], device=dev)
    lx, ax = _leaf(S["tgt_x"]), _leaf(S["src_x"])
    emb, fa, fb = _mlp_leaves(S["emb"]), _mlp_leaves(S["fc_a"]), _mlp_leaves(S["fc_b"])
    args = (c, S["tgt_pos"], S["src_pos"], lx, ax, S["tgt_mask"], S["src_mask"], S["cab"],
            S["temb"], cut, emb, fa, fb)
    leaves = [lx, ax] + _flat(emb) + _flat(fa) + _flat(fb)
    out = TC.cross_conv(*args)
    gs = [torch.randn_like(o) for o in out]
    before = TC.launches["cross_bwd"]
    got = torch.autograd.grad(out, leaves, gs)
    torch.cuda.synchronize()
    assert TC.launches["cross_bwd"] == before + 1
    _grad_close(TC.cross_conv_plain, args, leaves, gs, got)


@pytest.mark.cuda
def test_pair_backward_kernel_matches_plain(dev):
    S = _system(dev, nt=40, nsrc=40)
    f, bern = S["f"], S["bern"]
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 5.0, GSN)
    bsz, nl = S["tgt_x"].shape[:2]
    pos = f(bsz, nl, 3, sc=2.5)
    bm = bern(0.1, bsz, nl, nl)
    bf = f(bsz, nl, nl, 10) * bm[..., None]
    p = {k: _leaf(v) for k, v in (
        ("emb_w1", S["pair_w1"]), ("emb_b1", S["emb"]["l1"]["b"]), ("emb_w2", S["emb"]["l2"]["w"]),
        ("emb_b2", S["emb"]["l2"]["b"]), ("fc_w1", S["fc_a"]["l1"]["w"]),
        ("fc_b1", S["fc_a"]["l1"]["b"]), ("fc_w2", S["fc_a"]["l2"]["w"]),
        ("fc_b2", S["fc_a"]["l2"]["b"]))}
    x = _leaf(S["tgt_x"])
    zero = torch.zeros(bsz, nl, device=dev)
    args = (c, pos, pos, x, x, S["tgt_mask"], S["tgt_mask"], zero, zero, S["temb"], 5.0, p, bf,
            bm)
    out = TC.pair_conv(*args)
    g = torch.randn_like(out)
    before = TC.launches["pair_bwd"]
    got = torch.autograd.grad(out, [x] + list(p.values()), g)
    torch.cuda.synchronize()
    assert TC.launches["pair_bwd"] == before + 1
    _grad_close(TC.pair_conv_plain, args, [x] + list(p.values()), [g], got)


@pytest.mark.cuda
def test_knn_backward_kernel_matches_plain(dev):
    S = _system(dev, nt=10)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 4.0, GSN)
    pos = S["f"](*S["src_pos"].shape, sc=2.0)
    idx, valid = L.knn_edges(pos, pos, S["src_mask"], S["src_mask"], k=16, cutoff=4.0,
                             exclude_self=True)
    x = _leaf(S["src_x"])
    p = {"emb": _mlp_leaves(S["emb"]), "fc": _mlp_leaves(S["fc_a"])}
    args = (c, pos, x, S["src_mask"], idx, valid.float(), S["temb"], p)
    leaves = [x] + _flat(p["emb"]) + _flat(p["fc"])
    out = TC.knn_conv(*args)
    g = torch.randn_like(out)
    before = TC.launches["knn_bwd"]
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert TC.launches["knn_bwd"] == before + 1
    _grad_close(TC.knn_conv_plain, args, leaves, [g], got)


@pytest.mark.cuda
def test_backward_wrappers_reject_bad_cotangents(dev):
    S = _system(dev, nt=12, nsrc=60)
    cross = TC._cross_inputs(TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN), S["tgt_pos"],
                             S["src_pos"], S["tgt_x"], S["src_x"], S["tgt_mask"], S["src_mask"],
                             S["cab"], S["temb"], 6.0, S["emb"], S["fc_a"], S["fc_b"])
    data, lx, ax, w_in, beff, *w = cross
    bsz, nl, na, dout = lx.shape[0], lx.shape[1], ax.shape[1], data.c.dout
    good_la = torch.zeros(bsz, na, dout, device=dev)
    for bad in (torch.zeros(bsz, nl, dout + 1, device=dev), torch.zeros(bsz, nl, dout)):
        with pytest.raises(ValueError):
            TC.cross_bwd(data, lx, ax, w_in, beff, w, bad, good_la)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 5.0, GSN)
    zero = torch.zeros_like(S["tgt_mask"])
    bm = torch.zeros(bsz, nl, nl, device=dev)
    pair = TC._pair_inputs(c, S["tgt_pos"], S["tgt_pos"], S["tgt_x"], S["tgt_x"], S["tgt_mask"],
                           S["tgt_mask"], zero, S["temb"], 5.0,
                           {"emb_w1": S["pair_w1"], "emb_b1": S["emb"]["l1"]["b"],
                            "emb_w2": S["emb"]["l2"]["w"], "emb_b2": S["emb"]["l2"]["b"],
                            "fc_w1": S["fc_a"]["l1"]["w"], "fc_b1": S["fc_a"]["l1"]["b"],
                            "fc_w2": S["fc_a"]["l2"]["w"], "fc_b2": S["fc_a"]["l2"]["b"]},
                           torch.zeros(bsz, nl, nl, 10, device=dev), bm)
    data, tx, sx, w_in, beff, *w = pair
    for bad in (torch.zeros(bsz, nl + 1, c.dout, device=dev), torch.zeros(bsz, nl, c.dout)):
        with pytest.raises(ValueError):
            TC.pair_bwd(data, tx, sx, w_in, beff, w, bad)
    k = TC.ConvConsts(S["cs"].dw, NS, SED, 4.0, GSN)
    idx, valid = L.knn_edges(S["src_pos"], S["src_pos"], S["src_mask"], S["src_mask"], k=16,
                             cutoff=4.0, exclude_self=True)
    knn = TC._knn_inputs(k, S["src_pos"], S["src_x"], idx, valid.float(), S["temb"],
                         {"emb": S["emb"], "fc": S["fc_a"]})
    data, x, w_in, beff, *w = knn
    for bad in (torch.zeros(bsz, na, k.dout - 1, device=dev), torch.zeros(bsz, na, k.dout)):
        with pytest.raises(ValueError):
            TC.knn_bwd(data, x, w_in, beff, w, bad)


def _layer_system(dev, na=300, seed=3):
    """One small trunk layer (out_dim > din) with its graph, counts and
    parameters: the arguments of layer_conv, some rows fully masked."""
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(f"{NS}x0e+{NV}x1o", "1x0e+1x1o+1x2e", f"{NS}x0e+{NV}x1o+{NV}x1e")
    din, wn = cs.dw.in1.dim, cs.dw.weight_numel
    bsz, nl, edim = 2, 20, 6

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.3), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.3), "b": f(o, sc=0.1)}}

    lig_pos, atm_pos = f(bsz, nl, 3, sc=3), f(bsz, na, 3, sc=7)
    lig_mask = torch.tensor(rng.random((bsz, nl)) > 0.1, dtype=torch.float32, device=dev)
    atm_mask = torch.tensor(rng.random((bsz, na)) > 0.1, dtype=torch.float32, device=dev)
    lig_mask[0, 3] = 0.0
    cab = torch.tensor(rng.random((bsz, na)) > 0.85, dtype=torch.float32, device=dev)
    bm = torch.tensor(rng.random((bsz, nl, nl)) > 0.9, dtype=torch.float32, device=dev)
    bm = torch.maximum(bm, bm.transpose(1, 2)) * (1 - torch.eye(nl, device=dev))
    bf = f(bsz, nl, nl, edim) * bm[..., None]
    idx, valid = L.knn_edges(atm_pos, atm_pos, atm_mask, atm_mask, k=8, cutoff=4.5,
                             exclude_self=True)
    cut = torch.tensor([9.0, 7.5], device=dev)
    nw_ = sum(m for m, _ in cs.out.items)
    params = {"emb_lig": mlp(edim + SED + GSN, NS, NS), "emb_cross": mlp(SED + GSN, NS, NS),
              "emb_atom": mlp(SED + GSN, NS, NS)}
    for t in ("lig", "al", "la", "atom"):
        params.update({f"fc_{t}": mlp(3 * NS, 3 * NS, wn), f"mix_{t}": f(cs.lin.weight_numel,
                                                                         sc=0.3),
                       f"ln_{t}": {"weight": 1 + 0.1 * f(nw_), "mean_shift": f(nw_, sc=0.5),
                                   "bias": 0.05 * f(cs.out.num_scalars)}})
    lc = LC.LayerConsts(cs, TC.ConvConsts(cs.dw, NS, SED, 6.0, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, 9.0, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, 4.5, GSN))
    d_ll = TC._dist(lig_pos[:, None] - lig_pos[:, :, None])
    eye = torch.eye(nl, dtype=torch.bool, device=dev)
    both_l = (lig_mask[:, :, None] > 0) & (lig_mask[:, None] > 0)
    m_ll = ((((d_ll <= 6.0) & ~eye) | (bm > 0)) & both_l).float()
    d_c = TC._dist(atm_pos[:, None] - lig_pos[:, :, None])
    m_c = (((cab[:, None] > 0) | (d_c <= cut[:, None, None])) & (lig_mask[:, :, None] > 0)
           & (atm_mask[:, None] > 0)).float()
    args = [lc, lig_pos, atm_pos, f(bsz, nl, din), f(bsz, na, din), lig_mask, atm_mask, cab,
            f(bsz, SED), cut, bf, bm, idx, valid.float(), m_ll.sum(2), m_c.sum(2), m_c.sum(1),
            valid.float().sum(2), params]
    return args


def _fin_calls(args):
    """(wrapper, plain, arguments) of B7, B8 and B9 on the layer system."""
    lc, lp, ap, lx, ax, lm, am, cab, temb, cut, bf, bm, idx, valid, c_l, c_al, c_la, _, p = args
    zero = torch.zeros_like(lm)

    def fin(t):
        return {"mix": p[f"mix_{t}"], "ln": p[f"ln_{t}"]}

    return {
        "cross_conv_fin": (TC.cross_conv_fin, TC.cross_conv_fin_plain, (
            lc.cross, lc.fin, lp, ap, lx, ax, lm, am, cab, temb, cut, p["emb_cross"], p["fc_al"],
            p["fc_la"], fin("al"), fin("la"), c_al, c_la)),
        "pair_conv_fin": (TC.pair_conv_fin, TC.pair_conv_fin_plain, (
            lc.lig, lc.fin, lp, lp, lx, lx, lm, lm, zero, zero, temb, 6.0,
            {**TC.pair_params(p["emb_lig"], p["fc_lig"]), **fin("lig")}, bf, bm, c_l)),
        "knn_conv_fin": (TC.knn_conv_fin, TC.knn_conv_fin_plain, (
            lc.atom, lc.fin, ap, ax, am, idx, valid, temb,
            {"emb": p["emb_atom"], "fc": p["fc_atom"], **fin("atom")})),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("na", [300, 700])
def test_finalize_kernels_match_plain(dev, na):
    """B7-B9 with fin; na 700 groups several atoms per block of the la pass."""
    for name, (kernel, plain, a) in _fin_calls(_layer_system(dev, na=na)).items():
        before = TC.launches[name]
        got = kernel(*a)
        torch.cuda.synchronize()
        assert TC.launches[name] == before + 1
        ref = plain(*a)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g_, r_ in zip(got, ref):
            assert _rel(g_, r_) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("na", [300, 700])
def test_layer_kernel_matches_plain(dev, na):
    args = _layer_system(dev, na=na)
    before = TC.launches["layer_conv"]
    lig, atm = LC.layer_conv(*args)
    torch.cuda.synchronize()
    assert TC.launches["layer_conv"] == before + 1
    lig0, atm0 = LC.layer_conv_plain(*args)
    assert _rel(lig, lig0) <= 1e-4 and _rel(atm, atm0) <= 1e-4
    # a fully masked ligand row is its residual plus the two 0e LayerNorm biases
    assert torch.allclose(lig[0, 3], lig0[0, 3], atol=1e-6)


@pytest.mark.cuda
def test_layer_kernel_backward_is_the_plain_gradient(dev):
    """B10's backward recomputes through the plain version: the gradients
    equal autograd through layer_conv_plain (1e-5 of max|ref|: the same
    operations on the same inputs)."""
    args = _layer_system(dev)
    x = [_leaf(args[3]), _leaf(args[4])]
    p = {k: ({kk: {q: _leaf(w) for q, w in v2.items()} if isinstance(v2, dict) else _leaf(v2)
              for kk, v2 in v.items()} if isinstance(v, dict) else _leaf(v))
         for k, v in args[18].items()}
    a = list(args)
    a[3], a[4], a[18] = x[0], x[1], p
    leaves = x + [t for v in p.values() for t in (
        [w for v2 in v.values() for w in (v2.values() if isinstance(v2, dict) else [v2])]
        if isinstance(v, dict) else [v])]
    gs = None
    grads = []
    for fn in (LC.layer_conv, LC.layer_conv_plain):
        out = fn(*a)
        if gs is None:
            gs = [torch.randn_like(o) for o in out]
        grads.append(torch.autograd.grad(out, leaves, gs))
    for g_, r_ in zip(*grads):
        assert _rel(g_, r_) <= 1e-5


def _b11_calls(dev):
    """(bf16 wrapper, its plain version, f32 wrapper, args, target masks) of
    B11-cross, -pair and -knn on the small systems of the tests above."""
    S = _system(dev)
    f, bern = S["f"], S["bern"]
    cut = torch.tensor([6.5, 5.2, 8.0], device=dev)
    cross = (TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN), S["tgt_pos"], S["src_pos"],
             S["tgt_x"], S["src_x"], S["tgt_mask"], S["src_mask"], S["cab"], S["temb"], cut,
             S["emb"], S["fc_a"], S["fc_b"])
    P = _system(dev, nt=40, nsrc=40, seed=1)
    bsz, nl = P["tgt_x"].shape[:2]
    pos = P["f"](bsz, nl, 3, sc=2.5)
    bm = P["bern"](0.1, bsz, nl, nl)
    p = {"emb_w1": P["pair_w1"], "emb_b1": P["emb"]["l1"]["b"], "emb_w2": P["emb"]["l2"]["w"],
         "emb_b2": P["emb"]["l2"]["b"], "fc_w1": P["fc_a"]["l1"]["w"],
         "fc_b1": P["fc_a"]["l1"]["b"], "fc_w2": P["fc_a"]["l2"]["w"],
         "fc_b2": P["fc_a"]["l2"]["b"]}
    zero = torch.zeros(bsz, nl, device=dev)
    pair = (TC.ConvConsts(P["cs"].dw, NS, SED, 5.0, GSN), pos, pos, P["tgt_x"], P["tgt_x"],
            P["tgt_mask"], P["tgt_mask"], zero, zero, P["temb"], 5.0, p,
            P["f"](bsz, nl, nl, 10) * bm[..., None], bm)
    kpos = f(*S["src_pos"].shape, sc=2.0)
    idx, valid = L.knn_edges(kpos, kpos, S["src_mask"], S["src_mask"], k=16, cutoff=4.0,
                             exclude_self=True)
    knn = (TC.ConvConsts(S["cs"].dw, NS, SED, 4.0, GSN), kpos, S["src_x"], S["src_mask"], idx,
           valid.float(), S["temb"], {"emb": S["emb"], "fc": S["fc_a"]})
    calls = {"cross_conv_bf16": (TC.cross_conv, TC.cross_conv_plain, cross,
                                 (S["tgt_mask"], S["src_mask"])),
             "pair_conv_bf16": (TC.pair_conv, TC.pair_conv_plain, pair, (P["tgt_mask"],)),
             "knn_conv_bf16": (TC.knn_conv, TC.knn_conv_plain, knn, (valid.float().sum(-1),))}
    return {k: (functools.partial(fn, bf16_chain=True), functools.partial(plain, bf16_chain=True),
                fn, args, masks) for k, (fn, plain, args, masks) in calls.items()}


@pytest.mark.cuda
def test_bf16_chain_kernels_match_plain(dev):
    """B11 against the plain bf16 versions (1.5e-3 of max|ref|; measured
    <= 5.6e-4 on the H100); rows of masked targets exactly 0; one launch
    each, none of B1-B3. The control, the f32 wrapper against the same plain
    bf16 version, must lie beyond the bound (measured >= 2.3e-3, on the
    pair conv), so the bound tells the bf16 chain from f32."""
    for name, (kernel, plain, f32, args, masks) in _b11_calls(dev).items():
        TC.reset_launches()
        got = kernel(*args)
        torch.cuda.synchronize()
        assert TC.launches == {k: int(k == name) for k in TC.launches}, name
        ref, g32 = plain(*args), f32(*args)
        got, ref, g32 = (x if isinstance(x, tuple) else (x,) for x in (got, ref, g32))
        err = max(_rel(g_, r_) for g_, r_ in zip(got, ref))
        ctl = max(_rel(g_, r_) for g_, r_ in zip(g32, ref))
        print(f"{name}: max|err|/max|ref| {err:.2e}, the f32 wrapper's (control) {ctl:.2e}")
        assert err <= 1.5e-3 < ctl, name
        assert all(bool((g_[m_ <= 0] == 0).all()) for g_, m_ in zip(got, masks)), name


@pytest.mark.cuda
def test_bf16_chain_backward_is_the_f32_backward(dev):
    """B11's backward is B4-B6 on the same saved inputs: its gradients equal
    the f32 wrappers' exactly (the bf16 chain changes the forward only)."""
    for name, (kernel, _, f32, args, _) in _b11_calls(dev).items():
        grads = []
        for fn in (kernel, f32):
            a = list(args)
            x_at = {"cross_conv_bf16": (3, 4), "pair_conv_bf16": (3,), "knn_conv_bf16": (2,)}[name]
            leaves = []
            for i in x_at:
                a[i] = _leaf(a[i])
                leaves.append(a[i])
            if name == "pair_conv_bf16":
                a[4] = a[3]
            out = fn(*a)
            out = out if isinstance(out, tuple) else (out,)
            gen = torch.Generator(device=dev).manual_seed(3)
            gs = [torch.randn(o.shape, generator=gen, device=dev) for o in out]
            grads.append(torch.autograd.grad(out, leaves, gs))
        for g_, r_ in zip(*grads):
            assert torch.equal(g_, r_), name


@pytest.mark.cuda
def test_kernel_path_refuses_position_gradients(dev):
    """A position, temb or cutoff tensor that requires grad makes the kernel
    wrappers (f32 and bf16) raise and name the plain path: the backward
    kernels give gradients to features and parameters only."""
    calls = _b11_calls(dev)
    for name, (kernel, _, f32, args, _) in calls.items():
        data_at = {"cross_conv_bf16": (1, 2, 8, 9), "pair_conv_bf16": (1, 9),
                   "knn_conv_bf16": (1, 6)}[name]
        for fn in (kernel, f32):
            for i in data_at:
                a = list(args)
                a[i] = _leaf(a[i])
                with pytest.raises(RuntimeError, match="plain"):
                    fn(*a)
            with torch.no_grad():  # no graph, nothing to refuse
                a = list(args)
                a[1] = a[1].clone().requires_grad_(True)
                fn(*a)


# ---------------------------------------------------------------------------
# the probes P2-P4 (diffbindfr_torch/probes): each kernel against its plain
# version at the TPU probes' shapes (P2's chains at 64 grid steps over 8 input
# blocks), with the tolerances of tests/test_torch_probes.py (mosaic.TOL: exact
# for the layout probes, onehot and precision bit for bit, 1e-6 of max|ref|
# for bcast2d, 1e-5 for msel, abt, the MLP and dwloop; 1e-6 for legality and
# chain_vpu; chain_mxu by mxu_ops.mxu_errors: d3 = 5 rows 1e-5, the
# bf16-rounded rows within one bf16 unit plus 1e-5)
# ---------------------------------------------------------------------------

PROBE_WORDS = ("3d", "onehot", "tile", "bcast", "4d", "msel", "prec", "dw", "mlp", "abt")


@pytest.mark.cuda
@pytest.mark.parametrize("word", PROBE_WORDS)
def test_probe_mosaic_kernel_matches_plain(dev, word):
    from diffbindfr_torch.probes import mlp, mosaic

    torch.backends.cuda.matmul.allow_tf32 = False
    fn, plain, _ = mosaic.FUNCS[word]
    args = mosaic.inputs(word, dev)
    counts = {**mosaic.launches, **mlp.launches}
    got = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert sum({**mosaic.launches, **mlp.launches}.values()) == sum(counts.values()) + 1
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    if mosaic.TOL[word] == 0:
        assert torch.equal(got, ref), word
    else:
        assert _rel(got, ref) <= mosaic.TOL[word], (word, _rel(got, ref))
    if word in ("onehot", "prec"):  # the gather is the exact movement
        assert torch.equal(got, args[0][:, torch.arange(1024, device=dev) // 128])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1024, 32, 200])
def test_probe_mlp_kernel_matches_plain(dev, R):
    from diffbindfr_torch.probes import mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    args = mlp.inputs(R, dev)
    before = mlp.launches["probe_mlp"]
    got = mlp.mlp(*args)
    ref = mlp.mlp_plain(*args)
    torch.cuda.synchronize()
    assert mlp.launches["probe_mlp"] == before + 1
    assert got.shape == (480, R) and _rel(got, ref) <= 1e-5


@pytest.mark.cuda
def test_probe_mxu_ops_kernels_match_plain(dev):
    from diffbindfr_torch.probes import mxu_ops as M

    torch.backends.cuda.matmul.allow_tf32 = False
    before = dict(M.launches)
    a = M.legality_inputs(dev)
    got, ref = M.legality(a), M.legality_plain(a)
    assert _rel(got, ref) <= 1e-6 and not bool(got[:, 10:].any())
    src, w, cb = M.chain_inputs(8, dev)
    got, ref = M.chain_vpu(src, w, cb, 64), M.chain_vpu_plain(src, w, cb, 64)
    torch.cuda.synchronize()
    assert got.shape == (64, 1216, 8) and _rel(got, ref) <= 1e-6
    assert not bool(got[..., 4:].any())
    cbT = M.transpose_cb(cb)
    got, ref = M.chain_mxu(src, w, cbT, 64), M.chain_mxu_plain(src, w, cbT, 64)
    torch.cuda.synchronize()
    e5, ratio = M.mxu_errors(got, ref)
    assert got.shape == (64, 384, 40) and e5 <= 1e-5 and ratio <= 1.0, (e5, ratio)
    assert M.launches == {k: v + 1 for k, v in before.items()}


# ---------------------------------------------------------------------------
# the split-K contraction (P3-abt; B4's parameter gradients run the same
# kernel) and B4's wide-tile pass at the edges of its pair list
# ---------------------------------------------------------------------------

# the tool's shape; M, N, K off the 64 x 64 x 32 tiling (K not a multiple of
# 4: the 4-byte copy path); K within one slice, hence one chunk
ABT_SHAPES = [(480, 144, 1024), (70, 33, 130), (97, 200, 51), (7, 5, 3), (64, 130, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", ABT_SHAPES)
def test_abt_kernel_matches_plain(dev, m, n, k):
    from diffbindfr_torch.probes import mosaic

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen, device=dev)
    b = torch.randn(n, k, generator=gen, device=dev)
    before = mosaic.launches["probe_mosaic/abt"]
    got = mosaic.abt(a, b)
    ref = mosaic.abt_plain(a, b)
    torch.cuda.synchronize()
    assert mosaic.launches["probe_mosaic/abt"] == before + 1
    assert got.shape == (m, n) and _rel(got, ref) <= 1e-5
    assert torch.equal(got, mosaic.abt(a, b))  # the chunks are added in a fixed order


def _cross_grads(S, c, cut, lig_mask):
    lx, ax = _leaf(S["tgt_x"]), _leaf(S["src_x"])
    emb, fa, fb = _mlp_leaves(S["emb"]), _mlp_leaves(S["fc_a"]), _mlp_leaves(S["fc_b"])
    args = (c, S["tgt_pos"], S["src_pos"], lx, ax, lig_mask, S["src_mask"], S["cab"], S["temb"],
            cut, emb, fa, fb)
    leaves = [lx, ax] + _flat(emb) + _flat(fa) + _flat(fb)
    out = TC.cross_conv(*args)
    gs = [torch.randn_like(o) for o in out]
    return args, leaves, gs, [torch.autograd.grad(out, leaves, gs, retain_graph=True)
                              for _ in range(2)]


@pytest.mark.cuda
def test_cross_backward_kernel_ragged_pair_count_is_deterministic(dev):
    """5971 valid pairs (not a multiple of the 64-pair tile): the gradients
    match autograd through the plain version and two backward calls give
    the same bits."""
    S = _system(dev)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN)
    cut = torch.tensor([6.5, 5.2, 8.0], device=dev)
    args, leaves, gs, (got, again) = _cross_grads(S, c, cut, S["tgt_mask"])
    torch.cuda.synchronize()
    assert TC.cross_bwd_stats["pairs"] == 5971
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _grad_close(TC.cross_conv_plain, args, leaves, gs, got)


@pytest.mark.cuda
def test_cross_backward_kernel_without_valid_pairs(dev):
    """A B = 1 sample whose ligand rows are all masked: no pair, every
    gradient exactly 0 (the plain version's output depends on nothing)."""
    S = _system(dev, bsz=1, seed=5)
    c = TC.ConvConsts(S["cs"].dw, NS, SED, 32.0, GSN)
    mask = torch.zeros_like(S["tgt_mask"])
    args, leaves, gs, (got, again) = _cross_grads(S, c, torch.tensor([6.0], device=dev), mask)
    torch.cuda.synchronize()
    assert TC.cross_bwd_stats["pairs"] == 0
    assert not any(o.requires_grad for o in TC.cross_conv_plain(*args))
    assert all(not bool(g.abs().max()) and torch.equal(g, h) for g, h in zip(got, again))
