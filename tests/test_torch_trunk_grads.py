"""Gradients of the port's differentiable trunk convs against the JAX package.

On CPU tensors the wrappers (nn/trunk_convs.py pair_conv, cross_conv,
knn_conv) run their plain versions, so autograd through them is the plain
backward that the CUDA kernels B4-B6 are held to on the card. Here it is held
to jax.grad of the XLA twins (nn/pallas_conv.py make_*_twin) on the same
numpy inputs and cotangent, at ns=8, nv=4: every node-feature gradient and
every parameter gradient, as tests/test_pallas_conv_t.py compares the Pallas
backward kernels with the twins (rtol 5e-4, atol 5e-4). Also: the CPU path
counts no launch, the reverse neighbour list of the knn backward, and the
backward kernels' path tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

NS, NV, SED, GSN = 8, 4, 16, 16
LADDER = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"
SH = "1x0e+1x1o+1x2e"
B = 2
TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(3)
    spec = JL.make_conv_spec(LADDER, SH, LADDER, "sep").dw
    din, wn = spec.in1.dim, spec.weight_numel
    nl, na = 14, 96

    def f(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.3), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.3), "b": f(o, sc=0.1)}}

    bm = (rng.random((B, nl, nl)) > 0.8).astype(np.float32)
    d = dict(
        spec=spec, lig_pos=f(B, nl, 3, sc=2.5), atm_pos=f(B, na, 3, sc=5), lig_x=f(B, nl, din),
        atm_x=f(B, na, din), lig_mask=(rng.random((B, nl)) > 0.15).astype(np.float32),
        atm_mask=(rng.random((B, na)) > 0.1).astype(np.float32),
        cab=(rng.random((B, na)) > 0.8).astype(np.float32), temb=f(B, SED),
        cut=np.array([6.0, 5.5], np.float32), emb=mlp(SED + GSN, NS, NS),
        fc_al=mlp(3 * NS, 3 * NS, wn), fc_la=mlp(3 * NS, 3 * NS, wn),
        pair=dict(emb_w1=f(10 + SED + GSN, NS, sc=0.3), emb_b1=f(NS, sc=0.1),
                  emb_w2=f(NS, NS, sc=0.3), emb_b2=f(NS, sc=0.1),
                  fc_w1=f(3 * NS, 3 * NS, sc=0.3), fc_b1=f(3 * NS, sc=0.1),
                  fc_w2=f(3 * NS, wn, sc=0.3), fc_b2=f(wn, sc=0.1)),
        bond_mask=bm, bond_feat=f(B, nl, nl, 10) * bm[..., None],
    )
    d["knn_pos"] = f(B, na, 3, sc=2.0)
    idx, valid = TL.knn_edges(torch.from_numpy(d["knn_pos"]), torch.from_numpy(d["knn_pos"]),
                              torch.from_numpy(d["atm_mask"]), torch.from_numpy(d["atm_mask"]),
                              k=16, cutoff=4.0, exclude_self=True)
    d["idx"], d["valid"] = idx, valid.float()
    return d


def _consts(stop):
    return TC.ConvConsts(TL.make_conv_spec(LADDER, SH, LADDER).dw, NS, SED, stop, GSN)


def _leaf(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


def _tree(t):
    return {k: _tree(v) for k, v in t.items()} if isinstance(t, dict) else _leaf(t)


def _leaves(t, like=None):
    """Leaves of a nested dict, in the key order of `like` (JAX returns
    gradient trees with sorted keys)."""
    like = t if like is None else like
    if isinstance(like, dict):
        return [x for k, v in like.items() for x in _leaves(t[k], v)]
    return [t]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_cross_conv_grads_match_xla_twin(system):
    d = system
    twin = PC.make_cross_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=32.0,
                              gs_n=GSN)
    lx, ax = _leaf(d["lig_x"]), _leaf(d["atm_x"])
    emb, fal, fla = _tree(d["emb"]), _tree(d["fc_al"]), _tree(d["fc_la"])
    al, la = TC.cross_conv(_consts(32.0), *[_t(d[k]) for k in ("lig_pos", "atm_pos")], lx, ax,
                           *[_t(d[k]) for k in ("lig_mask", "atm_mask", "cab", "temb", "cut")],
                           emb, fal, fla)
    g_al, g_la = _cotangent(al.shape, 1), _cotangent(la.shape, 2)
    leaves = [lx, ax] + _leaves(emb) + _leaves(fal) + _leaves(fla)
    got = torch.autograd.grad((al, la), leaves, (_t(g_al), _t(g_la)))
    want = None

    @jax.jit
    def vjp_b(data, x, p, ct):
        # one sample's cotangent pulled back to its features and the params
        def fn(lx_, ax_, e_, a_, l_):
            return twin(*data[:2], lx_, ax_, *data[2:], e_, a_, l_)

        return jax.vjp(fn, *x, *p)[1](ct)

    for b in range(B):
        data = [d[k][b] for k in ("lig_pos", "atm_pos", "lig_mask", "atm_mask", "cab", "temb",
                                  "cut")]
        dlx, dax, *dp = vjp_b(data, (d["lig_x"][b], d["atm_x"][b]),
                              (d["emb"], d["fc_al"], d["fc_la"]), (g_al[b], g_la[b]))
        per = [dlx, dax] + [x for t, lk in zip(dp, (d["emb"], d["fc_al"], d["fc_la"]))
                            for x in _leaves(t, lk)]
        if want is None:
            want = [[np.asarray(x)] for x in per]
        else:
            for w, x in zip(want, per):
                w.append(np.asarray(x))
    feats = [np.stack(want[0]), np.stack(want[1])]
    params = [np.sum(w, axis=0) for w in want[2:]]
    _check(got, feats + params)


def test_pair_conv_grads_match_xla_twin(system):
    d = system
    twin = PC.make_pair_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=5.0,
                             gs_n=GSN, edge_extra=10, exclude_self=True, cab_on_src=True)
    x = _leaf(d["lig_x"])
    p = _tree(d["pair"])
    pos, mask = _t(d["lig_pos"]), _t(d["lig_mask"])
    zero = torch.zeros_like(mask)
    out = TC.pair_conv(_consts(5.0), pos, pos, x, x, mask, mask, zero, zero, _t(d["temb"]), 5.0,
                       p, _t(d["bond_feat"]), _t(d["bond_mask"]))
    g = _cotangent(out.shape, 3)
    got = torch.autograd.grad(out, [x] + _leaves(p), _t(g))
    zl = np.zeros(d["lig_x"].shape[1], np.float32)
    dx, dp = [], None

    @jax.jit
    def vjp_b(pos, mask, temb, bf, bm, x, p, ct):
        def fn(tx, sx, p_):
            return twin(pos, pos, tx, sx, mask, mask, zl, zl, temb, 5.0, p_, bf, bm)

        return jax.vjp(fn, x, x, p)[1](ct)

    for b in range(B):
        dt, ds, dpb = vjp_b(d["lig_pos"][b], d["lig_mask"][b], d["temb"][b], d["bond_feat"][b],
                            d["bond_mask"][b], d["lig_x"][b], d["pair"], g[b])
        # target and source are the same node features: their gradients add
        dx.append(np.asarray(dt) + np.asarray(ds))
        dpb = [np.asarray(v) for v in _leaves(dpb, d["pair"])]
        dp = dpb if dp is None else [a + c for a, c in zip(dp, dpb)]
    _check(got, [np.stack(dx)] + dp)


def test_knn_conv_grads_match_xla_twin(system):
    d = system
    twin = PC.make_knn_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=4.0,
                            gs_n=GSN, k=16)
    x = _leaf(d["atm_x"])
    p = {"emb": _tree(d["emb"]), "fc": _tree(d["fc_al"])}
    out = TC.knn_conv(_consts(4.0), _t(d["knn_pos"]), x, _t(d["atm_mask"]), d["idx"], d["valid"],
                      _t(d["temb"]), p)
    g = _cotangent(out.shape, 4)
    got = torch.autograd.grad(out, [x] + _leaves(p), _t(g))
    dx, dp = [], None

    @jax.jit
    def vjp_b(pos, mask, idx, valid, temb, x, p, ct):
        def fn(x_, p_):
            return twin(pos, x_, mask, idx, valid, temb, p_)

        return jax.vjp(fn, x, p)[1](ct)

    for b in range(B):
        dxb, dpb = vjp_b(d["knn_pos"][b], d["atm_mask"][b], d["idx"][b].numpy(),
                         d["valid"][b].numpy(), d["temb"][b], d["atm_x"][b],
                         {"emb": d["emb"], "fc": d["fc_al"]}, g[b])
        dx.append(np.asarray(dxb))
        dpb = [np.asarray(v) for v in _leaves(dpb, {"emb": d["emb"], "fc": d["fc_al"]})]
        dp = dpb if dp is None else [a + c for a, c in zip(dp, dpb)]
    _check(got, [np.stack(dx)] + dp)


def test_cpu_backward_counts_no_launch(system):
    d = system
    TC.reset_launches()
    x = _leaf(d["atm_x"])
    p = {"emb": _tree(d["emb"]), "fc": _tree(d["fc_al"])}
    out = TC.knn_conv(_consts(4.0), _t(d["knn_pos"]), x, _t(d["atm_mask"]), d["idx"], d["valid"],
                      _t(d["temb"]), p)
    out.sum().backward()
    assert x.grad is not None and all(v == 0 for v in TC.launches.values())


def test_reverse_neighbour_list(system):
    d = system
    idx, valid = d["idx"], d["valid"]
    n = idx.shape[1]
    off, tgt, src = TC.reverse_neighbours(idx.to(torch.int32), valid)
    assert off.shape == (B, n + 1)
    idx_np, valid_np = idx.numpy(), valid.numpy() > 0
    for b in range(B):
        for s in range(n):
            lo, hi = int(off[b, s]), int(off[b, s + 1])
            assert (src[lo:hi] == s).all()
            # every valid slot (t, j) with idx == s, in (target, slot) order
            want = np.nonzero((idx_np[b] == s) & valid_np[b])[0]
            assert tgt[lo:hi].tolist() == want.tolist()
    assert int(off[-1, -1]) == int((valid > 0).sum())


def test_backward_path_tables_cover_every_weight_and_input(system):
    c = _consts(5.0)
    w_meta, in_meta = c.bwd_tables
    assert w_meta.shape == (c.spec.weight_numel, 8)
    # a_base + (d1 - 1) mul inside the input, cb_off + d1 d3 inside cb
    assert (w_meta[:, 0] + (w_meta[:, 2] - 1) * w_meta[:, 1] < c.din).all()
    assert (w_meta[:, 4] + w_meta[:, 2] * w_meta[:, 5] <= c.tables[0].shape[1]).all()
    used = in_meta[:, :, 4] > 0
    assert used.any(axis=1).all() and used.sum(axis=1).max() <= TC.MAX_IN_PATHS
    # each (path, channel, component) appears once: one entry per weight and d1 row
    assert used.sum() == int(w_meta[:, 2].sum())
    layout, stride = TC._grad_layout(GSN + 10, NS, NS, 3 * NS, c.spec.weight_numel, B)
    end = max(o + int(np.prod(s)) for o, s in layout.values())
    assert stride % 4 == 0 and end <= stride < end + 4
