"""Plain PyTorch versions of the three trunk-conv kernels against the JAX
package: the XLA twins (nn/pallas_conv.py make_*_twin) on a batch, and once
each against the Pallas kernels in interpret mode (nn/pallas_conv_t.py) at a
small size (ns=8, nv=4), as tests/test_pallas_conv_t.py runs them.

Tolerance: f32 vs f32 with the pair sums taken in another order ->
max|err| <= 1e-5 * max|ref| against the twins, 1e-4 against the Pallas
kernels (they fold the time embedding into a bias). On the CPU the public
wrappers must use the plain versions and count no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_tpu.nn import pallas_conv_t as PT
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC

NS, NV, SED, GSN = 8, 4, 16, 16
LADDER = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"
SH = "1x0e+1x1o+1x2e"
B = 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    spec = JL.make_conv_spec(LADDER, SH, LADDER, "sep").dw
    din, wn = spec.in1.dim, spec.weight_numel
    nt, nsrc = 16, 128

    def f(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    d = dict(
        spec=spec, tgt_pos=f(B, nt, 3, sc=3), src_pos=f(B, nsrc, 3, sc=6),
        tgt_x=f(B, nt, din), src_x=f(B, nsrc, din),
        tgt_mask=(rng.random((B, nt)) > 0.15).astype(np.float32),
        src_mask=(rng.random((B, nsrc)) > 0.1).astype(np.float32),
        cab=(rng.random((B, nsrc)) > 0.8).astype(np.float32), temb=f(B, SED),
        emb=mlp(SED + GSN, NS, NS), fc_al=mlp(3 * NS, 3 * NS, wn), fc_la=mlp(3 * NS, 3 * NS, wn),
        cut=np.array([6.5, 5.5], np.float32), lig_pos=f(B, nt, 3, sc=2.5),
        pair=dict(emb_w1=f(10 + SED + GSN, NS, sc=0.2), emb_b1=f(NS, sc=0.1),
                  emb_w2=f(NS, NS, sc=0.2), emb_b2=f(NS, sc=0.1),
                  fc_w1=f(3 * NS, 3 * NS, sc=0.2), fc_b1=f(3 * NS, sc=0.1),
                  fc_w2=f(3 * NS, wn, sc=0.2), fc_b2=f(wn, sc=0.1)),
    )
    bm = (rng.random((B, nt, nt)) > 0.85).astype(np.float32)
    d["bond_mask"], d["bond_feat"] = bm, f(B, nt, nt, 10) * bm[..., None]
    knn_pos = f(B, nsrc, 3, sc=2.0)
    idx, valid = TL.knn_edges(torch.from_numpy(knn_pos), torch.from_numpy(knn_pos),
                              torch.from_numpy(d["src_mask"]), torch.from_numpy(d["src_mask"]),
                              k=16, cutoff=4.0, exclude_self=True)
    d["knn_pos"], d["idx"], d["valid"] = knn_pos, idx, valid.float()
    return d


def _consts(d, stop):
    return TC.ConvConsts(TL.make_conv_spec(LADDER, SH, LADDER).dw, NS, SED, stop, GSN)


def _cross_args(d):
    c = _consts(d, 32.0)
    return (c, *[torch.from_numpy(d[k]) for k in ("lig_pos", "src_pos", "tgt_x", "src_x",
                                                 "tgt_mask", "src_mask", "cab", "temb", "cut")],
            _tt(d["emb"]), _tt(d["fc_al"]), _tt(d["fc_la"]))


def _pair_args(d):
    c = _consts(d, 5.0)
    zero = torch.zeros(B, d["tgt_x"].shape[1])
    lp, tx, tm = (torch.from_numpy(d[k]) for k in ("lig_pos", "tgt_x", "tgt_mask"))
    return (c, lp, lp, tx, tx, tm, tm, zero, zero, torch.from_numpy(d["temb"]), 5.0,
            _tt(d["pair"]), torch.from_numpy(d["bond_feat"]), torch.from_numpy(d["bond_mask"]))


def _knn_args(d):
    c = _consts(d, 4.0)
    return (c, torch.from_numpy(d["knn_pos"]), torch.from_numpy(d["src_x"]),
            torch.from_numpy(d["src_mask"]), d["idx"], d["valid"], torch.from_numpy(d["temb"]),
            {"emb": _tt(d["emb"]), "fc": _tt(d["fc_al"])})


def test_cm_converters_and_path_constants_match(system):
    spec = system["spec"]
    x = np.random.default_rng(1).normal(size=(3, spec.out.dim)).astype(np.float32)
    np.testing.assert_array_equal(TC.cm_from_irreps(spec.out, torch.from_numpy(x)).numpy(),
                                  np.asarray(PC.cm_from_irreps(spec.out, jnp.asarray(x))))
    np.testing.assert_array_equal(TC.cm_to_irreps(spec.out, torch.from_numpy(x)).numpy(),
                                  np.asarray(PC.cm_to_irreps(spec.out, jnp.asarray(x))))
    m_t, ck_t = TC._path_constants(_consts(system, 5.0).spec)
    m_j, ck_j = PC._path_constants(spec)
    assert m_t == m_j
    np.testing.assert_array_equal(ck_t, ck_j)


def test_cross_plain_matches_xla_twin(system):
    d = system
    twin = PC.make_cross_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=32.0,
                              gs_n=GSN)
    al, la = TC.cross_conv_plain(*_cross_args(d))
    for b in range(B):
        al_j, la_j = twin(d["lig_pos"][b], d["src_pos"][b], d["tgt_x"][b], d["src_x"][b],
                          d["tgt_mask"][b], d["src_mask"][b], d["cab"][b], d["temb"][b],
                          d["cut"][b], d["emb"], d["fc_al"], d["fc_la"])
        assert _rel(al[b].numpy(), al_j) <= 1e-5 and _rel(la[b].numpy(), la_j) <= 1e-5


def test_pair_plain_matches_xla_twin(system):
    d = system
    twin = PC.make_pair_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=5.0,
                             gs_n=GSN, edge_extra=10, exclude_self=True, cab_on_src=True)
    got = TC.pair_conv_plain(*_pair_args(d))
    zl = np.zeros(d["tgt_x"].shape[1], np.float32)
    for b in range(B):
        want = twin(d["lig_pos"][b], d["lig_pos"][b], d["tgt_x"][b], d["tgt_x"][b],
                    d["tgt_mask"][b], d["tgt_mask"][b], zl, zl, d["temb"][b], 5.0, d["pair"],
                    d["bond_feat"][b], d["bond_mask"][b])
        assert _rel(got[b].numpy(), want) <= 1e-5


def test_knn_plain_matches_xla_twin(system):
    d = system
    twin = PC.make_knn_twin(d["spec"], din=d["spec"].in1.dim, ns=NS, sed=SED, gs_stop=4.0,
                            gs_n=GSN, k=16)
    got = TC.knn_conv_plain(*_knn_args(d))
    for b in range(B):
        want = twin(d["knn_pos"][b], d["src_x"][b], d["src_mask"][b], d["idx"][b].numpy(),
                    d["valid"][b].numpy(), d["temb"][b], {"emb": d["emb"], "fc": d["fc_al"]})
        assert _rel(got[b].numpy(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["cross", "pair", "knn"])
def test_plain_matches_pallas_interpret(system, kind):
    d, b = system, 0
    kw = dict(din=d["spec"].in1.dim, ns=NS, sed=SED, gs_n=GSN, interpret=True)
    if kind == "cross":
        conv = PT.make_cross_conv_t(d["spec"], gs_stop=32.0, **kw)
        want = conv(d["lig_pos"][b], d["src_pos"][b], d["tgt_x"][b], d["src_x"][b],
                    d["tgt_mask"][b], d["src_mask"][b], d["cab"][b], d["temb"][b], d["cut"][b],
                    d["emb"], d["fc_al"], d["fc_la"])
        got = [g[b].numpy() for g in TC.cross_conv_plain(*_cross_args(d))]
    elif kind == "pair":
        conv = PT.make_pair_conv_t(d["spec"], gs_stop=5.0, edge_extra=10, exclude_self=True,
                                   cab_on_src=True, **kw)
        zl = np.zeros(d["tgt_x"].shape[1], np.float32)
        want = [conv(d["lig_pos"][b], d["lig_pos"][b], d["tgt_x"][b], d["tgt_x"][b],
                     d["tgt_mask"][b], d["tgt_mask"][b], zl, zl, d["temb"][b], 5.0,
                     d["pair"], d["bond_feat"][b], d["bond_mask"][b])]
        got = [TC.pair_conv_plain(*_pair_args(d))[b].numpy()]
    else:
        conv = PT.make_knn_conv_t(d["spec"], gs_stop=4.0, k=16, **kw)
        want = [conv(d["knn_pos"][b], d["src_x"][b], d["src_mask"][b], d["idx"][b].numpy(),
                     d["valid"][b].numpy(), d["temb"][b], {"emb": d["emb"], "fc": d["fc_al"]})]
        got = [TC.knn_conv_plain(*_knn_args(d))[b].numpy()]
    for g, w in zip(got, want):
        assert _rel(g, np.asarray(w)) <= 1e-4


def test_wrappers_use_plain_versions_on_cpu(system):
    d = system
    TC.reset_launches()
    al, la = TC.cross_conv(*_cross_args(d))
    al0, la0 = TC.cross_conv_plain(*_cross_args(d))
    assert torch.equal(al, al0) and torch.equal(la, la0)
    assert torch.equal(TC.pair_conv(*_pair_args(d)), TC.pair_conv_plain(*_pair_args(d)))
    assert torch.equal(TC.knn_conv(*_knn_args(d)), TC.knn_conv_plain(*_knn_args(d)))
    assert TC.launches == {"cross_conv": 0, "pair_conv": 0, "knn_conv": 0,
                           "cross_bwd": 0, "pair_bwd": 0, "knn_bwd": 0,
                           "cross_conv_fin": 0, "pair_conv_fin": 0, "knn_conv_fin": 0,
                           "layer_conv": 0, "cross_conv_bf16": 0, "pair_conv_bf16": 0,
                           "knn_conv_bf16": 0}


def test_kernel_tables_describe_every_output_column(system):
    c = _consts(system, 5.0)
    ck, meta = c.tables
    spec = c.spec
    assert meta.shape == (spec.out.dim, 8) and ck.shape[0] == 9
    # each output column maps into the input, weight and cb ranges
    assert (meta[:, 0] + (meta[:, 2] - 1) * meta[:, 1] < spec.in1.dim).all()
    assert (meta[:, 3] < spec.weight_numel).all()
    assert (meta[:, 4] + (meta[:, 2] - 1) * meta[:, 5] < ck.shape[1]).all()
