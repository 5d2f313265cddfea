"""B6 (csrc/knn_bwd.cu) and B10 (csrc/layer_conv.cu over conv_fwd_wide.cuh),
the wide-tile redesigns, on the card: B6 against autograd through the plain
knn conv at a ragged pair count (not a multiple of the 64-pair tile), with
no valid slot, bit-identical over two calls and under CUDA-graph capture (it
reads nothing to the host); B10 against layer_conv_plain with a sample that
has no cross pair, at the kernel's row groups and with one row per block,
and its per-block cycle counts. Marked `cuda`: skipped (with a reason)
where no GPU is present. Imports no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: f32 sums in another order, max|err| <= 1e-4 * max|ref| forward;
every gradient max|err| <= 5e-4 * max|ref|, where the plain version may take
the kernel's decision at a ReLU pre-activation within f32 rounding of 0 and
nowhere else (nn/relu_ties.py).
"""
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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _knn_system(dev, bsz=3, n=301, seed=0, empty=()):
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(LADDER, "1x0e+1x1o+1x2e", LADDER)
    c = TC.ConvConsts(cs.dw, NS, SED, 4.0, GSN)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    pos = f(bsz, n, 3, sc=2.5)
    mask = torch.tensor(rng.random((bsz, n)) > 0.1, dtype=torch.float32, device=dev)
    for b in empty:
        mask[b] = 0
    idx, valid = L.knn_edges(pos, pos, mask, mask, k=16, cutoff=4.0, exclude_self=True)
    x = f(bsz, n, c.din).requires_grad_(True)
    p = {"emb": mlp(SED + GSN, NS, NS), "fc": mlp(3 * NS, 3 * NS, cs.dw.weight_numel)}
    p = {m: {l: {q: v.requires_grad_(True) for q, v in d.items()} for l, d in mp.items()}
         for m, mp in p.items()}
    leaves = [x] + [p[m][l][q] for m in ("emb", "fc") for l in ("l1", "l2") for q in ("w", "b")]
    return (c, pos, x, mask, idx, valid.float(), f(bsz, SED), p), leaves


@pytest.mark.cuda
def test_knn_backward_ragged_pair_count_is_deterministic(dev):
    args, leaves = _knn_system(dev)
    out = TC.knn_conv(*args)
    g = torch.randn_like(out)
    before = TC.launches["knn_bwd"]
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    again = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert TC.launches["knn_bwd"] == before + 2
    pairs = int((args[5] > 0).sum())
    assert int(TC.knn_bwd_stats["count"]) == pairs and pairs % TC.WIDE_TILE
    assert TC.knn_bwd_stats["slots"] == args[4].numel() > pairs
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    raw, final, flips = ReluTies(TC.knn_conv_plain, args, leaves, [g]).check(got, 5e-4)
    assert max(final) <= 5e-4, (raw, final, flips)


@pytest.mark.cuda
def test_knn_backward_without_valid_slot(dev):
    """Every atom masked: no neighbour slot is valid, every gradient exactly 0."""
    args, leaves = _knn_system(dev, bsz=2, n=80, seed=1, empty=(0, 1))
    out = TC.knn_conv(*args)
    got = torch.autograd.grad(out, leaves, torch.randn_like(out), allow_unused=True)
    torch.cuda.synchronize()
    assert int(TC.knn_bwd_stats["count"]) == 0
    assert all(g is None or not bool(g.abs().max()) for g in got)


@pytest.mark.cuda
def test_knn_backward_is_captured_by_a_cuda_graph(dev):
    """B6 reads nothing to the host: a CUDA graph captures a call, and its
    replay gives the eager call's bits."""
    args, _ = _knn_system(dev, bsz=2, n=200, seed=2)
    c, pos, x, mask, idx, valid, temb, p = args
    data, x1, w_in, beff, *w = (v.detach() if torch.is_tensor(v) else v
                                for v in TC._knn_inputs(c, pos, x, idx, valid, temb, p))
    g = torch.randn(x1.shape[0], x1.shape[1], c.dout, device=dev)
    eager = TC.knn_bwd(data, x1, w_in, beff, w, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TC.knn_bwd(data, x1, w_in, beff, w, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = TC.knn_bwd(data, x1, w_in, beff, w, g)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0])
    assert all(torch.equal(captured[1][k], eager[1][k]) for k in eager[1])


def _layer_system(dev, na=300, seed=4):
    """One small trunk layer (out_dim > din): the arguments of layer_conv;
    sample 1's ligand lies far from every atom and has no CA/CB flag, so it
    has no cross pair; a masked ligand row in sample 0."""
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
    lig_pos[1] += 200.0
    lig_mask = torch.tensor(rng.random((bsz, nl)) > 0.1, dtype=torch.float32, device=dev)
    atm_mask = torch.tensor(rng.random((bsz, na)) > 0.1, dtype=torch.float32, device=dev)
    lig_mask[0, 3] = 0.0
    cab = torch.tensor(rng.random((bsz, na)) > 0.85, dtype=torch.float32, device=dev)
    cab[1] = 0.0
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
        params.update({f"fc_{t}": mlp(3 * NS, 3 * NS, wn),
                       f"mix_{t}": f(cs.lin.weight_numel, sc=0.3),
                       f"ln_{t}": {"weight": 1 + 0.1 * f(nw_), "mean_shift": f(nw_, sc=0.5),
                                   "bias": 0.05 * f(cs.out.num_scalars)}})
    lc = LC.LayerConsts(cs, TC.ConvConsts(cs.dw, NS, SED, 6.0, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, 9.0, GSN),
                        TC.ConvConsts(cs.dw, NS, SED, 4.5, GSN))
    pair, cross = LC._dense_masks(lig_pos, atm_pos, lig_mask, atm_mask, cab, 6.0, cut, bm)
    assert bool(cross[0].any()) and not bool(cross[1].any())
    return [lc, lig_pos, atm_pos, f(bsz, nl, din), f(bsz, na, din), lig_mask, atm_mask, cab,
            f(bsz, SED), cut, bf, bm, idx, valid.float(), pair.float().sum(2),
            cross.float().sum(2), cross.float().sum(1), valid.float().sum(2), params]


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [None, (1, 1)])
def test_layer_kernel_with_a_sample_without_cross_pairs(dev, monkeypatch, groups):
    args = _layer_system(dev)
    if groups is not None:
        monkeypatch.setattr(LC, "row_groups", lambda ints: groups)
    g_l, g_a = groups or (LC.LIG_ROWS, LC.ATOM_ROWS)
    blocks = len(LC.layer_tile_plan(*[args[i] for i in (1, 2, 5, 6, 7)], 6.0, args[9],
                                    *[args[i] for i in (11, 12, 13)], g_l, g_a))
    cycles = torch.zeros(blocks, dtype=torch.int64, device=dev)
    before = TC.launches["layer_conv"]
    with torch.no_grad():
        lig, atm = LC.layer_conv(*args)
        lig2, atm2 = LC._layer_kernel(*args, cycles=cycles)
    torch.cuda.synchronize()
    assert TC.launches["layer_conv"] == before + 2
    assert torch.equal(lig, lig2) and torch.equal(atm, atm2)
    assert bool((cycles > 0).all())
    lig0, atm0 = LC.layer_conv_plain(*args)
    assert _rel(lig, lig0) <= 1e-4 and _rel(atm, atm0) <= 1e-4
    assert torch.allclose(lig[0, 3], lig0[0, 3], atol=1e-6)
