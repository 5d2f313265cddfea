"""B3 and B9, the f32 knn conv without and with its finalize, on the card
(csrc/knn_conv.cu: the knn grid of g_k atoms per block over
conv_fwd_wide.cuh's f32 chain; B9 finalizes each block's rows in the weight
stages): against knn_conv_plain / knn_conv_fin_plain at a ragged slot count
(no block's list a multiple of the 64-pair tile) with a sample whose atoms
are all masked (no valid slot), at the atoms per block the host picks and
at forced ones (1, 5, 32); two calls give the same bits; a CUDA graph
captures each call (it reads nothing to the host) and its replay gives the
same bits; the per-block cycle counts cover knn_tile_plan's grid; B3's
forward with B6's backward against autograd through knn_conv_plain.
Marked `cuda`: skipped (with a reason) where no GPU is present. Imports
no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_knn_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: chip_smoke.py's f32 gate, max|err| <= 1e-4 * max|ref| (f32 sums
in another order); rows without a valid slot exactly 0 (B3) or the
LayerNorm's 0e bias (B9); gradients max|err| <= 5e-4 * max|ref|, where
the plain version may take the kernel's decision at a ReLU pre-activation
within f32 rounding of 0 and nowhere else (nn/relu_ties.py).
"""
import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layers as L
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

NS, NV, SED, GSN = 8, 4, 16, 16
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
NA, B, K = 500, 3, 16
GATE = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _system(dev, seed=0):
    """(B3 args, B9 args): three samples, the third with every atom masked
    (no neighbour slot); 16-slot neighbour lists over the atoms within 4 A
    (ragged); B9's finalize with random mix and LayerNorm parameters."""
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(IN, "1x0e+1x1o+1x2e", OUT)
    c = TC.ConvConsts(cs.dw, NS, SED, 4.0, GSN)
    fin = TC.FinConsts(cs)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    pos = f(B, NA, 3, sc=5.0)
    mask = torch.tensor(rng.random((B, NA)) < 0.9, dtype=torch.float32, device=dev)
    mask[2] = 0.0
    idx, valid = L.knn_edges(pos, pos, mask, mask, k=K, cutoff=4.0, exclude_self=True)
    p = {"emb": mlp(SED + GSN, NS, NS), "fc": mlp(3 * NS, 3 * NS, c.spec.weight_numel)}
    args = (c, pos, f(B, NA, c.din), mask, idx, valid.float(), f(B, SED), p)
    ln = {"weight": 1.0 + f(fin.n_w, sc=0.1), "mean_shift": f(fin.n_w, sc=0.3),
          "bias": f(fin.n_b, sc=0.1)}
    fin_p = {**p, "mix": f(fin.spec.lin.weight_numel, sc=0.3), "ln": ln}
    return args, (c, fin, *args[1:7], fin_p)


def _picked(args, fin=None):
    c, idx = args[0], args[4]
    ints = TC._knn_ints(c, (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1]),
                        *idx.shape, False, fin)
    return TC.knn_row_groups(ints, torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("g_k", [None, 1, 5, 32])
@pytest.mark.parametrize("name", ["knn_conv", "knn_conv_fin"])
def test_knn_wide_matches_plain_ragged_and_empty(dev, name, g_k, monkeypatch):
    args, fin_args = _system(dev, seed=1)
    if g_k is not None:
        monkeypatch.setattr(TC, "knn_row_groups", lambda ints, sms: g_k)
    g = _picked(args, fin_args[1] if name == "knn_conv_fin" else None)
    per_atom = args[5].sum(-1)
    per_block = [int(per_atom[b, t0 : t0 + g].sum()) for b in range(B) for t0 in range(0, NA, g)]
    assert int(per_atom.min()) == 0 and int(per_atom[:2].max()) == K
    assert int(per_atom[2].sum()) == 0
    assert any(n % TC.WIDE_TILE for n in per_block)
    fn, plain, a = ((TC.knn_conv, TC.knn_conv_plain, args) if name == "knn_conv" else
                    (TC.knn_conv_fin, TC.knn_conv_fin_plain, fin_args))
    with torch.no_grad():
        before = TC.launches[name]
        got, again = fn(*a), fn(*a)
        torch.cuda.synchronize()
        assert TC.launches[name] == before + 2
        assert TC.knn_conv_stats[name]["atom_rows"] == g
        ref = plain(*a)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= GATE
    assert torch.equal(got, again)
    dead = per_atom == 0
    if name == "knn_conv":
        assert not bool(got[dead].any())
    else:
        fin, ln_b = fin_args[1], fin_args[8]["ln"]["bias"]
        bias = torch.zeros(fin.out_dim, device=dev)
        bias[: ln_b.shape[0]] = ln_b
        torch.testing.assert_close(got[dead], bias.expand(int(dead.sum()), -1), rtol=0,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knn_conv", "knn_conv_fin"])
def test_knn_wide_is_captured_by_a_cuda_graph(dev, name):
    args, fin_args = _system(dev, seed=2)
    fn, a = (TC.knn_conv, args) if name == "knn_conv" else (TC.knn_conv_fin, fin_args)
    with torch.no_grad():
        eager = fn(*a)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*a)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*a)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_knn_wide_block_cycles_cover_the_plan(dev):
    args, fin_args = _system(dev, seed=3)
    c, pos, x, _, idx, valid, temb, p = args
    for name in ("knn_conv", "knn_conv_fin"):
        g_k = _picked(args, fin_args[1] if name == "knn_conv_fin" else None)
        plan = TC.knn_tile_plan(idx, valid, g_k)
        assert len(plan) == B * -(-NA // g_k)
        with torch.no_grad():
            if name == "knn_conv":
                d = TC._knn_inputs(c, pos, x, idx, valid, temb, p)

                def launch(cyc):
                    st = torch.cuda.current_stream().cuda_stream
                    return TC._knn_conv_kernel(TC._library(), *d[:4], d[4:], st, cycles=cyc)
            else:
                def launch(cyc):
                    return TC._knn_fin_kernel(*fin_args, cycles=cyc)
            cycles = torch.zeros(len(plan), dtype=torch.int64, device=dev)
            launch(cycles)
            torch.cuda.synchronize()
            assert bool((cycles > 0).all())
            assert TC.knn_conv_stats[name]["atom_rows"] == g_k
            with pytest.raises(ValueError, match="cycles"):
                launch(cycles[1:])


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.cuda
def test_knn_wide_forward_with_b6_backward_matches_autograd(dev):
    args, _ = _system(dev, seed=4)
    c, pos, x0, mask, idx, valid, temb, p0 = args
    x = _leaf(x0)
    p = {k: {l: {"w": _leaf(v[l]["w"]), "b": _leaf(v[l]["b"])} for l in ("l1", "l2")}
         for k, v in p0.items()}
    a = (c, pos, x, mask, idx, valid, temb, p)
    leaves = [x] + [p[k][l][t] for k in ("emb", "fc") for l in ("l1", "l2") for t in ("w", "b")]
    before = {k: TC.launches[k] for k in ("knn_conv", "knn_bwd")}
    out = TC.knn_conv(*a)
    assert _rel(out.detach(), TC.knn_conv_plain(*a).detach()) <= GATE
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert TC.launches["knn_conv"] == before["knn_conv"] + 1
    assert TC.launches["knn_bwd"] == before["knn_bwd"] + 1
    raw, final, flips = ReluTies(TC.knn_conv_plain, a, leaves, [g]).check(got, 5e-4)
    assert max(final) <= 5e-4, (raw, final, flips)
