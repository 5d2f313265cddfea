"""B1 and B7, the dual cross conv without and with its finalize, on the card
(csrc/cross_conv.cu over conv_fwd_wide.cuh: one wide-tile grid, al blocks
then la blocks): against cross_conv_plain / cross_conv_fin_plain at ragged
pair counts (no block's list a multiple of the 64-pair tile), with a sample
that has no cross pair and a sample whose ligand is all masked, at the row
groups cross_row_groups picks and at others; two calls give the same bits;
a CUDA graph captures B1 (it reads nothing to the host); the per-block
cycle counts cover the grid of cross_tile_plan; the kernel path refuses
position gradients. Marked `cuda`: skipped (with a reason) where no GPU is
present. Imports no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_cross_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: f32 sums in another order, max|err| <= 1e-4 * max|ref|; rows
without a pair exactly 0 (B1) or exactly the plain finalize of a zero sum
(B7: the LayerNorm's 0e bias).
"""
import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layers as L
from diffbindfr_torch.nn import trunk_convs as TC

NS, NV, SED, GSN = 8, 4, 16, 16
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
NL, NA, B = 40, 500, 3
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _system(dev, seed=0):
    """(B1 args, B7 args): sample 0 ordinary, sample 1 with its ligand far
    from every atom and no CA/CB atom (no cross pair), sample 2 with every
    ligand row masked; a ladder whose out_dim > din."""
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(IN, "1x0e+1x1o+1x2e", OUT)
    c = TC.ConvConsts(cs.dw, NS, SED, 8.0, GSN)
    fin = TC.FinConsts(cs)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    def bern(p, *shape):
        return torch.tensor(rng.random(shape) < p, dtype=torch.float32, device=dev)

    lig_pos, atm_pos = f(B, NL, 3, sc=3.0), f(B, NA, 3, sc=8.0)
    lig_pos[1] += 500.0
    lig_mask, atm_mask, cab = bern(0.85, B, NL), bern(0.9, B, NA), bern(0.15, B, NA)
    cab[1] = 0.0
    lig_mask[2] = 0.0
    cut = torch.tensor([8.0, 7.0, 6.5], device=dev)
    wn = cs.dw.weight_numel
    args = (c, lig_pos, atm_pos, f(B, NL, c.din), f(B, NA, c.din), lig_mask, atm_mask, cab,
            f(B, SED), cut, mlp(SED + GSN, NS, NS), mlp(3 * NS, 3 * NS, wn),
            mlp(3 * NS, 3 * NS, wn))
    valid = TC.cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut)

    def fin_p():
        return {"mix": f(cs.lin.weight_numel, sc=0.3),
                "ln": {"weight": 1.0 + f(fin.n_w, sc=0.1), "mean_shift": f(fin.n_w, sc=0.1),
                       "bias": f(fin.n_b, sc=0.1)}}

    fin_args = (c, fin, *args[1:], fin_p(), fin_p(), valid.float().sum(2), valid.float().sum(1))
    return args, fin_args, valid


def _groups(args):
    c, lig_x, atm_x = args[0], args[3], args[4]
    ints = dict(batch=lig_x.shape[0], nl=lig_x.shape[1], na=atm_x.shape[1], din=c.din,
                dout=c.dout, ns=c.ns, he=NS, hf=3 * NS, nw=c.spec.weight_numel,
                kdim=c.tables[0].shape[1], gs_n=c.gs_n, out_dim=0, n_slots=0, mix_numel=0)
    return TC.cross_row_groups(ints, torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [None, (1, 3), (4, 32), (2, 7)])
def test_cross_wide_matches_plain_ragged_and_empty(dev, groups, monkeypatch):
    args, fin_args, valid = _system(dev)
    if groups is not None:
        monkeypatch.setattr(TC, "cross_row_groups", lambda ints, sms: groups)
    g_l, g_a = _groups(args)
    per_block = [int(valid[b, t0 : t0 + g_l].sum()) for b in range(B) for t0 in range(0, NL, g_l)]
    per_block += [int(valid[b, :, t0 : t0 + g_a].sum()) for b in range(B)
                  for t0 in range(0, NA, g_a)]
    assert any(n % TC.WIDE_TILE for n in per_block) and max(per_block) > TC.WIDE_TILE
    assert int(valid[1].sum()) == 0 and int(valid[2].sum()) == 0 and int(valid[0].sum()) > 0
    with torch.no_grad():
        before = dict(TC.launches)
        got, again = TC.cross_conv(*args), TC.cross_conv(*args)
        fin_got, fin_again = TC.cross_conv_fin(*fin_args), TC.cross_conv_fin(*fin_args)
        torch.cuda.synchronize()
        assert TC.launches["cross_conv"] == before["cross_conv"] + 2
        assert TC.launches["cross_conv_fin"] == before["cross_conv_fin"] + 2
        assert TC.cross_conv_stats["cross_conv"]["groups"] == (g_l, g_a)
        ref, fin_ref = TC.cross_conv_plain(*args), TC.cross_conv_fin_plain(*fin_args)
    for out, out2, want in ((got, again, ref), (fin_got, fin_again, fin_ref)):
        for g_, g2, r_ in zip(out, out2, want):
            assert bool(torch.isfinite(g_).all()) and _rel(g_, r_) <= TOL
            assert torch.equal(g_, g2)
    # no pair: zero sums (B1), the finalize of a zero sum (B7)
    for b in (1, 2):
        assert not bool(got[0][b].any()) and not bool(got[1][b].any())
        assert torch.equal(fin_got[0][b], fin_ref[0][b]) and torch.equal(fin_got[1][b],
                                                                          fin_ref[1][b])


@pytest.mark.cuda
def test_cross_wide_is_captured_by_a_cuda_graph(dev):
    args, _, _ = _system(dev, seed=1)
    with torch.no_grad():
        eager = TC.cross_conv(*args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TC.cross_conv(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = TC.cross_conv(*args)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.cuda
def test_cross_wide_block_cycles_cover_the_plan(dev):
    args, fin_args, _ = _system(dev, seed=2)
    g_l, g_a = _groups(args)
    c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cab, _, cut = args[:10]
    plan = TC.cross_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut, g_l, g_a)
    assert len(plan) == B * (-(-NL // g_l) + -(-NA // g_a))
    with torch.no_grad():
        d = TC._cross_inputs(*args)
        st = torch.cuda.current_stream().cuda_stream
        for launch in (lambda cyc: TC._cross_conv_kernel(TC._library(), *d[:5], d[5:], st,
                                                         cycles=cyc),
                       lambda cyc: TC._cross_fin_kernel(*fin_args, cycles=cyc)):
            cycles = torch.zeros(len(plan), dtype=torch.int64, device=dev)
            launch(cycles)
            torch.cuda.synchronize()
            assert bool((cycles > 0).all())
            with pytest.raises(ValueError, match="cycles"):
                launch(cycles[1:])


@pytest.mark.cuda
def test_cross_wide_refuses_position_gradients(dev):
    args, _, _ = _system(dev, seed=3)
    for i in (1, 2, 8, 9):  # positions, time embedding, cutoff
        a = list(args)
        a[i] = a[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="plain"):
            TC.cross_conv(*a)
