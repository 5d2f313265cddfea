"""B2 and B11-pair on the card: csrc/pair_conv.cu pair_conv_wide_kernel and
pair_conv_bf16_wide_kernel (pair_block<false, BF> on the grid of g_p ligand
rows per block that B8 runs) through pair_conv, against pair_conv_plain
(bf16_chain=True for B11-pair) on the same tensors: at the rows the host
picks, at 1 and at the most the shared memory holds; ragged rows (no
block's list a multiple of the 64-pair tile), a sample without ligand rows
and a batch without any pair (every sum exactly 0, no row left unwritten:
the output is not cleared before the launch); two calls give the same
bits, and so does the replay of a CUDA graph that captured a call (the
call reads nothing to the host); the per-block cycles cover pair_tile_plan's
grid; a plan that does not fit the shared memory is refused. The small
system is tests/test_torch_pair_wide_cuda.py's (ns 8, nv 4, nl 60, B = 3, a
bond chain with bonds beyond the cutoff). Marked `cuda`: skipped (with a
reason) where no GPU is present. Imports no JAX, so it runs on the GPU
machine with

    python -m pytest tests/test_torch_pair_sums_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: chip_smoke.py's gates, max|err| / max|ref|. B2: 1e-4 (f32 sums
in another order). B11-pair: 2.5e-3 (BF16_GATE: a TP weight or cb entry
that the kernel's and torch's f32 MLP orders put on either side of a bf16
rounding boundary moves one term by one bf16 unit), and the control, B2 on
the same inputs against the plain bf16 version, must lie beyond it.
"""
import pytest
import torch
from test_torch_pair_wide_cuda import B, NL, NS, _rel, _system, dev  # noqa: F401

from diffbindfr_torch.nn import trunk_convs as TC

GATE = {"pair_conv": 1e-4, "pair_conv_bf16": 2.5e-3}
KERNELS = list(GATE)


def _bf16(name):
    return name == "pair_conv_bf16"


def _largest_rows(args, bf16_chain):
    """The most rows whose plan fits the shared memory."""
    c, nb = args[0], args[12].shape[-1]
    dims = (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1])
    ints = TC._pair_ints(c, dims, B, NL, NL, nb, bf16_chain=bf16_chain)
    g = 1
    while TC.pair_plan_words(ints, g + 1) <= TC.SMEM_WORDS:
        g += 1
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("g_p", [None, 1, "largest"])
@pytest.mark.parametrize("name", KERNELS)
def test_pair_sums_wide_matches_plain(dev, name, g_p, monkeypatch):
    args, _, ok = _system(dev, seed=8)
    bf = _bf16(name)
    with torch.no_grad():
        # the control: B2 at the rows its rule picks
        ctl = TC.pair_conv(*args) if bf else None
    if g_p is not None:
        g = _largest_rows(args, bf) if g_p == "largest" else g_p
        monkeypatch.setattr(TC, "pair_row_groups", lambda ints, sms: g)
    with torch.no_grad():
        before = TC.launches[name]
        got, again = TC.pair_conv(*args, bf16_chain=bf), TC.pair_conv(*args, bf16_chain=bf)
        torch.cuda.synchronize()
        assert TC.launches[name] == before + 2
        rows = TC.pair_conv_stats[name]["lig_rows"]
        if g_p is not None:
            assert rows == g
        ref = TC.pair_conv_plain(*args, bf16_chain=bf)
    per_block = [int(ok[b, t0 : t0 + rows].sum()) for b in range(B) for t0 in range(0, NL, rows)]
    assert any(n % TC.WIDE_TILE for n in per_block)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= GATE[name]
    if bf:
        assert GATE[name] < _rel(ctl, ref)
    assert torch.equal(got, again)
    dead = ok.sum(-1) == 0
    assert bool(dead[2].all()) and not got[dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_pair_sums_wide_without_any_pair_writes_zeros(dev, name):
    args, _, ok = _system(dev, seed=9, no_pairs=True)
    assert not bool(ok.any())
    with torch.no_grad():
        # freed NaN memory, which the caching allocator may hand to the
        # output: NaN where a row would be left unwritten
        torch.full((B, NL, args[0].dout), float("nan"), device=dev)
        got = TC.pair_conv(*args, bf16_chain=_bf16(name))
        torch.cuda.synchronize()
    assert bool((got == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_pair_sums_wide_is_captured_by_a_cuda_graph(dev, name):
    args, _, _ = _system(dev, seed=10)
    bf = _bf16(name)
    with torch.no_grad():
        eager = TC.pair_conv(*args, bf16_chain=bf)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TC.pair_conv(*args, bf16_chain=bf)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = TC.pair_conv(*args, bf16_chain=bf)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_pair_sums_block_cycles_cover_the_plan(dev, name):
    args, _, _ = _system(dev, seed=11)
    c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
    with torch.no_grad():
        TC.pair_conv(*args, bf16_chain=_bf16(name))
        g_p = TC.pair_conv_stats[name]["lig_rows"]
        plan = TC.pair_tile_plan(tp, sp, tm, sm, cs, cut, bm, g_p)
        assert len(plan) == B * -(-NL // g_p)
        d = TC._pair_inputs(c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p, bf, bm, _bf16(name))
        cycles = torch.zeros(len(plan), dtype=torch.int64, device=dev)
        TC._pair_conv_kernel(TC._library(), *d[:5], d[5:], TC._stream(), cycles=cycles)
        torch.cuda.synchronize()
        assert bool((cycles > 0).all())
        with pytest.raises(ValueError, match="cycles"):
            TC._pair_conv_kernel(TC._library(), *d[:5], d[5:], TC._stream(), cycles=cycles[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_pair_sums_plan_that_does_not_fit_is_refused(dev, name, monkeypatch):
    args, _, _ = _system(dev, seed=12)
    too_many = _largest_rows(args, _bf16(name)) + 1
    monkeypatch.setattr(TC, "pair_row_groups", lambda ints, sms: too_many)
    before = TC.launches[name]
    with torch.no_grad(), pytest.raises(RuntimeError, match=name):
        TC.pair_conv(*args, bf16_chain=_bf16(name))
    assert TC.launches[name] == before
