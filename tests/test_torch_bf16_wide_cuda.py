"""B11-cross and B11-knn, the bf16-chain cross and knn convs, on the card
(csrc/cross_conv.cu: B1's one wide-tile grid, al blocks then la blocks;
csrc/knn_conv.cu: a knn grid of g_k atoms per block; both over
conv_fwd_wide.cuh's chain with the bf16 depthwise chain): against
cross_conv_plain / knn_conv_plain(bf16_chain=True) at ragged pair counts
(no block's list a multiple of the 64-pair tile), with a sample that has no
cross pair, a sample whose ligand is all masked and a sample whose atoms
are all masked (no neighbour slot), at the row groups the host picks and at
others; two calls give the same bits; a CUDA graph captures each call (it
reads nothing to the host); the per-block cycle counts cover the grids of
cross_tile_plan / knn_tile_plan. Marked `cuda`: skipped (with a reason)
where no GPU is present. Imports no JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_bf16_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: chip_smoke.py's BF16_GATE, max|err| <= 2.5e-3 * max|ref| (a TP
weight or cb entry that the kernel's and torch's f32 MLP orders put on
either side of a bf16 rounding boundary moves one term by one bf16 unit),
with the f32 plain version beyond it; rows without a pair exactly 0.
"""
import functools

import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layers as L
from diffbindfr_torch.nn import trunk_convs as TC

NS, NV, SED, GSN = 8, 4, 16, 16
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
NL, NA, B, K = 40, 500, 3, 16
GATE = 2.5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _system(dev, seed=0):
    """(cross args, knn args, valid cross pairs [B, nl, na]): sample 0
    ordinary, sample 1 with its ligand far from every atom and no CA/CB
    atom (no cross pair), sample 2 with every ligand row and every atom
    masked (no cross pair, no neighbour slot); 16-slot neighbour lists over
    the atoms within 4 A (ragged)."""
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(IN, "1x0e+1x1o+1x2e", OUT)
    c = TC.ConvConsts(cs.dw, NS, SED, 8.0, GSN)
    c_knn = TC.ConvConsts(cs.dw, NS, SED, 4.0, GSN)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    def bern(p, *shape):
        return torch.tensor(rng.random(shape) < p, dtype=torch.float32, device=dev)

    lig_pos, atm_pos = f(B, NL, 3, sc=3.0), f(B, NA, 3, sc=5.0)
    lig_pos[1] += 500.0
    lig_mask, atm_mask, cab = bern(0.85, B, NL), bern(0.9, B, NA), bern(0.15, B, NA)
    cab[1] = 0.0
    lig_mask[2] = 0.0
    atm_mask[2] = 0.0
    cut = torch.tensor([8.0, 7.0, 6.5], device=dev)
    wn = cs.dw.weight_numel
    temb, emb = f(B, SED), mlp(SED + GSN, NS, NS)
    atm_x = f(B, NA, c.din)
    args = (c, lig_pos, atm_pos, f(B, NL, c.din), atm_x, lig_mask, atm_mask, cab, temb, cut,
            emb, mlp(3 * NS, 3 * NS, wn), mlp(3 * NS, 3 * NS, wn))
    idx, valid = L.knn_edges(atm_pos, atm_pos, atm_mask, atm_mask, k=K, cutoff=4.0,
                             exclude_self=True)
    knn_args = (c_knn, atm_pos, atm_x, atm_mask, idx, valid.float(), temb,
                {"emb": mlp(SED + GSN, NS, NS), "fc": mlp(3 * NS, 3 * NS, wn)})
    return args, knn_args, TC.cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut)


def _cross_groups(args):
    c, lig_x, atm_x = args[0], args[3], args[4]
    ints = dict(batch=lig_x.shape[0], nl=lig_x.shape[1], na=atm_x.shape[1], din=c.din,
                dout=c.dout, ns=c.ns, he=NS, hf=3 * NS, nw=c.spec.weight_numel,
                kdim=c.tables[0].shape[1], gs_n=c.gs_n, out_dim=0, n_slots=0, mix_numel=0,
                bf16_chain=1)
    return TC.cross_row_groups(ints, torch.cuda.get_device_properties(0).multi_processor_count)


def _knn_groups(knn_args):
    c, idx = knn_args[0], knn_args[4]
    ints = TC._knn_ints(c, (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1]),
                        *idx.shape)
    return TC.knn_row_groups(ints, torch.cuda.get_device_properties(0).multi_processor_count)


CROSS = functools.partial(TC.cross_conv, bf16_chain=True)
KNN = functools.partial(TC.knn_conv, bf16_chain=True)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [None, (1, 3), (4, 32), (2, 7)])
def test_cross_bf16_matches_plain_ragged_and_empty(dev, groups, monkeypatch):
    args, _, valid = _system(dev)
    if groups is not None:
        monkeypatch.setattr(TC, "cross_row_groups", lambda ints, sms: groups)
    g_l, g_a = _cross_groups(args)
    per_block = [int(valid[b, t0 : t0 + g_l].sum()) for b in range(B) for t0 in range(0, NL, g_l)]
    per_block += [int(valid[b, :, t0 : t0 + g_a].sum()) for b in range(B)
                  for t0 in range(0, NA, g_a)]
    assert any(n % TC.WIDE_TILE for n in per_block) and max(per_block) > TC.WIDE_TILE
    assert int(valid[1].sum()) == 0 and int(valid[2].sum()) == 0 and int(valid[0].sum()) > 0
    with torch.no_grad():
        before = TC.launches["cross_conv_bf16"]
        got, again = CROSS(*args), CROSS(*args)
        torch.cuda.synchronize()
        assert TC.launches["cross_conv_bf16"] == before + 2
        assert TC.cross_conv_stats["cross_conv_bf16"]["groups"] == (g_l, g_a)
        ref = TC.cross_conv_plain(*args, bf16_chain=True)
        f32 = TC.cross_conv_plain(*args)
    for g_, g2, r_, c_ in zip(got, again, ref, f32):
        assert bool(torch.isfinite(g_).all()) and _rel(g_, r_) <= GATE < _rel(c_, r_)
        assert torch.equal(g_, g2)
    for b in (1, 2):
        assert not bool(got[0][b].any()) and not bool(got[1][b].any())


@pytest.mark.cuda
@pytest.mark.parametrize("g_k", [None, 1, 7, 32])
def test_knn_bf16_matches_plain_ragged_and_empty(dev, g_k, monkeypatch):
    _, knn_args, _ = _system(dev, seed=1)
    if g_k is not None:
        monkeypatch.setattr(TC, "knn_row_groups", lambda ints, sms: g_k)
    g = _knn_groups(knn_args)
    valid = knn_args[5]
    per_atom = valid.sum(-1)
    per_block = [int(per_atom[b, t0 : t0 + g].sum()) for b in range(B) for t0 in range(0, NA, g)]
    assert int(per_atom.min()) == 0 and int(per_atom[:2].max()) == K
    assert int(per_atom[2].sum()) == 0
    assert any(n % TC.WIDE_TILE for n in per_block)
    with torch.no_grad():
        before = TC.launches["knn_conv_bf16"]
        got, again = KNN(*knn_args), KNN(*knn_args)
        torch.cuda.synchronize()
        assert TC.launches["knn_conv_bf16"] == before + 2
        assert TC.knn_conv_stats["knn_conv_bf16"]["atom_rows"] == g
        ref = TC.knn_conv_plain(*knn_args, bf16_chain=True)
        f32 = TC.knn_conv_plain(*knn_args)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= GATE < _rel(f32, ref)
    assert torch.equal(got, again)
    assert not bool(got[per_atom == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cross", "knn"])
def test_bf16_wide_is_captured_by_a_cuda_graph(dev, kind):
    args, knn_args, _ = _system(dev, seed=2)
    fn, a = (CROSS, args) if kind == "cross" else (KNN, knn_args)
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
    eager, out = ((v if isinstance(v, tuple) else (v,)) for v in (eager, out))
    assert all(torch.equal(p, q) for p, q in zip(out, eager))


@pytest.mark.cuda
def test_bf16_wide_block_cycles_cover_the_plans(dev):
    args, knn_args, _ = _system(dev, seed=3)
    c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cab, _, cut = args[:10]
    g_l, g_a = _cross_groups(args)
    plan = TC.cross_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut, g_l, g_a)
    g_k = _knn_groups(knn_args)
    kc, pos, x, _, idx, valid, temb, p = knn_args
    knn_plan = TC.knn_tile_plan(idx, valid, g_k)
    assert len(knn_plan) == B * -(-NA // g_k)
    with torch.no_grad():
        d = TC._cross_inputs(*args, bf16_chain=True)
        kd = TC._knn_inputs(kc, pos, x, idx, valid, temb, p, True)
        for n, launch in ((len(plan), lambda cyc: TC._cross_conv_kernel(
                TC._library(), *d[:5], d[5:], TC._stream(), cycles=cyc)),
                          (len(knn_plan), lambda cyc: TC._knn_conv_kernel(
                              TC._library(), *kd[:4], kd[4:], TC._stream(), cycles=cyc))):
            cycles = torch.zeros(n, dtype=torch.int64, device=dev)
            launch(cycles)
            torch.cuda.synchronize()
            assert bool((cycles > 0).all())
            with pytest.raises(ValueError, match="cycles"):
                launch(cycles[1:])
