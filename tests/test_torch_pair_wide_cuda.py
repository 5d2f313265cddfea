"""B5 and B8 on the card, and B4 and B6 through the changed wide pass.

B5 (csrc/pair_bwd.cu: the pair list of dense_pairs.cuh, one wide-tile pass
with the bond rows, one grouped contraction, the node sums) through
pair_conv's autograd against autograd through pair_conv_plain; pair_bwd
against pair_bwd_plain on the same tensors, two calls the same bits; a
batch without any pair. B8 (csrc/pair_conv.cu pair_conv_fin_wide_kernel,
g_p ligand rows per block) against pair_conv_fin_plain at the rows the
host picks, at 1 and at the most the shared memory holds; two calls give
the same bits; a CUDA graph captures a call (it reads nothing to the host)
and its replay gives the same bits; the per-block cycles cover
pair_tile_plan's grid; a plan that does not fit is refused. B4 and B6 (the
wide pass now takes bond rows, which they do not have) against their plain
models, two calls the same bits. The small system: ns 8, nv 4, nl 60,
B = 3 (sample 2 without ligand rows), ragged lists (no block's list a
multiple of the 64-pair tile), a bond chain with bonds beyond the cutoff.
Marked `cuda`: skipped (with a reason) where no GPU is present. Imports no
JAX, so it runs on the GPU machine with

    python -m pytest tests/test_torch_pair_wide_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance: chip_smoke.py's gates. Forward f32: max|err| <= 1e-4 * max|ref|
(f32 sums in another order). Gradients: max|err| <= 5e-4 * max|ref|, where
the plain version may take the kernel's decision at a ReLU pre-activation
within f32 rounding of 0 and nowhere else (nn/relu_ties.py); the kernels
against their plain models of the same decomposition: 1e-4.
"""
import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layers as L
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

NS, NV, SED, GSN, NB = 8, 4, 16, 16, 6
IN = f"{NS}x0e+{NV}x1o"
OUT = f"{NS}x0e+{NV}x1o+{NV}x1e"
NL, B, CUT = 60, 3, 4.0
GATE, GRAD_GATE = 1e-4, 5e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _system(dev, seed=0, no_pairs=False):
    """(pair_conv args, B8 args): three samples, the third without ligand
    rows; the last 10 rows padding; a bond chain with one bond per sample
    beyond the cutoff; B8's finalize with random mix and LayerNorm
    parameters and the counts of the mask."""
    rng = np.random.default_rng(seed)
    cs = L.make_conv_spec(IN, "1x0e+1x1o+1x2e", OUT)
    c = TC.ConvConsts(cs.dw, NS, SED, CUT, GSN)
    fin = TC.FinConsts(cs)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    pos = f(B, NL, 3, sc=3.0)
    mask = torch.tensor(rng.random((B, NL)) < 0.9, dtype=torch.float32, device=dev)
    mask[:, NL - 10:] = 0.0
    mask[2] = 0.0
    if no_pairs:
        mask[:] = 0.0
    bm = torch.tensor(np.eye(NL, k=1) * (rng.random((B, NL, NL)) < 0.7), dtype=torch.float32,
                      device=dev)
    bm = ((bm + bm.transpose(1, 2)) > 0).float()
    pos[:, 2] = pos[:, 0] + torch.tensor([CUT + 1.0, 0.0, 0.0], device=dev)
    bm[:, 0, 2] = bm[:, 2, 0] = 1.0
    bf = f(B, NL, NL, NB) * bm[..., None]
    p = dict(emb_w1=f(NB + SED + GSN, NS, sc=0.2), emb_b1=f(NS, sc=0.1), emb_w2=f(NS, NS, sc=0.2),
             emb_b2=f(NS, sc=0.1), fc_w1=f(3 * NS, 3 * NS, sc=0.2), fc_b1=f(3 * NS, sc=0.1),
             fc_w2=f(3 * NS, c.spec.weight_numel, sc=0.2), fc_b2=f(c.spec.weight_numel, sc=0.1))
    zero = torch.zeros(B, NL, device=dev)
    x = f(B, NL, c.din)
    args = (c, pos, pos, x, x, mask, mask, zero, zero, f(B, SED), CUT, p, bf, bm)
    ok = TC.pair_valid(pos, pos, mask, mask, zero, TC._cutoffs(CUT, B, dev), bm)
    cnt = torch.clamp(ok.float().sum(-1), min=1.0)
    ln = {"weight": 1.0 + f(fin.n_w, sc=0.1), "mean_shift": f(fin.n_w, sc=0.3),
          "bias": f(fin.n_b, sc=0.1)}
    fin_p = {**p, "mix": f(fin.spec.lin.weight_numel, sc=0.3), "ln": ln}
    return args, (c, fin, *args[1:11], fin_p, bf, bm, cnt), ok


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.cuda
def test_pair_bwd_through_autograd_matches_the_plain_gradient(dev):
    args, _, ok = _system(dev, seed=1)
    per_block = ok.sum(-1).reshape(-1)
    assert int(ok.sum()) % TC.WIDE_TILE and int(per_block[2 * NL:].sum()) == 0
    c, tp, sp, x0, _, tm, sm, ct, cs, temb, cut, p0, bf, bm = args
    x = _leaf(x0)
    p = {k: _leaf(v) for k, v in p0.items()}
    a = (c, tp, sp, x, x, tm, sm, ct, cs, temb, cut, p, bf, bm)
    leaves = [x, *p.values()]
    before = {k: TC.launches[k] for k in ("pair_conv", "pair_bwd")}
    out = TC.pair_conv(*a)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert TC.launches["pair_conv"] == before["pair_conv"] + 1
    assert TC.launches["pair_bwd"] == before["pair_bwd"] + 1
    assert TC.pair_bwd_stats["pairs"] == int(ok.sum())
    assert TC.pair_bwd_stats["tiles"] == -(-int(ok.sum()) // TC.WIDE_TILE)
    raw, final, flips = ReluTies(TC.pair_conv_plain, a, leaves, [g]).check(got, GRAD_GATE)
    assert max(final) <= GRAD_GATE, (raw, final, flips)
    assert not bool(got[0][2].any())  # the sample without ligand rows


@pytest.mark.cuda
@pytest.mark.parametrize("no_pairs", [False, True], ids=["ragged", "no_pair"])
def test_pair_bwd_matches_its_plain_model_and_repeats_its_bits(dev, no_pairs):
    args, _, ok = _system(dev, seed=2, no_pairs=no_pairs)
    c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
    data, x1, x2, w_in, beff, *w = TC._pair_inputs(c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p,
                                                   bf, bm)
    g = torch.randn(B, NL, c.dout, device=dev)
    one = TC.pair_bwd(data, x1, x2, w_in, beff, w, g)
    two = TC.pair_bwd(data, x1, x2, w_in, beff, w, g)
    ref = TC.pair_bwd_plain(data, x1, x2, w_in, beff, w, g)
    torch.cuda.synchronize()

    def flat(r):
        return [r[0], r[1]] + [r[2][k] for k in sorted(r[2])]

    assert all(torch.equal(u, v) for u, v in zip(flat(one), flat(two)))
    assert TC.pair_bwd_stats["pairs"] == int(ok.sum())
    if no_pairs:
        assert all(not bool(u.any()) for u in flat(one))
        return
    for u, v in zip(flat(one), flat(ref)):
        assert bool(torch.isfinite(u).all()) and _rel(u, v) <= GATE


def _largest_rows(fin_args):
    """The most rows whose plan fits the shared memory (more than the
    sample's NL rows at these widths: one block per sample, the plan near
    the card's limit)."""
    c, fin, nb = fin_args[0], fin_args[1], fin_args[13].shape[-1]
    dims = (NS, 3 * NS, c.spec.weight_numel, c.tables[0].shape[1])
    ints = TC._pair_ints(c, dims, B, NL, NL, nb, fin)
    g = 1
    while TC.pair_plan_words(ints, g + 1) <= TC.SMEM_WORDS:
        g += 1
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("g_p", [None, 1, "largest"])
def test_pair_fin_wide_matches_plain(dev, g_p, monkeypatch):
    _, fin_args, ok = _system(dev, seed=3)
    if g_p is not None:
        g = _largest_rows(fin_args) if g_p == "largest" else g_p
        monkeypatch.setattr(TC, "pair_row_groups", lambda ints, sms: g)
    with torch.no_grad():
        before = TC.launches["pair_conv_fin"]
        got, again = TC.pair_conv_fin(*fin_args), TC.pair_conv_fin(*fin_args)
        torch.cuda.synchronize()
        assert TC.launches["pair_conv_fin"] == before + 2
        rows = TC.pair_conv_stats["pair_conv_fin"]["lig_rows"]
        if g_p is not None:
            assert rows == g
        ref = TC.pair_conv_fin_plain(*fin_args)
    per_block = [int(ok[b, t0 : t0 + rows].sum()) for b in range(B) for t0 in range(0, NL, rows)]
    assert any(n % TC.WIDE_TILE for n in per_block)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= GATE
    assert torch.equal(got, again)
    fin, ln_b = fin_args[1], fin_args[12]["ln"]["bias"]
    bias = torch.zeros(fin.out_dim, device=dev)
    bias[: ln_b.shape[0]] = ln_b
    dead = ok.sum(-1) == 0
    torch.testing.assert_close(got[dead], bias.expand(int(dead.sum()), -1), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_pair_fin_wide_is_captured_by_a_cuda_graph(dev):
    _, fin_args, _ = _system(dev, seed=4)
    with torch.no_grad():
        eager = TC.pair_conv_fin(*fin_args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TC.pair_conv_fin(*fin_args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = TC.pair_conv_fin(*fin_args)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_pair_fin_block_cycles_cover_the_plan(dev):
    _, fin_args, _ = _system(dev, seed=5)
    with torch.no_grad():
        TC.pair_conv_fin(*fin_args)
        g_p = TC.pair_conv_stats["pair_conv_fin"]["lig_rows"]
        c, fin, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm, cnt = fin_args
        plan = TC.pair_tile_plan(tp, sp, tm, sm, cs, cut, bm, g_p)
        assert len(plan) == B * -(-NL // g_p)
        cycles = torch.zeros(len(plan), dtype=torch.int64, device=dev)
        TC._pair_fin_kernel(*fin_args, cycles=cycles)
        torch.cuda.synchronize()
        assert bool((cycles > 0).all())
        with pytest.raises(ValueError, match="cycles"):
            TC._pair_fin_kernel(*fin_args, cycles=cycles[1:])


@pytest.mark.cuda
def test_pair_fin_plan_that_does_not_fit_is_refused(dev, monkeypatch):
    _, fin_args, _ = _system(dev, seed=6)
    too_many = _largest_rows(fin_args) + 1
    monkeypatch.setattr(TC, "pair_row_groups", lambda ints, sms: too_many)
    with torch.no_grad(), pytest.raises(RuntimeError, match="pair_conv_fin"):
        TC._pair_fin_kernel(*fin_args)


def _flat(r):
    out = []
    for v in r:
        out += [v[k] for k in sorted(v)] if isinstance(v, dict) else [v]
    return out


@pytest.mark.cuda
def test_b4_and_b6_on_the_changed_pass_match_their_plain_models(dev):
    """B4 and B6 pass nb = 0 to the wide pass that now also reads bond rows:
    they match their plain models and give the same bits twice."""
    rng = np.random.default_rng(7)
    cs = L.make_conv_spec(IN, "1x0e+1x1o+1x2e", OUT)
    c = TC.ConvConsts(cs.dw, NS, SED, 5.0, GSN)

    def f(*shape, sc=1.0):
        return torch.tensor(rng.normal(size=shape) * sc, dtype=torch.float32, device=dev)

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.2), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.2), "b": f(o, sc=0.1)}}

    na = 300
    lig_pos, atm_pos = f(B, 24, 3, sc=3.0), f(B, na, 3, sc=6.0)
    lm = torch.ones(B, 24, device=dev)
    am = torch.tensor(rng.random((B, na)) < 0.9, dtype=torch.float32, device=dev)
    cab = torch.tensor(rng.random((B, na)) < 0.1, dtype=torch.float32, device=dev)
    wn = c.spec.weight_numel
    temb = f(B, SED)
    d = TC._cross_inputs(c, lig_pos, atm_pos, f(B, 24, c.din), f(B, na, c.din), lm, am, cab,
                         temb, torch.full((B,), 6.0, device=dev), mlp(SED + GSN, NS, NS),
                         mlp(3 * NS, 3 * NS, wn), mlp(3 * NS, 3 * NS, wn))
    g_al, g_la = torch.randn(B, 24, c.dout, device=dev), torch.randn(B, na, c.dout, device=dev)
    idx, valid = L.knn_edges(atm_pos, atm_pos, am, am, k=16, cutoff=4.0, exclude_self=True)
    k = TC._knn_inputs(c, atm_pos, f(B, na, c.din), idx, valid.float(), temb,
                       {"emb": mlp(SED + GSN, NS, NS), "fc": mlp(3 * NS, 3 * NS, wn)})
    g = torch.randn(B, na, c.dout, device=dev)
    runs = {"cross_bwd": (lambda: TC.cross_bwd(d[0], *d[1:5], d[5:], g_al, g_la),
                          lambda: TC.cross_bwd_plain(d[0], *d[1:5], d[5:], g_al, g_la)),
            "knn_bwd": (lambda: TC.knn_bwd(k[0], *k[1:4], k[4:], g),
                        lambda: TC.knn_bwd_plain(k[0], *k[1:4], k[4:], g))}
    for name, (kernel, plain) in runs.items():
        one, two, ref = _flat(kernel()), _flat(kernel()), _flat(plain())
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(one, two)), name
        for u, v in zip(one, ref):
            assert bool(torch.isfinite(u).all()) and _rel(u, v) <= GATE, name
