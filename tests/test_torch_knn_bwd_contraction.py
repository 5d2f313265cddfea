"""B6's decomposition (csrc/knn_bwd.cu over conv_bwd_wide.cuh and abt_gemm.cuh)
as plain PyTorch, against autograd through the plain knn conv and against
jax.grad of the JAX package's knn twin.

On CPU tensors trunk_convs.knn_bwd runs knn_bwd_plain, the model of what the
kernels do: one list of the valid neighbour slots in (sample, target, slot)
order with a source-major permutation, the wide pass's feature-major rows
zero-padded to the B n k slots (the kernels size everything by the slots, so
they read no count to the host), those rows contracted over every slot into
each parameter gradient with its bias rows (db1_eff per sample segment), and
per atom its target rows in list order plus its source rows in
source-major order. Held here, at the small config of the score net (ns=8,
nv=4, 2 layers):
  * to torch.autograd.grad through knn_conv_plain, every feature and
    parameter gradient within 1e-5 of max|ref|, where the plain version may
    take the model's decision at a ReLU pre-activation within f32 rounding
    of 0 (nn/relu_ties.py); with a sample without atoms, no valid slot at
    all, and every slot valid;
  * to jax.vjp of diffbindfr_tpu/nn/pallas_conv.py make_knn_twin within
    5e-4 (rtol and atol), as tests/test_torch_trunk_grads.py holds the
    plain backward;
  * the pair list against a brute-force scan, its source-major order
    against reverse_neighbours, and the zero-padded slot sizing against an
    unpadded contraction.
Torch and JAX on the CPU, one torch thread.
"""
import jax
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv as PC
from diffbindfr_torch.models import score_net as sn
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

CFG = sn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
TOL = 1e-5


def _system(layer, bsz, seed, n=70, empty=(), k=16, cutoff=4.0, spread=2.0, c=None):
    """Seeded numpy inputs of the knn conv: positions, masks (samples in
    `empty` have no atom), the neighbour list, features, time embedding and
    the two MLPs, as torch leaves (features and parameters require grad)."""
    rng = np.random.default_rng(seed)
    c = sn._kernel_consts(CFG)[layer][2] if c is None else c

    def f(*shape, sc=1.0):
        return torch.from_numpy((rng.normal(size=shape) * sc).astype(np.float32))

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.3), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.3), "b": f(o, sc=0.1)}}

    pos = f(bsz, n, 3, sc=spread)
    mask = torch.from_numpy((rng.random((bsz, n)) > 0.1).astype(np.float32))
    for b in empty:
        mask[b] = 0
    idx, valid = TL.knn_edges(pos, pos, mask, mask, k=k, cutoff=cutoff, exclude_self=True)
    leaf = lambda t: t.requires_grad_(True)  # noqa: E731
    p = {"emb": mlp(c.sed + c.gs_n, c.ns, c.ns), "fc": mlp(3 * c.ns, 3 * c.ns,
                                                           c.spec.weight_numel)}
    p = {m: {l: {q: leaf(v) for q, v in d.items()} for l, d in mp.items()} for m, mp in p.items()}
    return dict(c=c, pos=pos, x=leaf(f(bsz, n, c.din)), mask=mask, idx=idx,
                valid=valid.float(), temb=f(bsz, c.sed), p=p)


def _args(S):
    return (S["c"], S["pos"], S["x"], S["mask"], S["idx"], S["valid"], S["temb"], S["p"])


def _leaves(S):
    return [S["x"]] + [S["p"][m][l][q] for m in ("emb", "fc") for l in ("l1", "l2")
                       for q in ("w", "b")]


def _model_grads(S, g, ld=None):
    """The leaves' gradients by knn_bwd_plain (what knn_bwd runs on CPU
    tensors), mapped to the parameter tree as _KnnConvFn.backward maps the
    kernel's: through the folded edge input (_prep_edge)."""
    data, x, w_in, beff, *w = TC._knn_inputs(S["c"], S["pos"], S["x"], S["idx"], S["valid"],
                                             S["temb"], S["p"])
    plain = [t.detach() for t in w]
    if ld is None:
        d_x, gr = TC.knn_bwd(data, x.detach(), w_in.detach(), beff.detach(), plain, g)
    else:
        d_x, gr = TC.knn_bwd_plain(data, x.detach(), w_in.detach(), beff.detach(), plain, g,
                                   ld=ld)
    cot = [d_x] + [gr[k] for k in ("w_in", "beff", "w2", "b2", "wf1", "bf1", "wf2", "bf2")]
    got = torch.autograd.grad([x, w_in, beff, *w], _leaves(S), cot, allow_unused=True)
    return [torch.zeros_like(t) if v is None else v for v, t in zip(got, _leaves(S))]


CASES = {"layer0_B2": dict(layer=0, bsz=2, seed=1), "layer1_B2": dict(layer=1, bsz=2, seed=2),
         "layer1_B3_empty_sample": dict(layer=1, bsz=3, seed=3, empty=(1,)),
         "layer1_B1_no_valid_slot": dict(layer=1, bsz=1, seed=4, empty=(0,)),
         "layer0_B2_every_slot_valid": dict(layer=0, bsz=2, seed=5, n=20, k=8, cutoff=100.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_decomposition_matches_autograd_through_plain(case):
    kw = dict(CASES[case])
    S = _system(kw.pop("layer"), kw.pop("bsz"), kw.pop("seed"), **kw)
    if case.endswith("every_slot_valid"):
        S["mask"].fill_(1.0)
        S["idx"], valid = TL.knn_edges(S["pos"], S["pos"], S["mask"], S["mask"], k=8,
                                       cutoff=100.0, exclude_self=True)
        S["valid"] = valid.float()
        assert bool((S["valid"] > 0).all())
    out = TC.knn_conv_plain(*_args(S))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    before = dict(TC.launches)
    got = _model_grads(S, g)
    assert TC.launches == before  # the CPU path launches no kernel
    if not bool((S["valid"] > 0).any()):  # no valid slot: every gradient is exactly 0
        assert float(out.detach().abs().max()) == 0
        assert all(not bool(v.abs().max()) for v in got)
        return
    ties = ReluTies(TC.knn_conv_plain, _args(S), _leaves(S), [g])
    raw, final, flips = ties.check(got, TOL)
    print(case, "max|err|/max|ref|", " ".join(f"{e:.1e}" for e in raw), "ties", len(flips))
    assert max(final) <= TOL, (raw, final, flips)


def test_decomposition_matches_jax_grad_of_the_knn_twin():
    ns, nv, sed, gsn = 8, 4, 16, 16
    ladder = f"{ns}x0e+{nv}x1o+{nv}x1e+{ns}x0o"
    spec = JL.make_conv_spec(ladder, "1x0e+1x1o+1x2e", ladder, "sep").dw
    c = TC.ConvConsts(TL.make_conv_spec(ladder, "1x0e+1x1o+1x2e", ladder).dw, ns, sed, 4.0, gsn)
    S = _system(0, 2, 9, n=96, c=c)
    out = TC.knn_conv_plain(*_args(S))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    got = _model_grads(S, g)
    twin = PC.make_knn_twin(spec, din=spec.in1.dim, ns=ns, sed=sed, gs_stop=4.0, gs_n=gsn, k=16)
    npp = jax.tree.map(lambda t: t.detach().numpy(), S["p"])

    @jax.jit
    def vjp_b(pos, mask, idx, valid, temb, x, p, ct):
        return jax.vjp(lambda x_, p_: twin(pos, x_, mask, idx, valid, temb, p_), x, p)[1](ct)

    want = None
    for b in range(2):
        dx, dp = vjp_b(S["pos"][b].numpy(), S["mask"][b].numpy(), S["idx"][b].numpy(),
                       S["valid"][b].numpy(), S["temb"][b].numpy(), S["x"][b].detach().numpy(),
                       npp, g[b].numpy())
        leaves = [np.asarray(dp[m][l][q]) for m in ("emb", "fc") for l in ("l1", "l2")
                  for q in ("w", "b")]
        want = [[np.asarray(dx)], leaves] if want is None else [
            want[0] + [np.asarray(dx)], [a + v for a, v in zip(want[1], leaves)]]
    want = [np.stack(want[0])] + want[1]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=5e-4)


def test_pair_list_is_target_major_with_a_source_major_permutation():
    S = _system(1, 3, 11, empty=(2,))
    idx, valid = S["idx"], S["valid"]
    bsz, n, k = idx.shape
    pt, ps, pb, sample_off, tgt_off, src_off, perm = TC.knn_pairs_plain(idx, valid)
    want = [(b, t, int(idx[b, t, j])) for b in range(bsz) for t in range(n) for j in range(k)
            if valid[b, t, j] > 0 and 0 <= idx[b, t, j] < n]
    assert list(zip(pb.tolist(), pt.tolist(), ps.tolist())) == want and len(want) > 0
    assert sample_off.tolist() == [sum(1 for w in want if w[0] < b) for b in range(bsz + 1)]
    assert tgt_off.tolist() == [sum(1 for w in want if w[0] * n + w[1] < i)
                                for i in range(bsz * n + 1)]
    assert src_off.tolist() == [sum(1 for w in want if w[0] * n + w[2] < i)
                                for i in range(bsz * n + 1)]
    # perm walks the list source by source, list order kept within a source:
    # the entries of reverse_neighbours, in its order
    key = [(pb[i].item(), ps[i].item(), i) for i in perm.tolist()]
    assert key == sorted(key)
    _, rev_tgt, rev_src = TC.reverse_neighbours(idx.to(torch.int32), valid)
    assert pt[perm].tolist() == rev_tgt[: len(want)].tolist()
    assert ps[perm].tolist() == rev_src[: len(want)].tolist()


def test_zero_padded_slots_give_the_same_gradients():
    """The kernels contract over every slot of B n k (rounded up to a tile),
    the pairs beyond the count zero: the gradients of that padded model equal
    those of a contraction over the pairs alone."""
    S = _system(1, 2, 13)
    out = TC.knn_conv_plain(*_args(S))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    n_pairs = int(((S["valid"] > 0)).sum())
    slots = S["idx"].numel()
    assert n_pairs < slots
    padded = _model_grads(S, g)
    exact = _model_grads(S, g, ld=n_pairs)
    wide = _model_grads(S, g, ld=-(-slots // TC.WIDE_TILE) * TC.WIDE_TILE + 3 * TC.WIDE_TILE)
    for a, b, c in zip(padded, exact, wide):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-6 * scale
        assert float((c - b).abs().max()) <= 1e-6 * scale
