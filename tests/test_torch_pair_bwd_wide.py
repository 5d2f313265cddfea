"""B5's decomposition (csrc/pair_bwd.cu over dense_pairs.cuh,
conv_bwd_wide.cuh and abt_gemm.cuh) as plain PyTorch, against autograd
through the plain pair conv and against the JAX package's hand-written
backward kernel.

On CPU tensors trunk_convs.pair_bwd runs pair_bwd_plain, the model of what
the kernels do: one list of the valid (target, source) pairs in target-major
order with a source-major permutation (bonded pairs beyond the cutoff in it,
self pairs never), the wide pass's feature-major rows with the pairs' bond
features as the edge input's extra rows, those rows contracted over the
pairs into each parameter gradient with its bias rows (db1_eff per sample
segment), d_tgt the target-scalar rows summed per target row in list order
and d_src the source rows summed per source in source-major order. Held
here, at ns=8, nv=4:
  * to torch.autograd.grad through pair_conv_plain, every feature and
    parameter gradient within 1e-5 of max|ref|, where the plain version may
    take the model's decision at a ReLU pre-activation within f32 rounding
    of 0 (nn/relu_ties.py): a ragged batch with a sample without ligand
    rows, and a batch without any pair;
  * to jax.grad through diffbindfr_tpu/nn/pallas_conv_t.py make_pair_conv_t
    (bwd="pallas": make_pair_bwd_t, in interpret mode, as
    tests/test_pallas_conv_t.py runs it) within 5e-4 (rtol and atol), as
    tests/test_torch_knn_bwd_contraction.py holds B6;
  * the pair list against a brute-force scan; wide_pass_plain without bond
    rows gives B4's rows unchanged.
Torch and JAX on the CPU, one torch thread.
"""
import jax
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn import pallas_conv_t as PT
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

NS, NV, SED, GSN, NB = 8, 4, 16, 16, 6
LADDER = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"
SH = "1x0e+1x1o+1x2e"
CUT = 4.0
TOL = 1e-5
KEYS = ("w_in", "beff", "w2", "b2", "wf1", "bf1", "wf2", "bf2")


def _system(bsz, nl, seed, empty=(), no_pairs=False):
    """Seeded numpy inputs of the pair conv in the score net's configuration
    (bond features, self pairs excluded, cab on the source side: none here):
    positions, masks (samples in `empty` have no ligand row), a bond chain
    with some bonds stretched beyond the cutoff, separate target and source
    features and the two MLPs, as torch leaves (features and parameters
    require grad). no_pairs: every row masked."""
    rng = np.random.default_rng(seed)
    c = TC.ConvConsts(TL.make_conv_spec(LADDER, SH, LADDER).dw, NS, SED, CUT, GSN)

    def f(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    pos = f(bsz, nl, 3, sc=2.5)
    mask = (rng.random((bsz, nl)) > 0.15).astype(np.float32)
    mask[:, :3] = 1.0
    for b in empty:
        mask[b] = 0.0
    if no_pairs:
        mask[:] = 0.0
    bond_mask = np.zeros((bsz, nl, nl), np.float32)
    bond_feat = np.zeros((bsz, nl, nl, NB), np.float32)
    for b in range(bsz):
        for i in range(nl - 1):
            if rng.random() < 0.6:
                bond_mask[b, i, i + 1] = bond_mask[b, i + 1, i] = 1.0
                bond_feat[b, i, i + 1] = bond_feat[b, i + 1, i] = f(NB)
        # a bond beyond the cutoff: atoms 0 and 2 moved apart
        pos[b, 2] = pos[b, 0] + np.array([CUT + 1.5, 0.0, 0.0], np.float32)
        bond_mask[b, 0, 2] = bond_mask[b, 2, 0] = 1.0
        bond_feat[b, 0, 2] = bond_feat[b, 2, 0] = f(NB)
    wn = c.spec.weight_numel
    p = dict(emb_w1=f(NB + SED + GSN, NS, sc=0.3), emb_b1=f(NS, sc=0.1), emb_w2=f(NS, NS, sc=0.3),
             emb_b2=f(NS, sc=0.1), fc_w1=f(3 * NS, 3 * NS, sc=0.3), fc_b1=f(3 * NS, sc=0.1),
             fc_w2=f(3 * NS, wn, sc=0.3), fc_b2=f(wn, sc=0.1))
    return dict(c=c, pos=pos, mask=mask, bond_feat=bond_feat, bond_mask=bond_mask,
                tx=f(bsz, nl, c.din), sx=f(bsz, nl, c.din), temb=f(bsz, SED), p=p)


def _torch(S):
    """(pair_conv_plain's arguments, the leaves: target features, source
    features, then the parameters in KEYS order of the dict)."""
    t = {k: torch.from_numpy(v) for k, v in S.items() if isinstance(v, np.ndarray)}
    tx, sx = t["tx"].requires_grad_(True), t["sx"].requires_grad_(True)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in S["p"].items()}
    zero = torch.zeros_like(t["mask"])
    args = (S["c"], t["pos"], t["pos"], tx, sx, t["mask"], t["mask"], zero, zero, t["temb"], CUT,
            p, t["bond_feat"], t["bond_mask"])
    return args, [tx, sx, *p.values()]


def _model_grads(args, g):
    """The leaves' gradients by pair_bwd_plain (what pair_bwd runs on CPU
    tensors), mapped to the parameter tree as _PairConvFn.backward maps the
    kernel's: through the folded edge input (_prep_edge)."""
    c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
    data, x1, x2, w_in, beff, *w = TC._pair_inputs(c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p,
                                                   bf, bm)
    before = dict(TC.launches)
    d_tgt, d_src, gr = TC.pair_bwd(data, x1.detach(), x2.detach(), w_in.detach(), beff.detach(),
                                   [t.detach() for t in w], g)
    assert TC.launches == before  # the CPU path launches no kernel
    assert d_tgt.shape == x1.shape and not d_tgt[..., c.ns:].any()
    leaves = [tx, sx, *p.values()]
    got = torch.autograd.grad([x1, x2, w_in, beff, *w], leaves,
                              [d_tgt, d_src] + [gr[k] for k in KEYS], allow_unused=True)
    return [torch.zeros_like(t) if v is None else v for v, t in zip(got, leaves)]


CASES = {"ragged_B3_no_ligand_in_sample_1": dict(bsz=3, nl=28, seed=1, empty=(1,)),
         "B2": dict(bsz=2, nl=20, seed=2),
         "B2_no_pair": dict(bsz=2, nl=12, seed=3, no_pairs=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_decomposition_matches_autograd_through_plain(case):
    args, leaves = _torch(_system(**CASES[case]))
    out = TC.pair_conv_plain(*args)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    got = _model_grads(args, g)
    if case.endswith("no_pair"):  # no valid pair: every gradient is exactly 0
        assert not bool(out.detach().any()) and all(not bool(v.any()) for v in got)
        return
    ties = ReluTies(TC.pair_conv_plain, args, leaves, [g])
    raw, final, flips = ties.check(got, TOL)
    print(case, "max|err|/max|ref|", " ".join(f"{e:.1e}" for e in raw), "ties", len(flips))
    assert max(final) <= TOL, (raw, final, flips)
    if case.startswith("ragged"):  # the sample without ligand rows: no feature gradient
        assert not bool(got[0][1].any()) and not bool(got[1][1].any())


def test_decomposition_matches_jax_make_pair_bwd_t():
    S = _system(2, 20, 9)
    args, _ = _torch(S)
    out = TC.pair_conv_plain(*args)
    g = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    got = _model_grads(args, torch.from_numpy(g))
    spec = JL.make_conv_spec(LADDER, SH, LADDER, "sep").dw
    conv = PT.make_pair_conv_t(spec, din=spec.in1.dim, ns=NS, sed=SED, gs_stop=CUT, gs_n=GSN,
                               edge_extra=NB, exclude_self=True, cab_on_src=True, interpret=True,
                               bwd="pallas")
    zl = np.zeros(S["mask"].shape[1], np.float32)

    @jax.jit
    def grads(pos, mask, temb, bf, bm, tx, sx, p, ct):
        def loss(tx_, sx_, p_):
            o = conv(pos, pos, tx_, sx_, mask, mask, zl, zl, temb, CUT, p_, bf, bm)
            return (o * ct).sum()

        return jax.grad(loss, argnums=(0, 1, 2))(tx, sx, p)

    d_tgt, d_src, d_p = [], [], None
    for b in range(2):
        dt, ds, dp = grads(*(S[k][b] for k in ("pos", "mask", "temb", "bond_feat", "bond_mask",
                                                "tx", "sx")), S["p"], g[b])
        d_tgt.append(np.asarray(dt))
        d_src.append(np.asarray(ds))
        dp = [np.asarray(dp[k]) for k in S["p"]]
        d_p = dp if d_p is None else [u + v for u, v in zip(d_p, dp)]
    for a, b in zip(got, [np.stack(d_tgt), np.stack(d_src)] + d_p):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=5e-4)


def test_pair_list_is_target_major_with_a_source_major_permutation():
    S = _system(3, 28, 11, empty=(2,))
    t = {k: torch.from_numpy(S[k]) for k in ("pos", "mask", "bond_mask")}
    bsz, nl = S["mask"].shape
    cut = torch.full((bsz,), CUT)
    pt, ps, pb, sample_off, tgt_off, src_off, perm = TC.pair_pairs_plain(
        t["pos"], t["pos"], t["mask"], t["mask"], torch.zeros(bsz, nl), cut, t["bond_mask"])
    d = np.sqrt(((S["pos"][:, None, :, :] - S["pos"][:, :, None, :]) ** 2).sum(-1) + 1e-12)
    want = [(b, i, j) for b in range(bsz) for i in range(nl) for j in range(nl)
            if S["mask"][b, i] > 0 and S["mask"][b, j] > 0
            and ((d[b, i, j] <= CUT and i != j) or S["bond_mask"][b, i, j] > 0)]
    assert list(zip(pb.tolist(), pt.tolist(), ps.tolist())) == want and len(want) > 0
    assert sample_off.tolist() == [sum(1 for w in want if w[0] < b) for b in range(bsz + 1)]
    assert tgt_off.tolist() == [sum(1 for w in want if w[0] * nl + w[1] < i)
                                for i in range(bsz * nl + 1)]
    assert src_off.tolist() == [sum(1 for w in want if w[0] * nl + w[2] < i)
                                for i in range(bsz * nl + 1)]
    # perm walks the list source by source, list order kept within a source
    key = [(pb[i].item(), ps[i].item(), i) for i in perm.tolist()]
    assert key == sorted(key)


def test_bonded_pairs_beyond_the_cutoff_are_listed_and_self_pairs_are_not():
    S = _system(2, 20, 13)
    t = {k: torch.from_numpy(S[k]) for k in ("pos", "mask", "bond_mask")}
    bsz, nl = S["mask"].shape
    pt, ps, pb, *_ = TC.pair_pairs_plain(t["pos"], t["pos"], t["mask"], t["mask"],
                                         torch.zeros(bsz, nl), torch.full((bsz,), CUT),
                                         t["bond_mask"])
    listed = set(zip(pb.tolist(), pt.tolist(), ps.tolist()))
    assert not any(i == j for _, i, j in listed)
    far = [(b, i, j) for b in range(bsz) for i in range(nl) for j in range(nl)
           if S["bond_mask"][b, i, j] > 0 and S["mask"][b, i] > 0 and S["mask"][b, j] > 0
           and np.linalg.norm(S["pos"][b, i] - S["pos"][b, j]) > CUT]
    assert len(far) >= 2 * bsz and set(far) <= listed
    # a listed bonded pair beyond the cutoff reaches the gradients: its bond
    # features' edge-MLP rows carry gradient
    args, _ = _torch(S)
    g = torch.randn(bsz, nl, S["c"].dout, generator=torch.Generator().manual_seed(5))
    c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
    data, x1, x2, w_in, beff, *w = TC._pair_inputs(c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p,
                                                   bf, bm)
    gr = TC.pair_bwd_plain(data, x1.detach(), x2.detach(), w_in.detach(), beff.detach(),
                           [v.detach() for v in w], g)[2]
    assert gr["w_in"].shape == (GSN + NB, NS) and bool(gr["w_in"][GSN:].abs().max() > 0)


def test_wide_pass_without_bond_rows_gives_b4s_rows():
    """B4 and B6 run the pass without bond rows: the edge input is the
    Gaussian rows alone, and an empty extra block changes no row's bits."""
    S = _system(2, 20, 17)
    c = S["c"]
    t = {k: torch.from_numpy(S[k]) for k in ("pos", "mask", "bond_mask", "tx", "sx")}
    bsz, nl = S["mask"].shape
    pt, ps, pb, *_ = TC.pair_pairs_plain(t["pos"], t["pos"], t["mask"], t["mask"],
                                         torch.zeros(bsz, nl), torch.full((bsz,), CUT),
                                         t["bond_mask"])
    vec = t["pos"][pb, ps] - t["pos"][pb, pt]
    rng = np.random.default_rng(2)
    w = [torch.from_numpy((rng.normal(size=s) * 0.3).astype(np.float32)) for s in (
        (GSN, NS), (bsz, NS), (NS, NS), (NS,), (3 * NS, 3 * NS), (3 * NS,),
        (3 * NS, c.spec.weight_numel), (c.spec.weight_numel,))]
    g = torch.from_numpy(rng.normal(size=(bsz, nl, c.dout)).astype(np.float32))
    pairs = (pt, ps, pb)
    plain = TC.wide_pass_plain(c, pairs, vec, t["tx"], t["sx"], g, *w)
    empty = TC.wide_pass_plain(c, pairs, vec, t["tx"], t["sx"], g, *w,
                               extra=torch.zeros(len(pt), 0))
    assert all(torch.equal(plain[0][k], empty[0][k]) for k in plain[0])
    assert torch.equal(plain[1], empty[1]) and torch.equal(plain[2], empty[2])
    assert torch.equal(plain[0]["in"], TC._gauss(c, TC._dist(vec)).t())
