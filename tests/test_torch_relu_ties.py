"""The tie-aware gradient check of the backward kernels (nn/relu_ties.py).

chip_smoke.py and tests/test_torch_kernels_cuda.py hold every gradient of
B4-B6 to 5e-4 max|ref| of autograd through the plain version, except where
a ReLU pre-activation lies within f32 rounding of 0 and the kernel took the
other decision there. Here, on CPU tensors at ns=8, nv=4, the "kernel"
gradients are made from the plain version: a tie planted by shifting one
hidden unit's bias so that one pair's pre-activation is 0 and then decided
the other way must pass, with that (pair, unit) reported; a flipped unit
that is not a tie, a wrong bias gradient, a zeroed node row, a perturbed
weight column, and a planted tie together with a wrong bias must fail.
"""
import numpy as np
import pytest
import torch

from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.nn.relu_ties import ReluTies

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

NS, NV, SED, GSN = 8, 4, 16, 16
LADDER = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"
TOL = 5e-4
# MLP role of each conv whose ReLU the tie is planted in (0 is the edge MLP)
TIE_ROLE = {"cross": 2, "pair": 1, "knn": 1}


def _system(conv, bias_shift=None):
    """(plain fn, args, leaves, leaf names, cotangents); `bias_shift` =
    (role, unit, value) is subtracted from that MLP's first bias."""
    rng = np.random.default_rng(0)
    spec = TL.make_conv_spec(LADDER, "1x0e+1x1o+1x2e", LADDER).dw
    din, wn = spec.in1.dim, spec.weight_numel

    def f(*shape, sc=1.0):
        return torch.tensor((rng.normal(size=shape) * sc).astype(np.float32))

    def bern(p, *shape):
        return torch.tensor((rng.random(shape) > p).astype(np.float32))

    def mlp(i, h, o):
        return {"l1": {"w": f(i, h, sc=0.3), "b": f(h, sc=0.1)},
                "l2": {"w": f(h, o, sc=0.3), "b": f(o, sc=0.1)}}

    bsz, nl, na = 2, 12, 80
    lig_pos, atm_pos = f(bsz, nl, 3, sc=2.5), f(bsz, na, 3, sc=5.0)
    lig_x, atm_x = f(bsz, nl, din), f(bsz, na, din)
    lig_mask, atm_mask, cab = bern(0.15, bsz, nl), bern(0.1, bsz, na), bern(0.8, bsz, na)
    temb = f(bsz, SED)
    mlps = [mlp(SED + GSN + (10 if conv == "pair" else 0), NS, NS), mlp(3 * NS, 3 * NS, wn),
            mlp(3 * NS, 3 * NS, wn)]
    if bias_shift is not None:
        role, unit, value = bias_shift
        mlps[role]["l1"]["b"][unit] -= value
    names, leaves = [], []

    def leaf(t, name):
        t = t.clone().requires_grad_(True)
        names.append(name)
        leaves.append(t)
        return t

    def tree(m, name):
        return {k: {q: leaf(v[q], f"{name}/{k}/{q}") for q in ("w", "b")} for k, v in m.items()}

    if conv == "cross":
        c = TC.ConvConsts(spec, NS, SED, 32.0, GSN)
        lx, ax = leaf(lig_x, "lig_x"), leaf(atm_x, "atm_x")
        emb, fal, fla = tree(mlps[0], "emb"), tree(mlps[1], "fc_al"), tree(mlps[2], "fc_la")
        args = (c, lig_pos, atm_pos, lx, ax, lig_mask, atm_mask, cab, temb,
                torch.tensor([6.0, 5.5]), emb, fal, fla)
        fn = TC.cross_conv_plain
    elif conv == "pair":
        c = TC.ConvConsts(spec, NS, SED, 5.0, GSN)
        bm = bern(0.8, bsz, nl, nl)
        x = leaf(lig_x, "x")
        emb, fc = tree(mlps[0], "emb"), tree(mlps[1], "fc")
        p = {"emb_w1": emb["l1"]["w"], "emb_b1": emb["l1"]["b"], "emb_w2": emb["l2"]["w"],
             "emb_b2": emb["l2"]["b"], "fc_w1": fc["l1"]["w"], "fc_b1": fc["l1"]["b"],
             "fc_w2": fc["l2"]["w"], "fc_b2": fc["l2"]["b"]}
        zero = torch.zeros(bsz, nl)
        args = (c, lig_pos, lig_pos, x, x, lig_mask, lig_mask, zero, zero, temb, 5.0, p,
                f(bsz, nl, nl, 10) * bm[..., None], bm)
        fn = TC.pair_conv_plain
    else:
        c = TC.ConvConsts(spec, NS, SED, 4.0, GSN)
        pos = f(bsz, na, 3, sc=2.0)
        idx, valid = TL.knn_edges(pos, pos, atm_mask, atm_mask, k=16, cutoff=4.0,
                                  exclude_self=True)
        x = leaf(atm_x, "x")
        args = (c, pos, x, atm_mask, idx, valid.float(), temb,
                {"emb": tree(mlps[0], "emb"), "fc": tree(mlps[1], "fc")})
        fn = TC.knn_conv_plain
    out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(1)
    gs = [torch.randn(o.shape, generator=gen) for o in out]
    return fn, args, leaves, names, gs


def _strongest_unit(ties, role, seed=2, tries=24):
    """(call, flat) of the sampled position in the MLPs of `role` whose
    decision flipped moves the gradients most, and that move."""
    gen = torch.Generator().manual_seed(seed)
    best = None
    for call, c in enumerate(ties.calls):
        if c["role"] != role:
            continue
        for flat in torch.randint(0, c["z"].numel(), (tries,), generator=gen).tolist():
            effect = max(ties.errors(ties.grads([(call, flat)])))
            if best is None or effect > best[0]:
                best = (effect, call, flat)
    return best


@pytest.fixture(scope="module", params=["cross", "pair", "knn"])
def planted(request):
    """A conv, a (pair, unit) whose decision moves the gradients by far more
    than TOL, and the same system with that pre-activation shifted to 0."""
    conv = request.param
    fn, args, leaves, names, gs = _system(conv)
    ties = ReluTies(fn, args, leaves, gs)
    effect, call, flat = _strongest_unit(ties, TIE_ROLE[conv])
    c = ties.calls[call]
    unit, z = flat % c["shape"][-1], float(c["z"].reshape(-1)[flat])
    fn, args, leaves, names, gs = _system(conv, (TIE_ROLE[conv], unit, z))
    tied = ReluTies(fn, args, leaves, gs)
    return dict(conv=conv, ties=ties, tied=tied, call=call, flat=flat, effect=effect,
                names=names, where=ties.describe(call, flat))


def test_plain_gradients_pass_without_flips(planted):
    ties = planted["ties"]
    raw, final, flips = ties.check(list(ties.ref), TOL)
    assert max(raw) == 0.0 and max(final) == 0.0 and flips == []


def test_planted_tie_decided_the_other_way_passes(planted):
    tied, call, flat = planted["tied"], planted["call"], planted["flat"]
    assert planted["effect"] > 20 * TOL
    assert bool((tied.calls[call]["idx"] == flat).any()), "the planted pre-activation is a tie"
    raw, final, flips = tied.check(tied.grads([(call, flat)]), TOL)
    assert max(raw) > 20 * TOL and max(final) <= TOL
    w = planted["where"]
    assert [(f["b"], f["target"], f["source"], f["unit"]) for f in flips] == \
        [(w["b"], w["target"], w["source"], w["unit"])]
    assert abs(flips[0]["z"]) <= flips[0]["bound"]


def test_flipped_unit_that_is_no_tie_fails(planted):
    ties, call, flat = planted["ties"], planted["call"], planted["flat"]
    assert not bool((ties.calls[call]["idx"] == flat).any())
    got = ties.grads([(call, flat)])
    raw, final, flips = ties.check(got, TOL)
    assert max(final) > 20 * TOL
    # explain() points at the flipped unit, whose |z| is above its bound
    e, w = ties.explain(got)[0], planted["where"]
    assert (e["b"], e["target"], e["source"], e["unit"]) == \
        (w["b"], w["target"], w["source"], w["unit"])
    assert abs(e["z"]) > e["bound"] and e["delta"] == pytest.approx(e["diff"], rel=1e-3)


@pytest.mark.parametrize("fault", ["bias", "node_row", "weight_column", "tie_and_bias"])
def test_faults_fail(planted, fault):
    tied, names = planted["tied"], planted["names"]
    got = list(tied.grads([(planted["call"], planted["flat"])]) if fault == "tie_and_bias"
               else tied.ref)
    bias = [i for i, n in enumerate(names) if n.endswith("l1/b")][-1]
    if fault in ("bias", "tie_and_bias"):
        got[bias] = got[bias].clone()
        got[bias][1] += 3 * TOL * tied.scales[bias]
    elif fault == "node_row":
        got[0] = got[0].clone()
        row = int(torch.nonzero(got[0][0].abs().amax(-1) > 0)[0])
        got[0][0, row] = 0.0
    else:
        w = names.index(names[bias].replace("/b", "/w"))
        got[w] = got[w].clone()
        got[w][:, 1] += 2 * TOL * tied.scales[w]
    raw, final, flips = tied.check(got, TOL)
    assert max(final) > TOL
