"""The bf16 tensor products of the score net's heads against the JAX
package: `irreps.apply_dw_tensor_product` at the centre conv's spec (the
tr/rot head) and `irreps.apply_full_tensor_product` at the torsion heads'
spec (FullTP(sh, bond 2e), l <= 1), in bf16 on the same numpy-seeded
inputs.

JAX rounds a Python-float constant to the array's dtype before it applies
it (weak typing); torch multiplies a bf16 tensor by a Python float kept in
f32. Both TPs end with `* alpha_p`, and alpha_p = sqrt(3) or sqrt(5/3) is
not a bf16 number, so the port rounds it as JAX does (`irreps._weak_scalar`).

Tolerance: bit for bit on every path but one. The two frameworks contract
in the same pairwise order on the CPU: the dw TP's `b @ C` and its
per-channel einsum, and the full TP's three-operand einsum, each pair
rounded to bf16. Within a pair, XLA and torch add the f32 products in the
same order except in the full TP's l1 = 2 x l2 = 2 -> l3 = 1 path (25
products per element), where a first contraction may land one bf16 unit
apart and a later cancellation shows that unit at the path's scale: there
a few elements (measured 1 of 6,144) may differ, each by at most one bf16
unit of the path's max|ref|. The control holds the test's power: with alpha
kept in f32 (the arithmetic before the repair) every path whose alpha is
not a bf16 number differs from JAX in hundreds of elements (measured 1,471
to 68,257 of 6,144 and 294,912).

The layer norm that follows every conv is held the same way, bit for bit:
its eps, a Python float too, sums the same either way, and its rsqrt is
taken in f32 and rounded once, as JAX takes it (torch's own bf16 rsqrt on
the CPU rounds wrongly for the elements its vector loop leaves over).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import irreps as JI
from diffbindfr_tpu.nn import layers as JL
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.nn import irreps as TI
from diffbindfr_torch.nn import layers as TL

# one intra-op thread: tier-1 runs six test processes on the machine's cores
torch.set_num_threads(1)

ROWS = 2048


def _specs():
    """(port spec, JAX spec) of the centre conv's dw TP and the torsion heads'
    full TP at the default (flagship) widths."""
    _, final, tor_sh, _ = tsn._specs(tsn.ScoreNetConfig())
    dw = final.dw
    lmax = max(ir.l for _, ir in dw.out.items)
    return {"center_dw": (dw, JI.compile_dw_tensor_product(str(dw.in1), str(dw.in2), lmax)),
            "torsion_full": (tor_sh, JI.compile_full_tensor_product(str(tor_sh.in1),
                                                                    str(tor_sh.in2), 1))}


def _run(name, spec, jspec, args):
    """(JAX, port) outputs as f32 numpy of the bf16 TP on the numpy inputs."""
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    targs = [torch.from_numpy(a).bfloat16() for a in args]
    if name == "center_dw":
        j = JI.apply_dw_tensor_product(jspec, *jargs)
        t = TI.apply_dw_tensor_product(spec, *targs)
    else:
        j = JI.apply_full_tensor_product(jspec, *jargs)
        t = TI.apply_full_tensor_product(spec, *targs)
    assert t.dtype == torch.bfloat16
    return np.asarray(j.astype(jnp.float32)), t.float().numpy()


@pytest.fixture(scope="module")
def cases():
    """Per spec: (port spec, JAX spec, inputs, JAX output), the JAX side run
    once for the module."""
    rng = np.random.default_rng(23)
    out = {}
    for name, (spec, jspec) in _specs().items():
        assert str(spec.out) == str(jspec.out)
        dims = (spec.in1.dim, spec.in2.dim) + ((spec.weight_numel,) if name == "center_dw"
                                               else ())
        args = [rng.normal(size=(ROWS, d)).astype(np.float32) for d in dims]
        out[name] = (spec, jspec, args, _run(name, spec, jspec, args)[0])
    return out


def _mismatches(spec, want, got):
    """Per path (l1, l2, l3, output slot): (elements that differ, the
    largest difference in bf16 units of the JAX element, the largest
    difference over one bf16 unit of the path's max|ref|)."""
    res = {}
    for p in spec.paths:
        off, mul, ir = spec.out.slices()[p.i3]
        a, b = want[:, off : off + mul * ir.dim], got[:, off : off + mul * ir.dim]
        d = np.abs(a - b)
        unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)
        scale = np.exp2(np.floor(np.log2(max(float(np.abs(a).max()), 1e-30))) - 7)
        res[(p.l1, p.l2, p.l3, p.i3)] = (int((a != b).sum()), float((d / unit).max()),
                                         float(d.max() / scale))
    return res


# the path whose f32 sums XLA and torch take in another order (see above):
# (l1, l2, l3) of the full TP, and the elements allowed to differ there
ORDER_PATHS = {("torsion_full", (2, 2, 1)): 4}


@pytest.mark.parametrize("name", ["center_dw", "torsion_full"])
def test_bf16_tp_rounds_alpha_as_jax(cases, name):
    spec, jspec, args, want = cases[name]
    got = _run(name, spec, jspec, args)[1]
    per_path = _mismatches(spec, want, got)
    print(name, per_path)
    assert np.isfinite(got).all()
    for (l1, l2, l3, slot), (n, _, of_max) in per_path.items():
        allowed = ORDER_PATHS.get((name, (l1, l2, l3)), 0)
        assert n <= allowed and (n == 0 or of_max <= 1.0), ((l1, l2, l3, slot), n, of_max)


@pytest.mark.parametrize("name", ["center_dw", "torsion_full"])
def test_alpha_kept_in_f32_differs_from_jax(cases, name, monkeypatch):
    """The control: the same TP with alpha unrounded differs from JAX in
    hundreds of elements of every path whose alpha is not a bf16 number."""
    spec, jspec, args, want = cases[name]
    monkeypatch.setattr(TI, "_weak_scalar", lambda c, dtype: c)
    per_path = _mismatches(spec, want, _run(name, spec, jspec, args)[1])
    print(name, "alpha in f32:", per_path)
    for p in spec.paths:
        n = per_path[(p.l1, p.l2, p.l3, p.i3)][0]
        if float(torch.tensor(p.alpha, dtype=torch.bfloat16)) != p.alpha:
            assert n >= 100, (p, n)


# rows of the layer norm's inputs: each slot's rsqrt runs over [rows, 1]
# values, so these leave 1 to 31 elements past a 32-wide vector loop
LN_ROWS = (1, 7, 31, 40, 1000)


def _to_cm(irreps, x):
    """Row-major irreps features [rows, dim] -> component-major (each slot
    [mul, d] stored as [d, mul]), the layout of irreps_layer_norm_apply_cm."""
    parts = []
    for off, mul, ir in irreps.slices():
        f = x[:, off : off + mul * ir.dim].reshape(len(x), mul, ir.dim)
        parts.append(f.transpose(0, 2, 1).reshape(len(x), -1))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("layout", ["row_major", "component_major"])
@pytest.mark.parametrize("rows", LN_ROWS)
def test_bf16_layer_norm_matches_jax(rows, layout):
    """irreps_layer_norm_apply (row-major) and irreps_layer_norm_apply_cm
    (component-major, the card's kernel path in tp_conv_finalize_cm) in bf16
    at the trunk's output ladder against the JAX package's, bit for bit, on
    numpy-seeded features and weights; the component-major input and JAX's
    output in the same permutation."""
    irreps = str(tsn._specs(tsn.ScoreNetConfig())[0][-1].out)
    jir, tir = JI.Irreps.parse(irreps), TI.Irreps.parse(irreps)
    rng = np.random.default_rng(rows)
    p = {k: np.asarray(v) * (1 + 0.2 * rng.normal(size=np.shape(v)))
         for k, v in JL.irreps_layer_norm_init(jir).items()}
    x = (rng.normal(size=(rows, jir.dim)) * np.exp(rng.normal(size=(rows, 1)))).astype(np.float32)
    want = JL.irreps_layer_norm_apply({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                                      jir, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    tp = {k: torch.tensor(v).bfloat16() for k, v in p.items()}
    if layout == "row_major":
        got = TL.irreps_layer_norm_apply(tp, tir, torch.from_numpy(x).bfloat16())
    else:
        got = TL.irreps_layer_norm_apply_cm(tp, tir, torch.from_numpy(_to_cm(tir, x)).bfloat16())
        want = _to_cm(tir, want)
    assert got.dtype == torch.bfloat16
    assert int((got.float().numpy() != want).sum()) == 0
