"""O(3) irreps algebra for the score network (l <= 2), in PyTorch.

Counterpart of diffbindfr_tpu/nn/irreps.py with the same conventions: l=1
basis (x, y, z); l=2 basis (xy, yz, 3z^2-1, xz, x^2-y^2); 'component'
normalisation |Y_l(v)|^2 = 2l+1; Clebsch-Gordan tensors solved numerically
(numpy, float64) as the rotation-invariant subspace of D1 x D2 x D3 with a
deterministic sign. The path tables are static numpy/Python data; only the
apply functions touch tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Irreps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Irrep:
    l: int
    p: int  # +1 even, -1 odd

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __str__(self):
        return f"{self.l}{'e' if self.p == 1 else 'o'}"


@dataclasses.dataclass(frozen=True)
class Irreps:
    items: tuple  # ((mul, Irrep), ...)

    @staticmethod
    def parse(s) -> "Irreps":
        if isinstance(s, Irreps):
            return s
        items = []
        for term in s.replace(" ", "").split("+"):
            m = re.fullmatch(r"(?:(\d+)x)?(\d+)([eo])", term)
            if not m:
                raise ValueError(f"bad irreps term {term!r}")
            mul = int(m.group(1) or 1)
            items.append((mul, Irrep(int(m.group(2)), 1 if m.group(3) == "e" else -1)))
        return Irreps(tuple(items))

    @property
    def dim(self) -> int:
        return sum(mul * ir.dim for mul, ir in self.items)

    @property
    def num_scalars(self) -> int:
        return sum(mul for mul, ir in self.items if ir.l == 0 and ir.p == 1)

    def slices(self):
        out, off = [], 0
        for mul, ir in self.items:
            out.append((off, mul, ir))
            off += mul * ir.dim
        return out

    def __str__(self):
        return "+".join(f"{mul}x{ir}" for mul, ir in self.items)


# ---------------------------------------------------------------------------
# Real spherical harmonics (component normalisation), l <= 2
# ---------------------------------------------------------------------------

_SQRT3 = float(np.sqrt(3.0))
_SQRT15 = float(np.sqrt(15.0))
_SQRT5 = float(np.sqrt(5.0))


def spherical_harmonics_l2(vec: torch.Tensor, normalize: bool = True, eps: float = 1e-9):
    """Y_{0..2}(vec) -> [..., 9]; zero vectors map to (1, 0, ..., 0)."""
    if normalize:
        n = torch.linalg.norm(vec, dim=-1, keepdim=True)
        v = vec / torch.clamp(n, min=eps)
    else:
        v = vec
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    y0 = torch.ones_like(x)
    return torch.stack(
        [
            y0,
            x * _SQRT3,
            y * _SQRT3,
            z * _SQRT3,
            _SQRT15 * x * y,
            _SQRT15 * y * z,
            _SQRT5 / 2.0 * (3.0 * z * z - 1.0),
            _SQRT15 * x * z,
            _SQRT15 / 2.0 * (x * x - y * y),
        ],
        dim=-1,
    )


def _sh_np(l: int, v: np.ndarray) -> np.ndarray:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.ones(v.shape[:-1] + (1,))
    if l == 1:
        return np.stack([x, y, z], axis=-1) * _SQRT3
    if l == 2:
        return np.stack(
            [
                _SQRT15 * x * y,
                _SQRT15 * y * z,
                _SQRT5 / 2.0 * (3 * z * z - 1),
                _SQRT15 * x * z,
                _SQRT15 / 2.0 * (x * x - y * y),
            ],
            axis=-1,
        )
    raise NotImplementedError(l)


@functools.lru_cache(maxsize=None)
def _wigner_sample_points(n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(12345)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def wigner_d_real(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner matrix D_l(R) in this module's SH basis (least squares)."""
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return R.copy()
    v = _wigner_sample_points()
    A = _sh_np(l, v)
    B = _sh_np(l, v @ R.T)
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Invariant coupling tensor C [2l1+1, 2l2+1, 2l3+1], ||C||_F = 1."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"triangle violated: {l1} {l2} {l3}")
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3
    rng = np.random.default_rng(2024)
    M = np.zeros((dim, dim))
    for _ in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        D = np.kron(
            np.kron(wigner_d_real(l1, R), wigner_d_real(l2, R)), wigner_d_real(l3, R)
        )
        A = D - np.eye(dim)
        M += A.T @ A
    w_eig, v_eig = np.linalg.eigh(M)
    if w_eig[0] >= 1e-8 or (dim > 1 and w_eig[1] <= 1e-4):
        raise ArithmeticError(f"no unique invariant for ({l1},{l2},{l3})")
    C = v_eig[:, 0].reshape(d1, d2, d3)
    flat = C.ravel()
    C = C * np.sign(flat[np.argmax(np.abs(flat))])
    return C.astype(np.float64)


# ---------------------------------------------------------------------------
# Tensor-product path tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPPath:
    i1: int
    i2: int
    i3: int
    s1: int
    s2: int
    s3: int
    mul1: int
    mul2: int
    mul3: int
    l1: int
    l2: int
    l3: int
    w_offset: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class TensorProductSpec:
    in1: Irreps
    in2: Irreps
    out: Irreps
    paths: tuple
    weight_numel: int


@functools.lru_cache(maxsize=None)
def compile_fc_tensor_product(in1_s: str, in2_s: str, out_s: str) -> TensorProductSpec:
    """Every symmetry-allowed fully connected path (mul1 x mul2 x mul3
    weights each), enumerated i1-major, with fan-in normalisation alpha =
    sqrt((2 l3 + 1) / sum of mul1 * mul2 into the output slot). The order,
    w_offset and alpha are the reference-checkpoint import's weight layout
    (utils/e3nn_compat.convert_fctp_weights)."""
    in1, in2, out = Irreps.parse(in1_s), Irreps.parse(in2_s), Irreps.parse(out_s)
    raw = []
    for i1, (off1, mul1, ir1) in enumerate(in1.slices()):
        for i2, (off2, mul2, ir2) in enumerate(in2.slices()):
            for i3, (off3, mul3, ir3) in enumerate(out.slices()):
                if ir3.p != ir1.p * ir2.p:
                    continue
                if not (abs(ir1.l - ir2.l) <= ir3.l <= ir1.l + ir2.l):
                    continue
                raw.append((i1, i2, i3, off1, off2, off3, mul1, mul2, mul3,
                            ir1.l, ir2.l, ir3.l))
    fan_in: dict = {}
    for r in raw:
        fan_in[r[2]] = fan_in.get(r[2], 0) + r[6] * r[7]
    paths = []
    w_off = 0
    for i1, i2, i3, s1, s2, s3, mul1, mul2, mul3, l1, l2, l3 in raw:
        alpha = float(np.sqrt((2 * l3 + 1) / max(fan_in[i3], 1)))
        paths.append(TPPath(i1, i2, i3, s1, s2, s3, mul1, mul2, mul3, l1, l2, l3, w_off, alpha))
        w_off += mul1 * mul2 * mul3
    return TensorProductSpec(in1, in2, out, tuple(paths), w_off)


@functools.lru_cache(maxsize=None)
def compile_dw_tensor_product(in1_s: str, in2_s: str, lmax_out: int = 2) -> TensorProductSpec:
    """Depthwise ('uvu') TP: one weight per (path, channel); every coupling
    emits its own output slot, truncated at lmax_out."""
    in1, in2 = Irreps.parse(in1_s), Irreps.parse(in2_s)
    out_items = []
    paths = []
    w_off = 0
    for i1, (off1, mul1, ir1) in enumerate(in1.slices()):
        for i2, (off2, mul2, ir2) in enumerate(in2.slices()):
            if mul2 != 1:
                raise ValueError("depthwise TP expects a mul-1 second input (sh)")
            for l3 in range(abs(ir1.l - ir2.l), ir1.l + ir2.l + 1):
                if l3 > lmax_out:
                    continue
                p3 = ir1.p * ir2.p
                i3 = len(out_items)
                out_items.append((mul1, Irrep(l3, p3)))
                alpha = float(np.sqrt(2 * l3 + 1))
                s3 = sum(m * ir.dim for m, ir in out_items[:-1])
                paths.append(
                    TPPath(i1, i2, i3, off1, off2, s3, mul1, 1, mul1,
                           ir1.l, ir2.l, l3, w_off, alpha)
                )
                w_off += mul1
    return TensorProductSpec(in1, in2, Irreps(tuple(out_items)), tuple(paths), w_off)


@functools.lru_cache(maxsize=None)
def compile_full_tensor_product(in1_s: str, in2_s: str, lmax_out: int | None = None):
    """Unweighted full TP: each allowed (i1, i2) -> l3 coupling is an output
    irrep of multiplicity mul1*mul2, optionally truncated at lmax_out."""
    in1, in2 = Irreps.parse(in1_s), Irreps.parse(in2_s)
    out_items = []
    raw = []
    for i1, (off1, mul1, ir1) in enumerate(in1.slices()):
        for i2, (off2, mul2, ir2) in enumerate(in2.slices()):
            for l3 in range(abs(ir1.l - ir2.l), ir1.l + ir2.l + 1):
                if lmax_out is not None and l3 > lmax_out:
                    continue
                i3 = len(out_items)
                out_items.append((mul1 * mul2, Irrep(l3, ir1.p * ir2.p)))
                raw.append((i1, i2, i3, off1, off2, mul1, mul2, ir1.l, ir2.l, l3))
    out = Irreps(tuple(out_items))
    paths = []
    for i1, i2, i3, s1, s2, mul1, mul2, l1, l2, l3 in raw:
        s3 = out.slices()[i3][0]
        alpha = float(np.sqrt(2 * l3 + 1))
        paths.append(
            TPPath(i1, i2, i3, s1, s2, s3, mul1, mul2, mul1 * mul2, l1, l2, l3, 0, alpha)
        )
    return TensorProductSpec(in1, in2, out, tuple(paths), 0)


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    in_irreps: Irreps
    out_irreps: Irreps
    blocks: tuple  # ((in_slots, out_slot, w_offset, n_in, mul_out), ...)
    weight_numel: int


@functools.lru_cache(maxsize=None)
def compile_linear(in_s: str, out_s: str) -> LinearSpec:
    """Equivariant linear layer: mixes channels within each (l, p) type."""
    in_ir, out_ir = Irreps.parse(in_s), Irreps.parse(out_s)
    blocks = []
    w_off = 0
    for i3, (off3, mul3, ir3) in enumerate(out_ir.slices()):
        ins = [
            (off1, mul1)
            for (off1, mul1, ir1) in in_ir.slices()
            if ir1.l == ir3.l and ir1.p == ir3.p
        ]
        n_in = sum(m for _, m in ins)
        if n_in == 0:
            continue
        blocks.append((tuple(ins), i3, w_off, n_in, mul3))
        w_off += n_in * mul3
    return LinearSpec(in_ir, out_ir, tuple(blocks), w_off)


def _cg(p: TPPath, like: torch.Tensor) -> torch.Tensor:
    return _cg_tensor(p.l1, p.l2, p.l3, like.dtype, str(like.device))


@functools.lru_cache(maxsize=None)
def _cg_tensor(l1: int, l2: int, l3: int, dtype, device: str) -> torch.Tensor:
    # kept per device: a copy from host memory at every call would make the
    # host wait for the device's queue to drain
    return torch.as_tensor(clebsch_gordan(l1, l2, l3), dtype=dtype, device=device)


def apply_dw_tensor_product(spec: TensorProductSpec, x1, x2, weights):
    """Depthwise weighted TP: y_p[e, u, k] = w_p[e, u] sum_ij a[e,u,i] b[e,j] C[ijk]
    (irreps layout in and out). x1 [..., in1.dim], x2 [..., 9], weights
    [..., weight_numel]."""
    lead = x1.shape[:-1]
    slot_acc: dict = {}
    for p in spec.paths:
        d1, d2, d3 = 2 * p.l1 + 1, 2 * p.l2 + 1, 2 * p.l3 + 1
        a = x1[..., p.s1 : p.s1 + p.mul1 * d1].reshape(lead + (p.mul1, d1))
        b = x2[..., p.s2 : p.s2 + d2]
        w = weights[..., p.w_offset : p.w_offset + p.mul1]
        C = _cg(p, x1).permute(1, 0, 2).reshape(d2, d1 * d3)
        Cb = (b @ C).reshape(lead + (d1, d3))
        z = torch.einsum("...ui,...ik->...uk", a, Cb)
        y = (z * w[..., None] * p.alpha).reshape(lead + (p.mul1 * d3,))
        slot_acc[p.i3] = slot_acc[p.i3] + y if p.i3 in slot_acc else y
    parts = []
    for i3, (off, mul, ir) in enumerate(spec.out.slices()):
        parts.append(slot_acc[i3] if i3 in slot_acc
                     else x1.new_zeros(lead + (mul * ir.dim,)))
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=None)
def _weak_scalar(c: float, dtype) -> float:
    """c as the JAX package applies a Python float to an array of `dtype`:
    rounded to that dtype first (JAX's weak typing), where torch would
    multiply a bf16 tensor by c kept in f32."""
    return float(torch.tensor(c, dtype=dtype))


def apply_fc_tensor_product(spec: TensorProductSpec, x1, x2, weights):
    """Fully connected weighted TP with per-edge uvw weights (irreps layout
    in and out): y_p[e, w, k] = alpha_p sum_uvij w[e, u, v, w] a[e, u, i]
    b[e, v, j] C[i, j, k], the paths of one output slot summed. x1 [...,
    in1.dim], x2 [..., in2.dim], weights [..., weight_numel]. A path whose
    second input has multiplicity 1 (the spherical harmonics) contracts
    the CG tensor with b first, as the JAX package does; one with mul2 > 1
    takes the general form. alpha_p is rounded to the inputs' dtype first,
    as JAX rounds it: in bf16, an alpha kept in f32 moves a training step's
    gradients by half of the distance between the bf16 and f32 steps."""
    lead = x1.shape[:-1]
    slot_acc: dict = {}
    for p in spec.paths:
        d1, d2, d3 = 2 * p.l1 + 1, 2 * p.l2 + 1, 2 * p.l3 + 1
        a = x1[..., p.s1 : p.s1 + p.mul1 * d1].reshape(lead + (p.mul1, d1))
        b = x2[..., p.s2 : p.s2 + p.mul2 * d2].reshape(lead + (p.mul2, d2))
        w = weights[..., p.w_offset : p.w_offset + p.mul1 * p.mul2 * p.mul3]
        C = _cg(p, x1)
        alpha = _weak_scalar(p.alpha, x1.dtype)
        if p.mul2 == 1:
            # Cb[e, i, k] = sum_j b[e, j] C[i, j, k]: one [E, d2] @ [d2, d1 d3]
            Cb = (b[..., 0, :] @ C.permute(1, 0, 2).reshape(d2, d1 * d3)).reshape(
                lead + (d1, d3))
            if d1 == 1:
                z = a[..., :, 0][..., :, None] * Cb[..., 0, :][..., None, :]
            else:
                z = torch.einsum("...ui,...ik->...uk", a, Cb)
            w = w.reshape(lead + (p.mul1, p.mul3))
            y = torch.einsum("...uw,...uk->...wk", w, z) * alpha
        else:
            w4 = w.reshape(lead + (p.mul1, p.mul2, p.mul3))
            z = torch.einsum("...ui,...vj,ijk->...uvk", a, b, C)
            y = torch.einsum("...uvw,...uvk->...wk", w4, z) * alpha
        y = y.reshape(lead + (p.mul3 * d3,))
        slot_acc[p.i3] = slot_acc[p.i3] + y if p.i3 in slot_acc else y
    parts = []
    for i3, (off, mul, ir) in enumerate(spec.out.slices()):
        parts.append(slot_acc[i3] if i3 in slot_acc
                     else x1.new_zeros(lead + (mul * ir.dim,)))
    return torch.cat(parts, dim=-1)


def apply_full_tensor_product(spec: TensorProductSpec, x1, x2):
    """Unweighted full TP (irreps layout)."""
    out_parts = []
    for p in spec.paths:
        d1, d2, d3 = 2 * p.l1 + 1, 2 * p.l2 + 1, 2 * p.l3 + 1
        a = x1[..., p.s1 : p.s1 + p.mul1 * d1].reshape(x1.shape[:-1] + (p.mul1, d1))
        b = x2[..., p.s2 : p.s2 + p.mul2 * d2].reshape(x2.shape[:-1] + (p.mul2, d2))
        y = torch.einsum("...ui,...vj,ijk->...uvk", a, b, _cg(p, x1)) * p.alpha
        out_parts.append(y.reshape(y.shape[:-3] + (p.mul1 * p.mul2 * d3,)))
    return torch.cat(out_parts, dim=-1)


def promote(x, w):
    """(x, w) in their common dtype: JAX's promotion for a product of a bf16
    and an f32 array (f32, the bf16 values exact), which torch's matmul and
    einsum do not apply themselves."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def apply_linear(spec: LinearSpec, x, w):
    """Per-irrep-type channel mixing on irreps-layout features."""
    x, w = promote(x, w)
    lead = x.shape[:-1]
    outs = {}
    out_slices = spec.out_irreps.slices()
    for ins, i3, w_off, n_in, mul3 in spec.blocks:
        d = out_slices[i3][2].dim
        xin = torch.cat(
            [x[..., o : o + m * d].reshape(lead + (m, d)) for o, m in ins], dim=-2
        )
        W = w[w_off : w_off + n_in * mul3].reshape(n_in, mul3)
        outs[i3] = torch.einsum("...ud,uw->...wd", xin, W).reshape(lead + (mul3 * d,))
    parts = []
    for i3, (off, mul, ir) in enumerate(out_slices):
        parts.append(outs[i3] if i3 in outs else x.new_zeros(lead + (mul * ir.dim,)))
    return torch.cat(parts, dim=-1)


def apply_linear_cm(spec: LinearSpec, x_cm, w):
    """apply_linear on component-major features (each slot stored as d
    contiguous [mul] blocks); same weights as apply_linear."""
    x_cm, w = promote(x_cm, w)
    lead = x_cm.shape[:-1]
    parts = []
    slot_out = {b[1]: b for b in spec.blocks}
    for i3, (off3, mul3, ir3) in enumerate(spec.out_irreps.slices()):
        d = ir3.dim
        if i3 not in slot_out:
            parts.append(x_cm.new_zeros(lead + (mul3 * d,)))
            continue
        ins, _, w_off, n_in, _ = slot_out[i3]
        W = w[w_off : w_off + n_in * mul3].reshape(n_in, mul3)
        for k in range(d):
            xin = torch.cat([x_cm[..., o + k * m : o + (k + 1) * m] for o, m in ins], dim=-1)
            parts.append(xin @ W)
    return torch.cat(parts, dim=-1)
