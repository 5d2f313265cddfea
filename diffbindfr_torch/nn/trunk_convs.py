"""The score network's three trunk convs: CUDA kernels and plain versions.

Counterpart of diffbindfr_tpu/nn/pallas_conv_t.py (the cmT Pallas kernels
on the default `use_pallas` path, with `pallas_bwd`). Each conv has
  * a wrapper (`pair_conv`, `cross_conv`, `knn_conv`) that, on CUDA
    tensors, runs a torch.autograd.Function whose forward launches the
    conv's hand-written CUDA kernel and whose backward launches its
    backward kernel (csrc/*.cu), or raises;
  * a plain PyTorch version (`*_plain`), a port of the XLA twin in
    diffbindfr_tpu/nn/pallas_conv.py:227-405, which the wrapper uses only
    for tensors on the CPU (autograd through it is the plain backward) and
    which tests and chip_smoke.py hold the kernels against;
  * launch counters, `launches[name]`, raised by one per kernel call.

| wrapper (launch counter) | replaces (TPU kernel) | CUDA source |
| cross_conv (B1) | pallas_conv_t.py:make_cross_conv_t (call :693) | csrc/cross_conv.cu |
| pair_conv (B2) | pallas_conv_t.py:make_pair_conv_t (call :433) | csrc/pair_conv.cu |
| knn_conv (B3) | pallas_conv_t.py:make_knn_conv_t (call :935) | csrc/knn_conv.cu |
| cross_bwd (B4) | pallas_conv_t.py:make_cross_bwd_t (call :1600) | csrc/cross_bwd.cu |
| pair_bwd (B5) | pallas_conv_t.py:make_pair_bwd_t (call :1258) | csrc/pair_bwd.cu |
| knn_bwd (B6) | pallas_conv_t.py:make_knn_bwd_t (call :1884) | csrc/knn_bwd.cu |
| cross_conv_fin (B7) | pallas_conv.py:make_cross_conv, fin= (call :1008) | csrc/cross_conv.cu |
| pair_conv_fin (B8) | pallas_conv.py:make_pair_conv, fin= (call :653) | csrc/pair_conv.cu |
| knn_conv_fin (B9) | pallas_conv.py:make_knn_conv, fin= (call :1225) | csrc/knn_conv.cu |
| cross_conv, bf16_chain (cross_conv_bf16, B11) | make_cross_conv_t, dw_dtype='bfloat16' (call :693) | csrc/cross_conv.cu |
| pair_conv, bf16_chain (pair_conv_bf16, B11) | make_pair_conv_t, dw_dtype='bfloat16' (call :433) | csrc/pair_conv.cu |
| knn_conv, bf16_chain (knn_conv_bf16, B11) | make_knn_conv_t, dw_dtype='bfloat16' (call :935) | csrc/knn_conv.cu |

The row-major kernels B7-B9 without `fin` compute exactly B1-B3's contract,
so B1-B3 serve them. With `fin` (a `FinConsts`), the `*_fin` wrappers return
the finished update: the masked sums divided by max(count, 1), mixed by the
irreps Linear and LayerNorm-ed, in one launch (csrc/conv_fin.cuh). Their
backward recomputes through the plain version with autograd, the JAX
package's rule for these kernels (`_vjp_wrap`, pallas_conv.py:211-224).

With `bf16_chain=True` the three wrappers launch B11, the same convs with the
JAX kernels' `dw_dtype='bfloat16'` body (pallas_conv_t.py:200-250 there):
the depthwise chain in bf16, each product and partial sum rounded once, in
the reference's order; some MLP input rows rounded to bf16 where the
reference moves them at one bf16 pass; the MLPs, geometry, masks and every
sum over pairs f32. The plain versions take the same flag and round at
exactly those points. The backward is B4-B6 unchanged: the bf16 chain is an
inference knob whose backward runs f32 (pallas_conv_t.py:283-290 there).

Contract (the twins'): component-major f32 node features in, masked message
SUM [B, N_target, dout] component-major out; a leading batch axis B
replaces the vmap. Weights and features may be bf16: the kernels and the
plain versions compute in f32 on their values, as the Pallas kernels cast
their inputs. Gradients flow to the node features and every parameter;
positions, time embedding, masks and bond features get none (pure data in
training, as the JAX package's hand-written backward assumes), and the
kernel path raises when one of positions, time embedding or cutoff requires
grad: those gradients come from the plain versions. The folded
edge input (`_prep_edge`) stays in the autograd graph, so the backward
kernels return gradients of (w_in, b_eff) and of the MLPs, and autograd maps
them to the parameter tree. What bounds the kernels on the H100 and what
their design does about it is in csrc/trunk_conv.cuh, csrc/trunk_conv_bwd.cuh
(B5, B6), csrc/conv_bwd_wide.cuh and csrc/abt_gemm.cuh (B4) and the kernel
sources. B4's plain version, cross_bwd_plain, is a model of its kernels'
decomposition (pair list, per-pair rows, contractions, node sums) that
cross_bwd runs on CPU tensors; the other backward kernels are held to
autograd through the plain forward.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import contraction
from .irreps import Irreps, TensorProductSpec, apply_dw_tensor_product, clebsch_gordan
from .layers import ConvSpec, sh_l2, tp_conv_finalize_cm

launches = {"cross_conv": 0, "pair_conv": 0, "knn_conv": 0,
            "cross_bwd": 0, "pair_bwd": 0, "knn_bwd": 0,
            "cross_conv_fin": 0, "pair_conv_fin": 0, "knn_conv_fin": 0, "layer_conv": 0,
            "cross_conv_bf16": 0, "pair_conv_bf16": 0, "knn_conv_bf16": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# component-major layout converters (nn/pallas_conv.py:51-80)
# ---------------------------------------------------------------------------


def cm_from_irreps(irreps: Irreps, x):
    """[..., dim] irreps layout ([mul, d] per slot) -> component-major ([d, mul])."""
    parts = []
    for off, mul, ir in irreps.slices():
        d = ir.dim
        blk = x[..., off : off + mul * d]
        if d > 1:
            blk = blk.reshape(x.shape[:-1] + (mul, d)).transpose(-1, -2).reshape(
                x.shape[:-1] + (mul * d,))
        parts.append(blk)
    return torch.cat(parts, dim=-1)


def cm_to_irreps(irreps: Irreps, x):
    parts = []
    for off, mul, ir in irreps.slices():
        d = ir.dim
        blk = x[..., off : off + mul * d]
        if d > 1:
            blk = blk.reshape(x.shape[:-1] + (d, mul)).transpose(-1, -2).reshape(
                x.shape[:-1] + (mul * d,))
        parts.append(blk)
    return torch.cat(parts, dim=-1)


# TP paths that may read one input column (kMaxInPaths, trunk_conv.cuh)
MAX_IN_PATHS = 8


def _path_constants(spec: TensorProductSpec):
    """Per-path metadata + stacked sh -> Cb contraction matrix [9, kdim]
    (alpha folded in); cb column layout per path: [i * d3 + k]."""
    metas = []
    ck_cols = []
    off = 0
    for p in spec.paths:
        d1, d2, d3 = 2 * p.l1 + 1, 2 * p.l2 + 1, 2 * p.l3 + 1
        C = clebsch_gordan(p.l1, p.l2, p.l3)
        block = np.zeros((9, d1 * d3))
        block[p.s2 : p.s2 + d2] = np.transpose(C, (1, 0, 2)).reshape(d2, d1 * d3) * p.alpha
        ck_cols.append(block)
        metas.append(dict(s1=p.s1, mul=p.mul1, d1=d1, d3=d3, s3=p.s3,
                          w_off=p.w_offset, cb_off=off))
        off += d1 * d3
    return metas, np.concatenate(ck_cols, axis=1)


@dataclasses.dataclass(frozen=True)
class ConvConsts:
    """Static tables of one trunk conv (one layer's depthwise TP)."""

    spec: TensorProductSpec
    ns: int
    sed: int
    gs_stop: float
    gs_n: int

    @property
    def din(self) -> int:
        return self.spec.in1.dim

    @property
    def dout(self) -> int:
        return self.spec.out.dim

    @property
    def gs_offsets(self) -> np.ndarray:
        return np.linspace(0.0, self.gs_stop, self.gs_n)

    @property
    def gs_coeff(self) -> float:
        offs = self.gs_offsets
        return float(-0.5 / (offs[1] - offs[0]) ** 2)

    @functools.cached_property
    def tables(self):
        """(ck [9, kdim] f32, out_meta [dout, 8] i32) as numpy arrays.
        out_meta row o (component-major output column o = s3 + k*mul + u):
        a_base = s1 + u, mul, d1, w_idx = w_off + u, cb_base = cb_off + k, d3."""
        metas, ck = _path_constants(self.spec)
        meta = np.zeros((self.dout, 8), np.int32)
        for m in metas:
            for k in range(m["d3"]):
                for u in range(m["mul"]):
                    meta[m["s3"] + k * m["mul"] + u] = (
                        m["s1"] + u, m["mul"], m["d1"], m["w_off"] + u,
                        m["cb_off"] + k, m["d3"], 0, 0)
        return ck.astype(np.float32), meta

    @functools.cached_property
    def path_metas(self):
        """Per TP path (in output-column order): s1, mul, d1, d3, s3, w_off,
        cb_off (columns of ck)."""
        return tuple(_path_constants(self.spec)[0])

    def device_tables(self, device):
        """(ck, gs_offsets, out_meta) tensors on `device`, cached."""
        return _device_tables(self, str(device))

    @functools.cached_property
    def bwd_tables(self):
        """(w_meta [nw, 8], in_meta [din, MAX_IN_PATHS, 8]) int32, the
        backward kernels' views of the same paths.
        w_meta row j = w_off + u: a_base = s1 + u, mul, d1, o_base = s3 + u,
        cb_off, d3. in_meta[c]: one entry per path reading input column
        c = s1 + i * mul + u: o_base, mul, w_idx, cb_base = cb_off + i * d3,
        d3; unused entries have d3 = 0."""
        metas, _ = _path_constants(self.spec)
        w_meta = np.zeros((self.spec.weight_numel, 8), np.int32)
        in_meta = np.zeros((self.din, MAX_IN_PATHS, 8), np.int32)
        used = np.zeros(self.din, np.int64)
        for m in metas:
            for u in range(m["mul"]):
                w_meta[m["w_off"] + u] = (m["s1"] + u, m["mul"], m["d1"], m["s3"] + u,
                                          m["cb_off"], m["d3"], 0, 0)
                for i in range(m["d1"]):
                    col = m["s1"] + i * m["mul"] + u
                    in_meta[col, used[col]] = (m["s3"] + u, m["mul"], m["w_off"] + u,
                                               m["cb_off"] + i * m["d3"], m["d3"], 0, 0, 0)
                    used[col] += 1
        return w_meta, in_meta

    def device_bwd_tables(self, device):
        """(w_meta, in_meta) tensors on `device`, cached."""
        return _device_bwd_tables(self, str(device))

    @functools.cached_property
    def wide_tables(self):
        """(w_meta [nw, 4], in_off [din + 1], in_ent [n_in, 4]) int32, the
        wide-tile backward pass's views of the paths (csrc/conv_bwd_wide.cuh).
        w_meta row j = w_off + u: a_base = s1 + u, mul, o_base = s3 + u,
        cb_off | d1 << 16 | d3 << 24. Input column c = s1 + i * mul + u has
        the entries in_ent[in_off[c] : in_off[c + 1]], one per path reading
        it, in path order: o_base = s3 + u, mul, w_idx = w_off + u,
        cb_base = cb_off + i * d3 | d3 << 16."""
        metas, ck = _path_constants(self.spec)
        if ck.shape[1] >= 1 << 16 or max(max(m["d1"], m["d3"]) for m in metas) > 5:
            raise ValueError("the wide backward pass takes cb offsets below 2^16 and paths of "
                             "l <= 2 (d1, d3 <= 5, kTpD)")
        w_meta = np.zeros((self.spec.weight_numel, 4), np.int32)
        ents = [[] for _ in range(self.din)]
        for m in metas:
            for u in range(m["mul"]):
                w_meta[m["w_off"] + u] = (m["s1"] + u, m["mul"], m["s3"] + u,
                                          m["cb_off"] | m["d1"] << 16 | m["d3"] << 24)
                for i in range(m["d1"]):
                    ents[m["s1"] + i * m["mul"] + u].append(
                        (m["s3"] + u, m["mul"], m["w_off"] + u,
                         (m["cb_off"] + i * m["d3"]) | m["d3"] << 16))
        in_off = np.cumsum([0] + [len(e) for e in ents]).astype(np.int32)
        in_ent = np.array([x for e in ents for x in e], np.int32).reshape(-1, 4)
        return w_meta, in_off, in_ent

    def device_wide_tables(self, device):
        """wide_tables as tensors on `device`, cached."""
        return _device_wide_tables(self, str(device))


@functools.lru_cache(maxsize=None)
def _device_tables(c: ConvConsts, device: str):
    ck, meta = c.tables
    return (torch.from_numpy(np.ascontiguousarray(ck)).to(device),
            torch.tensor(c.gs_offsets, dtype=torch.float32, device=device),
            torch.from_numpy(meta).to(device))


@functools.lru_cache(maxsize=None)
def _device_bwd_tables(c: ConvConsts, device: str):
    return tuple(torch.from_numpy(t).to(device) for t in c.bwd_tables)


@functools.lru_cache(maxsize=None)
def _device_wide_tables(c: ConvConsts, device: str):
    return tuple(torch.from_numpy(t).to(device) for t in c.wide_tables)


# ---------------------------------------------------------------------------
# plain versions (ports of the XLA twins), batched over B
# ---------------------------------------------------------------------------

# pair rows per chunk of the plain versions: bounds their peak memory
_PLAIN_PAIRS = 1 << 14


def _mlp2(w1, b1, w2, b2, x):
    return torch.relu(x @ w1 + b1) @ w2 + b2


def _gauss(c: ConvConsts, d):
    offs = torch.tensor(c.gs_offsets, dtype=torch.float32, device=d.device)
    return torch.exp(c.gs_coeff * (d[..., None] - offs) ** 2)


def _dist(vec):
    vx, vy, vz = vec[..., 0], vec[..., 1], vec[..., 2]
    return torch.sqrt(vx * vx + vy * vy + vz * vz + 1e-12)


def _cutoffs(cutoff, batch: int, device):
    if not torch.is_tensor(cutoff):  # a fill on the device, not a host copy
        return torch.full((batch,), cutoff, dtype=torch.float32, device=device)
    return cutoff.to(device, torch.float32).reshape(-1).expand(batch)


def _rows(mask_b):
    return torch.nonzero(mask_b > 0).reshape(-1)


def _chunks(idx, width: int):
    step = max(1, _PLAIN_PAIRS // max(width, 1))
    return [idx[i : i + step] for i in range(0, idx.shape[0], step)]


def _f32(tree):
    """The tree's bf16 / f16 tensors in f32, as the kernels read them; every
    other tensor is returned as it is (the same object)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_f32(v) for v in tree)
    if torch.is_tensor(tree) and tree.dtype in (torch.bfloat16, torch.float16):
        return tree.float()
    return tree


def _bf16_round(x):
    """x rounded to bf16 (round to nearest even), as f32."""
    return x.to(torch.bfloat16).float()


def _chain_bf16(c: ConvConsts, src, sh, w, maskf):
    """Per-pair messages [..., dout] (component-major, f32 values of bf16
    numbers) of the bf16 depthwise chain (pallas_conv_t._dw_paths_t with
    dw_dtype='bfloat16'): w = (w * mask) and cb = sh @ ck (alpha folded in)
    computed in f32 and rounded, the source rows rounded; per path, output
    column (k, u) = sum over i of (src[i, u] * w[u]) * cb[i, k], each product
    and each partial sum rounded to bf16, i ascending. A masked pair's
    message is exactly 0."""
    ck = c.device_tables(sh.device)[0]
    cb = (sh @ ck).to(torch.bfloat16)
    wb = (w * maskf[..., None]).to(torch.bfloat16)
    xb = src.to(torch.bfloat16)
    parts = []
    for m in c.path_metas:
        d1, d3, mul = m["d1"], m["d3"], m["mul"]
        a = xb[..., m["s1"] : m["s1"] + d1 * mul].unflatten(-1, (d1, mul))
        bs = a * wb[..., m["w_off"] : m["w_off"] + mul].unsqueeze(-2)
        cbp = cb[..., m["cb_off"] : m["cb_off"] + d1 * d3].unflatten(-1, (d1, d3))
        z = bs[..., 0, :, None] * cbp[..., 0, None, :]  # [..., mul, d3]
        for i in range(1, d1):
            z = z + bs[..., i, :, None] * cbp[..., i, None, :]
        parts.append(z.transpose(-1, -2).flatten(-2))
    return torch.cat(parts, dim=-1).float()


def pair_conv_plain(c: ConvConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask,
                    src_mask, cab_t, cab_s, temb, cutoff, params, bond_feat,
                    bond_mask, *, bf16_chain: bool = False):
    """Plain B2: make_pair_twin in the score net's configuration (bond
    features, self pairs excluded, cab flags on the source side). Rows and
    columns whose node mask is 0 contribute nothing in the twin either, so
    only valid nodes are visited. With `bf16_chain`, plain B11-pair
    (make_pair_conv_t(dw_dtype='bfloat16')): the target scalars enter the
    TP-weight MLP rounded to bf16 (pallas_conv_t.py:328 there), the source
    scalars exact; the bf16 chain (_chain_bf16)."""
    p, temb, bond_feat, tgt_x, src_x = _f32((params, temb, bond_feat, tgt_x, src_x))
    rnd = _bf16_round if bf16_chain else (lambda v: v)
    bsz, nt, ns = tgt_x.shape[0], tgt_x.shape[1], c.ns
    cut = _cutoffs(cutoff, bsz, tgt_x.device)
    out = tgt_x.new_zeros(bsz, nt, c.dout)
    for b in range(bsz):
        si = _rows(src_mask[b])
        src_irr = cm_to_irreps(c.spec.in1, src_x[b, si])
        for ti in _chunks(_rows(tgt_mask[b]), si.shape[0]):
            vec = src_pos[b, si][None, :, :] - tgt_pos[b, ti][:, None, :]
            d = _dist(vec)
            mask = (cab_s[b, si][None, :] > 0) | (d <= cut[b])
            mask = (mask & (ti[:, None] != si[None, :])) | (bond_mask[b][ti][:, si] > 0)
            r, s = vec.shape[:2]
            attr = _mlp2(p["emb_w1"], p["emb_b1"], p["emb_w2"], p["emb_b2"],
                         torch.cat([bond_feat[b][ti][:, si], temb[b].expand(r, s, -1),
                                    _gauss(c, d)], dim=-1))
            e = torch.cat([attr, rnd(tgt_x[b, ti, None, :ns]).expand(r, s, ns),
                           src_x[b, si, :ns][None].expand(r, s, ns)], dim=-1)
            w = _mlp2(p["fc_w1"], p["fc_b1"], p["fc_w2"], p["fc_b2"], e)
            if bf16_chain:
                out[b, ti] = _chain_bf16(c, src_x[b, si][None].expand(r, s, -1), sh_l2(vec), w,
                                         mask.float()).sum(1)
                continue
            m = apply_dw_tensor_product(c.spec, src_irr[None].expand(r, s, -1), sh_l2(vec), w)
            out[b, ti] = cm_from_irreps(c.spec.out, (m * mask[..., None].float()).sum(1))
    return out


def cross_conv_plain(c: ConvConsts, lig_pos, atm_pos, lig_x, atm_x, lig_mask,
                     atm_mask, cabflag, temb, cutoff, emb_params, fc_al, fc_la, *,
                     bf16_chain: bool = False):
    """Plain B1 (make_cross_twin): returns (al [B, nl, dout], la [B, na, dout]).
    With `bf16_chain`, plain B11-cross (make_cross_conv_t(dw_dtype=
    'bfloat16')): the ligand rows move rounded to bf16 (pallas_conv_t.py:
    584-585 there), so its scalars enter both TP-weight MLPs rounded and the
    la chain reads them; the atom rows enter the MLPs exact (:590-593); the
    bf16 chain (_chain_bf16) in both directions, every sum f32."""
    e_, fc_al, fc_la, temb, lig_x, atm_x = _f32((emb_params, fc_al, fc_la, temb, lig_x, atm_x))
    ns, rnd = c.ns, _bf16_round if bf16_chain else (lambda v: v)
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    cut = _cutoffs(cutoff, bsz, lig_x.device)
    al = lig_x.new_zeros(bsz, nl, c.dout)
    la = atm_x.new_zeros(bsz, na, c.dout)
    for b in range(bsz):
        ai = _rows(atm_mask[b])
        atm_irr = cm_to_irreps(c.spec.in1, atm_x[b, ai])
        la_sum = atm_x.new_zeros(ai.shape[0], c.dout)
        for li in _chunks(_rows(lig_mask[b]), ai.shape[0]):
            vec = atm_pos[b, ai][None, :, :] - lig_pos[b, li][:, None, :]
            d = _dist(vec)
            maskf = ((cabflag[b, ai][None, :] > 0) | (d <= cut[b]))[..., None].float()
            r, s = vec.shape[:2]
            attr = _mlp2(e_["l1"]["w"], e_["l1"]["b"], e_["l2"]["w"], e_["l2"]["b"],
                         torch.cat([temb[b].expand(r, s, -1), _gauss(c, d)], dim=-1))
            lig_sc = rnd(lig_x[b, li, None, :ns]).expand(r, s, ns)
            atm_sc = atm_x[b, ai, :ns][None].expand(r, s, ns)
            sh = sh_l2(vec)
            w_al = _mlp2(fc_al["l1"]["w"], fc_al["l1"]["b"], fc_al["l2"]["w"],
                         fc_al["l2"]["b"], torch.cat([attr, lig_sc, atm_sc], dim=-1))
            w_la = _mlp2(fc_la["l1"]["w"], fc_la["l1"]["b"], fc_la["l2"]["w"],
                         fc_la["l2"]["b"], torch.cat([attr, atm_sc, lig_sc], dim=-1))
            if bf16_chain:
                al[b, li] = _chain_bf16(c, atm_x[b, ai][None].expand(r, s, -1), sh, w_al,
                                        maskf[..., 0]).sum(1)
                la_sum = la_sum + _chain_bf16(c, lig_x[b, li, None].expand(r, s, -1), sh, w_la,
                                              maskf[..., 0]).sum(0)
                continue
            m_al = apply_dw_tensor_product(c.spec, atm_irr[None].expand(r, s, -1), sh, w_al)
            al[b, li] = cm_from_irreps(c.spec.out, (m_al * maskf).sum(1))
            lig_irr = cm_to_irreps(c.spec.in1, lig_x[b, li])
            m_la = apply_dw_tensor_product(c.spec, lig_irr[:, None].expand(r, s, -1), sh, w_la)
            la_sum = la_sum + (m_la * maskf).sum(0)
        la[b, ai] = la_sum if bf16_chain else cm_from_irreps(c.spec.out, la_sum)
    return al, la


def knn_conv_plain(c: ConvConsts, pos, x, mask, idx, valid, temb, params, *,
                   bf16_chain: bool = False):
    """Plain B3 (make_knn_twin): sums over the valid neighbour slots. With
    `bf16_chain`, plain B11-knn (make_knn_conv_t(dw_dtype='bfloat16')): the
    gathered neighbour rows and the target scalars move rounded to bf16
    (pallas_conv_t.py:842, :848 there) into the TP-weight MLP and the bf16
    chain (_chain_bf16); sums over the valid slots f32."""
    e_, fc, temb, x = _f32((params["emb"], params["fc"], temb, x))
    ns, rnd = c.ns, _bf16_round if bf16_chain else (lambda v: v)
    bsz, n, k = idx.shape
    out = x.new_zeros(bsz, n, c.dout)
    for b in range(bsz):
        xi = cm_to_irreps(c.spec.in1, x[b])
        nb_idx = idx[b].long()
        vec = pos[b][nb_idx] - pos[b][:, None, :]
        d = _dist(vec)
        attr = _mlp2(e_["l1"]["w"], e_["l1"]["b"], e_["l2"]["w"], e_["l2"]["b"],
                     torch.cat([temb[b].expand(n, k, -1), _gauss(c, d)], dim=-1))
        ee = torch.cat([attr, rnd(x[b, :, None, :ns]).expand(n, k, ns),
                        rnd(x[b][nb_idx][..., :ns])], dim=-1)
        w = _mlp2(fc["l1"]["w"], fc["l1"]["b"], fc["l2"]["w"], fc["l2"]["b"], ee)
        if bf16_chain:
            out[b] = _chain_bf16(c, x[b][nb_idx], sh_l2(vec), w, valid[b].float()).sum(1)
            continue
        m = apply_dw_tensor_product(c.spec, xi[nb_idx], sh_l2(vec), w)
        out[b] = cm_from_irreps(c.spec.out, (m * valid[b].float()[..., None]).sum(1))
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "dbfr_pair_conv": [_P] * 7 + [_I] + [_P] * 15 + [_I] * 12 + [_F, _I, _I, _P],
    "dbfr_cross_conv": [_P] * 25 + [_I] * 11 + [_F, _P],
    "dbfr_knn_conv": [_P] * 17 + [_I] * 11 + [_F, _P],
    "dbfr_pair_bwd": [_P] * 7 + [_I] + [_P] * 23 + [_I] * 12 + [_F, _I, _I, _P],
    "dbfr_cross_pairs": [_P] * 11 + [_I] * 3 + [_P],
    "dbfr_cross_bwd": [_P] * 46 + [_I] * 20 + [_F, _P],
    "dbfr_knn_bwd": [_P] * 26 + [_I] * 11 + [_F, _P],
    "dbfr_pair_conv_fin": [_P] * 7 + [_I] + [_P] * 15 + [_I] * 12 + [_F, _I, _I]
                          + [_P] * 7 + [_I] * 3 + [_P],
    "dbfr_cross_conv_fin": [_P] * 25 + [_I] * 11 + [_F] + [_P] * 12 + [_I] * 3 + [_P],
    "dbfr_knn_conv_fin": [_P] * 17 + [_I] * 11 + [_F] + [_P] * 7 + [_I] * 3 + [_P],
    "dbfr_layer_conv": [_P, _I, _P, _I, _P, _I, _P],
}
# B11: the same arguments as B1-B3
for _name in ("pair", "cross", "knn"):
    _ARGTYPES[f"dbfr_{_name}_conv_bf16"] = _ARGTYPES[f"dbfr_{_name}_conv"]
# the widest matrix a kernel thread tiles (kMaxJ * 32 columns, trunk_conv.cuh)
_MAX_COLS = 320
# persistent blocks of B5's and B6's target passes: rows of their
# parameter-gradient scratch (kBwdBlocks, trunk_conv_bwd.cuh)
_BWD_BLOCKS = 264
# pairs per block of B4's wide-tile pass; its scratch rows are a multiple of
# this apart (kWideTile, conv_bwd_wide.cuh)
WIDE_TILE = 64


def _library():
    from ..utils import cuda_build

    lib = cuda_build.load()
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _arg(t, shape, dev):
    """Validate one kernel input; returns it as contiguous float32."""
    if t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel input on {t.device} with shape {tuple(t.shape)}; "
                         f"expected {dev} and {tuple(shape)}")
    return t.to(torch.float32).contiguous()


def _mlp_args(mlp, n_in, hidden, n_out, dev):
    return [_arg(mlp["l1"]["w"], (n_in, hidden), dev), _arg(mlp["l1"]["b"], (hidden,), dev),
            _arg(mlp["l2"]["w"], (hidden, n_out), dev), _arg(mlp["l2"]["b"], (n_out,), dev)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _prep_edge(c: ConvConsts, emb_w1, emb_b1, temb, edge_extra: int, bsz: int, dev):
    """Reorder the edge-MLP input rows to [Gaussian | bond] and fold the time
    embedding into a per-sample bias (constant across the pairs of a sample).
    Plain differentiable tensor ops: autograd maps the kernels' gradients of
    (w_in, beff) back to emb_w1 / emb_b1."""
    he = emb_b1.shape[0]
    w1 = _arg(emb_w1, (edge_extra + c.sed + c.gs_n, he), dev)
    beff = _arg(temb, (bsz, c.sed), dev) @ w1[edge_extra : edge_extra + c.sed]
    beff = beff + _arg(emb_b1, (he,), dev)
    w_in = torch.cat([w1[edge_extra + c.sed :], w1[:edge_extra]], dim=0).contiguous()
    return w_in, beff.contiguous()


def _dims(c: ConvConsts, emb_w2, fc_w1):
    """(edge hidden, TP-weight hidden, n weights, kdim), checked against the
    widest product a kernel thread tiles."""
    he, hf, nw = emb_w2.shape[0], fc_w1.shape[1], c.spec.weight_numel
    kdim = c.tables[0].shape[1]
    if max(he, hf, nw, 3 * c.ns, kdim) > _MAX_COLS:
        raise ValueError(f"trunk conv kernels tile at most {_MAX_COLS} columns")
    return he, hf, nw, kdim


def _check_nodes(name: str, *counts):
    if max(counts) >= 1 << 16:
        raise ValueError(f"{name}: at most 65535 nodes per side")


def _grad_layout(ke: int, he: int, ns: int, hf: int, nw: int, bsz: int):
    """Offsets of the backward kernels' reduced parameter gradients (the
    layout of set_grad_layout in trunk_conv_bwd.cuh) and the row stride."""
    shapes = (("w_in", (ke, he)), ("beff", (bsz, he)), ("w2", (he, ns)), ("b2", (ns,)),
              ("wf1", (3 * ns, hf)), ("bf1", (hf,)), ("wf2", (hf, nw)), ("bf2", (nw,)))
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, shape)
        off += int(np.prod(shape))
    return out, (off + 3) & ~3


def _split_grads(flat, layout):
    return {k: flat[o : o + int(np.prod(shape))].view(shape) for k, (o, shape) in layout.items()}


def _grad_scratch(layout_stride: int, dev):
    """(per-block partial sums, zeroed; reduced result)"""
    return (torch.zeros(_BWD_BLOCKS, layout_stride, dtype=torch.float32, device=dev),
            torch.empty(layout_stride, dtype=torch.float32, device=dev))


def _transposed(*ws):
    return [w.t().contiguous() for w in ws]


class _Data:
    """Non-differentiable inputs of one kernel call (positions, masks, cutoff,
    neighbour lists, bond features), validated and contiguous, with the conv's
    static tables and sizes, and whether the forward runs the bf16 chain
    (B11). Autograd sees none of them: in training they are pure data, as the
    JAX package's hand-written backward assumes."""

    def __init__(self, c: ConvConsts, dims, bsz, bf16_chain=False, **tensors):
        self.c, self.dims, self.bsz, self.bf16_chain = c, dims, bsz, bf16_chain
        self.__dict__.update(tensors)


def _no_data_grads(name: str, **tensors):
    """Raise when autograd would need a gradient the kernels do not give:
    positions, time embedding and cutoff are data to B4-B6."""
    if not torch.is_grad_enabled():
        return
    need = [k for k, t in tensors.items() if torch.is_tensor(t) and t.requires_grad]
    if need:
        raise RuntimeError(
            f"{name}: {', '.join(need)} require grad, but the CUDA kernel path gives gradients "
            f"only to node features and parameters; differentiate them through the plain "
            f"path ({name}_plain on the same inputs, or score_net.apply(..., "
            f"use_kernels=False))")


# ---- B2 pair conv / B5 backward ------------------------------------------


def pair_params(emb, fc):
    """The pair conv's parameter dict from the edge MLP and the TP-weight MLP."""
    return {"emb_w1": emb["l1"]["w"], "emb_b1": emb["l1"]["b"], "emb_w2": emb["l2"]["w"],
            "emb_b2": emb["l2"]["b"], "fc_w1": fc["l1"]["w"], "fc_b1": fc["l1"]["b"],
            "fc_w2": fc["l2"]["w"], "fc_b2": fc["l2"]["b"]}


def pair_conv(c: ConvConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask,
              cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask, *,
              bf16_chain: bool = False):
    """B2 ligand-ligand conv, the score net's configuration: self pairs
    excluded, bonded pairs always on, cab flags on the source side.
    Differentiable in the node features and every parameter (B5 backward).
    With `bf16_chain`, B11-pair (pair_conv_plain's bf16 rounding); its
    backward is B5, the f32 gradients."""
    if not tgt_x.is_cuda:
        return pair_conv_plain(c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask,
                               cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask,
                               bf16_chain=bf16_chain)
    _no_data_grads("pair_conv", tgt_pos=tgt_pos, src_pos=src_pos, temb=temb, cutoff=cutoff)
    return _PairConvFn.apply(*_pair_inputs(c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask,
                                           src_mask, cab_s, temb, cutoff, params, bond_feat,
                                           bond_mask, bf16_chain))


def _pair_inputs(c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_s, temb, cutoff,
                 params, bond_feat, bond_mask, bf16_chain=False):
    """Arguments of _PairConvFn: validated data, features, folded edge input
    and the other weights."""
    p, dev = params, tgt_x.device
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    _check_nodes("pair_conv", nt, nsrc)
    nb = bond_feat.shape[-1]
    he, hf, nw, kdim = _dims(c, p["emb_w2"], p["fc_w1"])
    w_in, beff = _prep_edge(c, p["emb_w1"], p["emb_b1"], temb, nb, bsz, dev)
    data = _Data(c, (he, hf, nw, kdim), bsz, bf16_chain, nb=nb, **{
        k: _arg(v, shape, dev) for k, v, shape in (
        ("tgt_pos", tgt_pos, (bsz, nt, 3)), ("src_pos", src_pos, (bsz, nsrc, 3)),
        ("tgt_mask", tgt_mask, (bsz, nt)), ("src_mask", src_mask, (bsz, nsrc)),
        ("cab_s", cab_s, (bsz, nsrc)), ("bond_feat", bond_feat, (bsz, nt, nsrc, nb)),
        ("bond_mask", bond_mask, (bsz, nt, nsrc)))})
    data.cut = _cutoffs(cutoff, bsz, dev).contiguous()
    weights = [_arg(p["emb_w2"], (he, c.ns), dev), _arg(p["emb_b2"], (c.ns,), dev),
               _arg(p["fc_w1"], (3 * c.ns, hf), dev), _arg(p["fc_b1"], (hf,), dev),
               _arg(p["fc_w2"], (hf, nw), dev), _arg(p["fc_b2"], (nw,), dev)]
    return (data, _arg(tgt_x, (bsz, nt, c.din), dev), _arg(src_x, (bsz, nsrc, c.din), dev),
            w_in, beff, *weights)


class _PairConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, tgt_x, src_x, w_in, beff, *weights):
        ctx.data = data
        ctx.save_for_backward(tgt_x, src_x, w_in, beff, *weights)
        return _pair_conv_kernel(_library(), data, tgt_x, src_x, w_in, beff, weights, _stream())

    @staticmethod
    def backward(ctx, g):
        tgt_x, src_x, w_in, beff, *weights = ctx.saved_tensors
        d_tgt, d_src, gr = pair_bwd(ctx.data, tgt_x, src_x, w_in, beff, weights, g)
        return (None, d_tgt, d_src, gr["w_in"], gr["beff"], gr["w2"], gr["b2"], gr["wf1"],
                gr["bf1"], gr["wf2"], gr["bf2"])


def _pair_conv_kernel(lib, data, tgt_x, src_x, w_in, beff, weights, stream):
    c, d = data.c, data
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(tgt_x.device)
    out = torch.zeros(bsz, nt, c.dout, dtype=torch.float32, device=tgt_x.device)
    name = "pair_conv_bf16" if d.bf16_chain else "pair_conv"
    rc = getattr(lib, "dbfr_" + name)(
        _ptr(d.tgt_pos), _ptr(d.src_pos), _ptr(tgt_x), _ptr(src_x), _ptr(d.tgt_mask),
        _ptr(d.src_mask), _ptr(d.cab_s), 0, _ptr(d.cut), _ptr(d.bond_feat), _ptr(d.bond_mask),
        _ptr(w_in), _ptr(beff), *[_ptr(v) for v in weights],
        _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(out),
        bsz, nt, nsrc, c.din, c.dout, d.nb, c.ns, he, hf, nw, kdim, c.gs_n,
        c.gs_coeff, 0, 1, stream)
    _check(rc, name)
    launches[name] += 1
    return out


def pair_bwd(data, tgt_x, src_x, w_in, beff, weights, g):
    """B5: (d_tgt, d_src, parameter gradients) of pair_conv for the output
    cotangent g, by the hand-written kernel (CUDA tensors only)."""
    c, d, dev = data.c, data, tgt_x.device
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    he, hf, nw, kdim = d.dims
    w2, b2, wf1, bf1, wf2, bf2 = weights
    layout, stride = _grad_layout(c.gs_n + d.nb, he, c.ns, hf, nw, bsz)
    part, flat = _grad_scratch(stride, dev)
    ck, gs_off, _ = c.device_tables(dev)
    w_meta, in_meta = c.device_bwd_tables(dev)
    g = _arg(g, (bsz, nt, c.dout), dev)
    d_tgt = torch.empty(bsz, nt, c.din, dtype=torch.float32, device=dev)
    d_src = torch.empty(bsz, nsrc, c.din, dtype=torch.float32, device=dev)
    transposed = _transposed(w2, wf1, wf2)  # kept alive through the call
    rc = _library().dbfr_pair_bwd(
        _ptr(d.tgt_pos), _ptr(d.src_pos), _ptr(tgt_x), _ptr(src_x), _ptr(d.tgt_mask),
        _ptr(d.src_mask), _ptr(d.cab_s), 0, _ptr(d.cut), _ptr(d.bond_feat), _ptr(d.bond_mask),
        _ptr(w_in), _ptr(beff), *[_ptr(v) for v in weights],
        *[_ptr(v) for v in transposed],
        _ptr(ck), _ptr(gs_off), _ptr(w_meta), _ptr(in_meta), _ptr(g), _ptr(d_tgt), _ptr(d_src),
        _ptr(part), _ptr(flat), bsz, nt, nsrc, c.din, c.dout, d.nb, c.ns, he, hf, nw, kdim,
        c.gs_n, c.gs_coeff, 0, 1, _stream())
    _check(rc, "pair_bwd")
    launches["pair_bwd"] += 1
    return d_tgt, d_src, _split_grads(flat, layout)


# ---- B1 cross conv / B4 backward -----------------------------------------


def cross_conv(c: ConvConsts, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask,
               cabflag, temb, cutoff, emb_params, fc_al, fc_la, *, bf16_chain: bool = False):
    """B1 dual cross conv: (al [B, nl, dout], la [B, na, dout]).
    Differentiable in the node features and every parameter (B4 backward).
    With `bf16_chain`, B11-cross (cross_conv_plain's bf16 rounding); its
    backward is B4, the f32 gradients."""
    if not lig_x.is_cuda:
        return cross_conv_plain(c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask,
                                cabflag, temb, cutoff, emb_params, fc_al, fc_la,
                                bf16_chain=bf16_chain)
    _no_data_grads("cross_conv", lig_pos=lig_pos, atm_pos=atm_pos, temb=temb, cutoff=cutoff)
    return _CrossConvFn.apply(*_cross_inputs(c, lig_pos, atm_pos, lig_x, atm_x, lig_mask,
                                             atm_mask, cabflag, temb, cutoff, emb_params,
                                             fc_al, fc_la, bf16_chain))


def _cross_inputs(c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, temb,
                  cutoff, emb_params, fc_al, fc_la, bf16_chain=False):
    e_, dev = emb_params, lig_x.device
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    _check_nodes("cross_conv", nl, na)
    he, hf, nw, kdim = _dims(c, e_["l2"]["w"], fc_al["l1"]["w"])
    w_in, beff = _prep_edge(c, e_["l1"]["w"], e_["l1"]["b"], temb, 0, bsz, dev)
    data = _Data(c, (he, hf, nw, kdim), bsz, bf16_chain, **{
        k: _arg(v, shape, dev) for k, v, shape in (
        ("lig_pos", lig_pos, (bsz, nl, 3)), ("atm_pos", atm_pos, (bsz, na, 3)),
        ("lig_mask", lig_mask, (bsz, nl)), ("atm_mask", atm_mask, (bsz, na)),
        ("cab", cabflag, (bsz, na)))})
    data.cut = _cutoffs(cutoff, bsz, dev).contiguous()
    weights = [_arg(e_["l2"]["w"], (he, c.ns), dev), _arg(e_["l2"]["b"], (c.ns,), dev)]
    weights += _mlp_args(fc_al, 3 * c.ns, hf, nw, dev) + _mlp_args(fc_la, 3 * c.ns, hf, nw, dev)
    return (data, _arg(lig_x, (bsz, nl, c.din), dev), _arg(atm_x, (bsz, na, c.din), dev),
            w_in, beff, *weights)


class _CrossConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, lig_x, atm_x, w_in, beff, *weights):
        ctx.data = data
        ctx.save_for_backward(lig_x, atm_x, w_in, beff, *weights)
        lib, st = _library(), _stream()
        out = _cross_conv_kernel(lib, data, lig_x, atm_x, w_in, beff, weights, st)
        # B4's pair counts start here, so that its backward reads the count
        # it sizes its scratch by without waiting for the queue to drain
        ctx.pairs = (_cross_pairs(lib, st, data, lig_x.shape[0], lig_x.shape[1], atm_x.shape[1])
                     if any(ctx.needs_input_grad) else None)
        return out

    @staticmethod
    def backward(ctx, g_al, g_la):
        lig_x, atm_x, w_in, beff, *weights = ctx.saved_tensors
        d_lig, d_atm, ga, gl = cross_bwd(ctx.data, lig_x, atm_x, w_in, beff, weights, g_al, g_la,
                                         pairs=ctx.pairs)
        edge = [ga[k] + gl[k] for k in ("w_in", "beff", "w2", "b2")]
        fc = [gr[k] for gr in (ga, gl) for k in ("wf1", "bf1", "wf2", "bf2")]
        return (None, d_lig, d_atm, *edge, *fc)


def _cross_conv_kernel(lib, data, lig_x, atm_x, w_in, beff, weights, stream):
    c, d = data.c, data
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(lig_x.device)
    al = torch.zeros(bsz, nl, c.dout, dtype=torch.float32, device=lig_x.device)
    la = torch.zeros(bsz, na, c.dout, dtype=torch.float32, device=lig_x.device)
    name = "cross_conv_bf16" if d.bf16_chain else "cross_conv"
    rc = getattr(lib, "dbfr_" + name)(
        _ptr(d.lig_pos), _ptr(d.atm_pos), _ptr(lig_x), _ptr(atm_x), _ptr(d.lig_mask),
        _ptr(d.atm_mask), _ptr(d.cab), _ptr(d.cut), _ptr(w_in), _ptr(beff),
        *[_ptr(v) for v in weights], _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(al), _ptr(la),
        bsz, nl, na, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff, stream)
    _check(rc, name)
    launches[name] += 1
    return al, la


# what the last cross_bwd call on the card allocated: its pair count and
# scratch bytes (chip_smoke.py reports them)
cross_bwd_stats: dict = {}


def _aligned(t):
    """t, or a copy of it whose data starts on a 16-byte boundary (the
    kernels stage weights with 16-byte cp.async copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cross_bwd(data, lig_x, atm_x, w_in, beff, weights, g_al, g_la, pairs=None):
    """B4: (d_lig, d_atm, al gradients, la gradients) of cross_conv; the edge-
    MLP entries of the two gradient dicts are the two directions' shares.
    On CUDA tensors the kernels of csrc/cross_bwd.cu: the valid pairs as one
    list (their count read to the host, to size the scratch: counted here,
    or, from the autograd forward, by `pairs`), per direction a wide-tile
    pair pass writing feature-major rows and one grouped launch of the
    split-K contraction that turns them into every parameter gradient, then
    the per-node sums of the pairs' rows. On CPU tensors the plain model of
    that decomposition, cross_bwd_plain."""
    c, d, dev = data.c, data, lig_x.device
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    g_al = lig_x.new_zeros(bsz, nl, c.dout) if g_al is None else _arg(g_al, (bsz, nl, c.dout), dev)
    g_la = atm_x.new_zeros(bsz, na, c.dout) if g_la is None else _arg(g_la, (bsz, na, c.dout), dev)
    if not lig_x.is_cuda:
        return cross_bwd_plain(data, lig_x, atm_x, w_in, beff, weights, g_al, g_la)
    lib, st = _library(), _stream()
    if pairs is None:
        pairs = _cross_pairs(lib, st, data, bsz, nl, na)
    return _cross_bwd_kernel(lib, st, data, lig_x, atm_x, w_in, beff, weights, g_al, g_la, pairs)


@dataclasses.dataclass
class _CrossPairs:
    """B4's pair counts (dbfr_cross_pairs): per ligand row the rank of each
    valid atom (pid) and the rows' and atoms' exclusive prefix sums; the
    total copied to pinned host memory, complete when `done` is."""

    pid: torch.Tensor
    lig_off: torch.Tensor
    atm_off: torch.Tensor
    keep: tuple
    total: torch.Tensor
    done: torch.cuda.Event

    def count(self) -> int:
        if self.done is not None:
            self.done.synchronize()
        return int(self.total[0])


def _cross_pairs(lib, st, data, bsz, nl, na):
    d, dev = data, data.lig_pos.device
    i32 = dict(dtype=torch.int32, device=dev)
    pid = torch.empty(bsz, nl, na, **i32)
    cnt_l, lig_off = torch.empty(bsz * nl, **i32), torch.empty(bsz * nl + 1, **i32)
    cnt_a, atm_off = torch.empty(bsz * na, **i32), torch.empty(bsz * na + 1, **i32)
    _check(lib.dbfr_cross_pairs(
        _ptr(d.lig_pos), _ptr(d.atm_pos), _ptr(d.lig_mask), _ptr(d.atm_mask), _ptr(d.cab),
        _ptr(d.cut), _ptr(pid), _ptr(cnt_l), _ptr(lig_off), _ptr(cnt_a), _ptr(atm_off),
        bsz, nl, na, st), "cross_pairs")
    total = torch.empty(1, dtype=torch.int32, pin_memory=dev.type == "cuda")
    total.copy_(lig_off[-1:], non_blocking=True)
    done = torch.cuda.Event() if dev.type == "cuda" else None
    if done is not None:
        done.record()
    return _CrossPairs(pid, lig_off, atm_off, (cnt_l, cnt_a), total, done)


def _cross_bwd_kernel(lib, st, data, lig_x, atm_x, w_in, beff, weights, g_al, g_la, pairs):
    c, d, dev = data.c, data, lig_x.device
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    he, hf, nw, kdim = d.dims
    ns, din = c.ns, c.din
    weights = [_aligned(w) for w in weights]
    w2, b2, al_w1, al_b1, al_w2, al_b2, la_w1, la_b1, la_w2, la_b2 = weights
    w_in = _aligned(w_in)
    layout, stride = _grad_layout(c.gs_n, he, ns, hf, nw, bsz)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    pid, lig_off, atm_off = pairs.pid, pairs.lig_off, pairs.atm_off
    n_pairs = pairs.count()  # the scratch is sized by it
    ld = -(-n_pairs // WIDE_TILE) * WIDE_TILE
    pair_l, pair_a, pair_b = (torch.empty(ld, **i32) for _ in range(3))
    at_atom, sample_off = torch.empty(n_pairs, **i32), torch.empty(bsz + 1, **i32)
    rows = torch.empty(_wide_row_count(c.gs_n, he, ns, hf, nw), ld, **f32)
    al_tgt, la_tgt = torch.empty(ld, ns, **f32), torch.empty(ld, ns, **f32)
    al_src, la_src = torch.empty(ld, din, **f32), torch.empty(ld, din, **f32)
    n_tiles = sum(contraction.tiles(m, n) for m, n in _wide_problems(c.gs_n, he, ns, hf, nw, bsz))
    splits = contraction.max_splits(n_tiles, ld, contraction.sm_count(str(dev)))
    part = torch.empty(splits, stride, **f32)
    flat_al, flat_la = torch.empty(stride, **f32), torch.empty(stride, **f32)
    d_lig, d_atm = torch.empty(bsz, nl, din, **f32), torch.empty(bsz, na, din, **f32)
    ck, gs_off, _ = c.device_tables(dev)
    w_meta, in_off, in_ent = c.device_wide_tables(dev)
    w2t, al_w1t, al_w2t, la_w1t, la_w2t = [_aligned(t) for t in
                                           _transposed(w2, al_w1, al_w2, la_w1, la_w2)]
    rc = lib.dbfr_cross_bwd(
        _ptr(d.lig_pos), _ptr(d.atm_pos), _ptr(lig_x), _ptr(atm_x), _ptr(w_in), _ptr(beff),
        _ptr(w2), _ptr(b2), _ptr(w2t), _ptr(al_w1), _ptr(al_b1), _ptr(al_w2), _ptr(al_b2),
        _ptr(al_w1t), _ptr(al_w2t), _ptr(la_w1), _ptr(la_b1), _ptr(la_w2), _ptr(la_b2),
        _ptr(la_w1t), _ptr(la_w2t), _ptr(ck), _ptr(gs_off), _ptr(w_meta), _ptr(in_off),
        _ptr(in_ent), _ptr(g_al), _ptr(g_la), _ptr(pid), _ptr(lig_off), _ptr(atm_off),
        _ptr(pair_l), _ptr(pair_a), _ptr(pair_b), _ptr(at_atom), _ptr(sample_off), _ptr(rows),
        _ptr(al_tgt), _ptr(al_src), _ptr(la_tgt), _ptr(la_src), _ptr(part), _ptr(flat_al),
        _ptr(flat_la), _ptr(d_lig), _ptr(d_atm), bsz, nl, na, din, c.dout, ns, he, hf, nw,
        kdim, c.gs_n, in_ent.shape[0], n_pairs, ld, layout["w_in"][0], layout["w2"][0],
        layout["wf1"][0], layout["wf2"][0], stride, splits, c.gs_coeff, st)
    _check(rc, "cross_bwd")
    launches["cross_bwd"] += 1
    scratch = (pid, *pairs.keep, lig_off, atm_off, pair_l, pair_a, pair_b, at_atom, sample_off,
               rows, al_tgt, la_tgt, al_src, la_src, part)
    cross_bwd_stats.update(pairs=n_pairs, splits=splits, scratch_bytes=sum(
        t.numel() * t.element_size() for t in scratch))
    return d_lig, d_atm, _split_grads(flat_al, layout), _split_grads(flat_la, layout)


def _wide_row_count(ke, he, ns, hf, nw):
    """Feature rows of one direction's scratch (WideRows, conv_bwd_wide.cuh):
    in, h1, dh1, de[0:ns], e, dh, h, dw."""
    return ke + 2 * he + ns + 3 * ns + 2 * hf + nw


def _wide_problems(ke, he, ns, hf, nw, bsz):
    """[rows, cols] of B4's four contractions per direction, bias rows
    included: dW1 + db1_eff (a row per sample), dW2 + db2, dWf1 + dbf1,
    dWf2 + dbf2."""
    return ((ke + bsz, he), (he + 1, ns), (3 * ns + 1, hf), (hf + 1, nw))


# ---- B4's decomposition, plain -------------------------------------------


def cross_pairs_plain(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut):
    """The pair list of B4 (csrc/cross_bwd.cu): the valid (ligand, atom)
    pairs of every sample in ligand-major order (b, l, a ascending), as
    (pair_l, pair_a, pair_b); sample_off [B + 1] (the first pair of each
    sample), lig_off [B * nl + 1] (of each ligand row), atm_off [B * na + 1]
    (of each atom, in the atom-major permutation) and perm, the list indices
    in atom-major order, list order kept within an atom. The mask is
    cross_conv_plain's."""
    bsz, nl, na = lig_pos.shape[0], lig_pos.shape[1], atm_pos.shape[1]
    d = _dist(atm_pos[:, None, :, :] - lig_pos[:, :, None, :])
    valid = ((cab[:, None, :] > 0) | (d <= cut[:, None, None])) & (lig_mask[:, :, None] > 0) \
        & (atm_mask[:, None, :] > 0)
    pair_b, pair_l, pair_a = torch.nonzero(valid, as_tuple=True)
    zero = torch.zeros(1, dtype=torch.long, device=lig_pos.device)

    def offsets(counts):
        return torch.cat([zero, torch.cumsum(counts.reshape(-1), 0)])

    perm = torch.sort(pair_b * na + pair_a, stable=True).indices
    return (pair_l, pair_a, pair_b, offsets(valid.sum((1, 2))), offsets(valid.sum(2)),
            offsets(valid.sum(1)), perm)


def _tp_bwd_plain(c: ConvConsts, x, cb, w, g):
    """Per pair, the depthwise TP's gradients: (dw [P, nw], dx [P, din]) for
    the source rows x, cb = sh @ ck, the TP weights w and the target's
    cotangent g, component-major: out[s3 + k mul + u] = w[w_off + u] sum_i
    x[s1 + i mul + u] cb[cb_off + i d3 + k]."""
    dw, dx = torch.zeros_like(w), torch.zeros_like(x)
    for m in c.path_metas:
        d1, d3, mul, s1, wo = m["d1"], m["d3"], m["mul"], m["s1"], m["w_off"]
        xp = x[:, s1 : s1 + d1 * mul].unflatten(-1, (d1, mul))
        cp = cb[:, m["cb_off"] : m["cb_off"] + d1 * d3].unflatten(-1, (d1, d3))
        gp = g[:, m["s3"] : m["s3"] + d3 * mul].unflatten(-1, (d3, mul))
        dw[:, wo : wo + mul] = (gp * torch.einsum("pim,pik->pkm", xp, cp)).sum(1)
        dx[:, s1 : s1 + d1 * mul] += (torch.einsum("pkm,pik->pim", gp, cp)
                                      * w[:, None, wo : wo + mul]).flatten(1)
    return dw, dx


def cross_pass_plain(c: ConvConsts, pairs, vec, tgt_x, src_x, gout, w_in, beff, w2, b2, wf1,
                     bf1, wf2, bf2):
    """One direction's wide-tile pass, plain (csrc/conv_bwd_wide.cuh): pairs
    = (target, source, sample) index tensors, vec [P, 3] = atom - ligand.
    Returns the feature-major rows that the parameter gradients contract
    ({in, h1, dh1, dea, e, dh, h, dw}, each [features, P]), the pairs' rows
    of d / d target scalars [P, ns] and of d / d source features [P, din]."""
    t, s, b = pairs
    ns = c.ns
    inp = _gauss(c, _dist(vec))
    h1 = torch.relu(inp @ w_in + beff[b])
    e = torch.cat([h1 @ w2 + b2, tgt_x[b, t, :ns], src_x[b, s, :ns]], dim=-1)
    h = torch.relu(e @ wf1 + bf1)
    w = h @ wf2 + bf2
    cb = sh_l2(vec) @ c.device_tables(vec.device)[0]
    dw, dx = _tp_bwd_plain(c, src_x[b, s], cb, w, gout[b, t])
    dh = (dw @ wf2.t()) * (h > 0)
    de = dh @ wf1.t()
    dh1 = (de[:, :ns] @ w2.t()) * (h1 > 0)
    dx[:, :ns] += de[:, 2 * ns:]
    rows = {"in": inp, "h1": h1, "dh1": dh1, "dea": de[:, :ns], "e": e, "dh": dh, "h": h,
            "dw": dw}
    return {k: v.t() for k, v in rows.items()}, de[:, ns : 2 * ns], dx


def cross_bwd_plain(data, lig_x, atm_x, w_in, beff, weights, g_al, g_la):
    """cross_bwd's plain version, a model of its decomposition: the pair list
    (cross_pairs_plain), per direction the pass's rows (cross_pass_plain)
    contracted over the pairs into each parameter gradient with its bias rows
    (contraction.contract_plain; db1_eff per sample segment), and the pairs'
    node rows summed per ligand row and, through the atom-major permutation,
    per atom. Same returns as cross_bwd."""
    c, d = data.c, data
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    he, hf, nw, _ = d.dims
    ns, din = c.ns, c.din
    w2, b2, *fcs = weights
    pl, pa, pb, sample_off, lig_off, atm_off, perm = cross_pairs_plain(
        d.lig_pos, d.atm_pos, d.lig_mask, d.atm_mask, d.cab, d.cut)
    vec = d.atm_pos[pb, pa] - d.lig_pos[pb, pl]
    dirs = {"al": ((pl, pa, pb), lig_x, atm_x, g_al, fcs[:4]),
            "la": ((pa, pl, pb), atm_x, lig_x, g_la, fcs[4:])}
    grads, node_rows = {}, {}
    for name, (pairs, tx, sx, g, fc) in dirs.items():
        rows, node_rows[name + "_tgt"], node_rows[name + "_src"] = cross_pass_plain(
            c, pairs, vec, tx, sx, g, w_in, beff, w2, b2, *fc)
        w_in_b = contraction.contract_plain(rows["in"], rows["dh1"], sample_off)
        w2_b = contraction.contract_plain(rows["h1"], rows["dea"])
        wf1_b = contraction.contract_plain(rows["e"], rows["dh"])
        wf2_b = contraction.contract_plain(rows["h"], rows["dw"])
        grads[name] = {"w_in": w_in_b[: c.gs_n], "beff": w_in_b[c.gs_n :], "w2": w2_b[:he],
                       "b2": w2_b[he], "wf1": wf1_b[: 3 * ns], "bf1": wf1_b[3 * ns],
                       "wf2": wf2_b[:hf], "bf2": wf2_b[hf]}

    def seg_sum(rows, off, n):
        seg = torch.repeat_interleave(torch.arange(n, device=rows.device), off[1:] - off[:-1])
        return rows.new_zeros(n, din).index_add_(0, seg, rows)

    pad = (0, din - ns)
    lig_rows = node_rows["la_src"] + torch.nn.functional.pad(node_rows["al_tgt"], pad)
    atm_rows = node_rows["al_src"] + torch.nn.functional.pad(node_rows["la_tgt"], pad)
    d_lig = seg_sum(lig_rows, lig_off, bsz * nl).view(bsz, nl, din)
    d_atm = seg_sum(atm_rows[perm], atm_off, bsz * na).view(bsz, na, din)
    return d_lig, d_atm, grads["al"], grads["la"]


# ---- B3 knn conv / B6 backward -------------------------------------------


def knn_conv(c: ConvConsts, pos, x, mask, idx, valid, temb, params, *,
             bf16_chain: bool = False):
    """B3 pocket-atom conv over the neighbour list idx/valid [B, N, k].
    Differentiable in the node features and every parameter (B6 backward).
    With `bf16_chain`, B11-knn (knn_conv_plain's bf16 rounding); its
    backward is B6, the f32 gradients."""
    if not x.is_cuda:
        return knn_conv_plain(c, pos, x, mask, idx, valid, temb, params, bf16_chain=bf16_chain)
    _no_data_grads("knn_conv", pos=pos, temb=temb)
    return _KnnConvFn.apply(*_knn_inputs(c, pos, x, idx, valid, temb, params, bf16_chain))


def _knn_inputs(c, pos, x, idx, valid, temb, params, bf16_chain=False):
    e_, fc, dev = params["emb"], params["fc"], x.device
    bsz, n, k = idx.shape
    _check_nodes("knn_conv", n)
    he, hf, nw, kdim = _dims(c, e_["l2"]["w"], fc["l1"]["w"])
    w_in, beff = _prep_edge(c, e_["l1"]["w"], e_["l1"]["b"], temb, 0, bsz, dev)
    if idx.device != dev:
        raise ValueError(f"kernel input on {idx.device}; expected {dev}")
    data = _Data(c, (he, hf, nw, kdim), bsz, bf16_chain, pos=_arg(pos, (bsz, n, 3), dev),
                 valid=_arg(valid, (bsz, n, k), dev), idx=idx.to(torch.int32).contiguous())
    weights = [_arg(e_["l2"]["w"], (he, c.ns), dev), _arg(e_["l2"]["b"], (c.ns,), dev)]
    weights += _mlp_args(fc, 3 * c.ns, hf, nw, dev)
    return (data, _arg(x, (bsz, n, c.din), dev), w_in, beff, *weights)


class _KnnConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, x, w_in, beff, *weights):
        ctx.data = data
        ctx.save_for_backward(x, w_in, beff, *weights)
        return _knn_conv_kernel(_library(), data, x, w_in, beff, weights, _stream())

    @staticmethod
    def backward(ctx, g):
        x, w_in, beff, *weights = ctx.saved_tensors
        d_x, gr = knn_bwd(ctx.data, x, w_in, beff, weights, g)
        return (None, d_x, gr["w_in"], gr["beff"], gr["w2"], gr["b2"], gr["wf1"], gr["bf1"],
                gr["wf2"], gr["bf2"])


def _knn_conv_kernel(lib, data, x, w_in, beff, weights, stream):
    c, d = data.c, data
    bsz, n, k = d.idx.shape
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(x.device)
    out = torch.zeros(bsz, n, c.dout, dtype=torch.float32, device=x.device)
    name = "knn_conv_bf16" if d.bf16_chain else "knn_conv"
    rc = getattr(lib, "dbfr_" + name)(
        _ptr(d.pos), _ptr(x), _ptr(d.idx), _ptr(d.valid), None, _ptr(w_in), _ptr(beff),
        *[_ptr(v) for v in weights], _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(out),
        bsz, n, k, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff, stream)
    _check(rc, name)
    launches[name] += 1
    return out


def reverse_neighbours(idx, valid):
    """Reverse neighbour list of idx/valid [B, n, k]: (rev_off [B, n + 1],
    rev_tgt, rev_src) with the entries of source s of sample b at
    rev_off[b, s] .. rev_off[b, s + 1], in (target, slot) order. Device ops
    only (a stable sort and a search), no host read."""
    bsz, n, k = idx.shape
    dev = idx.device
    idx = idx.long()
    ok = (valid > 0) & (idx >= 0) & (idx < n)
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    key = torch.where(ok, bidx * (n + 1) + idx, torch.full_like(idx, bsz * (n + 1)))
    skey, perm = torch.sort(key.reshape(-1), stable=True)
    rev_tgt = ((perm // k) % n).to(torch.int32)
    rev_src = (skey % (n + 1)).to(torch.int32)
    q = (torch.arange(bsz, device=dev)[:, None] * (n + 1)
         + torch.arange(n + 1, device=dev)[None]).reshape(-1)
    rev_off = torch.searchsorted(skey, q).to(torch.int32).reshape(bsz, n + 1)
    return rev_off.contiguous(), rev_tgt.contiguous(), rev_src.contiguous()


def knn_bwd(data, x, w_in, beff, weights, g):
    """B6: (d_x, parameter gradients) of knn_conv for the output cotangent g."""
    c, d, dev = data.c, data, x.device
    bsz, n, k = d.idx.shape
    he, hf, nw, kdim = d.dims
    w2, b2, wf1, bf1, wf2, bf2 = weights
    layout, stride = _grad_layout(c.gs_n, he, c.ns, hf, nw, bsz)
    part, flat = _grad_scratch(stride, dev)
    ck, gs_off, _ = c.device_tables(dev)
    w_meta, in_meta = c.device_bwd_tables(dev)
    rev_off, rev_tgt, rev_src = reverse_neighbours(d.idx, d.valid)
    g = _arg(g, (bsz, n, c.dout), dev)
    d_x = torch.empty(bsz, n, c.din, dtype=torch.float32, device=dev)
    w2t, wf1t, wf2t = _transposed(w2, wf1, wf2)
    rc = _library().dbfr_knn_bwd(
        _ptr(d.pos), _ptr(x), _ptr(d.idx), _ptr(d.valid), _ptr(w_in), _ptr(beff), _ptr(w2),
        _ptr(b2), _ptr(w2t), _ptr(wf1), _ptr(bf1), _ptr(wf2), _ptr(bf2), _ptr(wf1t),
        _ptr(wf2t), _ptr(ck), _ptr(gs_off), _ptr(w_meta), _ptr(in_meta), _ptr(rev_off),
        _ptr(rev_tgt), _ptr(rev_src), _ptr(g), _ptr(d_x), _ptr(part), _ptr(flat),
        bsz, n, k, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff, _stream())
    _check(rc, "knn_bwd")
    launches["knn_bwd"] += 1
    return d_x, _split_grads(flat, layout)


# ---------------------------------------------------------------------------
# finalize epilogue (B7-B9 with fin=, and B10): divide by max(count, 1) ->
# irreps-Linear mix -> irreps LayerNorm, component-major
# (nn/pallas_conv.py:_fin_twin, dense_mix_cm, ln_tables, make_ln_cm)
# ---------------------------------------------------------------------------

# input slots of one irrep type that an output slot mixes (kMixSegs, conv_fin.cuh)
MIX_SEGS = 4
# components of an irrep the LayerNorm statistics hold (kMaxComp: l <= 2)
MAX_COMP = 5


@dataclasses.dataclass(frozen=True)
class FinConsts:
    """Static tables of one conv's finalize (a layers.ConvSpec: dw TP output
    -> irreps Linear -> LayerNorm over `spec.out`)."""

    spec: ConvSpec

    @property
    def out_dim(self) -> int:
        return self.spec.out.dim

    @property
    def n_w(self) -> int:  # LayerNorm weights / mean shifts: one per slot channel
        return sum(mul for mul, _ in self.spec.out.items)

    @property
    def n_b(self) -> int:  # LayerNorm biases: one per 0e channel
        return self.spec.out.num_scalars

    @functools.cached_property
    def tables(self):
        """(mix_meta [out_dim, 16], ln_slots [n_slots, 8]) int32.

        mix_meta row j (component-major output column j = off3 + k mul3 + v
        of slot i3): nseg, mul3, then per input slot s of the same irrep
        type (in_base = o + k m, m, w_base = w_off + r mul3 + v), so that
        y[j] = sum_s sum_u x[in_base + u] w[w_base + u mul3] (apply_linear_cm);
        entry 14 is i3 and 15 is k. ln_slots row i3: off, mul, d, iw (first
        weight / mean shift), ib (first bias, -1 unless 0e)."""
        out, lin = self.spec.out, self.spec.lin
        blocks = {blk[1]: blk for blk in lin.blocks}
        meta = np.zeros((out.dim, 16), np.int32)
        slots = np.zeros((len(out.items), 8), np.int32)
        iw = ib = 0
        for i3, (off3, mul3, ir3) in enumerate(out.slices()):
            d = ir3.dim
            if d > MAX_COMP:
                raise ValueError(f"finalize kernels take l <= 2, not {ir3}")
            is_0e = ir3.l == 0 and ir3.p == 1
            slots[i3, :5] = (off3, mul3, d, iw, ib if is_0e else -1)
            iw += mul3
            ib += mul3 if is_0e else 0
            ins, w_off = (blocks[i3][0], blocks[i3][2]) if i3 in blocks else ((), 0)
            if len(ins) > MIX_SEGS:
                raise ValueError(f"finalize kernels mix at most {MIX_SEGS} input slots")
            for k in range(d):
                for v in range(mul3):
                    row = meta[off3 + k * mul3 + v]
                    row[0], row[1], row[14], row[15] = len(ins), mul3, i3, k
                    r = 0
                    for s, (o, m) in enumerate(ins):
                        row[2 + 3 * s : 5 + 3 * s] = (o + k * m, m, w_off + r * mul3 + v)
                        r += m
        return meta, slots

    def device_tables(self, device):
        """(mix_meta, ln_slots) tensors on `device`, cached."""
        return _device_fin_tables(self, str(device))


@functools.lru_cache(maxsize=None)
def _device_fin_tables(f: FinConsts, device: str):
    return tuple(torch.from_numpy(t).to(device) for t in f.tables)


def finalize_plain(fin: FinConsts, p, agg, cnt):
    """Plain finalize: agg [..., dout] sums / max(cnt, 1) -> mix -> LayerNorm;
    p = {"mix": weight vector, "ln": LayerNorm dict}."""
    return tp_conv_finalize_cm(p, fin.spec, agg / torch.clamp(cnt, min=1.0)[..., None])


def pair_conv_fin_plain(c: ConvConsts, fin: FinConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask,
                        src_mask, cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask, cnt):
    """Plain B8 (make_pair_twin(fin=)): params also hold "mix" and "ln"."""
    return finalize_plain(fin, params, pair_conv_plain(
        c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t, cab_s, temb, cutoff,
        params, bond_feat, bond_mask), cnt)


def cross_conv_fin_plain(c: ConvConsts, fin: FinConsts, lig_pos, atm_pos, lig_x, atm_x, lig_mask,
                         atm_mask, cabflag, temb, cutoff, emb_params, fc_al, fc_la, fin_al,
                         fin_la, cnt_al, cnt_la):
    """Plain B7 (make_cross_twin(fin=)): finished (al [B, nl, out_dim],
    la [B, na, out_dim])."""
    al, la = cross_conv_plain(c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag,
                              temb, cutoff, emb_params, fc_al, fc_la)
    return finalize_plain(fin, fin_al, al, cnt_al), finalize_plain(fin, fin_la, la, cnt_la)


def knn_conv_fin_plain(c: ConvConsts, fin: FinConsts, pos, x, mask, idx, valid, temb, params):
    """Plain B9 (make_knn_twin(fin=)): finalized by the count of valid slots."""
    return finalize_plain(fin, params, knn_conv_plain(c, pos, x, mask, idx, valid, temb, params),
                          valid.float().sum(-1))


def _flatten(tree, leaves: list):
    """Structure of `tree` (nested dicts / lists / tuples) with each tensor
    replaced by its index in `leaves`, where it is appended."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return ("t", len(leaves) - 1)
    if isinstance(tree, dict):
        return ("d", {k: _flatten(v, leaves) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return ("l", type(tree), [_flatten(v, leaves) for v in tree])
    return ("c", tree)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "t":
        return leaves[spec[1]]
    if kind == "d":
        return {k: _unflatten(v, leaves) for k, v in spec[1].items()}
    if kind == "l":
        return spec[1](_unflatten(v, leaves) for v in spec[2])
    return spec[1]


class _PlainBackwardFn(torch.autograd.Function):
    """Forward: `kernel(*args)`; backward: autograd through `plain(*args)`,
    recomputed (the JAX package's custom-VJP rule for B7-B10). Every tensor
    of `args` is an input, so gradients reach whatever the plain version
    differentiates."""

    @staticmethod
    def forward(ctx, kernel, plain, spec, *leaves):
        ctx.plain, ctx.spec = plain, spec
        ctx.save_for_backward(*leaves)
        return kernel(*_unflatten(spec, leaves))

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_(True) if n and t.is_floating_point() else t.detach()
                  for t, n in zip(saved, need)]
        diff = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*_unflatten(ctx.spec, leaves))
            outs = out if isinstance(out, tuple) else (out,)
            grads = torch.autograd.grad(outs, diff, gs, allow_unused=True) if diff else ()
        it = iter(grads)
        return (None, None, None, *[next(it) if t.requires_grad else None for t in leaves])


def _with_plain_backward(kernel, plain, *args):
    leaves: list = []
    spec = _flatten(args, leaves)
    return _PlainBackwardFn.apply(kernel, plain, spec, *leaves)


def _fin_ptrs(fin: FinConsts, p, cnt, rows, dev):
    """Kernel arguments of one finalize: pointers to (cnt, mix, ln weight,
    mean shift, bias), and those tensors, which the caller holds through
    the launch."""
    ln = p["ln"]
    ts = [_arg(cnt, rows, dev), _arg(p["mix"], (fin.spec.lin.weight_numel,), dev),
          _arg(ln["weight"], (fin.n_w,), dev), _arg(ln["mean_shift"], (fin.n_w,), dev),
          _arg(ln["bias"], (fin.n_b,), dev)]
    return [_ptr(t) for t in ts], ts


def _fin_tail(fin: FinConsts, dev):
    mix_meta, ln_slots = fin.device_tables(dev)
    return [_ptr(mix_meta), _ptr(ln_slots)], [fin.out_dim, len(fin.spec.out.items),
                                              fin.spec.lin.weight_numel]


# ---- B8 pair conv with finalize --------------------------------------------


def pair_conv_fin(c: ConvConsts, fin: FinConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask,
                  src_mask, cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask, cnt):
    """B8: pair_conv's sums finalized in the kernel -> [B, nt, out_dim]."""
    args = (c, fin, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t, cab_s, temb,
            cutoff, params, bond_feat, bond_mask, cnt)
    if not tgt_x.is_cuda:
        return pair_conv_fin_plain(*args)
    return _with_plain_backward(_pair_fin_kernel, pair_conv_fin_plain, *args)


def _pair_fin_kernel(c, fin, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t, cab_s,
                     temb, cutoff, params, bond_feat, bond_mask, cnt):
    data, tx, sx, w_in, beff, *weights = _pair_inputs(
        c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_s, temb, cutoff, params,
        bond_feat, bond_mask)
    d, dev = data, tx.device
    bsz, nt, nsrc = tx.shape[0], tx.shape[1], sx.shape[1]
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(dev)
    fptrs, _keep = _fin_ptrs(fin, params, cnt, (bsz, nt), dev)
    tptrs, tints = _fin_tail(fin, dev)
    out = torch.empty(bsz, nt, fin.out_dim, dtype=torch.float32, device=dev)
    rc = _library().dbfr_pair_conv_fin(
        _ptr(d.tgt_pos), _ptr(d.src_pos), _ptr(tx), _ptr(sx), _ptr(d.tgt_mask),
        _ptr(d.src_mask), _ptr(d.cab_s), 0, _ptr(d.cut), _ptr(d.bond_feat), _ptr(d.bond_mask),
        _ptr(w_in), _ptr(beff), *[_ptr(v) for v in weights],
        _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(out),
        bsz, nt, nsrc, c.din, c.dout, d.nb, c.ns, he, hf, nw, kdim, c.gs_n,
        c.gs_coeff, 0, 1, *fptrs, *tptrs, *tints, _stream())
    _check(rc, "pair_conv_fin")
    launches["pair_conv_fin"] += 1
    return out


# ---- B7 cross conv with finalize -------------------------------------------


def cross_conv_fin(c: ConvConsts, fin: FinConsts, lig_pos, atm_pos, lig_x, atm_x, lig_mask,
                   atm_mask, cabflag, temb, cutoff, emb_params, fc_al, fc_la, fin_al, fin_la,
                   cnt_al, cnt_la):
    """B7: cross_conv's two sums finalized in the kernel -> (al [B, nl,
    out_dim], la [B, na, out_dim]); fin_al / fin_la = {"mix", "ln"}."""
    args = (c, fin, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, temb, cutoff,
            emb_params, fc_al, fc_la, fin_al, fin_la, cnt_al, cnt_la)
    if not lig_x.is_cuda:
        return cross_conv_fin_plain(*args)
    return _with_plain_backward(_cross_fin_kernel, cross_conv_fin_plain, *args)


def _cross_fin_kernel(c, fin, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, temb,
                      cutoff, emb_params, fc_al, fc_la, fin_al, fin_la, cnt_al, cnt_la):
    data, lx, ax, w_in, beff, *weights = _cross_inputs(
        c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, temb, cutoff,
        emb_params, fc_al, fc_la)
    d, dev = data, lx.device
    bsz, nl, na = lx.shape[0], lx.shape[1], ax.shape[1]
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(dev)
    al_ptrs, _keep_al = _fin_ptrs(fin, fin_al, cnt_al, (bsz, nl), dev)
    la_ptrs, _keep_la = _fin_ptrs(fin, fin_la, cnt_la, (bsz, na), dev)
    tptrs, tints = _fin_tail(fin, dev)
    al = torch.empty(bsz, nl, fin.out_dim, dtype=torch.float32, device=dev)
    la = torch.empty(bsz, na, fin.out_dim, dtype=torch.float32, device=dev)
    rc = _library().dbfr_cross_conv_fin(
        _ptr(d.lig_pos), _ptr(d.atm_pos), _ptr(lx), _ptr(ax), _ptr(d.lig_mask),
        _ptr(d.atm_mask), _ptr(d.cab), _ptr(d.cut), _ptr(w_in), _ptr(beff),
        *[_ptr(v) for v in weights], _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(al), _ptr(la),
        bsz, nl, na, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff,
        *al_ptrs, *la_ptrs, *tptrs, *tints, _stream())
    _check(rc, "cross_conv_fin")
    launches["cross_conv_fin"] += 1
    return al, la


# ---- B9 knn conv with finalize ---------------------------------------------


def knn_conv_fin(c: ConvConsts, fin: FinConsts, pos, x, mask, idx, valid, temb, params):
    """B9: knn_conv's sums finalized in the kernel by the count of valid
    neighbour slots -> [B, N, out_dim]; params also hold "mix" and "ln"."""
    args = (c, fin, pos, x, mask, idx, valid, temb, params)
    if not x.is_cuda:
        return knn_conv_fin_plain(*args)
    return _with_plain_backward(_knn_fin_kernel, knn_conv_fin_plain, *args)


def _knn_fin_kernel(c, fin, pos, x, mask, idx, valid, temb, params):
    data, xx, w_in, beff, *weights = _knn_inputs(c, pos, x, idx, valid, temb, params)
    d, dev = data, xx.device
    bsz, n, k = d.idx.shape
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(dev)
    fptrs, _keep = _fin_ptrs(fin, params, d.valid.sum(-1), (bsz, n), dev)
    tptrs, tints = _fin_tail(fin, dev)
    out = torch.empty(bsz, n, fin.out_dim, dtype=torch.float32, device=dev)
    rc = _library().dbfr_knn_conv_fin(
        _ptr(d.pos), _ptr(xx), _ptr(d.idx), _ptr(d.valid), None, _ptr(w_in), _ptr(beff),
        *[_ptr(v) for v in weights], _ptr(ck), _ptr(gs_off), _ptr(meta), _ptr(out),
        bsz, n, k, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff,
        *fptrs, *tptrs, *tints, _stream())
    _check(rc, "knn_conv_fin")
    launches["knn_conv_fin"] += 1
    return out
