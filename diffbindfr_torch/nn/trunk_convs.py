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
their design does about it is in csrc/conv_fwd_wide.cuh (B1, B7 and
B11-cross: one grid of 64-pair tiles for both directions, rows per block
from cross_row_groups; B3, B9 and B11-knn: one knn grid, atoms per block
from knn_row_groups; B2, B8 and B11-pair: one grid of ligand rows, rows per
block from pair_row_groups; B11's bf16 chain runs in the same tiles),
csrc/conv_bwd_wide.cuh, csrc/dense_pairs.cuh and csrc/abt_gemm.cuh (B4, B5,
B6), csrc/trunk_conv.cuh (the geometry, masks and pair compaction they
share) and the kernel sources. B4's, B5's and B6's plain versions,
cross_bwd_plain, pair_bwd_plain and knn_bwd_plain, are models of their
kernels' decomposition (pair list, per-pair rows, contractions, node sums)
that cross_bwd, pair_bwd and knn_bwd run on CPU tensors. B1's, B7's and
B11-cross's block and tile plan has its plain model in cross_tile_plan and
cross_conv_tiled_plain (bf16_chain for B11-cross) /
cross_conv_fin_tiled_plain, B3's, B9's and B11-knn's in knn_tile_plan and
knn_conv_tiled_plain (bf16_chain for B11-knn) / knn_conv_fin_tiled_plain,
B2's, B8's and B11-pair's in pair_tile_plan and pair_conv_tiled_plain
(bf16_chain for B11-pair) / pair_conv_fin_tiled_plain, which the CPU tests
hold against the plain versions and the JAX kernels.
"""
from __future__ import annotations

import contextlib
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
    "dbfr_pair_conv": [_P, _I, _P, _I, _P, _I, _P],
    "dbfr_cross_conv": [_P, _I, _P, _I, _P, _I, _P],
    "dbfr_cross_conv_bf16": [_P, _I, _P, _I, _P, _I, _P],
    # B3: the conv's arguments, then atoms per block and the per-block cycles
    "dbfr_knn_conv": [_P] * 17 + [_I] * 11 + [_F, _I, _P, _P],
    "dbfr_pair_pairs": [_P] * 12 + [_I] * 3 + [_P],
    "dbfr_pair_bwd": [_P] * 37 + [_I] * 21 + [_F, _P],
    "dbfr_cross_pairs": [_P] * 11 + [_I] * 3 + [_P],
    "dbfr_cross_bwd": [_P] * 46 + [_I] * 20 + [_F, _P],
    "dbfr_knn_bwd": [_P] * 35 + [_I] * 19 + [_F, _P],
    "dbfr_pair_conv_fin": [_P, _I, _P, _I, _P, _I, _P],
    "dbfr_cross_conv_fin": [_P, _I, _P, _I, _P, _I, _P],
    "dbfr_knn_conv_fin": [_P] * 17 + [_I] * 11 + [_F] + [_P] * 7 + [_I] * 3 + [_I, _P, _P],
    "dbfr_layer_conv": [_P, _I, _P, _I, _P, _I, _P],
}
# B11-pair and B11-knn: the same arguments as B2 and B3
_ARGTYPES["dbfr_pair_conv_bf16"] = _ARGTYPES["dbfr_pair_conv"]
_ARGTYPES["dbfr_knn_conv_bf16"] = _ARGTYPES["dbfr_knn_conv"]
# the widest product of the wide tiles: output columns l + 32 j of a lane,
# j < 10 (wide_gemm, conv_bwd_wide.cuh)
_WIDE_COLS = 320
# pairs per block of B4's, B5's and B6's wide-tile pass; their scratch rows
# are a multiple of this apart (kWideTile, conv_bwd_wide.cuh)
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


@contextlib.contextmanager
def _on_device(dev):
    """Launches inside run on `dev`, the device of their tensors: the host
    thread's current device is set to it (a kernel launches on the current
    device), and the handle yielded is that device's current stream."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


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
    widest product the wide tiles compute (the MLPs' outputs, and the
    backward's 3 ns); kdim is bounded by the plan's shared memory, which the
    C entry points check."""
    he, hf, nw = emb_w2.shape[0], fc_w1.shape[1], c.spec.weight_numel
    kdim = c.tables[0].shape[1]
    if max(he, hf, nw, 3 * c.ns) > _WIDE_COLS:
        raise ValueError(f"trunk conv kernels tile at most {_WIDE_COLS} columns")
    return he, hf, nw, kdim


def _check_nodes(name: str, *counts):
    if max(counts) >= 1 << 16:
        raise ValueError(f"{name}: at most 65535 nodes per side")


def _grad_layout(ke: int, he: int, ns: int, hf: int, nw: int, bsz: int):
    """Offsets of the backward kernels' parameter gradients (each one of
    the contractions' results, abt_gemm.cuh out_off: dW1 and its per-sample
    bias rows, dW2 and db2, dWf1 and dbf1, dWf2 and dbf2) and the row
    stride."""
    shapes = (("w_in", (ke, he)), ("beff", (bsz, he)), ("w2", (he, ns)), ("b2", (ns,)),
              ("wf1", (3 * ns, hf)), ("bf1", (hf,)), ("wf2", (hf, nw)), ("bf2", (nw,)))
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, shape)
        off += int(np.prod(shape))
    return out, (off + 3) & ~3


def _split_grads(flat, layout):
    return {k: flat[o : o + int(np.prod(shape))].view(shape) for k, (o, shape) in layout.items()}


def _transposed(*ws):
    return [w.t().contiguous() for w in ws]


@dataclasses.dataclass
class _DensePairs:
    """The pair counts of a dense conv's backward (B4: dbfr_cross_pairs, B5:
    dbfr_pair_pairs; csrc/dense_pairs.cuh): per target row the rank of each
    valid source (pid) and the target rows' and sources' exclusive prefix
    sums; the total copied to pinned host memory, complete when `done` is."""

    pid: torch.Tensor
    tgt_off: torch.Tensor
    src_off: torch.Tensor
    keep: tuple
    total: torch.Tensor
    done: torch.cuda.Event

    @classmethod
    def start(cls, fn, name, st, dev, bsz, nt, nsrc, *inputs):
        """Launch the counts (fn: dbfr_cross_pairs or dbfr_pair_pairs, on
        the tensors `inputs`) and queue the copy of the total to the host."""
        i32 = dict(dtype=torch.int32, device=dev)
        pid = torch.empty(bsz, nt, nsrc, **i32)
        cnt_t, tgt_off = torch.empty(bsz * nt, **i32), torch.empty(bsz * nt + 1, **i32)
        cnt_s, src_off = torch.empty(bsz * nsrc, **i32), torch.empty(bsz * nsrc + 1, **i32)
        _check(fn(*[_ptr(t) for t in inputs], _ptr(pid), _ptr(cnt_t), _ptr(tgt_off), _ptr(cnt_s),
                  _ptr(src_off), bsz, nt, nsrc, st), name)
        total = torch.empty(1, dtype=torch.int32, pin_memory=dev.type == "cuda")
        total.copy_(tgt_off[-1:], non_blocking=True)
        done = torch.cuda.Event() if dev.type == "cuda" else None
        if done is not None:
            done.record()
        return cls(pid, tgt_off, src_off, (cnt_t, cnt_s), total, done)

    def count(self) -> int:
        if self.done is not None:
            self.done.synchronize()
        return int(self.total[0])


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
        lib = _library()
        with _on_device(tgt_x.device) as st:
            out = _pair_conv_kernel(lib, data, tgt_x, src_x, w_in, beff, weights, st)
            # B5's pair counts start here, so that its backward reads the count
            # it sizes its scratch by without waiting for the queue to drain
            ctx.pairs = (_pair_pairs(lib, st, data, tgt_x.shape[0], tgt_x.shape[1],
                                     src_x.shape[1])
                         if any(ctx.needs_input_grad) else None)
        return out

    @staticmethod
    def backward(ctx, g):
        tgt_x, src_x, w_in, beff, *weights = ctx.saved_tensors
        d_tgt, d_src, gr = pair_bwd(ctx.data, tgt_x, src_x, w_in, beff, weights, g,
                                    pairs=ctx.pairs)
        return (None, d_tgt, d_src, gr["w_in"], gr["beff"], gr["w2"], gr["b2"], gr["wf1"],
                gr["bf1"], gr["wf2"], gr["bf2"])


def _pair_conv_kernel(lib, data, tgt_x, src_x, w_in, beff, weights, stream, cycles=None):
    """One launch of B2 ("pair_conv") or, with the data's bf16_chain, B11-pair
    ("pair_conv_bf16") on csrc/pair_conv.cu's grid of ligand rows
    (_pair_wide)."""
    name = "pair_conv_bf16" if data.bf16_chain else "pair_conv"
    return _pair_wide(lib, name, data, tgt_x, src_x, w_in, beff, weights, stream, cycles=cycles)


# what the last pair_bwd call on the card did: its pair count, the pass's
# 64-pair tiles and the SMs they fill, K chunks and scratch bytes
# (chip_smoke.py reports them)
pair_bwd_stats: dict = {}


def pair_bwd(data, tgt_x, src_x, w_in, beff, weights, g, pairs=None):
    """B5: (d_tgt, d_src, parameter gradients) of pair_conv for the output
    cotangent g. On CUDA tensors the kernels of csrc/pair_bwd.cu: the valid
    pairs as one list (their count read to the host, to size the scratch:
    counted here, or, from the autograd forward, by `pairs`), one wide-tile
    pair pass writing feature-major rows (the edge input [Gaussian | bond
    features]), one grouped launch of the split-K contraction that turns
    them into every parameter gradient, then the per-node sums of the pairs'
    rows: d_tgt over the targets' segments, d_src over the sources'. On CPU
    tensors the plain model of that decomposition, pair_bwd_plain."""
    c, dev = data.c, tgt_x.device
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    g = _arg(g, (bsz, nt, c.dout), dev)
    if not tgt_x.is_cuda:
        return pair_bwd_plain(data, tgt_x, src_x, w_in, beff, weights, g)
    lib = _library()
    with _on_device(dev) as st:
        if pairs is None:
            pairs = _pair_pairs(lib, st, data, bsz, nt, nsrc)
        return _pair_bwd_kernel(lib, st, data, tgt_x, src_x, w_in, beff, weights, g, pairs)


def _pair_pairs(lib, st, data, bsz, nt, nsrc):
    """B5's pair counts (dbfr_pair_pairs): the pair conv's mask, as the
    forward decides it, over every (target, source) of the batch."""
    d = data
    return _DensePairs.start(lib.dbfr_pair_pairs, "pair_pairs", st, d.tgt_pos.device, bsz, nt,
                             nsrc, d.tgt_pos, d.src_pos, d.tgt_mask, d.src_mask, d.cab_s, d.cut,
                             d.bond_mask)


def _pair_bwd_kernel(lib, st, data, tgt_x, src_x, w_in, beff, weights, g, pairs):
    c, d, dev = data.c, data, tgt_x.device
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    he, hf, nw, kdim = d.dims
    ns, din, ke = c.ns, c.din, c.gs_n + d.nb
    weights = [_aligned(w) for w in weights]
    w2, b2, wf1, bf1, wf2, bf2 = weights
    w_in = _aligned(w_in)
    layout, stride = _grad_layout(ke, he, ns, hf, nw, bsz)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    n_pairs = pairs.count()  # the scratch is sized by it
    ld = -(-n_pairs // WIDE_TILE) * WIDE_TILE
    pair_t, pair_s, pair_b = (torch.empty(ld, **i32) for _ in range(3))
    at_src, sample_off = torch.empty(n_pairs, **i32), torch.empty(bsz + 1, **i32)
    rows = torch.empty(_wide_row_count(ke, he, ns, hf, nw), ld, **f32)
    tgt_rows, src_rows = torch.empty(ld, ns, **f32), torch.empty(ld, din, **f32)
    sms = contraction.sm_count(str(dev))
    n_tiles = sum(contraction.tiles(m, q) for m, q in _wide_problems(ke, he, ns, hf, nw, bsz))
    splits = contraction.max_splits(n_tiles, ld, sms)
    part = torch.empty(splits, stride, **f32)
    flat = torch.empty(stride, **f32)
    d_tgt, d_src = torch.empty(bsz, nt, din, **f32), torch.empty(bsz, nsrc, din, **f32)
    ck, gs_off, _ = c.device_tables(dev)
    w_meta, in_off, in_ent = c.device_wide_tables(dev)
    w2t, wf1t, wf2t = [_aligned(t) for t in _transposed(w2, wf1, wf2)]
    rc = lib.dbfr_pair_bwd(
        _ptr(d.tgt_pos), _ptr(d.src_pos), _ptr(tgt_x), _ptr(src_x), _ptr(d.bond_feat),
        _ptr(w_in), _ptr(beff), _ptr(w2), _ptr(b2), _ptr(w2t), _ptr(wf1), _ptr(bf1), _ptr(wf2),
        _ptr(bf2), _ptr(wf1t), _ptr(wf2t), _ptr(ck), _ptr(gs_off), _ptr(w_meta), _ptr(in_off),
        _ptr(in_ent), _ptr(g), _ptr(pairs.pid), _ptr(pairs.tgt_off), _ptr(pairs.src_off),
        _ptr(pair_t), _ptr(pair_s), _ptr(pair_b), _ptr(at_src), _ptr(sample_off), _ptr(rows),
        _ptr(tgt_rows), _ptr(src_rows), _ptr(part), _ptr(flat), _ptr(d_tgt), _ptr(d_src), bsz,
        nt, nsrc, din, c.dout, d.nb, ns, he, hf, nw, kdim, c.gs_n, in_ent.shape[0], n_pairs, ld,
        layout["w_in"][0], layout["w2"][0], layout["wf1"][0], layout["wf2"][0], stride, splits,
        c.gs_coeff, st)
    _check(rc, "pair_bwd")
    launches["pair_bwd"] += 1
    scratch = (pairs.pid, *pairs.keep, pairs.tgt_off, pairs.src_off, pair_t, pair_s, pair_b,
               at_src, sample_off, rows, tgt_rows, src_rows, part)
    tiles = ld // WIDE_TILE
    pair_bwd_stats.update(pairs=n_pairs, tiles=tiles, sms=min(tiles, sms), splits=splits,
                          scratch_bytes=sum(t.numel() * t.element_size() for t in scratch))
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
        lib = _library()
        with _on_device(lig_x.device) as st:
            out = _cross_conv_kernel(lib, data, lig_x, atm_x, w_in, beff, weights, st)
            # B4's pair counts start here, so that its backward reads the count
            # it sizes its scratch by without waiting for the queue to drain
            ctx.pairs = (_cross_pairs(lib, st, data, lig_x.shape[0], lig_x.shape[1],
                                      atm_x.shape[1])
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


def _cross_conv_kernel(lib, data, lig_x, atm_x, w_in, beff, weights, stream, cycles=None):
    """B1, or with the data's bf16_chain B11-cross: one launch of the
    wide-tile grid (_cross_wide)."""
    name = "cross_conv_bf16" if data.bf16_chain else "cross_conv"
    return _cross_wide(lib, name, data, lig_x, atm_x, w_in, beff, weights, stream, cycles=cycles)


# Order of B1's, B7's and B11-cross's pointer and int arguments: the enums
# CrossPtr and CrossInt of csrc/cross_conv.cu, name for name.
_FIN_KEYS = ("cnt", "mix", "ln_w", "ln_ms", "ln_b")
_CROSS_WEIGHTS = ("w2", "b2", *[f"{d}_{w}" for d in ("al", "la") for w in ("w1", "b1", "w2", "b2")])
CROSS_PTRS = (
    "lig_pos", "atm_pos", "lig_x", "atm_x", "lig_mask", "atm_mask", "cab", "cut", "w_in", "beff",
    *_CROSS_WEIGHTS, "ck", "gs_off", "out_meta", "out_al", "out_la",
    *[f"{d}_{k}" for d in ("al", "la") for k in _FIN_KEYS], "mix_meta", "ln_slots", "cycles")
CROSS_INTS = ("batch", "nl", "na", "din", "dout", "ns", "he", "hf", "nw", "kdim", "gs_n",
              "out_dim", "n_slots", "mix_numel", "lig_rows", "atom_rows")

# what the last B1 / B7 / B11-cross launch on the card used, by launch
# counter: rows per block (g_l, g_a) and the block's shared memory
# (chip_smoke.py reports them)
cross_conv_stats: dict = {}


def _cross_wide(lib, name, data, lig_x, atm_x, w_in, beff, weights, stream, fin=None,
                fin_ts=(), cycles=None):
    """One launch of csrc/cross_conv.cu's wide-tile grid: B1 (name
    "cross_conv": the two directions' sums), B11-cross ("cross_conv_bf16":
    the same with the bf16 chain) or B7 ("cross_conv_fin": fin a FinConsts,
    fin_ts the al and la finalize tensors of _fin_ptrs), the rows per block
    from cross_row_groups. `cycles`, an int64 tensor of one entry
    per block (cross_tile_plan's order), receives each block's clock64()
    cycles (chip_smoke.py's share of each kind of block)."""
    c, d, dev = data.c, data, lig_x.device
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(dev)
    width = c.dout if fin is None else fin.out_dim
    al = torch.empty(bsz, nl, width, dtype=torch.float32, device=dev)
    la = torch.empty(bsz, na, width, dtype=torch.float32, device=dev)
    ints = {"batch": bsz, "nl": nl, "na": na, "din": c.din, "dout": c.dout, "ns": c.ns,
            "he": he, "hf": hf, "nw": nw, "kdim": kdim, "gs_n": c.gs_n, "out_dim": 0,
            "n_slots": 0, "mix_numel": 0}
    # cp.async stages the MLP weights 16 bytes at a time
    t = {"lig_pos": d.lig_pos, "atm_pos": d.atm_pos, "lig_x": lig_x, "atm_x": atm_x,
         "lig_mask": d.lig_mask, "atm_mask": d.atm_mask, "cab": d.cab, "cut": d.cut,
         "w_in": _aligned(w_in), "beff": beff, "ck": ck, "gs_off": gs_off, "out_meta": meta,
         "out_al": al, "out_la": la, "cycles": cycles}
    t.update(zip(_CROSS_WEIGHTS, [_aligned(w) for w in weights]))
    if fin is not None:
        mix_meta, ln_slots = fin.device_tables(dev)
        ints.update(out_dim=fin.out_dim, n_slots=len(fin.spec.out.items),
                    mix_numel=fin.spec.lin.weight_numel)
        t.update(mix_meta=mix_meta, ln_slots=ln_slots)
        for side, ts in zip(("al", "la"), fin_ts):
            t.update({f"{side}_{k}": v for k, v in zip(_FIN_KEYS, ts)})
    ints["bf16_chain"] = int(name == "cross_conv_bf16")  # the plan's, not an argument
    g_l, g_a = ints["lig_rows"], ints["atom_rows"] = cross_row_groups(
        ints, contraction.sm_count(str(dev)))
    cross_conv_stats[name] = dict(groups=(g_l, g_a), smem_bytes=4 * cross_plan_words(ints, g_l,
                                                                                     g_a))
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.device != dev
                               or cycles.numel() != bsz * (-(-nl // g_l) + -(-na // g_a))):
        raise ValueError(f"{name}: cycles takes one int64 per block on the kernel's device")
    ptr_arr = (ctypes.c_void_p * len(CROSS_PTRS))(*[_ptr(t.get(k)) for k in CROSS_PTRS])
    int_arr = (ctypes.c_int * len(CROSS_INTS))(*[int(ints[k]) for k in CROSS_INTS])
    float_arr = (ctypes.c_float * 1)(c.gs_coeff)
    rc = getattr(lib, "dbfr_" + name)(ptr_arr, len(CROSS_PTRS), int_arr, len(CROSS_INTS),
                                      float_arr, 1, stream)
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
    lib = _library()
    with _on_device(dev) as st:
        if pairs is None:
            pairs = _cross_pairs(lib, st, data, bsz, nl, na)
        return _cross_bwd_kernel(lib, st, data, lig_x, atm_x, w_in, beff, weights, g_al, g_la,
                                 pairs)


def _cross_pairs(lib, st, data, bsz, nl, na):
    d = data
    return _DensePairs.start(lib.dbfr_cross_pairs, "cross_pairs", st, d.lig_pos.device, bsz, nl,
                             na, d.lig_pos, d.atm_pos, d.lig_mask, d.atm_mask, d.cab, d.cut)


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
    pid, lig_off, atm_off = pairs.pid, pairs.tgt_off, pairs.src_off
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
    na = atm_pos.shape[1]
    valid = cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut)
    pair_b, pair_l, pair_a = torch.nonzero(valid, as_tuple=True)
    zero = torch.zeros(1, dtype=torch.long, device=lig_pos.device)

    def offsets(counts):
        return torch.cat([zero, torch.cumsum(counts.reshape(-1), 0)])

    perm = torch.sort(pair_b * na + pair_a, stable=True).indices
    return (pair_l, pair_a, pair_b, offsets(valid.sum((1, 2))), offsets(valid.sum(2)),
            offsets(valid.sum(1)), perm)


def _tp_plain(c: ConvConsts, x, cb, w):
    """Per pair, the depthwise TP's message [P, dout] for the source rows x,
    cb = sh @ ck and the TP weights w, component-major: out[s3 + k mul + u]
    = w[w_off + u] sum_i x[s1 + i mul + u] cb[cb_off + i d3 + k]."""
    out = x.new_zeros(x.shape[0], c.dout)
    for m in c.path_metas:
        d1, d3, mul, s1, wo = m["d1"], m["d3"], m["mul"], m["s1"], m["w_off"]
        xp = x[:, s1 : s1 + d1 * mul].unflatten(-1, (d1, mul))
        cp = cb[:, m["cb_off"] : m["cb_off"] + d1 * d3].unflatten(-1, (d1, d3))
        z = torch.einsum("pim,pik->pkm", xp, cp) * w[:, None, wo : wo + mul]
        out[:, m["s3"] : m["s3"] + d3 * mul] = z.flatten(1)
    return out


def pair_chain_plain(c: ConvConsts, vec, tgt_x, src_x, extra, w_in, beff, w2, b2, wf1, bf1,
                     wf2, bf2):
    """The per-pair forward chain of the wide-tile kernels (csrc/
    conv_fwd_wide.cuh, and the recompute in conv_bwd_wide.cuh): vec [P, 3] =
    the geometry's source - target, the pairs' target and source feature
    rows (component-major), the edge input's extra rows (bond features, or
    None), the folded edge MLP (w_in over [Gaussian | extra], beff for the
    pairs' samples), W2, b2 and the TP-weight MLP. Returns the edge input,
    h1, e = [attr | tgt scalars | src scalars], h, the TP weights w and
    cb = sh @ ck, each [P, features]."""
    inp = _gauss(c, _dist(vec))
    if extra is not None:
        inp = torch.cat([inp, extra], dim=-1)
    h1 = torch.relu(inp @ w_in + beff)
    e = torch.cat([h1 @ w2 + b2, tgt_x[:, : c.ns], src_x[:, : c.ns]], dim=-1)
    h = torch.relu(e @ wf1 + bf1)
    return inp, h1, e, h, h @ wf2 + bf2, sh_l2(vec) @ c.device_tables(vec.device)[0]


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


def wide_pass_plain(c: ConvConsts, pairs, vec, tgt_x, src_x, gout, w_in, beff, w2, b2, wf1,
                    bf1, wf2, bf2, extra=None):
    """One direction's wide-tile pass, plain (csrc/conv_bwd_wide.cuh; B4 per
    direction, B5, B6): pairs = (target, source, sample) index tensors, vec
    [P, 3] = the geometry's source - target (B4: atom - ligand in both),
    extra [P, nb] the edge input's rows after the Gaussian ones (B5: the
    pairs' bond features; None: none, w_in has the Gaussian rows alone).
    Returns the feature-major rows that the parameter gradients contract
    ({in, h1, dh1, dea, e, dh, h, dw}, each [features, P]), the pairs' rows
    of d / d target scalars [P, ns] and of d / d source features [P, din]."""
    t, s, b = pairs
    ns = c.ns
    inp, h1, e, h, w, cb = pair_chain_plain(c, vec, tgt_x[b, t], src_x[b, s], extra, w_in,
                                            beff[b], w2, b2, wf1, bf1, wf2, bf2)
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
    (cross_pairs_plain), per direction the pass's rows (wide_pass_plain)
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
        rows, node_rows[name + "_tgt"], node_rows[name + "_src"] = wide_pass_plain(
            c, pairs, vec, tx, sx, g, w_in, beff, w2, b2, *fc)
        w_in_b = contraction.contract_plain(rows["in"], rows["dh1"], sample_off)
        w2_b = contraction.contract_plain(rows["h1"], rows["dea"])
        wf1_b = contraction.contract_plain(rows["e"], rows["dh"])
        wf2_b = contraction.contract_plain(rows["h"], rows["dw"])
        grads[name] = {"w_in": w_in_b[: c.gs_n], "beff": w_in_b[c.gs_n :], "w2": w2_b[:he],
                       "b2": w2_b[he], "wf1": wf1_b[: 3 * ns], "bf1": wf1_b[3 * ns],
                       "wf2": wf2_b[:hf], "bf2": wf2_b[hf]}

    pad = (0, din - ns)
    lig_rows = node_rows["la_src"] + torch.nn.functional.pad(node_rows["al_tgt"], pad)
    atm_rows = node_rows["al_src"] + torch.nn.functional.pad(node_rows["la_tgt"], pad)
    d_lig = _segment_sum(lig_rows, lig_off, bsz * nl).view(bsz, nl, din)
    d_atm = _segment_sum(atm_rows[perm], atm_off, bsz * na).view(bsz, na, din)
    return d_lig, d_atm, grads["al"], grads["la"]


# ---- B5's decomposition, plain -------------------------------------------


def pair_valid(tgt_pos, src_pos, tgt_mask, src_mask, cab, cut, bond_mask):
    """The pair conv's valid (target, source) pairs [B, nt, nsrc], as the
    kernels decide them (trunk_conv.cuh dense_valid): both nodes valid, and
    the source a cab node or within the sample's cutoff and not the target
    itself, or the two bonded."""
    nt, nsrc = tgt_pos.shape[1], src_pos.shape[1]
    dev = tgt_pos.device
    d = _dist(src_pos[:, None, :, :] - tgt_pos[:, :, None, :])
    other = torch.arange(nt, device=dev)[:, None] != torch.arange(nsrc, device=dev)[None, :]
    keep = (((cab[:, None, :] > 0) | (d <= cut[:, None, None])) & other) | (bond_mask > 0)
    return keep & (tgt_mask[:, :, None] > 0) & (src_mask[:, None, :] > 0)


def pair_pairs_plain(tgt_pos, src_pos, tgt_mask, src_mask, cab, cut, bond_mask):
    """The pair list of B5 (csrc/pair_bwd.cu, dense_pairs.cuh): the valid
    pairs of every sample in target-major order (b, t, s ascending), as
    (pair_t, pair_s, pair_b); sample_off [B + 1], tgt_off [B nt + 1] (the
    first pair of each target row), src_off [B nsrc + 1] (of each source, in
    the source-major permutation) and perm, the list indices in source-major
    order, list order kept within a source."""
    nsrc = src_pos.shape[1]
    valid = pair_valid(tgt_pos, src_pos, tgt_mask, src_mask, cab, cut, bond_mask)
    pair_b, pair_t, pair_s = torch.nonzero(valid, as_tuple=True)
    zero = torch.zeros(1, dtype=torch.long, device=tgt_pos.device)

    def offsets(counts):
        return torch.cat([zero, torch.cumsum(counts.reshape(-1), 0)])

    perm = torch.sort(pair_b * nsrc + pair_s, stable=True).indices
    return (pair_t, pair_s, pair_b, offsets(valid.sum((1, 2))), offsets(valid.sum(2)),
            offsets(valid.sum(1)), perm)


def pair_bwd_plain(data, tgt_x, src_x, w_in, beff, weights, g):
    """pair_bwd's plain version, a model of its decomposition: the pair list
    (pair_pairs_plain), the pass's rows (wide_pass_plain, the pairs' bond
    features as the edge input's extra rows) contracted over the pairs into
    each parameter gradient with its bias rows (contraction.contract_plain;
    db1_eff per sample segment), d_tgt the target-scalar rows summed per
    target row in list order, d_src the source rows summed per source in
    source-major order. Same returns as pair_bwd."""
    c, d = data.c, data
    bsz, nt, nsrc = tgt_x.shape[0], tgt_x.shape[1], src_x.shape[1]
    he, hf, _, _ = d.dims
    ns, din, ke = c.ns, c.din, c.gs_n + d.nb
    pt, ps, pb, sample_off, tgt_off, src_off, perm = pair_pairs_plain(
        d.tgt_pos, d.src_pos, d.tgt_mask, d.src_mask, d.cab_s, d.cut, d.bond_mask)
    vec = d.src_pos[pb, ps] - d.tgt_pos[pb, pt]
    rows, tgt_rows, src_rows = wide_pass_plain(c, (pt, ps, pb), vec, tgt_x, src_x, g, w_in, beff,
                                               *weights, extra=d.bond_feat[pb, pt, ps])
    w_in_b = contraction.contract_plain(rows["in"], rows["dh1"], sample_off)
    w2_b = contraction.contract_plain(rows["h1"], rows["dea"])
    wf1_b = contraction.contract_plain(rows["e"], rows["dh"])
    wf2_b = contraction.contract_plain(rows["h"], rows["dw"])
    grads = {"w_in": w_in_b[:ke], "beff": w_in_b[ke:], "w2": w2_b[:he], "b2": w2_b[he],
             "wf1": wf1_b[: 3 * ns], "bf1": wf1_b[3 * ns], "wf2": wf2_b[:hf], "bf2": wf2_b[hf]}
    d_tgt = _segment_sum(torch.nn.functional.pad(tgt_rows, (0, din - ns)), tgt_off, bsz * nt)
    d_src = _segment_sum(src_rows[perm], src_off, bsz * nsrc)
    return d_tgt.view(bsz, nt, din), d_src.view(bsz, nsrc, din), grads


# ---- the forward wide-tile plan (csrc/conv_fwd_wide.cuh): B1, B2, B3, B7,
# B8, B9, B10, B11 ---

_WIDE_S = WIDE_TILE + 4  # pair stride of the feature-major tiles (kWideS)
_WIDE_SW = _WIDE_S // 2  # and of a bf16 tile, in 32-bit words (kWideSW)
_WIDE_KT = 16  # weight rows per cp.async stage (kWideKT)
_STAT = 8  # LayerNorm statistics per (row, slot) (kStat)
_TP_PAIRS = 32  # source rows the TP stages at a time (kTpPairs)
SMEM_WORDS = 232448 // 4  # the H100's shared memory per block, 4-byte words
CROSS_ATOM_ROWS = 32  # the most atoms a B1 / B7 / B11-cross la block owns (cross_row_groups)
KNN_ATOM_ROWS = 32  # the most atoms a B3 / B9 / B11-knn block owns (knn_row_groups)
# valid share of the neighbour slots that knn_row_groups expects: the 3dbs
# bucket's 1024 atoms x 16 slots hold 9,567 valid pairs (927 real atoms)
KNN_SLOT_FILL = 0.58
# the most ligand rows a B2 / B8 / B11-pair block owns (pair_row_groups)
PAIR_LIG_ROWS = 32
# valid pairs per real ligand row that pair_row_groups expects: the 3dbs
# bucket's 35 real rows (of 128) hold 458 pairs a sample, 7,328 at B = 16
PAIR_ROW_PAIRS = 13.1
# a B8 block's finalize in tiles of pair work, which pair_row_groups charges
# every block, real rows or not: B9's finalize took ~35 us a block against
# ~70 us a tile (PERF.md section 6, PR 12)
PAIR_FIN_TILES = 0.5
# a B2 or B11-pair block's fixed cost in tiles of pair work, which
# pair_row_groups charges every block: the compaction scan of its g x nsrc
# candidates (two barriers per 256) and its rows' stores, zeros for padded
# rows; B8's blocks of padded rows took ~19% of a working block's ~1.8 tiles
# (PERF.md section 6, PR 13), nearly all of it the finalize
PAIR_SCAN_TILES = 0.05


def _r4(n: int) -> int:
    return (n + 3) & ~3


def fwd_regions(ke, ns, he, hf, nw, kdim, din, dout, out_dim, mix_numel, n_slots, g, per,
                bf16=False):
    """FwdPlan's regions (fwd_plan, conv_fwd_wide.cuh) in 4-byte words: p1,
    p2, sh, ws, ck, acc, oacc, stats, list, misc. bf16: the plan of the bf16
    chain (ConvArgs::bf16_chain), whose w, cb and staged source rows are
    bf16 tiles of _WIDE_SW words per row."""
    ws = _r4(2 * _WIDE_KT * 32 * -(-max(he, ns, hf, nw) // 32))
    if bf16:
        p1 = max(max(he, hf) * _WIDE_S, _r4(kdim * _WIDE_SW), _r4(g * out_dim))
        p2 = max(max(ke, 3 * ns) * _WIDE_S, _r4(nw * _WIDE_SW), _r4(mix_numel))
        ws = max(ws, _r4(din * _WIDE_SW))
    else:
        p1 = max(max(he, hf, kdim) * _WIDE_S, _r4(g * out_dim))
        p2 = max(max(ke, 3 * ns, nw) * _WIDE_S, _r4(mix_numel))
        ws = max(ws, _TP_PAIRS * _r4(din))
    return (p1, p2, 9 * _WIDE_S, ws, _r4(9 * kdim), _r4(g * dout), _r4(g * out_dim),
            _r4(g * n_slots * _STAT), _r4(g * per), 4 * WIDE_TILE + 8)


def _fin_after_sums(r, out_dim):
    """fin_after_sums (conv_fwd_wide.cuh) on fwd_regions' list: with a
    finalize, its output rows and statistics in the weight stages."""
    if out_dim > 0:
        r[3], r[6], r[7] = max(r[3], r[6] + r[7]), 0, 0
    return r


def cross_plan_words(ints: dict, g_l: int, g_a: int) -> int:
    """Shared memory of a B1 / B7 block (with a true ints["bf16_chain"], a
    B11-cross block) in 4-byte words (cross_plan, csrc/cross_conv.cu: the
    al and la plans, region by region the larger; with a finalize, out_dim
    > 0, its output rows and statistics in the weight stages), from the
    kernel's CROSS_INTS."""
    n, bf16 = ints, bool(ints.get("bf16_chain"))

    def conv(g, per):
        return fwd_regions(n["gs_n"], n["ns"], n["he"], n["hf"], n["nw"], n["kdim"], n["din"],
                           n["dout"], n["out_dim"], n["mix_numel"], n["n_slots"], g, per, bf16)

    return sum(_fin_after_sums([max(x) for x in zip(conv(g_l, n["na"]), conv(g_a, n["nl"]))],
                               n["out_dim"]))


def cross_row_groups(ints: dict, sms: int):
    """(g_l, g_a): ligand rows per al block and atoms per la block of B1 /
    B7 (with a true ints["bf16_chain"], of B11-cross, on its plan), picked
    on the host from the batch and the shapes; the masks are not read (no
    wait for the device: a CUDA graph captures the call).

    A real ligand row has ~230 cross pairs at the 3dbs bucket (~3.6 tiles),
    an atom ~9: the CA/CB atoms pair with every ligand row, the others only
    within the cutoff. So the al blocks that hold real rows are the grid's
    longest, and no block should outlast the SMs' mean share of the grid's
    tiles. The al and la directions have about as many tiles each, so the
    mean share is 2 B n_real / sms rows' worth, and g_l is the largest of
    4, 2, 1 with g_l <= 2 B n_real / sms. The host does not know n_real
    without reading the mask; it takes a quarter of the bucket, nl / 4 (the
    3dbs ligand fills 35 rows of 128), which errs toward smaller groups,
    whose cost is a few per cent of tile fill: g_l = 4 at B = 16, 1 at
    B = 4 and below, at nl = 128 on 132 SMs.
    An atom's few pairs fill a tile only over many atoms (3dbs: 79% at 16
    atoms, 85% at 22, 90% at 32), so g_a is as large as the shared memory
    holds, at most CROSS_ATOM_ROWS; then g_l halves until the block fits.
    B11-cross's half-size w and cb tiles free ~38 KB at flagship width, so
    its la blocks take CROSS_ATOM_ROWS atoms where B1's take 22."""
    g_l = next(g for g in (4, 2, 1) if g == 1 or 2 * g * sms <= ints["batch"] * ints["nl"])
    g_a = CROSS_ATOM_ROWS
    while cross_plan_words(ints, g_l, g_a) > SMEM_WORDS and g_a > 1:
        g_a -= 1
    while cross_plan_words(ints, g_l, g_a) > SMEM_WORDS and g_l > 1:
        g_l //= 2
    if cross_plan_words(ints, g_l, g_a) > SMEM_WORDS:
        raise ValueError("cross_conv: one block's tile does not fit the shared memory")
    return g_l, g_a


def knn_plan_words(ints: dict, g_k: int) -> int:
    """Shared memory of a B3 block in 4-byte words (knn_plan, csrc/
    knn_conv.cu: fwd_plan of the conv in knn mode; with a finalize, out_dim
    > 0, B9's, its output rows and statistics in the weight stages; with a
    true bf16_chain, B11-knn's), from the kernel's sizes (_knn_ints): batch,
    n, k, din, dout, ns, he, hf, nw, kdim, gs_n, and bf16_chain, out_dim,
    n_slots, mix_numel. Sizes without bf16_chain are B11-knn's (the bf16
    plan), those without out_dim have no finalize."""
    n = ints
    fin = [n.get(key, 0) for key in ("out_dim", "mix_numel", "n_slots")]
    return sum(_fin_after_sums(list(fwd_regions(
        n["gs_n"], n["ns"], n["he"], n["hf"], n["nw"], n["kdim"], n["din"], n["dout"], *fin,
        g_k, n["k"], bf16=bool(n.get("bf16_chain", 1)))), fin[0]))


def knn_row_groups(ints: dict, sms: int) -> int:
    """g_k, the atoms per block of the knn grid (B3, B9, B11-knn), picked on
    the host from the batch, the shapes and the SM count on the plan of
    knn_plan_words; no mask or count is read (no wait for the device: a
    CUDA graph captures the call).

    One block runs per SM (its shared memory), and the blocks of the 1-D
    grid start as SMs come free, so the grid takes about the mean tiles per
    SM plus the last blocks' tail. Larger blocks fill their 64-pair tiles
    better (the 3dbs bucket, per sample: 178 tiles 84% full at 16 atoms,
    165 at 91% at 32), smaller ones shorten the tail (at most 4 tiles per
    block at 16 atoms, 7 at 32). The host expects KNN_SLOT_FILL of the k
    slots valid, so a block of g atoms holds T(g) = g k fill / 64 + 1/2
    tiles (its last one half full), and g_k is the g <= KNN_ATOM_ROWS
    that fits the shared memory and minimises B ceil(n / g) T(g) / sms +
    T(g): the mean tiles per SM plus one block. At the 3dbs bucket on 132
    SMs that is 19 atoms at B = 16 and 10 at B = 4, on the f32 plan (which
    holds at most 28 atoms at flagship width) as on the bf16 plan (32)."""
    bsz, n, k = ints["batch"], ints["n"], ints["k"]
    best = None
    for g in range(1, KNN_ATOM_ROWS + 1):
        if knn_plan_words(ints, g) > SMEM_WORDS:
            break
        tiles = g * k * KNN_SLOT_FILL / WIDE_TILE + 0.5
        cost = bsz * -(-n // g) * tiles / sms + tiles
        if best is None or cost < best[0]:
            best = (cost, g)
    if best is None:
        raise ValueError("knn_conv: one block's tile does not fit the shared memory")
    return best[1]


def pair_plan_words(ints: dict, g_p: int) -> int:
    """Shared memory of a block on the grid of ligand rows in 4-byte words
    (pair_plan, csrc/pair_conv.cu: fwd_plan of the conv in dense mode; with
    a finalize, out_dim > 0, B8's, its output rows and statistics in the
    weight stages; with a true bf16_chain, B11-pair's, the bf16 plan), from
    the kernel's sizes (_pair_ints): nsrc, din, dout, nb, ns, he, hf, nw,
    kdim, gs_n, and out_dim, n_slots, mix_numel, bf16_chain. Sizes without
    out_dim have no finalize, those without bf16_chain the f32 plan."""
    n = ints
    fin = [n.get(key, 0) for key in ("out_dim", "mix_numel", "n_slots")]
    return sum(_fin_after_sums(list(fwd_regions(
        n["gs_n"] + n["nb"], n["ns"], n["he"], n["hf"], n["nw"], n["kdim"], n["din"], n["dout"],
        *fin, g_p, n["nsrc"], bf16=bool(n.get("bf16_chain", 0)))), fin[0]))


def pair_row_groups(ints: dict, sms: int) -> int:
    """g_p, the ligand rows per block of the grid of ligand rows (B2, B8,
    B11-pair), picked on the host from the batch, the shapes and the SM
    count on the plan of pair_plan_words; no mask or count is read (no wait
    for the device: a CUDA graph captures the call).

    One block runs per SM (its shared memory) and the blocks start in grid
    order as SMs come free. A block of g rows that holds real rows (they
    come first) holds T(g) = g PAIR_ROW_PAIRS / 64 + 1/2 tiles (its last
    one half full; ~5 rows fill a tile), and a tile's latency, not the
    card's throughput, sets its time: the working blocks run in waves of
    `sms`, so the grid takes about ceil(W / sms) T(g), W = B ceil(r / g)
    working blocks for r real rows a sample. Every block, working or not,
    also pays a fixed cost F, spread over the SMs: B8's finalize of its
    rows (PAIR_FIN_TILES), or, without a finalize (B2, B11-pair), the
    compaction scan of its g x nsrc candidates and the stores of its rows'
    sums, zeros for padded rows (PAIR_SCAN_TILES). The host does not know r
    without reading the masks; the 3dbs ligand fills 35 of its bucket's 128
    rows, and a W just past a multiple of `sms` adds a whole wave (B2 at B
    = 16: 4 rows a block, 144 working blocks on 132 SMs, took 0.187 ms
    against 0.140 at 6 rows; PERF.md section 6, PR 14). So g_p is the g <=
    PAIR_LIG_ROWS that fits the shared memory and minimises the worst case
    over r from nt / 4 to nt / 2 of ceil(W / sms) T(g) + (B ceil(nt / g) /
    sms + 1) F."""
    bsz, n = ints["batch"], ints["nt"]
    fixed = PAIR_FIN_TILES if ints.get("out_dim", 0) > 0 else PAIR_SCAN_TILES
    best = None
    for g in range(1, PAIR_LIG_ROWS + 1):
        if pair_plan_words(ints, g) > SMEM_WORDS:
            break
        tiles = g * PAIR_ROW_PAIRS / WIDE_TILE + 0.5
        waves = max(-(-bsz * -(-r // g) // sms) for r in range(-(-n // 4), -(-n // 2) + 1))
        cost = waves * tiles + (bsz * -(-n // g) / sms + 1) * fixed
        if best is None or cost < best[0]:
            best = (cost, g)
    if best is None:
        raise ValueError("pair_conv: one block's tile does not fit the shared memory")
    return best[1]


@dataclasses.dataclass
class TileBlock:
    """One block of a wide-tile forward grid (B1, B7, B10): its kind, sample,
    first owned target and count, and per conv its pairs in list order cut
    into 64-pair tiles, each a [n, 2] tensor of (target, source)."""

    kind: str
    b: int
    t0: int
    g: int
    tiles: dict


def block_tiles(valid_rows, t0: int, src=None):
    """The valid candidates of a block's owned targets t0 .. (valid_rows
    [g, candidates], its rows of a conv's mask) in candidate order (target-
    major, then candidate index), as the kernel compacts them
    (trunk_conv.cuh compact_pairs), cut into tiles of WIDE_TILE (target,
    source) pairs; src maps a candidate to its source (knn: the neighbour
    list [g, k]), else the candidate index is the source."""
    t, o = torch.nonzero(valid_rows, as_tuple=True)
    s = o if src is None else src[t, o]
    pairs = torch.stack([t + t0, s], dim=1)
    return list(pairs.split(WIDE_TILE)) if len(pairs) else []


def cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab, cut):
    """The cross conv's valid (ligand row, atom) pairs [B, nl, na]: both
    nodes valid and the atom a CA/CB atom or within the sample's cutoff."""
    d = _dist(atm_pos[:, None, :, :] - lig_pos[:, :, None, :])
    return ((cab[:, None, :] > 0) | (d <= cut[:, None, None])) & (lig_mask[:, :, None] > 0) \
        & (atm_mask[:, None, :] > 0)


def cross_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, cutoff, g_l, g_a):
    """B1's, B7's and B11-cross's blocks in grid order (the al blocks of every sample,
    g_l ligand rows each; then the la blocks, g_a atoms each), each with its
    targets' valid pairs in candidate order cut into tiles of WIDE_TILE."""
    bsz, nl, na = lig_pos.shape[0], lig_pos.shape[1], atm_pos.shape[1]
    al = cross_valid(lig_pos, atm_pos, lig_mask, atm_mask, cab,
                     _cutoffs(cutoff, bsz, lig_pos.device))
    blocks = []
    for kind, mask, n, g in (("al", al, nl, g_l), ("la", al.transpose(1, 2), na, g_a)):
        for b in range(bsz):
            blocks += [TileBlock(kind, b, t0, g, {kind: block_tiles(mask[b, t0 : t0 + g], t0)})
                       for t0 in range(0, n, g)]
    return blocks


def wide_tile_plain(c: ConvConsts, vec, tgt_x, src_x, extra, w_in, beff, emb, fc, bf_sc=None):
    """The messages [P, dout] of one tile's pairs as conv_fwd_wide.cuh
    computes them: pair_chain_plain on the folded edge input, then the TP.
    bf_sc: None (f32), or the bf16 chain (BF) with its (target, source)
    flags, which scalars enter the TP-weight MLP rounded to bf16
    (ConvArgs::bf_tgt_sc, bf_src_sc); the messages then from _chain_bf16."""
    tx, sx = tgt_x, src_x
    if bf_sc is not None:
        tx = _bf16_round(tgt_x) if bf_sc[0] else tgt_x
        sx = _bf16_round(src_x) if bf_sc[1] else src_x
    *_, w, cb = pair_chain_plain(c, vec, tx, sx, extra, w_in, beff, emb["l2"]["w"],
                                 emb["l2"]["b"], fc["l1"]["w"], fc["l1"]["b"], fc["l2"]["w"],
                                 fc["l2"]["b"])
    if bf_sc is None:
        return _tp_plain(c, src_x, cb, w)
    return _chain_bf16(c, src_x, sh_l2(vec), w, vec.new_ones(vec.shape[0]))


def cross_conv_tiled_plain(c: ConvConsts, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask,
                           cabflag, temb, cutoff, emb_params, fc_al, fc_la, groups, *,
                           bf16_chain: bool = False):
    """B1's decomposition, plain: the blocks of cross_tile_plan at groups
    (g_l, g_a), each tile's messages (wide_tile_plain; the la direction's
    geometry flipped to atom - ligand, as the kernel's) added to their
    targets' sums tile by tile, in list order. With `bf16_chain`,
    B11-cross's: the ligand scalars rounded (al: the targets', la: the
    sources'), each tile's messages through the bf16 chain. Same returns as
    cross_conv_plain."""
    e_, fc_al, fc_la, temb, lig_x, atm_x = _f32((emb_params, fc_al, fc_la, temb, lig_x, atm_x))
    bsz, nl, na = lig_x.shape[0], lig_x.shape[1], atm_x.shape[1]
    w_in, beff = _prep_edge(c, e_["l1"]["w"], e_["l1"]["b"], temb, 0, bsz, lig_x.device)
    sums = {"al": lig_x.new_zeros(bsz, nl, c.dout), "la": atm_x.new_zeros(bsz, na, c.dout)}
    sides = {"al": (lig_pos, atm_pos, lig_x, atm_x, fc_al),
             "la": (atm_pos, lig_pos, atm_x, lig_x, fc_la)}
    bf_sc = {"al": (True, False), "la": (False, True)} if bf16_chain else {"al": None, "la": None}
    for blk in cross_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cabflag, cutoff, *groups):
        tp, sp, tx, sx, fc = sides[blk.kind]
        b = blk.b
        for tile in blk.tiles[blk.kind]:
            t, s = tile[:, 0], tile[:, 1]
            vec = sp[b, s] - tp[b, t]
            vec = -vec if blk.kind == "la" else vec  # the kernel's flip: atom - ligand
            sums[blk.kind][b].index_add_(0, t, wide_tile_plain(
                c, vec, tx[b, t], sx[b, s], None, w_in, beff[b], e_, fc, bf_sc[blk.kind]))
    return sums["al"], sums["la"]


def cross_conv_fin_tiled_plain(c: ConvConsts, fin, lig_pos, atm_pos, lig_x, atm_x, lig_mask,
                               atm_mask, cabflag, temb, cutoff, emb_params, fc_al, fc_la, fin_al,
                               fin_la, cnt_al, cnt_la, groups):
    """B7's decomposition, plain: cross_conv_tiled_plain's sums, each
    direction finalized. Same returns as cross_conv_fin_plain."""
    al, la = cross_conv_tiled_plain(c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask,
                                    cabflag, temb, cutoff, emb_params, fc_al, fc_la, groups)
    return finalize_plain(fin, fin_al, al, cnt_al), finalize_plain(fin, fin_la, la, cnt_la)


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
        lib = _library()
        with _on_device(x.device) as st:
            return _knn_conv_kernel(lib, data, x, w_in, beff, weights, st)

    @staticmethod
    def backward(ctx, g):
        x, w_in, beff, *weights = ctx.saved_tensors
        d_x, gr = knn_bwd(ctx.data, x, w_in, beff, weights, g)
        return (None, d_x, gr["w_in"], gr["beff"], gr["w2"], gr["b2"], gr["wf1"], gr["bf1"],
                gr["wf2"], gr["bf2"])


# what the last launch of each knn-grid kernel on the card used, by launch
# counter: atoms per block and the block's shared memory (chip_smoke.py
# reports them)
knn_conv_stats: dict = {}


def _knn_ints(c: ConvConsts, dims, bsz: int, n: int, k: int, bf16_chain: bool = True,
              fin: FinConsts | None = None) -> dict:
    """The knn grid's sizes, as knn_plan_words and knn_row_groups read them:
    B11-knn's unless bf16_chain is false, then B3's, or with `fin` B9's."""
    he, hf, nw, kdim = dims
    ints = dict(batch=bsz, n=n, k=k, din=c.din, dout=c.dout, ns=c.ns, he=he, hf=hf, nw=nw,
                kdim=kdim, gs_n=c.gs_n, bf16_chain=int(bf16_chain), out_dim=0, n_slots=0,
                mix_numel=0)
    if fin is not None:
        ints.update(out_dim=fin.out_dim, n_slots=len(fin.spec.out.items),
                    mix_numel=fin.spec.lin.weight_numel)
    return ints


def _knn_conv_kernel(lib, data, x, w_in, beff, weights, stream, cycles=None, fin=None,
                     fin_ts=()):
    """One launch of csrc/knn_conv.cu's knn grid: B3 ("knn_conv"), B11-knn
    ("knn_conv_bf16", the data's bf16_chain) or B9 ("knn_conv_fin": fin a
    FinConsts, fin_ts the finalize tensors of _fin_ptrs), g_k atoms per
    block from knn_row_groups. `cycles`, an int64 tensor of one entry per
    block (knn_tile_plan's order), receives each block's clock64() cycles
    (chip_smoke.py's block report)."""
    c, d, dev = data.c, data, x.device
    bsz, n, k = d.idx.shape
    he, hf, nw, kdim = d.dims
    ck, gs_off, meta = c.device_tables(dev)
    name = "knn_conv_fin" if fin is not None else (
        "knn_conv_bf16" if d.bf16_chain else "knn_conv")
    ints = _knn_ints(c, d.dims, bsz, n, k, d.bf16_chain, fin)
    g_k = knn_row_groups(ints, contraction.sm_count(str(dev)))
    knn_conv_stats[name] = dict(atom_rows=g_k, smem_bytes=4 * knn_plan_words(ints, g_k))
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.device != dev
                               or cycles.numel() != bsz * -(-n // g_k)):
        raise ValueError(f"{name}: cycles takes one int64 per block on the kernel's device")
    fin_args = []
    if fin is not None:
        tptrs, _ = _fin_tail(fin, dev)
        fin_args = [_ptr(t) for t in fin_ts] + tptrs + [ints["out_dim"], ints["n_slots"],
                                                        ints["mix_numel"]]
    out = torch.empty(bsz, n, c.dout if fin is None else fin.out_dim, dtype=torch.float32,
                      device=dev)
    # cp.async stages the MLP weights 16 bytes at a time
    rc = getattr(lib, "dbfr_" + name)(
        _ptr(d.pos), _ptr(x), _ptr(d.idx), _ptr(d.valid), None, _ptr(_aligned(w_in)),
        _ptr(beff), *[_ptr(_aligned(v)) for v in weights], _ptr(ck), _ptr(gs_off), _ptr(meta),
        _ptr(out), bsz, n, k, c.din, c.dout, c.ns, he, hf, nw, kdim, c.gs_n, c.gs_coeff,
        *fin_args, g_k, _ptr(cycles), stream)
    _check(rc, name)
    launches[name] += 1
    return out


def knn_valid(idx, valid):
    """The knn conv's valid (atom, slot) pairs [B, n, k]: the slot valid and
    its neighbour index inside the sample, as the kernels decide them
    (trunk_conv.cuh compact_pairs)."""
    return (valid > 0) & (idx >= 0) & (idx < idx.shape[1])


def knn_tile_plan(idx, valid, g_k):
    """B3's, B9's and B11-knn's blocks in grid order (every sample's
    blocks, g_k atoms each, in atom order), each with its atoms' valid
    neighbour slots in candidate order (atom-major, then slot) cut into
    tiles of WIDE_TILE (target, neighbour) pairs."""
    bsz, n, _ = idx.shape
    ok, nb = knn_valid(idx, valid), idx.long()
    return [TileBlock("knn", b, t0, g_k, {"knn": block_tiles(ok[b, t0 : t0 + g_k], t0,
                                                             nb[b, t0 : t0 + g_k])})
            for b in range(bsz) for t0 in range(0, n, g_k)]


def knn_conv_tiled_plain(c: ConvConsts, pos, x, mask, idx, valid, temb, params, g_k, *,
                         bf16_chain: bool = False):
    """B3's decomposition, plain (with `bf16_chain`, B11-knn's): the blocks
    of knn_tile_plan at g_k atoms, each tile's messages (wide_tile_plain on
    the kernel's folded edge input; with the bf16 chain both scalar halves
    rounded) added to their atoms' sums tile by tile, in list order. Same
    returns as knn_conv_plain."""
    e_, fc, temb, x = _f32((params["emb"], params["fc"], temb, x))
    bsz, n, _ = idx.shape
    w_in, beff = _prep_edge(c, e_["l1"]["w"], e_["l1"]["b"], temb, 0, bsz, x.device)
    out = x.new_zeros(bsz, n, c.dout)
    bf_sc = (True, True) if bf16_chain else None
    for blk in knn_tile_plan(idx, valid, g_k):
        b = blk.b
        for tile in blk.tiles["knn"]:
            t, s = tile[:, 0], tile[:, 1]
            out[b].index_add_(0, t, wide_tile_plain(c, pos[b, s] - pos[b, t], x[b, t], x[b, s],
                                                    None, w_in, beff[b], e_, fc, bf_sc))
    return out


def knn_conv_fin_tiled_plain(c: ConvConsts, fin, pos, x, mask, idx, valid, temb, params, g_k):
    """B9's decomposition, plain: knn_conv_tiled_plain's sums, finalized by
    the count of valid slots. Same returns as knn_conv_fin_plain."""
    return finalize_plain(fin, params, knn_conv_tiled_plain(c, pos, x, mask, idx, valid, temb,
                                                            params, g_k), valid.float().sum(-1))


def reverse_neighbours(idx, valid):
    """Reverse neighbour list of idx/valid [B, n, k]: (rev_off [B, n + 1],
    rev_tgt, rev_src) with the entries of source s of sample b at
    rev_off[b, s] .. rev_off[b, s + 1], in (target, slot) order: the
    source-major order of B6's pair list (knn_pairs_plain). Device ops only
    (a stable sort and a search), no host read."""
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


# what the last knn_bwd call on the card allocated: its neighbour slots, the
# device word holding its pair count, K chunks and scratch bytes
# (chip_smoke.py reports them)
knn_bwd_stats: dict = {}


def knn_bwd(data, x, w_in, beff, weights, g):
    """B6: (d_x, parameter gradients) of knn_conv for the output cotangent g.
    On CUDA tensors the kernels of csrc/knn_bwd.cu: the valid neighbour slots
    as one list with each pair's source-major place, one wide-tile pair pass
    writing feature-major rows, one grouped launch of the split-K contraction
    that turns them into every parameter gradient, then the per-atom sums of
    the pairs' rows; sized by the B n k slots, so no host read. On CPU
    tensors the plain model of that decomposition, knn_bwd_plain."""
    c, dev = data.c, x.device
    bsz, n, _ = data.idx.shape
    g = _arg(g, (bsz, n, c.dout), dev)
    if not x.is_cuda:
        return knn_bwd_plain(data, x, w_in, beff, weights, g)
    lib = _library()
    with _on_device(dev) as st:
        return _knn_bwd_kernel(lib, st, data, x, w_in, beff, weights, g)


def _knn_bwd_kernel(lib, st, data, x, w_in, beff, weights, g):
    c, d, dev = data.c, data, x.device
    bsz, n, k = d.idx.shape
    he, hf, nw, kdim = d.dims
    ns, din = c.ns, c.din
    weights = [_aligned(w) for w in weights]
    w2, b2, wf1, bf1, wf2, bf2 = weights
    w_in = _aligned(w_in)
    layout, stride = _grad_layout(c.gs_n, he, ns, hf, nw, bsz)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    slots = bsz * n * k
    ld = -(-slots // WIDE_TILE) * WIDE_TILE
    cnt_t, tgt_off, src_off = (torch.empty(bsz * n + (i > 0), **i32) for i in range(3))
    sample_off = torch.empty(bsz + 1, **i32)
    pair_t, pair_s, pair_b, at_src = (torch.empty(ld, **i32) for _ in range(4))
    rows = torch.empty(_wide_row_count(c.gs_n, he, ns, hf, nw), ld, **f32)
    tgt_rows, src_rows = torch.empty(ld, ns, **f32), torch.empty(ld, din, **f32)
    n_tiles = sum(contraction.tiles(m, q) for m, q in _wide_problems(c.gs_n, he, ns, hf, nw, bsz))
    splits = contraction.max_splits(n_tiles, ld, contraction.sm_count(str(dev)))
    part = torch.empty(splits, stride, **f32)
    flat, d_x = torch.empty(stride, **f32), torch.empty(bsz, n, din, **f32)
    ck, gs_off, _ = c.device_tables(dev)
    w_meta, in_off, in_ent = c.device_wide_tables(dev)
    w2t, wf1t, wf2t = [_aligned(t) for t in _transposed(w2, wf1, wf2)]
    rc = lib.dbfr_knn_bwd(
        _ptr(d.pos), _ptr(x), _ptr(d.idx), _ptr(d.valid), _ptr(w_in), _ptr(beff), _ptr(w2),
        _ptr(b2), _ptr(w2t), _ptr(wf1), _ptr(bf1), _ptr(wf2), _ptr(bf2), _ptr(wf1t), _ptr(wf2t),
        _ptr(ck), _ptr(gs_off), _ptr(w_meta), _ptr(in_off), _ptr(in_ent), _ptr(g), _ptr(cnt_t),
        _ptr(tgt_off), _ptr(src_off), _ptr(sample_off), _ptr(pair_t), _ptr(pair_s),
        _ptr(pair_b), _ptr(at_src), _ptr(rows), _ptr(tgt_rows), _ptr(src_rows), _ptr(part),
        _ptr(flat), _ptr(d_x), bsz, n, k, din, c.dout, ns, he, hf, nw, kdim, c.gs_n,
        in_ent.shape[0], ld, layout["w_in"][0], layout["w2"][0], layout["wf1"][0],
        layout["wf2"][0], stride, splits, c.gs_coeff, st)
    _check(rc, "knn_bwd")
    launches["knn_bwd"] += 1
    scratch = (cnt_t, tgt_off, src_off, sample_off, pair_t, pair_s, pair_b, at_src, rows,
               tgt_rows, src_rows, part)
    knn_bwd_stats.update(slots=slots, count=tgt_off[-1:], splits=splits, scratch_bytes=sum(
        t.numel() * t.element_size() for t in scratch))
    return d_x, _split_grads(flat, layout)


# ---- B6's decomposition, plain -------------------------------------------


def knn_pairs_plain(idx, valid):
    """The pair list of B6 (csrc/knn_bwd.cu): the valid neighbour slots
    (valid > 0, 0 <= idx < n) of every sample in (sample, target, slot)
    order, as (pair_t, pair_s, pair_b); sample_off [B + 1] (the first pair
    of each sample), tgt_off [B n + 1] (of each target row), src_off
    [B n + 1] (of each source, in the source-major permutation) and perm,
    the list indices in source-major order, (target, slot) order kept within
    a source: the order of reverse_neighbours."""
    bsz, n, k = idx.shape
    idx = idx.long()
    ok = (valid > 0) & (idx >= 0) & (idx < n)
    pair_b, pair_t, slot = torch.nonzero(ok, as_tuple=True)
    pair_s = idx[pair_b, pair_t, slot]
    zero = torch.zeros(1, dtype=torch.long, device=idx.device)
    rev_off = reverse_neighbours(idx, valid)[0].long()
    src_off = torch.cat([rev_off[:, :n].reshape(-1), rev_off[-1:, n]])
    perm = torch.sort(pair_b * n + pair_s, stable=True).indices
    return (pair_t, pair_s, pair_b, torch.cat([zero, torch.cumsum(ok.sum((1, 2)), 0)]),
            torch.cat([zero, torch.cumsum(ok.sum(2).reshape(-1), 0)]), src_off, perm)


def knn_bwd_plain(data, x, w_in, beff, weights, g, ld=None):
    """knn_bwd's plain version, a model of its decomposition: the pair list
    (knn_pairs_plain), the pass's rows (wide_pass_plain) zero-padded to `ld`
    columns (the kernels' B n k slots rounded up to a 64-pair tile; None:
    that) and contracted over them into each parameter gradient with its
    bias rows (contraction.contract_plain; db1_eff per sample segment), and
    per atom its target rows summed in list order plus its source rows in
    source-major order. Same returns as knn_bwd."""
    c, d = data.c, data
    bsz, n, k = d.idx.shape
    he, hf, _, _ = d.dims
    ns, din = c.ns, c.din
    pt, ps, pb, sample_off, tgt_off, src_off, perm = knn_pairs_plain(d.idx, d.valid)
    vec = d.pos[pb, ps] - d.pos[pb, pt]
    rows, tgt_rows, src_rows = wide_pass_plain(c, (pt, ps, pb), vec, x, x, g, w_in, beff,
                                               *weights)
    ld = -(-bsz * n * k // WIDE_TILE) * WIDE_TILE if ld is None else ld
    rows = {r: torch.nn.functional.pad(v, (0, ld - v.shape[1])) for r, v in rows.items()}
    w_in_b = contraction.contract_plain(rows["in"], rows["dh1"], sample_off)
    w2_b = contraction.contract_plain(rows["h1"], rows["dea"])
    wf1_b = contraction.contract_plain(rows["e"], rows["dh"])
    wf2_b = contraction.contract_plain(rows["h"], rows["dw"])
    grads = {"w_in": w_in_b[: c.gs_n], "beff": w_in_b[c.gs_n :], "w2": w2_b[:he], "b2": w2_b[he],
             "wf1": wf1_b[: 3 * ns], "bf1": wf1_b[3 * ns], "wf2": wf2_b[:hf], "bf2": wf2_b[hf]}
    d_x = (_segment_sum(torch.nn.functional.pad(tgt_rows, (0, din - ns)), tgt_off, bsz * n)
           + _segment_sum(src_rows[perm], src_off, bsz * n))
    return d_x.view(bsz, n, din), grads


def _segment_sum(rows, off, n):
    """[n, width]: row i sums rows off[i] .. off[i + 1] - 1."""
    seg = torch.repeat_interleave(torch.arange(n, device=rows.device), off[1:] - off[:-1])
    return rows.new_zeros(n, rows.shape[1]).index_add_(0, seg, rows)


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


# ---- B8 pair conv with finalize; the grid of ligand rows of B2, B8, B11-pair


def pair_conv_fin(c: ConvConsts, fin: FinConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask,
                  src_mask, cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask, cnt):
    """B8: pair_conv's sums finalized in the kernel -> [B, nt, out_dim]
    (_pair_fin_kernel); params also hold "mix" and "ln"."""
    args = (c, fin, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t, cab_s, temb,
            cutoff, params, bond_feat, bond_mask, cnt)
    if not tgt_x.is_cuda:
        return pair_conv_fin_plain(*args)
    return _with_plain_backward(_pair_fin_kernel, pair_conv_fin_plain, *args)


# Order of the pointer and int arguments of B2, B8 and B11-pair: the enums
# PairPtr and PairInt of csrc/pair_conv.cu, name for name.
_PAIR_WEIGHTS = ("w2", "b2", "wf1", "bf1", "wf2", "bf2")
PAIR_PTRS = ("tgt_pos", "src_pos", "tgt_x", "src_x", "tgt_mask", "src_mask", "cab", "cut",
             "bond_feat", "bond_mask", "w_in", "beff", *_PAIR_WEIGHTS, "ck", "gs_off",
             "out_meta", "out", *_FIN_KEYS, "mix_meta", "ln_slots", "cycles")
PAIR_INTS = ("batch", "nt", "nsrc", "din", "dout", "nb", "ns", "he", "hf", "nw", "kdim", "gs_n",
             "out_dim", "n_slots", "mix_numel", "lig_rows")

# what the last launch of each kernel on the grid of ligand rows used, by
# launch counter (pair_conv, pair_conv_bf16, pair_conv_fin): ligand rows per
# block and the block's shared memory (chip_smoke.py reports them)
pair_conv_stats: dict = {}


def _pair_ints(c: ConvConsts, dims, bsz: int, nt: int, nsrc: int, nb: int,
               fin: FinConsts | None = None, bf16_chain: bool = False) -> dict:
    """The sizes of a kernel on the grid of ligand rows, as pair_plan_words
    and pair_row_groups read them: B2's, with `fin` B8's, with `bf16_chain`
    B11-pair's."""
    he, hf, nw, kdim = dims
    ints = dict(batch=bsz, nt=nt, nsrc=nsrc, din=c.din, dout=c.dout, nb=nb, ns=c.ns, he=he,
                hf=hf, nw=nw, kdim=kdim, gs_n=c.gs_n, out_dim=0, n_slots=0, mix_numel=0,
                bf16_chain=int(bf16_chain))
    if fin is not None:
        ints.update(out_dim=fin.out_dim, n_slots=len(fin.spec.out.items),
                    mix_numel=fin.spec.lin.weight_numel)
    return ints


def _pair_wide(lib, name, data, tx, sx, w_in, beff, weights, stream, fin=None, fin_ts=(),
               cycles=None):
    """One launch of csrc/pair_conv.cu's grid of ligand rows: B2
    ("pair_conv"), B11-pair ("pair_conv_bf16", the data's bf16_chain) or B8
    ("pair_conv_fin": fin a FinConsts, fin_ts the finalize tensors of
    _fin_ptrs), g_p ligand rows per block from pair_row_groups. `cycles`, an
    int64 tensor of one entry per block (pair_tile_plan's order), receives
    each block's clock64() cycles (chip_smoke.py's block report)."""
    c, d, dev = data.c, data, tx.device
    bsz, nt, nsrc = tx.shape[0], tx.shape[1], sx.shape[1]
    ck, gs_off, meta = c.device_tables(dev)
    ints = _pair_ints(c, d.dims, bsz, nt, nsrc, d.nb, fin, d.bf16_chain)
    g_p = ints["lig_rows"] = pair_row_groups(ints, contraction.sm_count(str(dev)))
    pair_conv_stats[name] = dict(lig_rows=g_p, smem_bytes=4 * pair_plan_words(ints, g_p))
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.device != dev
                               or cycles.numel() != bsz * -(-nt // g_p)):
        raise ValueError(f"{name}: cycles takes one int64 per block on the kernel's device")
    # every row is written, the sums of rows without a pair as zeros
    out = torch.empty(bsz, nt, c.dout if fin is None else fin.out_dim, dtype=torch.float32,
                      device=dev)
    # cp.async stages the MLP weights 16 bytes at a time
    t = {"tgt_pos": d.tgt_pos, "src_pos": d.src_pos, "tgt_x": tx, "src_x": sx,
         "tgt_mask": d.tgt_mask, "src_mask": d.src_mask, "cab": d.cab_s, "cut": d.cut,
         "bond_feat": d.bond_feat, "bond_mask": d.bond_mask, "w_in": _aligned(w_in),
         "beff": beff, "ck": ck, "gs_off": gs_off, "out_meta": meta, "out": out,
         "cycles": cycles}
    t.update(zip(_PAIR_WEIGHTS, [_aligned(w) for w in weights]))
    if fin is not None:
        t.update(zip(_FIN_KEYS, fin_ts))
        t["mix_meta"], t["ln_slots"] = fin.device_tables(dev)
    ptr_arr = (ctypes.c_void_p * len(PAIR_PTRS))(*[_ptr(t.get(k)) for k in PAIR_PTRS])
    int_arr = (ctypes.c_int * len(PAIR_INTS))(*[int(ints[k]) for k in PAIR_INTS])
    float_arr = (ctypes.c_float * 1)(c.gs_coeff)
    rc = getattr(lib, "dbfr_" + name)(ptr_arr, len(PAIR_PTRS), int_arr, len(PAIR_INTS),
                                      float_arr, 1, stream)
    _check(rc, name)
    launches[name] += 1
    return out


def _pair_fin_kernel(c, fin, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t, cab_s,
                     temb, cutoff, params, bond_feat, bond_mask, cnt, cycles=None):
    """One launch of B8 (_pair_wide)."""
    data, tx, sx, w_in, beff, *weights = _pair_inputs(
        c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_s, temb, cutoff, params,
        bond_feat, bond_mask)
    _, fin_ts = _fin_ptrs(fin, params, cnt, (tx.shape[0], tx.shape[1]), tx.device)
    lib = _library()
    with _on_device(tx.device) as st:
        return _pair_wide(lib, "pair_conv_fin", data, tx, sx, w_in, beff, weights, st,
                          fin=fin, fin_ts=fin_ts, cycles=cycles)


def pair_tile_plan(tgt_pos, src_pos, tgt_mask, src_mask, cab, cutoff, bond_mask, g_p):
    """B2's, B8's and B11-pair's blocks in grid order (every sample's
    blocks, g_p ligand rows each, in row order), each with its rows' valid
    pairs in candidate order (row-major, then source) cut into tiles of
    WIDE_TILE (target, source) pairs."""
    bsz, nt = tgt_pos.shape[0], tgt_pos.shape[1]
    ok = pair_valid(tgt_pos, src_pos, tgt_mask, src_mask, cab,
                    _cutoffs(cutoff, bsz, tgt_pos.device), bond_mask)
    return [TileBlock("pair", b, t0, g_p, {"pair": block_tiles(ok[b, t0 : t0 + g_p], t0)})
            for b in range(bsz) for t0 in range(0, nt, g_p)]


def pair_conv_tiled_plain(c: ConvConsts, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask,
                          cab_t, cab_s, temb, cutoff, params, bond_feat, bond_mask, g_p, *,
                          bf16_chain: bool = False):
    """B2's decomposition, plain (with `bf16_chain`, B11-pair's): the blocks
    of pair_tile_plan at g_p rows, each tile's messages (wide_tile_plain on
    the kernel's folded edge input, the pairs' bond features as its extra
    rows; with the bf16 chain the target scalars rounded, the source
    scalars exact) added to their rows' sums tile by tile, in list order.
    Same returns as pair_conv_plain."""
    p, temb, bond_feat, tgt_x, src_x = _f32((params, temb, bond_feat, tgt_x, src_x))
    bsz, nt = tgt_x.shape[0], tgt_x.shape[1]
    w_in, beff = _prep_edge(c, p["emb_w1"], p["emb_b1"], temb, bond_feat.shape[-1], bsz,
                            tgt_x.device)
    emb = {"l2": {"w": p["emb_w2"], "b": p["emb_b2"]}}
    fc = {"l1": {"w": p["fc_w1"], "b": p["fc_b1"]}, "l2": {"w": p["fc_w2"], "b": p["fc_b2"]}}
    bf_sc = (True, False) if bf16_chain else None
    sums = tgt_x.new_zeros(bsz, nt, c.dout)
    for blk in pair_tile_plan(tgt_pos, src_pos, tgt_mask, src_mask, cab_s, cutoff, bond_mask,
                              g_p):
        b = blk.b
        for tile in blk.tiles["pair"]:
            t, s = tile[:, 0], tile[:, 1]
            sums[b].index_add_(0, t, wide_tile_plain(
                c, src_pos[b, s] - tgt_pos[b, t], tgt_x[b, t], src_x[b, s], bond_feat[b, t, s],
                w_in, beff[b], emb, fc, bf_sc))
    return sums


def pair_conv_fin_tiled_plain(c: ConvConsts, fin: FinConsts, tgt_pos, src_pos, tgt_x, src_x,
                              tgt_mask, src_mask, cab_t, cab_s, temb, cutoff, params, bond_feat,
                              bond_mask, cnt, g_p):
    """B8's decomposition, plain: pair_conv_tiled_plain's sums, finalized.
    Same returns as pair_conv_fin_plain."""
    sums = pair_conv_tiled_plain(c, tgt_pos, src_pos, tgt_x, src_x, tgt_mask, src_mask, cab_t,
                                 cab_s, temb, cutoff, params, bond_feat, bond_mask, g_p)
    return finalize_plain(fin, _f32(params), sums, cnt)


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
                      cutoff, emb_params, fc_al, fc_la, fin_al, fin_la, cnt_al, cnt_la,
                      cycles=None):
    """One launch of B7 (_cross_wide)."""
    data, lx, ax, w_in, beff, *weights = _cross_inputs(
        c, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cabflag, temb, cutoff,
        emb_params, fc_al, fc_la)
    dev, bsz, nl, na = lx.device, lx.shape[0], lx.shape[1], ax.shape[1]
    _, ts_al = _fin_ptrs(fin, fin_al, cnt_al, (bsz, nl), dev)
    _, ts_la = _fin_ptrs(fin, fin_la, cnt_la, (bsz, na), dev)
    lib = _library()
    with _on_device(dev) as st:
        return _cross_wide(lib, "cross_conv_fin", data, lx, ax, w_in, beff, weights, st,
                           fin=fin, fin_ts=(ts_al, ts_la), cycles=cycles)


# ---- B9 knn conv with finalize ---------------------------------------------


def knn_conv_fin(c: ConvConsts, fin: FinConsts, pos, x, mask, idx, valid, temb, params):
    """B9: knn_conv's sums finalized in the kernel by the count of valid
    neighbour slots -> [B, N, out_dim]; params also hold "mix" and "ln"."""
    args = (c, fin, pos, x, mask, idx, valid, temb, params)
    if not x.is_cuda:
        return knn_conv_fin_plain(*args)
    return _with_plain_backward(_knn_fin_kernel, knn_conv_fin_plain, *args)


def _knn_fin_kernel(c, fin, pos, x, mask, idx, valid, temb, params, cycles=None):
    """One launch of B9 (_knn_conv_kernel)."""
    data, xx, w_in, beff, *weights = _knn_inputs(c, pos, x, idx, valid, temb, params)
    d, dev = data, xx.device
    bsz, n, _ = d.idx.shape
    _, ts = _fin_ptrs(fin, params, d.valid.sum(-1), (bsz, n), dev)
    lib = _library()
    with _on_device(dev) as st:
        return _knn_conv_kernel(lib, data, xx, w_in, beff, weights, st, cycles,
                                fin=fin, fin_ts=ts)
