"""Functional building blocks of the score network, in PyTorch.

Counterpart of diffbindfr_tpu/nn/layers.py: parameters are nested dicts of
tensors (as loaded from the JAX package's checkpoints) and every block is a
plain function of (params, tensors). Padded elements are handled by masks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .irreps import (
    Irreps,
    LinearSpec,
    TensorProductSpec,
    apply_dw_tensor_product,
    apply_fc_tensor_product,
    apply_linear,
    apply_linear_cm,
    compile_dw_tensor_product,
    compile_fc_tensor_product,
    compile_linear,
    promote,
    spherical_harmonics_l2,
)

# ---------------------------------------------------------------------------
# linear / mlp
# ---------------------------------------------------------------------------


def linear_apply(p, x):
    """x @ w + b; a bf16 input with f32 weights (or the reverse) computes in
    f32, as jnp's promotion does."""
    x, w = promote(x, p["w"])
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_apply(p, x, act=torch.relu):
    """Linear-act-Linear (SimpleLinear). No dropout: training pins it to 0.0,
    as the JAX package's train_cli does."""
    return linear_apply(p["l2"], act(linear_apply(p["l1"], x)))


# ---------------------------------------------------------------------------
# equivariant layer norm (irreps layout and component-major layout)
# ---------------------------------------------------------------------------


def _rsqrt(x):
    """rsqrt(x) in x's dtype, taken in f32 and rounded once, as JAX takes a
    bf16 rsqrt. torch's own bf16 rsqrt does so on the card (held there by
    tests/test_torch_kernels_cuda.py), so a CUDA tensor takes it as it is,
    with no casts to launch; on the CPU it rounds wrongly in about a quarter
    of the elements that its vector loop leaves over."""
    if x.is_cuda:
        return torch.rsqrt(x)
    return torch.rsqrt(x.float()).to(x.dtype)


def irreps_layer_norm_apply(p, irreps: Irreps, x, eps: float = 1e-5):
    outs = []
    iw = ib = ims = 0
    for off, mul, ir in irreps.slices():
        d = ir.dim
        field = x[..., off : off + mul * d].reshape(x.shape[:-1] + (mul, d))
        mean = field.mean(dim=-2, keepdim=True)
        shift = p["mean_shift"][ims : ims + mul][:, None]
        field = field - mean * shift
        ims += mul
        norm = (field**2).mean(dim=-1).mean(dim=-1, keepdim=True)
        inv = _rsqrt(norm + eps) * p["weight"][iw : iw + mul]
        iw += mul
        field = field * inv[..., None]
        if d == 1 and ir.p == 1:
            field = field + p["bias"][ib : ib + mul][:, None]
            ib += mul
        outs.append(field.reshape(x.shape[:-1] + (mul * d,)))
    return torch.cat(outs, dim=-1)


def irreps_layer_norm_apply_cm(p, irreps: Irreps, x, eps: float = 1e-5):
    outs = []
    iw = ib = ims = 0
    for off, mul, ir in irreps.slices():
        d = ir.dim
        field = torch.stack(
            [x[..., off + k * mul : off + (k + 1) * mul] for k in range(d)], dim=-2
        )  # [..., d, mul]
        mean = field.mean(dim=-1, keepdim=True)
        shift = p["mean_shift"][ims : ims + mul]
        field = field - mean * shift[None, :]
        ims += mul
        norm = (field**2).mean(dim=-2).mean(dim=-1, keepdim=True)
        inv = _rsqrt(norm + eps) * p["weight"][iw : iw + mul]
        iw += mul
        field = field * inv[..., None, :]
        if d == 1 and ir.p == 1:
            field = field + p["bias"][ib : ib + mul][None, :]
            ib += mul
        outs.append(torch.cat([field[..., k, :] for k in range(d)], dim=-1))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def gaussian_smearing(d, start: float, stop: float, num: int):
    """[...] distances -> [..., num] RBF features."""
    offset = torch.linspace(start, stop, num, dtype=torch.float32, device=d.device)
    coeff = -0.5 / (offset[1] - offset[0]) ** 2
    return torch.exp(coeff * (d[..., None] - offset) ** 2)


def sinusoidal_time_emb(t, dim: int, scale: float = 1000.0):
    """t [...] in [0, 1] -> [..., dim]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) / (half - 1)
        * torch.arange(half, dtype=torch.float32, device=t.device)
    )
    ang = (t * scale)[..., None] * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def atom_encoder_apply(p, cat_feats, scalars):
    """cat_feats [..., n_cat] int ids; scalars [..., scalar_dim] or None."""
    x = 0.0
    for i, e in enumerate(p["embs"]):
        x = x + e["emb"][cat_feats[..., i]]
    if scalars is not None and "scalar_lin" in p:
        x = x + torch.cat([x, scalars], dim=-1) @ p["scalar_lin"]["w"]
    return x


# ---------------------------------------------------------------------------
# tensor-product convolution
# ---------------------------------------------------------------------------

# pairs per chunk of the 'fc' conv (fc_conv_mean): its per-pair TP weights
# number up to 7776 at flagship width, so a dense [16, 128, 1024] cross block
# of them would take ~65 GB; a chunk of this many pairs takes ~0.5 GB in f32
FC_CHUNK_PAIRS = 16384


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one TP conv layer.

    mode 'sep' (the default): depthwise TP with per-edge per-channel weights,
    then an edge-independent irreps Linear (`lin`, weights "mix") after
    aggregation. mode 'fc': the reference-exact fully connected TP with
    per-edge uvw weights (`fc`), no mix; checkpoints imported from the
    reference (utils/torch_import.py) need it."""

    mode: str
    out: Irreps
    fc: TensorProductSpec | None = None
    dw: TensorProductSpec | None = None
    lin: LinearSpec | None = None

    @property
    def tp(self) -> TensorProductSpec:
        """The per-edge weighted TP: `dw` under 'sep', `fc` under 'fc'."""
        return self.dw if self.mode == "sep" else self.fc

    @property
    def msg_dim(self) -> int:
        return self.tp.out.dim


def make_conv_spec(in_s: str, sh_s: str, out_s: str, mode: str = "sep") -> ConvSpec:
    out = Irreps.parse(out_s)
    if mode == "fc":
        return ConvSpec(mode, out, fc=compile_fc_tensor_product(in_s, sh_s, out_s))
    if mode != "sep":
        raise ValueError(f"conv mode {mode!r}: 'sep' or 'fc'")
    lmax = max(ir.l for _, ir in out.items)
    dw = compile_dw_tensor_product(in_s, sh_s, lmax_out=lmax)
    return ConvSpec(mode, out, dw=dw, lin=compile_linear(str(dw.out), out_s))


def tp_conv_messages(p, spec: ConvSpec, src_feat, edge_sh, edge_attr):
    """Per-edge weighted TP (before aggregation); under 'sep' the result
    lives in the depthwise output space, mixed after aggregation."""
    w = mlp_apply(p["fc"], edge_attr)
    if spec.mode == "fc":
        return apply_fc_tensor_product(spec.fc, src_feat, edge_sh, w)
    return apply_dw_tensor_product(spec.dw, src_feat, edge_sh, w)


def tp_conv_finalize(p, spec: ConvSpec, agg):
    if spec.mode == "sep":
        agg = apply_linear(spec.lin, agg, p["mix"])
    if "ln" in p:
        agg = irreps_layer_norm_apply(p["ln"], spec.out, agg)
    return agg


def fc_conv_mean(p, spec: ConvSpec, src, sh, e_parts, mask, chunk_pairs: int = FC_CHUNK_PAIRS):
    """masked_mean(tp_conv_messages(p, spec, src, sh, cat(e_parts)), mask,
    dim=2), computed chunk by chunk of pairs, never over the whole block.

    mask [B, R, K]; src [B, R, K, din], sh [B, R, K, d2] and each of e_parts
    [B, R, K, c] may have size 1 on any of their first three axes, which then
    broadcasts (pass x[:, None] rather than x[:, None].expand(...): the
    backward sums such an input's gradient over its broadcast axes chunk by
    chunk, while an expanded view would take its gradient at the block's
    size). The mean runs over the K pairs of each of the B x R rows. A chunk
    holds whole rows, max(1, chunk_pairs // K) of them, so each row's sum
    over its pairs is the one masked_mean takes, in the same dtype (f32 when
    K > 32). Pairs whose mask is 0 in every row are left out of every chunk,
    and so are rows whose pairs are all masked: their products are
    multiplied by 0 in the mean, so the function is the same. That choice
    costs one read of the mask to the host per call.

    Under autograd the forward keeps only its inputs and the live rows and
    columns; the backward walks the same chunks again, reruns each chunk's
    weight MLP and TP with grad enabled and takes its gradients, so at most
    one chunk's per-pair weights are alive (_FcConvMean). Returns [B, R,
    msg_dim] in the messages' dtype."""
    leaves = _tree_leaves(p["fc"])
    return _FcConvMean.apply(spec, chunk_pairs, mask, p["fc"], len(e_parts), src, sh,
                             *e_parts, *leaves)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _tree_like(tree, leaves: list):
    """`tree` with its leaves (in _tree_leaves order) replaced by `leaves`."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree)


def _chunk_index(x, bi, ri, ki):
    """x's index at a chunk's rows and pairs: an axis of size 1 broadcasts."""
    zero = bi.new_zeros(())
    return tuple(i if n > 1 else zero for i, n in zip((bi, ri, ki), x.shape[:3]))


def _take(x, bi, ri, ki):
    """x [B|1, R|1, K|1, c] at a chunk's rows and pairs -> [rows, pairs, c]."""
    return x[_chunk_index(x, bi, ri, ki)].expand(bi.shape[0], ki.shape[1], x.shape[-1])


def _put_add(acc, x, bi, ri, ki, g):
    """acc (x's shape, f32) += the chunk's gradient g [rows, pairs, c] at
    x's entries, summed first over the axes on which x broadcasts."""
    idx = _chunk_index(x, bi, ri, ki)
    shape = torch.broadcast_shapes(*[i.shape for i in idx])
    g = g.to(acc.dtype)
    for d, n in enumerate(shape):
        if n == 1 and g.shape[d] > 1:
            g = g.sum(dim=d, keepdim=True)
    acc.index_put_(idx, g, accumulate=True)


def _chunk_mean(fc, spec: ConvSpec, xs, n_parts: int, mask_c, n_r, acc):
    """One chunk's rows of the mean: xs = (src, sh, *e_parts) at the chunk
    ([rows, pairs, c] each), mask_c [rows, pairs], n_r [rows]."""
    src, sh, parts = xs[0], xs[1], xs[2 : 2 + n_parts]
    m = tp_conv_messages({"fc": fc}, spec, src, sh, torch.cat(parts, dim=-1))
    s = (m.to(acc) * mask_c[..., None].to(acc)).sum(dim=1)
    return (s.to(torch.float32) / torch.clamp(n_r, min=1.0)[:, None]).to(m.dtype)


class _FcConvMean(torch.autograd.Function):
    """fc_conv_mean with a backward that recomputes each chunk.

    Inputs: spec, chunk_pairs, mask, the fc MLP's tree (its structure), the
    number of e_parts, then src, sh, *e_parts and the MLP's leaves."""

    @staticmethod
    def _plan(ctx, mask, chunk_pairs):
        bsz, nrow, k = mask.shape
        live = mask > 0
        ctx.rows = torch.nonzero(live.any(dim=2).reshape(-1)).reshape(-1)
        ctx.cols = torch.nonzero(live.any(dim=(0, 1))).reshape(-1)
        ctx.n = mask.to(torch.float32).sum(dim=2).reshape(-1)
        ctx.step = max(1, chunk_pairs // max(int(ctx.cols.numel()), 1))
        ctx.nrow, ctx.acc_long = nrow, k > 32

    @staticmethod
    def _chunks(ctx, mask):
        """(rows r, bi, ri, ki, mask at the chunk) of every chunk."""
        ki = ctx.cols[None, :]
        for lo in range(0, int(ctx.rows.numel()), ctx.step):
            r = ctx.rows[lo : lo + ctx.step]
            bi, ri = (r // ctx.nrow)[:, None], (r % ctx.nrow)[:, None]
            yield r, bi, ri, ki, mask[bi, ri, ki]

    @staticmethod
    def forward(ctx, spec, chunk_pairs, mask, fc_tree, n_parts, *tensors):
        bsz, nrow, _ = mask.shape
        ctx.spec, ctx.fc_tree, ctx.n_parts = spec, fc_tree, n_parts
        _FcConvMean._plan(ctx, mask, chunk_pairs)
        xs, leaves = tensors[: 2 + n_parts], tensors[2 + n_parts :]
        fc = _tree_like(fc_tree, leaves)
        acc = torch.float32 if ctx.acc_long else xs[0].dtype
        out = xs[0].new_zeros(bsz * nrow, spec.msg_dim)
        for r, bi, ri, ki, mask_c in _FcConvMean._chunks(ctx, mask):
            out[r] = _chunk_mean(fc, spec, [_take(x, bi, ri, ki) for x in xs], n_parts,
                                 mask_c, ctx.n[r], acc)
        ctx.save_for_backward(mask, *tensors)
        return out.reshape(bsz, nrow, -1)

    @staticmethod
    def _chunk_grads(ctx, fc, lv, xs, need_x, index, mask_c, n_r, acc, g_r):
        """One chunk rerun with grad enabled: the gradients of its rows'
        mean (cotangent g_r) for its slices of xs and for lv (None where not
        needed). The chunk's graph, and its per-pair weights, go when this
        returns."""
        with torch.enable_grad():
            xc = [_take(x, *index).detach().requires_grad_(nd) for x, nd in zip(xs, need_x)]
            o = _chunk_mean(fc, ctx.spec, xc, ctx.n_parts, mask_c, n_r, acc)
            wrt = [t for t in xc + lv if t.requires_grad]
            got = iter(torch.autograd.grad(o, wrt, g_r.to(o.dtype), allow_unused=True))
        return [next(got) if t.requires_grad else None for t in xc + lv]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        mask, *tensors = ctx.saved_tensors
        n_parts = ctx.n_parts
        xs, leaves = tensors[: 2 + n_parts], tensors[2 + n_parts :]
        need = ctx.needs_input_grad[5:]
        need_x, need_p = need[: 2 + n_parts], need[2 + n_parts :]
        if not any(need):
            return (None,) * (5 + len(tensors))
        g = g_out.reshape(-1, g_out.shape[-1])
        gx = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) if nd else None
              for x, nd in zip(xs, need_x)]
        gp = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) if nd else None
              for w, nd in zip(leaves, need_p)]
        lv = [w.detach().requires_grad_(nd) for w, nd in zip(leaves, need_p)]
        fc = _tree_like(ctx.fc_tree, lv)
        acc = torch.float32 if ctx.acc_long else xs[0].dtype
        for r, bi, ri, ki, mask_c in _FcConvMean._chunks(ctx, mask):
            got = _FcConvMean._chunk_grads(ctx, fc, lv, xs, need_x, (bi, ri, ki), mask_c,
                                           ctx.n[r], acc, g[r])
            for x, gt, acc_x in zip(xs, got, gx):
                if gt is not None:
                    _put_add(acc_x, x, bi, ri, ki, gt)
            for gt, acc_p in zip(got[len(xs):], gp):
                if gt is not None:
                    acc_p += gt.to(torch.float32)
        grads = [None if a is None else a.to(x.dtype) for a, x in zip(gx + gp, tensors)]
        return (None, None, None, None, None, *grads)


def conv_mean(p, spec: ConvSpec, src, sh, e_parts, mask, dim: int):
    """masked_mean(tp_conv_messages(p, spec, src, sh, cat(e_parts)), mask,
    dim): a conv's messages averaged over its pairs, axis `dim` of the
    block. Under 'fc' fc_conv_mean takes it chunk by chunk, over the block
    laid out [B, R, K] with the mean's axis last ([B, 1, K] for a block
    [B, K])."""
    if spec.mode == "sep":
        def full(x):
            return x.expand(*mask.shape, x.shape[-1])
        return masked_mean(tp_conv_messages(p, spec, full(src), full(sh),
                                            torch.cat([full(x) for x in e_parts], dim=-1)),
                           mask, dim=dim)
    if mask.dim() == 2:
        def rows(x):
            return x[:, None]
    elif dim == 1:
        def rows(x):
            return x.transpose(1, 2)
    else:
        def rows(x):
            return x
    agg = fc_conv_mean(p, spec, rows(src), rows(sh), [rows(x) for x in e_parts], rows(mask))
    return agg[:, 0] if mask.dim() == 2 else agg


def tp_conv_finalize_cm(p, spec: ConvSpec, agg_cm):
    """tp_conv_finalize entirely in component-major layout."""
    out = apply_linear_cm(spec.lin, agg_cm, p["mix"])
    if "ln" in p:
        out = irreps_layer_norm_apply_cm(p["ln"], spec.out, out)
    return out


# ---------------------------------------------------------------------------
# masked aggregation helpers
# ---------------------------------------------------------------------------


def masked_mean(msgs, mask, dim: int):
    """Mean of msgs over `dim` counting only mask == 1 entries.

    Accumulates in f32 when the reduced axis is longer than 32 (bf16 sums
    over hundreds of neighbours lose precision); short reductions keep the
    message dtype. Returns msgs.dtype."""
    m = mask[..., None] if mask.dim() == msgs.dim() - 1 else mask
    acc = torch.float32 if msgs.shape[dim] > 32 else msgs.dtype
    s = (msgs.to(acc) * m.to(acc)).sum(dim=dim)
    n = m.to(torch.float32).sum(dim=dim)
    return (s.to(torch.float32) / torch.clamp(n, min=1.0)).to(msgs.dtype)


def pad_to_dim(x, dim: int):
    """Right-pad the last axis with zeros (irreps ladder residuals)."""
    if x.shape[-1] == dim:
        return x
    return torch.nn.functional.pad(x, (0, dim - x.shape[-1]))


# ---------------------------------------------------------------------------
# neighbour lists
# ---------------------------------------------------------------------------


def knn_edges(pos_q, pos_k, mask_q, mask_k, k: int, cutoff, exclude_self: bool = False):
    """Fixed-degree neighbour list from dense distances, batched.

    pos_q [..., Nq, 3], pos_k [..., Nk, 3], masks [..., N]. Returns (idx
    [..., Nq, k] int64, valid [..., Nq, k] bool): the k nearest keys within
    `cutoff` (a float or a tensor broadcastable to [..., 1, 1]). Exact
    top-k with ties to the lower index, as lax.top_k: a stable ascending
    sort, never torch.topk, whose tie order on CUDA is unspecified.
    """
    k = min(k, pos_k.shape[-2])
    d2 = ((pos_q[..., :, None, :] - pos_k[..., None, :, :]) ** 2).sum(dim=-1)
    # constants by fill on the device: no host copy, so no wait for the queue
    big = torch.full((), 1e10, dtype=d2.dtype, device=d2.device)
    invalid = ~(mask_k > 0)[..., None, :]
    if exclude_self:
        eye = torch.eye(pos_q.shape[-2], pos_k.shape[-2], dtype=torch.bool, device=d2.device)
        invalid = invalid | eye
    d2 = torch.where(invalid, big, d2)
    d2_sorted, idx = torch.sort(d2, dim=-1, stable=True)
    d2_sel, idx = d2_sorted[..., :k], idx[..., :k]
    cut = (cutoff.to(d2.device, d2.dtype) if torch.is_tensor(cutoff)
           else torch.full((), cutoff, dtype=d2.dtype, device=d2.device))
    valid = (d2_sel <= cut**2) & (mask_q > 0)[..., None] & (d2_sel < big * 0.5)
    return idx, valid


def sh_l2(vec):
    """Spherical harmonics 0e+1o+2e with component normalisation."""
    return spherical_harmonics_l2(vec, normalize=True)
