"""MDN pose scorer (counterpart of diffbindfr_tpu/models/mdn_scorer.py): the
KarmaDock-style scoring head of `predict`, batched over poses.

It reads the DockingSample the dock used, the ligand positions and the
pocket's atom14 positions; every protein feature (backbone dihedrals,
orientation vectors, knn-30 CA graph edge features) is computed from them.

  * protein: vector-gated GVP-GNN encoder over the knn-30 CA graph -> 128
  * ligand: edge-aware graph transformer over the covalent graph (dense
    masked multi-head attention) -> 128
  * MDN: a 10-component Gaussian mixture per (ligand atom, residue) pair over
    their minimum atom14 distance; the score sums the mixture probability at
    the observed distance over pairs closer than 5 A.

`mdn_loss` is the training NLL (`train_cli --model mdn`, mdn_train.py),
differentiable through the encoders and the mixture head.

Parameters are the JAX package's tree (nested dicts and lists) as tensors:
`load_checkpoint(path, use_ema=True)` reads a checkpoint file,
`params_from_jax` carries a JAX parameter tree held as numpy arrays, and
`init_params` draws a fresh tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..nn.layers import gaussian_smearing, knn_edges, linear_apply
from ..utils.checkpoint import params_from_numpy

# atom14 slot order: N, CA, C, O, CB, ...
N_, CA, C_, O_, CB = 0, 1, 2, 3, 4

# mean_nll of a pose with no pair inside dist_threshold (it left the
# pocket): finite, and far above any real per-contact NLL
NO_CONTACT_NLL = 1e4


@dataclasses.dataclass(frozen=True)
class MDNConfig:
    lig_node_dim: int = 27
    lig_edge_dim: int = 10
    hidden: int = 128
    pro_scalar_in: int = 9
    pro_vector_in: int = 3
    pro_edge_scalar: int = 21
    pro_vector_hidden: int = 16
    gvp_layers: int = 3
    gt_layers: int = 6
    gt_heads: int = 4
    n_gaussians: int = 10
    knn: int = 30
    rbf_bins: int = 16
    dist_threshold: float = 5.0  # scoring cutoff (A)
    train_dist_threshold: float = 7.0  # pairs included in the MDN loss
    dropout: float = 0.1


def params_from_jax(tree, device="cuda"):
    """A JAX MDN parameter tree of numpy arrays (e.g. the JAX init_params
    output after np.asarray) -> the port's tree of tensors on `device`.
    Leaves that are None (a GVP without vector input has no `wh`) are left
    out, as the checkpoint files leave them out."""

    def drop_none(node):
        if isinstance(node, dict):
            return {k: drop_none(v) for k, v in node.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [drop_none(v) for v in node]
        return node

    return params_from_numpy(drop_none(tree), device)


def _xavier(gen, shape):
    a = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * a


def _linear_init(gen, din, dout, bias=True):
    p = {"w": _xavier(gen, (din, dout))}
    if bias:
        p["b"] = torch.zeros(dout)
    return p


def _gvp_init(gen, si, vi, so, vo):
    hv = max(vi, vo)
    p = {"wm": _linear_init(gen, si + (hv if vi else 0), so)}
    if vi:
        p["wh"] = _xavier(gen, (vi, hv))
    if vo:
        p["wu"] = _xavier(gen, (hv if vi else 1, vo))
        p["wg"] = _linear_init(gen, so, vo)
    return p


def init_params(generator: torch.Generator, cfg: MDNConfig, device="cpu"):
    """A fresh parameter tree (float32 on `device`) drawn from the CPU
    `generator`: the JAX package's init_params tree, keys, shapes and
    distributions (xavier-uniform weights, zero biases); the draws differ."""
    g, h, hv = generator, cfg.hidden, cfg.pro_vector_hidden
    p: dict = {"seq_emb": {"emb": _xavier(g, (21, 20))},
               "pro_node_in": [_gvp_init(g, cfg.pro_scalar_in + 20, cfg.pro_vector_in, h, hv)],
               "pro_edge_in": [_gvp_init(g, cfg.pro_edge_scalar, 1, 32, 1)],
               "gvp_layers": []}
    for _ in range(cfg.gvp_layers):
        p["gvp_layers"].append({
            "msg": [_gvp_init(g, h + 32 + h, hv + 1 + hv, h, hv), _gvp_init(g, h, hv, h, hv),
                    _gvp_init(g, h, hv, h, hv)],
            "ff": [_gvp_init(g, h, hv, 2 * h, 2 * hv), _gvp_init(g, 2 * h, 2 * hv, h, hv)]})
    p["pro_out"] = _gvp_init(g, h, hv, h, 0)
    p["lig_node_in"] = _linear_init(g, cfg.lig_node_dim, h)
    p["lig_edge_in"] = _linear_init(g, cfg.lig_edge_dim + 8, h)
    p["gt_layers"] = [{"q": _linear_init(g, h, h), "k": _linear_init(g, h, h),
                       "v": _linear_init(g, h, h), "eb": _linear_init(g, h, cfg.gt_heads),
                       "ev": _linear_init(g, h, h), "o": _linear_init(g, h, h),
                       "ff1": _linear_init(g, h, 2 * h), "ff2": _linear_init(g, 2 * h, h)}
                      for _ in range(cfg.gt_layers)]
    p["pair_l"] = _linear_init(g, h, h)
    p["pair_p"] = _linear_init(g, h, h, bias=False)
    for k in ("z_pi", "z_sigma", "z_mu"):
        p[k] = _linear_init(g, h, cfg.n_gaussians)
    p["atom_types"] = _linear_init(g, h, 18)
    p["bond_types"] = _linear_init(g, 2 * h, 5)
    return params_from_numpy(p, device)


# ---------------------------------------------------------------------------
# GVP primitives (vector-gated; Jing et al. 2021)
# ---------------------------------------------------------------------------


def _gvp_apply(p, s, V, act=torch.relu, vec_in: int = 0, vec_out: int = 0):
    """s [..., si]; V [..., vi, 3] (ignored when vec_in == 0)."""
    if vec_in:
        vh = torch.einsum("...vi,vw->...wi", V, p["wh"])
        norms = torch.sqrt((vh**2).sum(dim=-1) + 1e-8)
        s_out = linear_apply(p["wm"], torch.cat([s, norms], dim=-1))
    else:
        s_out = linear_apply(p["wm"], s)
    Vout = None
    if vec_out:
        base = vh if vec_in else s.new_zeros(s.shape[:-1] + (1, 3))
        Vout = torch.einsum("...wi,wu->...ui", base, p["wu"])
        gate = torch.sigmoid(linear_apply(p["wg"], act(s_out)))
        Vout = Vout * gate[..., None]
    return act(s_out), Vout


def _vec_layer_norm(V):
    n2 = (V**2).sum(dim=-1).mean(dim=-1, keepdim=True)
    return V * torch.rsqrt(n2 + 1e-8)[..., None]


def _scalar_ln(s):
    mu = s.mean(dim=-1, keepdim=True)
    var = ((s - mu) ** 2).mean(dim=-1, keepdim=True)
    return (s - mu) * torch.rsqrt(var + 1e-6)


# ---------------------------------------------------------------------------
# protein features (batched: [B, R, ...])
# ---------------------------------------------------------------------------


def _dihedral(p0, p1, p2, p3):
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1 = torch.cross(b0, b1, dim=-1)
    n2 = torch.cross(b1, b2, dim=-1)
    m1 = torch.cross(n1, b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-9),
                     dim=-1)
    x = (n1 * n2).sum(dim=-1)
    y = (m1 * n2).sum(dim=-1)
    return torch.atan2(y, x + 1e-12)


def _normalize(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)


def _gather_rows(x, idx):
    """x [B, R, ...], idx [B, R, K] -> [B, R, K, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def protein_graph_features(aatype, pos14, mask14, res_mask, knn: int, rbf_bins: int):
    """Residue node and edge features from atom14 geometry.

    Returns (node_s [B,R,9], node_v [B,R,3,3], nbr_idx [B,R,K], nbr_mask
    [B,R,K], edge_s [B,R,K,21], edge_v [B,R,K,1,3])."""
    r = aatype.shape[-1]
    dev = pos14.device
    ca, n, c, cb, o = (pos14[..., i, :] for i in (CA, N_, C_, CB, O_))
    has_cb = mask14[..., CB]
    cb = torch.where(has_cb[..., None] > 0, cb, ca)

    def d(a, b):
        return 0.1 * torch.linalg.vector_norm(a - b + 1e-6, dim=-1)

    intra = torch.stack([d(ca, cb), d(n, cb), d(n, c)], dim=-1)  # [B, R, 3]

    # backbone dihedrals against the previous / next residue; defined only
    # where the rolled-in neighbour is a real residue
    prev = torch.roll(torch.stack([ca, c], dim=-2), 1, dims=-3)  # prev CA, C
    nxt_n = torch.roll(n, -1, dims=-2)
    omega = _dihedral(prev[..., 0, :], prev[..., 1, :], n, ca)
    phi = _dihedral(prev[..., 1, :], n, ca, c)
    psi = _dihedral(n, ca, c, nxt_n)
    ar = torch.arange(r, device=dev)
    first, last = ar == 0, ar == r - 1
    prev_ok = (torch.roll(res_mask, 1, dims=-1) > 0) & (res_mask > 0) & ~first
    next_ok = (torch.roll(res_mask, -1, dims=-1) > 0) & (res_mask > 0) & ~last
    omega = torch.where(prev_ok, omega, 0.0)
    phi = torch.where(prev_ok, phi, 0.0)
    psi = torch.where(next_ok, psi, 0.0)
    dihed = torch.stack([omega, phi, psi], dim=-1)
    ang_mask = torch.stack([prev_ok, prev_ok, next_ok], dim=-1).to(pos14.dtype)
    node_s = torch.cat(
        [intra, torch.sin(dihed) * ang_mask, torch.cos(dihed) * ang_mask], dim=-1
    )  # [B, R, 9]

    fwd = _normalize(torch.roll(ca, -1, dims=-2) - ca) * next_ok[..., None]
    bwd = _normalize(torch.roll(ca, 1, dims=-2) - ca) * prev_ok[..., None]
    bis = _normalize(_normalize(c - ca) + _normalize(n - ca))
    perp = _normalize(torch.cross(_normalize(c - ca), _normalize(n - ca), dim=-1))
    side = -bis * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)
    node_v = torch.stack([fwd, bwd, side], dim=-2)  # [B, R, 3, 3]

    # knn graph over CA
    idx, valid = knn_edges(ca, ca, res_mask, res_mask, k=min(knn, r), cutoff=1e6,
                           exclude_self=True)
    com = (pos14 * mask14[..., None]).sum(dim=-2) / torch.clamp(
        mask14.sum(dim=-1, keepdim=True), min=1.0)
    ca_j = _gather_rows(ca, idx)
    cadist = d(ca[..., None, :], ca_j)
    cedist = d(com[..., None, :], _gather_rows(com, idx))
    cbdist = d(cb[..., None, :], _gather_rows(cb, idx))
    odist = d(o[..., None, :], _gather_rows(o, idx))
    connect = (cbdist < 0.45).to(pos14.dtype)
    rbf = gaussian_smearing(cbdist, 0.0, 2.0, rbf_bins)
    edge_s = torch.cat(
        [connect[..., None], cadist[..., None], cedist[..., None],
         cbdist[..., None], odist[..., None], rbf],
        dim=-1,
    )  # [B, R, K, 21]
    edge_v = _normalize(ca_j - ca[..., None, :])[..., None, :]  # [B, R, K, 1, 3]
    return node_s, node_v, idx, valid.to(pos14.dtype), edge_s, edge_v


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def _gvp_encode_protein(p, cfg: MDNConfig, s, pos14):
    hv = cfg.pro_vector_hidden
    node_s, node_v, idx, nmask, edge_s, edge_v = protein_graph_features(
        s.aatype, pos14, s.atom14_mask, s.res_mask, cfg.knn, cfg.rbf_bins
    )
    node_s = torch.cat([node_s, p["seq_emb"]["emb"][s.aatype]], dim=-1)
    hs, hV = _gvp_apply(p["pro_node_in"][0], node_s, node_v,
                        vec_in=cfg.pro_vector_in, vec_out=hv)
    es, eV = _gvp_apply(p["pro_edge_in"][0], edge_s, edge_v, vec_in=1, vec_out=1)

    w = nmask[..., None]
    denom = torch.clamp(nmask.sum(dim=-1), min=1.0)  # [B, R]
    for lay in p["gvp_layers"]:
        # messages: (s_j, edge_s, s_i) x (V_j, edge_v, V_i)
        sj, Vj = _gather_rows(hs, idx), _gather_rows(hV, idx)
        si_ = hs[..., None, :].expand(sj.shape)
        Vi_ = hV[..., None, :, :].expand(Vj.shape)
        ms = torch.cat([sj, es, si_], dim=-1)
        mV = torch.cat([Vj, eV, Vi_], dim=-2)
        ms, mV = _gvp_apply(lay["msg"][0], ms, mV, vec_in=2 * hv + 1, vec_out=hv)
        ms, mV = _gvp_apply(lay["msg"][1], ms, mV, vec_in=hv, vec_out=hv)
        ms, mV = _gvp_apply(lay["msg"][2], ms, mV, vec_in=hv, vec_out=hv)
        agg_s = (ms * w).sum(dim=-2) / denom[..., None]
        agg_V = (mV * w[..., None]).sum(dim=-3) / denom[..., None, None]
        hs = _scalar_ln(hs + agg_s)
        hV = _vec_layer_norm(hV + agg_V)
        fs, fV = _gvp_apply(lay["ff"][0], hs, hV, vec_in=hv, vec_out=2 * hv)
        fs, fV = _gvp_apply(lay["ff"][1], fs, fV, vec_in=2 * hv, vec_out=hv)
        hs = _scalar_ln(hs + fs)
        hV = _vec_layer_norm(hV + fV)

    out_s, _ = _gvp_apply(p["pro_out"], hs, hV, vec_in=hv, vec_out=0)
    return out_s  # [B, R, h]


def _gt_encode_ligand(p, cfg: MDNConfig, s, lig_pos):
    h, nh = cfg.hidden, cfg.gt_heads
    dh = h // nh
    B, nl = s.lig_mask.shape
    dev = lig_pos.device
    x = linear_apply(p["lig_node_in"], s.lig_feat)

    # dense edge embedding from the covalent edge list (+ bond-length RBF)
    b = torch.arange(B, device=dev)[:, None]
    src, dst = s.lig_e_src, s.lig_e_dst
    dist = torch.linalg.vector_norm(lig_pos[b, dst] - lig_pos[b, src] + 1e-9, dim=-1)
    efeat = torch.cat([s.lig_e_feat, gaussian_smearing(dist, 0.0, 4.0, 8)], dim=-1)
    e = linear_apply(p["lig_edge_in"], efeat) * s.lig_e_mask[..., None]
    bb = b.expand(src.shape)
    e_dense = x.new_zeros(B, nl, nl, h).index_put_((bb, src, dst), e, accumulate=True)
    adj = x.new_zeros(B, nl, nl).index_put_((bb, src, dst), s.lig_e_mask, accumulate=True)
    attend = (adj > 0) | torch.eye(nl, dtype=torch.bool, device=dev)
    attend = attend & (s.lig_mask[:, :, None] > 0) & (s.lig_mask[:, None, :] > 0)

    for lay in p["gt_layers"]:
        q = linear_apply(lay["q"], x).reshape(B, nl, nh, dh)
        k = linear_apply(lay["k"], x).reshape(B, nl, nh, dh)
        v = linear_apply(lay["v"], x).reshape(B, nl, nh, dh)
        eb = linear_apply(lay["eb"], e_dense)  # [B, NL, NL, nh]
        logits = torch.einsum("bihd,bjhd->bijh", q, k) / math.sqrt(dh) + eb
        logits = torch.where(attend[..., None], logits, -1e9)
        att = torch.softmax(logits, dim=2)
        ev = linear_apply(lay["ev"], e_dense).reshape(B, nl, nl, nh, dh)
        out = torch.einsum("bijh,bjhd->bihd", att, v) + torch.einsum(
            "bijh,bijhd->bihd", att, ev)
        x = _scalar_ln(x + linear_apply(lay["o"], out.reshape(B, nl, h)))
        y = linear_apply(lay["ff2"], F.silu(linear_apply(lay["ff1"], x)))
        x = _scalar_ln(x + y)
    return x * s.lig_mask[..., None]  # [B, NL, h]


# ---------------------------------------------------------------------------
# MDN head and scores
# ---------------------------------------------------------------------------


class MDNOutput(NamedTuple):
    pi: torch.Tensor  # [B, NL, R, G]
    sigma: torch.Tensor
    mu: torch.Tensor
    dist: torch.Tensor  # [B, NL, R] min atom14 distance
    pair_mask: torch.Tensor  # [B, NL, R]
    atom_logits: torch.Tensor  # [B, NL, 18]
    bond_logits: torch.Tensor  # [B, EL, 5]


def mdn_head(p, cfg: MDNConfig, lig_s, pro_s, lig_pos, pos14, s):
    # pairwise hidden: the first layer split across the concat boundary
    hidden = (linear_apply(p["pair_l"], lig_s)[:, :, None, :]
              + linear_apply(p["pair_p"], pro_s)[:, None, :, :])
    if "pair_norm" in p:
        # imported weights: eval-mode BatchNorm folded to a per-channel affine
        hidden = hidden * p["pair_norm"]["scale"] + p["pair_norm"]["shift"]
    else:
        hidden = _scalar_ln(hidden)
    hidden = F.elu(hidden)
    pi = torch.softmax(linear_apply(p["z_pi"], hidden), dim=-1)
    sigma = F.elu(linear_apply(p["z_sigma"], hidden)) + 1.1
    mu = F.elu(linear_apply(p["z_mu"], hidden)) + 1.0

    # min distance ligand atom <-> residue atom14
    d = torch.linalg.vector_norm(
        lig_pos[:, :, None, None, :] - pos14[:, None, :, :, :] + 1e-9, dim=-1
    )  # [B, NL, R, 14]
    d = torch.where(s.atom14_mask[:, None] > 0, d, 1e4)
    dist = d.min(dim=-1).values
    pair_mask = (s.lig_mask[:, :, None] * s.res_mask[:, None, :]) > 0

    b = torch.arange(lig_s.shape[0], device=lig_s.device)[:, None]
    atom_logits = linear_apply(p["atom_types"], lig_s)
    bond_logits = linear_apply(
        p["bond_types"],
        torch.cat([lig_s[b, s.lig_e_src], lig_s[b, s.lig_e_dst]], dim=-1),
    )
    return MDNOutput(pi, sigma, mu, dist, pair_mask, atom_logits, bond_logits)


def _log_gauss(y, mu, sigma):
    return -0.5 * ((y - mu) / sigma) ** 2 - torch.log(sigma) - 0.5 * math.log(2 * math.pi)


def mixture_prob(pi, sigma, mu, y):
    """sum_k pi_k N(y | mu_k, sigma_k)."""
    logp = _log_gauss(y[..., None], mu, sigma) + torch.log(pi + 1e-12)
    return torch.exp(logp).sum(dim=-1)


def score_batch_both(p, cfg: MDNConfig, batch, lig_pos, pos14):
    """([B] summed probability, [B] mean per-contact NLL) of B poses.

    batch: a DockingSample of tensors [B, ...]; lig_pos [B, NL, 3]; pos14
    [B, R, 14, 3]. The summed probability (higher = better) grows with the
    interface; the mean NLL over the pairs inside dist_threshold (lower =
    better) does not. A pose with no such pair gets NO_CONTACT_NLL."""
    pro_s = _gvp_encode_protein(p, cfg, batch, pos14)
    lig_s = _gt_encode_ligand(p, cfg, batch, lig_pos)
    out = mdn_head(p, cfg, lig_s, pro_s, lig_pos, pos14, batch)
    keep = out.pair_mask & (out.dist <= cfg.dist_threshold)
    prob = mixture_prob(out.pi, out.sigma, out.mu, out.dist)
    sum_prob = torch.where(keep, prob, 0.0).sum(dim=(-1, -2))
    logp = _log_gauss(out.dist[..., None], out.mu, out.sigma) + torch.log(out.pi + 1e-12)
    nll = -torch.logsumexp(logp, dim=-1)
    n_keep = keep.sum(dim=(-1, -2)).to(nll.dtype)
    mean_nll = torch.where(
        n_keep > 0,
        torch.where(keep, nll, 0.0).sum(dim=(-1, -2)) / torch.clamp(n_keep, min=1.0),
        NO_CONTACT_NLL,
    )
    return sum_prob, mean_nll


def score_sample_both(p, cfg: MDNConfig, s, lig_pos, pos14):
    """(summed probability, mean NLL) of one pose: unbatched tensors."""
    sb = type(s)(*[v[None] for v in s])
    sp_, nll = score_batch_both(p, cfg, sb, lig_pos[None], pos14[None])
    return sp_[0], nll[0]


def mdn_loss(p, cfg: MDNConfig, batch, lig_pos, pos14):
    """[B] training NLL of B poses (the JAX mdn_loss per sample): the mean
    over the pairs closer than train_dist_threshold of the mixture's
    negative log-likelihood at their distance; differentiable in `p`."""
    pro_s = _gvp_encode_protein(p, cfg, batch, pos14)
    lig_s = _gt_encode_ligand(p, cfg, batch, lig_pos)
    out = mdn_head(p, cfg, lig_s, pro_s, lig_pos, pos14, batch)
    logp = _log_gauss(out.dist[..., None], out.mu, out.sigma) + torch.log(out.pi + 1e-12)
    nll = -torch.logsumexp(logp, dim=-1)
    keep = out.pair_mask & (out.dist <= cfg.train_dist_threshold)
    n_keep = keep.sum(dim=(-1, -2)).to(nll.dtype)
    return torch.where(keep, nll, 0.0).sum(dim=(-1, -2)) / torch.clamp(n_keep, min=1.0)
