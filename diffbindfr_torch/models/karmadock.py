"""KarmaDock pose refinement and scoring: the port's counterpart of
diffbindfr_tpu/models/karmadock.py, batched over poses.

The model family the MDN scorer (models/mdn_scorer.py) comes from: the
scorer's protein (GVP-GNN) and ligand (graph transformer) encoders, then
E(3)-equivariant attention layers that move the ligand atoms along their
relative vectors to the ligand and the pocket's CA atoms (EGNN_Block), a
gated residual fusion of the ligand features (Gate_Block), the MDN head's
score of the refined pose, and an AlphaFold-style AngleResnet that predicts
each residue's side-chain angles as normalised (sin, cos) pairs. The JAX
package runs one sample under vmap; here every tensor carries the batch
axis B first. No command runs it: it is a model of the family, held to the
JAX package by tests/test_torch_karmadock.py. `params_from_jax` carries a
JAX parameter tree (numpy leaves); `init_params` draws a fresh one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..nn.layers import gaussian_smearing, linear_apply, mlp_apply
from ..utils.checkpoint import params_from_numpy
from . import mdn_scorer as mdn


@dataclasses.dataclass(frozen=True)
class KarmaDockConfig:
    mdn: mdn.MDNConfig = mdn.MDNConfig()
    egnn_layers: int = 8
    egnn_heads: int = 4
    cross_cutoff: float = 10.0  # lig-protein edges for pose refinement


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def gate_apply(p, old, new):
    """Gated residual fusion (Gate_Block): g = sigmoid(W1 [old, new]);
    LN(old + g * W2 new)."""
    g = torch.sigmoid(linear_apply(p["w1"], torch.cat([old, new], dim=-1)))
    return mdn._scalar_ln(old + g * linear_apply(p["w2"], new))


def egnn_apply(p, cfg: KarmaDockConfig, lig_x, lig_pos, lig_mask, pro_x, pro_pos, pro_mask):
    """One E(3)-equivariant attention layer: ligand atoms attend over the
    ligand and the residues' CA atoms within cross_cutoff; coordinates move
    along the relative vectors by attention-weighted scalar gates.

    lig_x [B, NL, h], lig_pos [B, NL, 3], lig_mask [B, NL]; pro_x [B, R,
    h], pro_pos [B, R, 3], pro_mask [B, R]. Returns (x, new_pos)."""
    bsz, nl, h = lig_x.shape
    nh = cfg.egnn_heads
    dh = h // nh
    ctx_x = torch.cat([lig_x, pro_x], dim=1)  # [B, NC, h]
    ctx_pos = torch.cat([lig_pos, pro_pos], dim=1)
    ctx_mask = torch.cat([lig_mask, pro_mask], dim=1)
    nc = ctx_x.shape[1]

    vec = ctx_pos[:, None, :, :] - lig_pos[:, :, None, :]  # [B, NL, NC, 3]
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    rbf = gaussian_smearing(dist, 0.0, cfg.cross_cutoff, 16)
    e = mlp_apply(p["e_mlp"], torch.cat([lig_x[:, :, None, :] + ctx_x[:, None, :, :], rbf],
                                        dim=-1))
    q = linear_apply(p["q"], lig_x).reshape(bsz, nl, nh, dh)
    k = linear_apply(p["k"], ctx_x).reshape(bsz, nc, nh, dh)
    v = linear_apply(p["v"], ctx_x).reshape(bsz, nc, nh, dh)
    logits = torch.einsum("bihd,bjhd->bijh", q, k) / math.sqrt(dh)
    logits = logits + linear_apply(p["eb"], e)
    keep = ((dist <= cfg.cross_cutoff) & (lig_mask[:, :, None] > 0)
            & (ctx_mask[:, None, :] > 0))
    logits = torch.where(keep[..., None], logits, -1e9)
    att = torch.softmax(logits, dim=2)
    out = torch.einsum("bijh,bjhd->bihd", att, v).reshape(bsz, nl, h)
    x = mdn._scalar_ln(lig_x + linear_apply(p["o"], out))
    x = mdn._scalar_ln(x + mlp_apply(p["ff"], x, act=F.silu))

    # coordinate update: attention-mean of gated relative vectors
    gate = mlp_apply(p["coord_mlp"], e)[..., 0]  # [B, NL, NC]
    att_m = att.mean(dim=-1) * keep
    delta = ((att_m * gate)[..., None] * vec / (dist[..., None] + 1.0)).sum(dim=2)
    return x, lig_pos + delta * lig_mask[..., None]


def angle_resnet_apply(p, x, n_angles: int, eps: float = 1e-6):
    """AlphaFold-style angle head (AF2 supplementary algorithm 20): residual
    MLP -> [..., n_angles, 2] normalised (sin, cos) pairs."""
    a = linear_apply(p["in1"], torch.relu(x))
    for blk in p["blocks"]:
        hb = linear_apply(blk["l1"], torch.relu(a))
        a = a + linear_apply(blk["l2"], torch.relu(hb))
    sc = linear_apply(p["out"], torch.relu(a))
    sc = sc.reshape(sc.shape[:-1] + (n_angles, 2))
    return sc / torch.sqrt((sc**2).sum(dim=-1, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _mlp_init(gen, din, dout, hidden=None):
    hidden = dout if hidden is None else hidden
    return {"l1": mdn._linear_init(gen, din, hidden), "l2": mdn._linear_init(gen, hidden, dout)}


def init_params(generator: torch.Generator, cfg: KarmaDockConfig, device="cpu"):
    """A fresh parameter tree (float32 on `device`) drawn from the CPU
    `generator`: the JAX init_params tree, keys, shapes and distributions
    (xavier-uniform weights, zero biases) without the gate's unused key
    leaf; the draws differ."""
    g, h = generator, cfg.mdn.hidden
    lin = mdn._linear_init
    egnn = [{"q": lin(g, h, h), "k": lin(g, h, h), "v": lin(g, h, h),
             "e_mlp": _mlp_init(g, h + 16, h), "eb": lin(g, h, cfg.egnn_heads),
             "o": lin(g, h, h), "coord_mlp": _mlp_init(g, h, 1, hidden=h // 2),
             "ff": _mlp_init(g, h, h, hidden=2 * h)} for _ in range(cfg.egnn_layers)]
    p = {"encoder": mdn.init_params(g, cfg.mdn), "egnn": egnn,
         "node_gate": {"w1": lin(g, 2 * h, h), "w2": lin(g, h, h)},
         "angle": {"in1": lin(g, h, 32),
                   "blocks": [{"l1": lin(g, 32, 32), "l2": lin(g, 32, 32)} for _ in range(2)],
                   "out": lin(g, 32, 2 * 4)}}
    return params_from_numpy(p, device)


def params_from_jax(tree, device="cuda"):
    """A JAX KarmaDock parameter tree of numpy arrays -> the port's tree on
    `device`. The gate's "ln" leaf (a PRNG key the JAX model never reads)
    is left out, and so are the encoder's None leaves."""
    tree = dict(tree, node_gate={k: v for k, v in tree["node_gate"].items() if k != "ln"})
    return mdn.params_from_jax(tree, device)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


class KarmaDockOutput(NamedTuple):
    lig_pos: torch.Tensor  # [B, NL, 3] refined pose
    mdn_score: torch.Tensor  # [B]
    chi_sincos: torch.Tensor  # [B, R, 4, 2] predicted side-chain angles


def apply(params, cfg: KarmaDockConfig, s, lig_pos, pos14) -> KarmaDockOutput:
    """Pose refinement and scoring of B poses: s a DockingSample of tensors
    [B, ...], lig_pos [B, NL, 3], pos14 [B, R, 14, 3]."""
    mcfg = cfg.mdn
    enc = params["encoder"]
    pro_s = mdn._gvp_encode_protein(enc, mcfg, s, pos14)
    lig_s0 = mdn._gt_encode_ligand(enc, mcfg, s, lig_pos)

    ca = pos14[:, :, mdn.CA]
    lig_s, pos = lig_s0, lig_pos
    for lay in params["egnn"]:
        lig_s, pos = egnn_apply(lay, cfg, lig_s, pos, s.lig_mask, pro_s, ca, s.res_mask)
    lig_s = gate_apply(params["node_gate"], lig_s0, lig_s)

    out = mdn.mdn_head(enc, mcfg, lig_s, pro_s, pos, pos14, s)
    prob = mdn.mixture_prob(out.pi, out.sigma, out.mu, out.dist)
    keep = out.pair_mask & (out.dist <= mcfg.dist_threshold)
    score = torch.where(keep, prob, 0.0).sum(dim=(-1, -2))
    chi = angle_resnet_apply(params["angle"], pro_s, n_angles=4)
    return KarmaDockOutput(lig_pos=pos, mdn_score=score, chi_sincos=chi)
