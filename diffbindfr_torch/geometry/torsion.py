"""Batched ligand pose updates: translation, rigid rotation, torsions,
Kabsch (counterpart of diffbindfr_tpu/geometry/torsion.py:19-130).

Every function takes a leading batch axis B. Torsions are applied in bond
order, as the JAX package's lax.scan does: each rotation moves the axes of
the bonds after it.
"""
from __future__ import annotations

import torch

from .kabsch import kabsch_align, kabsch_apply
from .rotations import axis_angle_to_matrix


def apply_torsion_updates(pos, tor_bonds, frag_mask, updates, tor_mask):
    """Rotate each bond's moving fragment about the bond axis.

    pos [B, L, 3]; tor_bonds [B, T, 2] (u, v), the v side rotates about
    pos[v] with axis pos[u] - pos[v]; frag_mask [B, T, L] bool; updates
    [B, T] radians; tor_mask [B, T] bool (False for padding).
    """
    bidx = torch.arange(pos.shape[0], device=pos.device)
    for i in range(tor_bonds.shape[1]):
        valid = tor_mask[:, i]
        theta = torch.where(valid, updates[:, i], torch.zeros_like(updates[:, i]))
        pu = pos[bidx, tor_bonds[:, i, 0]]
        pivot = pos[bidx, tor_bonds[:, i, 1]]
        axis = pu - pivot
        axis = axis * torch.rsqrt((axis**2).sum(dim=-1, keepdim=True) + 1e-12)
        R = axis_angle_to_matrix(axis * theta[:, None])
        rotated = (pos - pivot[:, None]) @ R.transpose(-1, -2) + pivot[:, None]
        move = (frag_mask[:, i] & valid[:, None])[..., None]
        pos = torch.where(move, rotated, pos)
    return pos


def modify_conformer(pos, node_mask, tr_update, rot_update, tor_bonds, frag_mask,
                     torsion_updates, tor_mask):
    """One pose update: centroid-centred rotation + translation, then the
    torsions, then Kabsch-align the flexible result onto the rigid one so
    that translation, rotation and torsions stay disentangled.

    pos [B, L, 3]; node_mask [B, L] bool; tr/rot [B, 3]; see
    apply_torsion_updates for the rest.
    """
    w = node_mask.to(pos.dtype)[..., None]
    n = torch.clamp(w.sum(dim=-2, keepdim=True), min=1.0)
    center = (pos * w).sum(dim=-2, keepdim=True) / n
    R = axis_angle_to_matrix(rot_update)
    rigid = (pos - center) @ R.transpose(-1, -2) + tr_update[:, None, :] + center
    flexible = apply_torsion_updates(rigid, tor_bonds, frag_mask, torsion_updates, tor_mask)
    Ra, ta = kabsch_align(flexible, rigid, node_mask.to(pos.dtype))
    aligned = kabsch_apply(Ra, ta, flexible)
    has_tor = tor_mask.any(dim=-1)[:, None, None]
    out = torch.where(has_tor, aligned, rigid)
    return torch.where(node_mask[..., None], out, pos)


def pose_transform(pos, node_mask, tr_update, rot_update, tor_bonds, frag_mask,
                   torsion_updates, tor_mask):
    """Torsions first, then the rigid move about the centroid, no Kabsch:
    the pose parametrisation of the gradient minimizers (differentiable
    everywhere, also at zero rotation).

    pos [B, L, 3]; node_mask [B, L] bool; tr/rot [B, 3]; see
    apply_torsion_updates for the rest.
    """
    flexible = apply_torsion_updates(pos, tor_bonds, frag_mask, torsion_updates, tor_mask)
    w = node_mask.to(pos.dtype)[..., None]
    n = torch.clamp(w.sum(dim=-2, keepdim=True), min=1.0)
    center = (flexible * w).sum(dim=-2, keepdim=True) / n
    R = axis_angle_to_matrix(rot_update)
    out = (flexible - center) @ R.transpose(-1, -2) + center + tr_update[:, None, :]
    return torch.where(node_mask[..., None], out, pos)
