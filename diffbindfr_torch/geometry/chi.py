"""Side-chain all-atom rebuild from frames and torsions: AlphaFold2
supplementary Algorithm 24 (counterpart of
diffbindfr_tpu/geometry/chi.py:191 build_atom14). It reads no residue
constants: the frames, templates and group indices come with the sample.
"""
from __future__ import annotations

import torch


def build_atom14(torsion_sincos, backbone_rots, backbone_transl, default_frame,
                 template_pos, group_idx, atom14_mask):
    """Atom14 positions [..., N, 14, 3] from (sin, cos) of (psi, chi1..4)
    [..., N, 5, 2], backbone frames [..., N, 3, 3] / [..., N, 3], default
    frames [..., N, 8, 4, 4], templates [..., N, 14, 3] and group ids."""
    norm = torch.sqrt((torsion_sincos**2).sum(dim=-1, keepdim=True) + 1e-12)
    sc = torsion_sincos / norm
    s, c = sc[..., 0], sc[..., 1]
    lead = s.shape[:-1]
    # groups 0..2 get identity x-rotations; groups 3..7 rotate by psi, chi1..4
    s8 = torch.cat([s.new_zeros(lead + (3,)), s], dim=-1)
    c8 = torch.cat([c.new_ones(lead + (3,)), c], dim=-1)
    one, zero = torch.ones_like(s8), torch.zeros_like(s8)
    rot_x = torch.stack(
        [
            torch.stack([one, zero, zero], dim=-1),
            torch.stack([zero, c8, -s8], dim=-1),
            torch.stack([zero, s8, c8], dim=-1),
        ],
        dim=-2,
    )
    R = default_frame[..., :3, :3] @ rot_x  # [..., N, 8, 3, 3]
    T = default_frame[..., :3, 3]  # [..., N, 8, 3]

    def compose(Ra, Ta, Rb, Tb):
        return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, Tb) + Ta

    R4, T4 = R[..., 4, :, :], T[..., 4, :]
    R5, T5 = compose(R4, T4, R[..., 5, :, :], T[..., 5, :])
    R6, T6 = compose(R5, T5, R[..., 6, :, :], T[..., 6, :])
    R7, T7 = compose(R6, T6, R[..., 7, :, :], T[..., 7, :])
    R_all = torch.stack([R[..., 0, :, :], R[..., 1, :, :], R[..., 2, :, :], R[..., 3, :, :],
                         R4, R5, R6, R7], dim=-3)
    T_all = torch.stack([T[..., 0, :], T[..., 1, :], T[..., 2, :], T[..., 3, :],
                         T4, T5, T6, T7], dim=-2)
    Rg = torch.einsum("...ij,...gjk->...gik", backbone_rots, R_all)
    Tg = torch.einsum("...ij,...gj->...gi", backbone_rots, T_all) + backbone_transl[..., None, :]
    gi = group_idx.long()
    sel_R = torch.gather(Rg, -3, gi[..., None, None].expand(gi.shape + (3, 3)))
    sel_T = torch.gather(Tg, -2, gi[..., None].expand(gi.shape + (3,)))
    pos = torch.einsum("...aij,...aj->...ai", sel_R, template_pos) + sel_T
    return pos * atom14_mask[..., None]
