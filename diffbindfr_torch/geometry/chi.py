"""Side-chain chi extraction (numpy, prep) and all-atom rebuild (torch,
the sampler's path): the port's counterpart of diffbindfr_tpu/geometry/chi.py.

  - `extract_chi_and_template` (reference prot_math.py:116-241): from an
    experimental pocket, the per-residue backbone frames, psi/chi1-4, a
    custom per-residue template (so the rebuild reproduces the input bond
    geometry) and the default frames chaining each chi group to its parent.
    The same numpy operations as the JAX package's, so the same bits.
  - `build_atom14`: AlphaFold2 supplementary Algorithm 24. It reads no
    residue constants: the frames, templates and group ids come with the
    sample.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..constants import residues as rc

# ---------------------------------------------------------------------------
# numpy prep
# ---------------------------------------------------------------------------


def _rigid_4x4_np(ex, ey, t, eps=1e-6):
    ex = ex / (np.linalg.norm(ex, axis=-1, keepdims=True) + eps)
    ey = ey - np.sum(ey * ex, axis=-1, keepdims=True) * ex
    ey = ey / (np.linalg.norm(ey, axis=-1, keepdims=True) + eps)
    ez = np.cross(ex, ey)
    n = ex.shape[0]
    m = np.zeros((n, 4, 4), dtype=np.float32)
    m[:, :3, 0] = ex
    m[:, :3, 1] = ey
    m[:, :3, 2] = ez
    m[:, :3, 3] = t
    m[:, 3, 3] = 1.0
    return m


def _residue_frame_np(origin, x_axis, xy_plane, eps=1e-20):
    e0 = x_axis - origin
    e1 = xy_plane - origin
    e0 = e0 / np.sqrt(np.sum(e0**2, axis=-1, keepdims=True) + eps)
    e1 = e1 - e0 * np.sum(e0 * e1, axis=-1, keepdims=True)
    e1 = e1 / np.sqrt(np.sum(e1**2, axis=-1, keepdims=True) + eps)
    e2 = np.cross(e0, e1)
    return np.stack([e0, e1, e2], axis=-1), origin


def _apply_inv_np(x, R, t):
    """x [N, M, 3], R [N, 3, 3], t [N, 3] -> R^T (x - t)."""
    return np.einsum("nlk,nml->nmk", R, x - t[:, None, :])


def _parse_xrot_np(p):
    """p [N, 3] -> (projection onto xy-plane with y>=0, rotation angle)."""
    yz = p.copy()
    yz[:, 0] = 0.0
    r = np.linalg.norm(yz, axis=-1)
    proj = np.zeros_like(p)
    proj[:, 0] = p[:, 0]
    proj[:, 1] = r
    angle = np.arctan2(p[:, 2], p[:, 1])
    return proj.astype(np.float32), angle.astype(np.float32)


def _rot_x_np(x, angle):
    """Rotate points x [N, M, 3] about the x axis by per-row angle [N]."""
    c, s = np.cos(angle), np.sin(angle)
    y = x.copy()
    y[..., 1] = c[:, None] * x[..., 1] - s[:, None] * x[..., 2]
    y[..., 2] = s[:, None] * x[..., 1] + c[:, None] * x[..., 2]
    return y


class ChiTemplate(NamedTuple):
    """Per-residue frame/template record (all numpy, preprocessing output)."""

    sequence: np.ndarray  # [N] aatype
    atom14_position: np.ndarray  # [N, 14, 3]
    atom14_mask: np.ndarray  # [N, 14]
    backbone_transl: np.ndarray  # [N, 3]
    backbone_rots: np.ndarray  # [N, 3, 3]
    default_frame: np.ndarray  # [N, 8, 4, 4]
    rigid_group_positions: np.ndarray  # [N, 14, 3]
    torsion_angle: np.ndarray  # [N, 5] radians: psi, chi1..4


def extract_chi_and_template(
    aatype: np.ndarray,
    atom14_pos: np.ndarray,
    atom14_mask: np.ndarray,
) -> ChiTemplate:
    """Recover frames, torsions and custom templates from a structure.

    Residues with missing chi atoms get partially-zero templates; the caller
    (SCFixer equivalent) replaces those with ideal AF2 constants.
    """
    num_res = aatype.shape[0]
    chi_to_a14 = rc.chi_angles_to_atom14[aatype]  # [N, 4, 4]
    chi_mask = rc.chi_angles_mask[aatype]  # [N, 4]
    group_of = rc.restype_atom14_to_rigid_group[aatype]  # [N, 14]

    template = np.zeros((num_res, 14, 3), dtype=np.float32)
    frames = np.zeros((num_res, 8, 4, 4), dtype=np.float32)
    frames[:] = np.eye(4, dtype=np.float32)
    angles = np.zeros((num_res, 5), dtype=np.float32)

    rots, transl = _residue_frame_np(
        atom14_pos[:, 1], atom14_pos[:, 2], atom14_pos[:, 0]
    )
    local = _apply_inv_np(atom14_pos, rots, transl)

    template[:, 0, :2] = local[:, 0, :2]  # N (in xy-plane by construction)
    template[:, 2, :1] = local[:, 2, :1]  # C (on the x axis)
    template[:, 4, :] = local[:, 4, :]  # CB (GLY keeps zeros via mask)

    # phi frame (group 2): x along CA->N, xy-plane via global +x convention
    frames[:, 2] = _rigid_4x4_np(
        template[:, 0] - template[:, 1],
        np.tile(np.array([1.0, 0.0, 0.0], dtype=np.float32), (num_res, 1)),
        template[:, 0],
    )
    # psi frame (group 3): x along CA->C, xy-plane via N
    frames[:, 3] = _rigid_4x4_np(
        template[:, 2] - template[:, 1],
        template[:, 1] - template[:, 0],
        template[:, 2],
    )
    psi_local = _apply_inv_np(local, frames[:, 3, :3, :3], template[:, 2])
    o_proj, psi = _parse_xrot_np(psi_local[:, 3])
    template[:, 3] = o_proj
    angles[:, 0] = psi

    # chi chain: rotate residue coordinates into each chi frame in turn
    cur = local
    for k in range(4):
        m = chi_mask[:, k].astype(bool)
        if not m.any():
            continue
        sub = cur[m]
        n_sub = sub.shape[0]
        quad_idx = chi_to_a14[m, k]  # [n_sub, 4]
        quad = sub[np.arange(n_sub)[:, None], quad_idx]  # [n_sub, 4, 3]
        if k == 0:
            mat = _rigid_4x4_np(
                quad[:, 2] - quad[:, 1], quad[:, 0] - quad[:, 1], quad[:, 2]
            )
        else:
            ey = np.tile(np.array([-1.0, 0.0, 0.0], dtype=np.float32), (n_sub, 1))
            mat = _rigid_4x4_np(quad[:, 2], ey, quad[:, 2])
        frames[m, 4 + k] = mat
        sub_local = _apply_inv_np(sub, mat[:, :3, :3], quad[:, 2])
        quad_local = sub_local[np.arange(n_sub)[:, None], quad_idx]
        _, chi = _parse_xrot_np(quad_local[:, 3])
        angles[m, k + 1] = chi
        sub_rot = _rot_x_np(sub_local, -chi)
        in_group = group_of[m] == (4 + k)  # [n_sub, 14]
        tpl = template[m]
        tpl[in_group] = sub_rot[in_group]
        template[m] = tpl
        cur_m = cur[m]
        cur_m[:] = sub_rot
        cur[m] = cur_m

    return ChiTemplate(
        sequence=aatype.astype(np.int64),
        atom14_position=atom14_pos.astype(np.float32),
        atom14_mask=atom14_mask.astype(np.float32),
        backbone_transl=transl.astype(np.float32),
        backbone_rots=rots.astype(np.float32),
        default_frame=frames,
        rigid_group_positions=template * atom14_mask[..., None].astype(np.float32),
        torsion_angle=angles,
    )


# ---------------------------------------------------------------------------
# torch rebuild (AF2 Algorithm 24)
# ---------------------------------------------------------------------------


def build_atom14(torsion_sincos, backbone_rots, backbone_transl, default_frame,
                 template_pos, group_idx, atom14_mask):
    """Atom14 positions [..., N, 14, 3] from (sin, cos) of (psi, chi1..4)
    [..., N, 5, 2], backbone frames [..., N, 3, 3] / [..., N, 3], default
    frames [..., N, 8, 4, 4], templates [..., N, 14, 3] and group ids.
    torch is imported here, not with the module, which host prep reads."""
    import torch

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
