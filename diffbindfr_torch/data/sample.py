"""Fixed-shape padded docking samples as tensors.

Counterpart of diffbindfr_tpu/data/sample.py: one (pocket, ligand) pair is a
`DockingSample` of dense arrays padded to a bucket size class; a batch
stacks samples of one bucket along a new leading axis. Fields hold numpy
arrays on the host (as `make_sample` builds them or a prep cache holds
them) or tensors on a device.

Pocket atoms use a packed layout: the existing atom14 slots of all pocket
residues flattened in (residue, slot) order; `pack_flat` maps each packed
atom back to r * 14 + slot.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..constants import residues as rc

CA37, CB37 = 1, 3  # atom37 ids of CA / CB (constants/residues.py atom37_order)


@dataclasses.dataclass(frozen=True)
class Buckets:
    """Static size class of a padded sample."""

    n_lig: int = 64
    n_lig_edges: int = 160
    n_tor: int = 24
    n_res: int = 64
    n_atm: int = 512


# Ligand and pocket ladders are independent (diffbindfr_tpu/data/sample.py:57-75).
LIG_BUCKET_LEVELS = (
    (32, 80, 12),
    (64, 160, 24),
    (96, 224, 32),
    (128, 288, 48),
)
POCKET_BUCKET_LEVELS = (
    (48, 384),
    (64, 512),
    (96, 768),
    (128, 1024),
)


def choose_bucket(n_lig: int, n_edges: int, n_tor: int, n_res: int, n_atm: int):
    for nl, ne, nt in LIG_BUCKET_LEVELS:
        if n_lig <= nl and n_edges <= ne and n_tor <= nt:
            break
    else:
        raise ValueError(
            f"ligand too large for all buckets: lig={n_lig} "
            f"edges={n_edges} tor={n_tor}"
        )
    for nr, na in POCKET_BUCKET_LEVELS:
        if n_res <= nr and n_atm <= na:
            break
    else:
        raise ValueError(f"pocket too large for all buckets: res={n_res} atm={n_atm}")
    return Buckets(nl, ne, nt, nr, na)


class DockingSample(NamedTuple):
    """One padded (pocket, ligand) pair; field order matches the JAX package."""

    lig_feat: object  # [NL, 27] f32
    lig_pos: object  # [NL, 3] f32
    lig_ref_pos: object  # [NL, 3] f32
    lig_mask: object  # [NL] f32
    lig_e_src: object  # [EL] i32
    lig_e_dst: object  # [EL] i32
    lig_e_feat: object  # [EL, 10] f32
    lig_e_mask: object  # [EL] f32
    tor_src: object  # [T] i32
    tor_dst: object  # [T] i32
    tor_mask: object  # [T] f32
    rot_node_mask: object  # [T, NL] f32
    atm_pos: object  # [NA, 3] f32
    atm_mask: object  # [NA] f32
    atm_feat: object  # [NA, 5] i32
    cab_idx: object  # [NCAB] i32
    cab_mask: object  # [NCAB] f32
    noncab_mask: object  # [NA] f32
    sc_src: object  # [R, 4] i32
    sc_dst: object  # [R, 4] i32
    chi_mask: object  # [R, 4] f32
    aatype: object  # [R] i32
    res_mask: object  # [R] f32
    backbone_rots: object  # [R, 3, 3] f32
    backbone_transl: object  # [R, 3] f32
    default_frame: object  # [R, 8, 4, 4] f32
    template_pos: object  # [R, 14, 3] f32
    group_idx: object  # [R, 14] i32
    atom14_mask: object  # [R, 14] f32
    torsion_angle: object  # [R, 5] f32
    pack_flat: object  # [NA] i32
    pocket_center: object  # [3] f32


def _pad(a: np.ndarray, n: int, axis: int = 0, fill=0):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n - a.shape[axis])
    return np.pad(a, pad, constant_values=fill)


def make_sample(lig, pocket) -> DockingSample:
    """Freeze one featurised pair (chem/records.py's LigandRecord and
    PocketRecord) into a padded numpy DockingSample at the smallest bucket
    that holds it (choose_bucket; `bucket_of` reads it back), as
    diffbindfr_tpu/data/sample.py:142-226 does: the same operations, so the
    same bits."""
    nl, el, nt = lig.num_atoms, lig.edge_index.shape[1], lig.num_torsions
    r = pocket.num_res

    # --- packed pocket atoms
    exists = pocket.atom14_mask.astype(bool)  # [R, 14]
    ridx, aidx = np.nonzero(exists)
    na = ridx.shape[0]
    b = choose_bucket(nl, el, nt, r, na)

    pack_flat = ridx * 14 + aidx
    atm_pos = pocket.atom14_pos.reshape(-1, 3)[pack_flat]
    atm_feat = pocket.node_feat[ridx, aidx].astype(np.int32)  # [NA, 5]
    a37 = rc.restype_atom14_to_atom37[pocket.aatype][ridx, aidx]
    is_cab = (a37 == CA37) | (a37 == CB37)

    # inverse map: (r, a14) -> packed index (0 for missing; masked out)
    inv = np.zeros((r, 14), dtype=np.int64)
    inv[ridx, aidx] = np.arange(na)

    # chi rotation bonds j->k in packed coordinates
    chi_bonds = rc.restype_chi_bond_atom14[pocket.aatype]  # [R, 4, 2]
    rr = np.arange(r)[:, None]
    sc_src = inv[rr, chi_bonds[..., 0]]
    sc_dst = inv[rr, chi_bonds[..., 1]]
    chi_mask = pocket.chi_mask.astype(np.float32)
    sc_src = sc_src * (chi_mask > 0)
    sc_dst = sc_dst * (chi_mask > 0)

    cab_pos = np.nonzero(is_cab)[0]
    ncab = cab_pos.shape[0]
    n_cab = 2 * b.n_res  # CA+CB compact list length

    return DockingSample(
        lig_feat=_pad(lig.node_feat.astype(np.float32), b.n_lig),
        lig_pos=_pad(lig.pos.astype(np.float32), b.n_lig),
        lig_ref_pos=_pad(lig.pos.astype(np.float32), b.n_lig),
        lig_mask=_pad(np.ones(nl, np.float32), b.n_lig),
        lig_e_src=_pad(lig.edge_index[0].astype(np.int32), b.n_lig_edges),
        lig_e_dst=_pad(lig.edge_index[1].astype(np.int32), b.n_lig_edges),
        lig_e_feat=_pad(lig.edge_feat.astype(np.float32), b.n_lig_edges),
        lig_e_mask=_pad(np.ones(el, np.float32), b.n_lig_edges),
        tor_src=_pad(lig.edge_index[0][lig.tor_edge_mask].astype(np.int32), b.n_tor),
        tor_dst=_pad(lig.edge_index[1][lig.tor_edge_mask].astype(np.int32), b.n_tor),
        tor_mask=_pad(np.ones(nt, np.float32), b.n_tor),
        rot_node_mask=_pad(_pad(lig.rot_node_mask.astype(np.float32), b.n_lig, axis=1),
                           b.n_tor),
        atm_pos=_pad(atm_pos.astype(np.float32), b.n_atm),
        atm_mask=_pad(np.ones(na, np.float32), b.n_atm),
        atm_feat=_pad(atm_feat, b.n_atm),
        cab_idx=_pad(cab_pos.astype(np.int32), n_cab),
        cab_mask=_pad(np.ones(ncab, np.float32), n_cab),
        noncab_mask=_pad((~is_cab).astype(np.float32), b.n_atm),
        sc_src=_pad(sc_src.astype(np.int32), b.n_res),
        sc_dst=_pad(sc_dst.astype(np.int32), b.n_res),
        chi_mask=_pad(chi_mask, b.n_res),
        aatype=_pad(pocket.aatype.astype(np.int32), b.n_res),
        res_mask=_pad(np.ones(r, np.float32), b.n_res),
        backbone_rots=_pad(pocket.backbone_rots.astype(np.float32), b.n_res),
        backbone_transl=_pad(pocket.backbone_transl.astype(np.float32), b.n_res),
        default_frame=_pad(pocket.default_frame.astype(np.float32), b.n_res),
        template_pos=_pad(pocket.rigid_group_positions.astype(np.float32), b.n_res),
        group_idx=_pad(pocket.group_idx.astype(np.int32), b.n_res),
        atom14_mask=_pad(pocket.atom14_mask.astype(np.float32), b.n_res),
        torsion_angle=_pad(pocket.torsion_angle.astype(np.float32), b.n_res),
        pack_flat=_pad(pack_flat.astype(np.int32), b.n_atm),
        pocket_center=pocket.center.astype(np.float32),
    )


def bucket_of(s: DockingSample) -> Buckets:
    """Size class of an (unbatched) sample, read from its padded shapes."""
    return Buckets(
        n_lig=int(s.lig_feat.shape[-2]),
        n_lig_edges=int(s.lig_e_src.shape[-1]),
        n_tor=int(s.tor_src.shape[-1]),
        n_res=int(s.aatype.shape[-1]),
        n_atm=int(s.atm_pos.shape[-2]),
    )


def _load_sample_npz(path: str) -> DockingSample:
    """Read a prep-cache npz (app/pipeline.py:95-97 of the JAX package)."""
    with np.load(path, allow_pickle=False) as data:
        return DockingSample(**{k: data[k] for k in DockingSample._fields})


def stack_samples(samples: list) -> DockingSample:
    """Batch host samples of the same bucket along a new leading axis."""
    return DockingSample(
        *[np.stack([np.asarray(getattr(s, f)) for s in samples])
          for f in DockingSample._fields]
    )


def to_device(s: DockingSample, device) -> DockingSample:
    """numpy sample -> tensors on `device` (float32 / int64 index fields).
    torch is imported here, not with the module: host prep reads this
    module and its spawn workers stay without torch."""
    import torch

    out = []
    for v in s:
        t = torch.as_tensor(np.asarray(v))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        out.append(t.to(device))
    return DockingSample(*out)
