"""Fixed-shape padded docking samples as tensors.

Counterpart of diffbindfr_tpu/data/sample.py: one (pocket, ligand) pair is a
`DockingSample` of dense arrays padded to a bucket size class; a batch
stacks samples of one bucket along a new leading axis. Fields hold numpy
arrays on the host (as read from a prep cache) or tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


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
    """numpy sample -> tensors on `device` (float32 / int64 index fields)."""
    out = []
    for v in s:
        t = torch.as_tensor(np.asarray(v))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        out.append(t.to(device))
    return DockingSample(*out)
