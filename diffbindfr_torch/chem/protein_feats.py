"""Pocket selection, side-chain template extraction, and pocket featurization:
the port's counterpart of diffbindfr_tpu/chem/protein_feats.py (the record
is chem/records.py's PocketRecord).

Rebuilds the reference's protein pipeline stages
(druglib/datasets/Docking/pocket_pipeline.py:21-309 and
druglib/datasets/Docking/struct_init.py:61-110 SCFixer) as plain numpy
preprocessing producing a fixed-schema PocketRecord:

  SCPocketFinder  -> residues with any heavy atom within ``cutoff`` A of the
                     reference ligand (or a point), backbone complete
  chi extraction  -> frames + custom template (geometry.chi)
  SCFixer         -> residues with missing chi atoms fall back to ideal AF2
                     geometry so they become fully diffusable
  PocketGraphBuilder -> chi rotation-bond indices into the packed atom array
  PocketFeaturizer   -> [R, 14, 5] categorical features
  Decentration       -> CA-centroid shift (stored for move-back)
"""
from __future__ import annotations

import numpy as np

from ..constants import residues as rc
from ..geometry.chi import ChiTemplate, extract_chi_and_template
from ..io.pdb import Protein
from .records import PocketRecord


def atom37_to_atom14(prot: Protein) -> tuple[np.ndarray, np.ndarray]:
    """Convert atom37 records to atom14 (reference prot_math.py:18-43)."""
    n = prot.num_res
    a14_to_37 = rc.restype_atom14_to_atom37[prot.aatype]  # [N, 14]
    ridx = np.arange(n)[:, None]
    pos14 = prot.atom_positions[ridx, a14_to_37]
    mask14 = rc.restype_atom14_mask[prot.aatype] * prot.atom_mask[ridx, a14_to_37]
    return pos14 * mask14[..., None], mask14


def select_pocket(
    prot: Protein,
    ref_points: np.ndarray,
    cutoff: float = 12.0,
) -> np.ndarray:
    """Residue indices with any heavy atom within ``cutoff`` of ref_points,
    requiring a complete backbone (N, CA, C) so frames are defined."""
    pos = prot.atom_positions  # [N, 37, 3]
    mask = prot.atom_mask.astype(bool)
    ref = np.asarray(ref_points, dtype=np.float32).reshape(-1, 3)

    ridx, aidx = np.nonzero(mask)
    # the native C++ cell grid (io/native.py), as the JAX package runs it
    from ..io.native import pocket_hits_native

    hits = pocket_hits_native(pos[ridx, aidx], ridx, prot.num_res, ref, cutoff)
    backbone_ok = prot.atom_mask[:, :3].all(axis=-1).astype(bool)
    return np.where(hits & backbone_ok)[0]


def chi_exists_mask(aatype: np.ndarray, atom14_mask: np.ndarray) -> np.ndarray:
    """[R, 4]: chi defined for the residue AND all 4 dihedral atoms present
    (reference prot_math.py:350-391 make_torsion_mask)."""
    quad = rc.chi_angles_to_atom14[aatype]  # [R, 4, 4]
    ridx = np.arange(aatype.shape[0])[:, None, None]
    present = atom14_mask[ridx, quad].astype(bool).all(axis=-1)  # [R, 4]
    return rc.chi_angles_mask[aatype].astype(bool) & present


def build_pocket_record(
    prot: Protein,
    ref_points: np.ndarray,
    cutoff: float = 12.0,
    extra_res_feats: tuple = (),
) -> PocketRecord:
    """`extra_res_feats`: optional continuous per-residue features computed
    on the FULL protein and selected down to the pocket — any of "rasa"
    (relative solvent accessibility, the DSSP/SASA role), "depth" (distance
    below the solvent-accessible surface, the MSMS/Bio.PDB.ResidueDepth
    role, reference protein.py:822-830). Off by default, matching the
    shipped reference config (LoadProtein use_ss=False)."""
    sel = select_pocket(prot, ref_points, cutoff)
    if sel.size == 0:
        raise ValueError("empty pocket selection")
    pocket = prot.select(sel)
    pos14, mask14 = atom37_to_atom14(pocket)
    aatype = pocket.aatype

    tpl: ChiTemplate = extract_chi_and_template(aatype, pos14, mask14)
    chi_mask = chi_exists_mask(aatype, mask14)

    # --- SCFixer (struct_init.py:61-110): residues whose chi atoms are
    # partially missing get ideal AF2 frames/templates/masks so the sampler
    # can rebuild ('repair') them from diffused chi angles.
    should_have = rc.chi_angles_mask[aatype].astype(bool)
    broken = (chi_mask != should_have).any(axis=-1)
    bb_ok = mask14[:, :3].astype(bool).all(axis=-1)
    fix = broken & bb_ok
    default_frame = tpl.default_frame.copy()
    template = tpl.rigid_group_positions.copy()
    atom14_mask = mask14.copy()
    if fix.any():
        default_frame[fix] = rc.restype_rigid_group_default_frame[aatype[fix]]
        template[fix] = rc.restype_atom14_rigid_group_positions[aatype[fix]]
        atom14_mask[fix] = rc.restype_atom14_mask[aatype[fix]]
        chi_mask = np.where(fix[:, None], should_have, chi_mask)
    chi_mask = chi_mask & bb_ok[:, None]

    # --- PocketFeaturizer (pocket_pipeline.py:213-273): 5 categorical ids
    # per atom14 slot
    n = aatype.shape[0]
    a14_to_37 = rc.restype_atom14_to_atom37[aatype]  # [R, 14]
    atom37_label = a14_to_37.astype(np.float32)
    coarse = rc.atom37_to_coarse[a14_to_37].astype(np.float32)
    element = rc.atom37_to_element[a14_to_37].astype(np.float32)
    aa_label = np.repeat(aatype[:, None], 14, axis=1).astype(np.float32)
    is_backbone = np.zeros((n, 14), dtype=np.float32)
    is_backbone[:, :4] = 1.0
    node_feat = np.stack(
        [atom37_label, coarse, element, aa_label, is_backbone], axis=-1
    ) * atom14_mask[..., None]

    # --- Decentration (pocket_pipeline.py:276-309): CA centroid
    ca_ok = atom14_mask[:, 1].astype(bool)
    center = pos14[ca_ok, 1].mean(axis=0).astype(np.float32)

    res_extra = None
    if extra_res_feats:
        from .secondary_structure import exposure, residue_depth, shrake_rupley_sasa

        cols = []
        exp = None
        for name in extra_res_feats:
            if name in ("rasa", "depth") and exp is None:
                exp = exposure(prot)  # both features read it: computed once
            if name == "rasa":
                cols.append(shrake_rupley_sasa(prot, exp=exp)[1])
            elif name == "depth":
                cols.append(residue_depth(prot, exp=exp))
            else:
                raise ValueError(f"unknown extra residue feature: {name!r} "
                                 "(supported: 'rasa', 'depth')")
        res_extra = np.stack(cols, axis=-1)[sel].astype(np.float32)

    return PocketRecord(
        aatype=aatype,
        atom14_pos=(pos14 - center) * mask14[..., None],
        atom14_mask=atom14_mask,
        backbone_rots=tpl.backbone_rots,
        backbone_transl=tpl.backbone_transl - center,
        default_frame=default_frame,
        rigid_group_positions=template,
        torsion_angle=tpl.torsion_angle,
        chi_mask=chi_mask,
        node_feat=node_feat,
        center=center,
        residue_index=pocket.residue_index,
        chain_index=pocket.chain_index,
        pocket_res_indices=sel,
        group_idx=rc.restype_atom14_to_rigid_group[aatype],
        res_extra=res_extra,
        atom14_input_mask=mask14,
        chain_ids=list(pocket.chain_ids),
    )
