"""Structure export and per-pose metrics: the port's copy of
diffbindfr_tpu/app/export.py, writing the same bytes.

Per pose `lig_final.sdf` (the ligand at its docked coordinates) and
`prot_final.pdb` (the full input protein with the pocket residues' rebuilt
side chains swapped in), optionally a pocket-only PDB and the per-step
trajectory files, and the metrics (symmetric L-RMSD, centroid, chi1<15deg
rate, sc-RMSD) against the crystal pose and the input pocket.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..chem.records import LigandRecord, PocketRecord
from ..io.pdb import Protein, to_pdb_string
from ..io.sdf import RawMol, to_sdf_block
from ..metrics import (
    centroid_distance,
    chi1_accuracy,
    ligand_rmsd,
    sidechain_rmsd,
)


@dataclasses.dataclass
class PoseMetrics:
    l_rmsd: float | None = None
    centroid: float | None = None
    chi1_rate: float | None = None
    sc_rmsd: float | None = None

    def as_dict(self):
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


def ligand_to_rawmol(lig: LigandRecord, coords: np.ndarray, props=None) -> RawMol:
    return RawMol(
        name=lig.name,
        elements=list(lig.elements),
        coords=np.asarray(coords, dtype=np.float32),
        bonds=np.asarray(lig.bonds),
        bond_orders=np.asarray(lig.bond_orders),
        formal_charges=np.asarray(lig.formal_charges),
        props=props or {},
    )


def _pocket_swap_indices(pocket: PocketRecord):
    """(ks, ss, ri, a37): the pocket atom14 slots that exist and where
    they land in the full protein's atom37 arrays."""
    from ..constants import residues as rc

    nres = len(pocket.pocket_res_indices)
    a14_to_37 = rc.restype_atom14_to_atom37[pocket.aatype[:nres]]  # [R, 14]
    ks, ss = np.nonzero(np.asarray(pocket.atom14_mask[:nres]))
    ri = np.asarray(pocket.pocket_res_indices)[ks]
    return ks, ss, ri, a14_to_37[ks, ss]


def full_protein_with_pocket(
    prot: Protein, pocket: PocketRecord, atom14_pos: np.ndarray
) -> tuple:
    """Swap the rebuilt pocket atom14 coordinates (pocket frame) back into
    the full protein's atom37 arrays. Returns (positions [N,37,3],
    mask [N,37])."""
    pos37 = prot.atom_positions.copy()
    mask37 = prot.atom_mask.copy()
    world = np.asarray(atom14_pos) + pocket.center[None, None, :]
    ks, ss, ri, a37 = _pocket_swap_indices(pocket)
    pos37[ri, a37] = world[ks, ss]
    mask37[ri, a37] = 1.0
    return pos37, mask37


class PoseStructWriter:
    """Per-pose protein PDB writer that caches a `PdbTemplate` per
    (protein, pocket layout): across poses of the same pair — and across
    pairs sharing the same receptor in a screen — only the swapped pocket
    atoms' coordinates are re-formatted (the full-protein serialization
    measured 262 s of a 2,400-pose screen's export stage)."""

    def __init__(self):
        self._templates: dict = {}

    @staticmethod
    def _prot_fp(prot: Protein) -> str:
        fp = getattr(prot, "_pdb_template_fp", None)
        if fp is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            for arr in (prot.atom_positions, prot.atom_mask, prot.aatype,
                        prot.residue_index, prot.chain_index):
                h.update(np.ascontiguousarray(arr).tobytes())
            fp = h.hexdigest()
            try:
                prot._pdb_template_fp = fp
            except Exception:
                pass
        return fp

    def get(self, prot: Protein, pocket: PocketRecord):
        """Returns (template, ks, ss): render with
        `template.render(world_atom14[ks, ss])`."""
        nres = len(pocket.pocket_res_indices)
        key = (
            self._prot_fp(prot),
            np.asarray(pocket.pocket_res_indices).tobytes(),
            np.ascontiguousarray(pocket.atom14_mask[:nres]).tobytes(),
            np.ascontiguousarray(pocket.aatype[:nres]).tobytes(),
        )
        entry = self._templates.get(key)
        if entry is None:
            from ..io.pdb import PdbTemplate

            ks, ss, ri, a37 = _pocket_swap_indices(pocket)
            mask37 = prot.atom_mask.copy()
            mask37[ri, a37] = 1.0
            entry = (PdbTemplate(prot, mask37, ri, a37), ks, ss)
            self._templates[key] = entry
        return entry


def export_pose(
    outdir: str,
    lig: LigandRecord,
    pocket: PocketRecord,
    prot: Protein,
    lig_pos_pocket_frame: np.ndarray,  # [NL_padded or NL, 3]
    atom14_pos: np.ndarray,  # [R_padded or R, 14, 3] pocket frame
    lig_name: str = "lig_final.sdf",
    prot_name: str = "prot_final.pdb",
    export_pocket: bool = False,
    props: dict | None = None,
    struct_writer: PoseStructWriter | None = None,
) -> None:
    os.makedirs(outdir, exist_ok=True)
    na = lig.num_atoms
    r = pocket.num_res
    lig_world = np.asarray(lig_pos_pocket_frame)[:na] + pocket.center[None, :]
    raw = ligand_to_rawmol(lig, lig_world, props)
    with open(os.path.join(outdir, lig_name), "w") as fh:
        fh.write(to_sdf_block(raw))

    a14 = np.asarray(atom14_pos)[:r]
    if struct_writer is not None and not export_pocket:
        tpl, ks, ss = struct_writer.get(prot, pocket)
        world = a14 + pocket.center[None, None, :]
        with open(os.path.join(outdir, prot_name), "w") as fh:
            fh.write(tpl.render(world[ks, ss]))
        return

    pos37, mask37 = full_protein_with_pocket(prot, pocket, a14)
    out_prot = Protein(
        atom_positions=pos37,
        atom_mask=mask37,
        aatype=prot.aatype,
        residue_index=prot.residue_index,
        chain_index=prot.chain_index,
        b_factors=prot.b_factors,
        chain_ids=prot.chain_ids,
        resnames=prot.resnames,
        insertion_codes=prot.insertion_codes,
    )
    with open(os.path.join(outdir, prot_name), "w") as fh:
        fh.write(to_pdb_string(out_prot))

    if export_pocket:
        pocket_prot = out_prot.select(np.asarray(pocket.pocket_res_indices))
        with open(os.path.join(outdir, "pocket_final.pdb"), "w") as fh:
            fh.write(to_pdb_string(pocket_prot))


def pose_metrics(
    lig: LigandRecord,
    pocket: PocketRecord,
    lig_pos_pocket_frame: np.ndarray,
    atom14_pos: np.ndarray,
    crystal_lig_pos: np.ndarray | None = None,  # [NL, 3] world frame
    holo_pocket=None,  # PocketRecord or analysis.HoloRef
) -> PoseMetrics:
    """`holo_pocket` is the side-chain reference: for redock pass the input
    `pocket` itself (the reference grades recovery against the prep-time
    crystal pocket, evaluation/export.py:165-195); for apo->holo pass an
    `analysis.HoloRef` built from the holo structure. The reference mask
    is the INPUT existing-atom mask (pre-SCFixer) — atoms the sampler
    repaired from ideal templates have no crystal coordinate to grade
    against."""
    m = PoseMetrics()
    na = lig.num_atoms
    pred_world = np.asarray(lig_pos_pocket_frame)[:na] + pocket.center[None, :]
    if crystal_lig_pos is not None:
        m.l_rmsd = ligand_rmsd(
            pred_world, np.asarray(crystal_lig_pos), lig.bonds, lig.elements
        )
        m.centroid = centroid_distance(pred_world, np.asarray(crystal_lig_pos))
    if holo_pocket is not None:
        r = pocket.num_res
        pred14 = np.asarray(atom14_pos)[:r] + pocket.center[None, None, :]
        ref14 = holo_pocket.atom14_pos + holo_pocket.center[None, None, :]
        ref_mask = getattr(holo_pocket, "atom14_input_mask", None)
        if ref_mask is None:
            ref_mask = holo_pocket.atom14_mask
        mask = (pocket.atom14_mask * ref_mask).astype(np.float32)
        m.chi1_rate = chi1_accuracy(pocket.aatype, pred14, ref14, mask)
        m.sc_rmsd = sidechain_rmsd(pocket.aatype, pred14, ref14, mask)
    return m


def export_trajectory(
    outdir: str,
    lig: LigandRecord,
    pocket: PocketRecord,
    lig_traj: np.ndarray,  # [S, NL_pad, 3] pocket frame
    atom14_traj: np.ndarray | None,  # [S, R_pad, 14, 3]
) -> None:
    """Per-step denoising trajectory: multi-molecule SDF + XTC for the
    ligand and a multi-MODEL PDB + XTC for the complex (reference
    export.py:268-305 writes per-step PDBs + an XTC via mdtraj; io/xtc.py
    is the in-repo codec)."""
    from ..io.xtc import write_xtc

    na = lig.num_atoms
    steps = lig_traj.shape[0]
    with open(os.path.join(outdir, "lig_traj.sdf"), "w") as fh:
        for t in range(steps):
            world = lig_traj[t, :na] + pocket.center[None, :]
            fh.write(to_sdf_block(ligand_to_rawmol(lig, world,
                                                   {"step": str(t)})))
    write_xtc(
        os.path.join(outdir, "lig_traj.xtc"),
        lig_traj[:, :na] + pocket.center[None, None, :],
    )
    if atom14_traj is None:
        return
    from ..constants import residues as rc
    from ..io.pdb import Protein

    r = pocket.num_res
    with open(os.path.join(outdir, "pocket_traj.pdb"), "w") as fh:
        for t in range(steps):
            fh.write(f"MODEL     {t + 1:>4}\n")
            world = atom14_traj[t, :r] + pocket.center[None, None, :]
            pos37 = np.zeros((r, 37, 3), np.float32)
            mask37 = np.zeros((r, 37), np.float32)
            a14_to_37 = rc.restype_atom14_to_atom37[pocket.aatype]
            for k in range(r):
                for sl in range(14):
                    if pocket.atom14_mask[k, sl]:
                        pos37[k, a14_to_37[k, sl]] = world[k, sl]
                        mask37[k, a14_to_37[k, sl]] = 1.0
            prot = Protein(
                atom_positions=pos37, atom_mask=mask37,
                aatype=pocket.aatype, residue_index=pocket.residue_index,
                chain_index=pocket.chain_index,
                b_factors=np.zeros((r, 37), np.float32),
            )
            body = to_pdb_string(prot)
            fh.write(body.replace("END\n", "ENDMDL\n"))
    # packed pocket heavy atoms as an XTC alongside the multi-model PDB
    exists = pocket.atom14_mask.astype(bool)
    ridx, aidx = np.nonzero(exists)
    pocket_xyz = (
        atom14_traj[:, :r][:, ridx, aidx] + pocket.center[None, None, :]
    )
    write_xtc(os.path.join(outdir, "pocket_traj.xtc"), pocket_xyz)
