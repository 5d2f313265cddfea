"""Pocket residue selection + visualization artifacts: the port's copy of
diffbindfr_tpu/app/pocket_viz.py, on the port's PDB and ligand parsers.

The reference's DiffBindFR/utils/pocket.py wraps ProDy/nglview to pull the
holo-pocket residue numbers around a ligand and format them as selection
strings for notebooks (get_pocket_resnums_dict / resnum_dict_to_nv_str /
resnum_dict_to_prody_str, pocket.py:145-391). This module reproduces that
surface on the in-repo parsers (no ProDy/PyMOL/nglview), and additionally
writes a standalone PyMOL script so a pose can be inspected anywhere.
"""
from __future__ import annotations

import numpy as np

from ..io.pdb import parse_pdb
from ..io.sdf import parse_ligand_file


def pocket_resnums(
    prot_pdb: str,
    ligand_file: str | None = None,
    center: np.ndarray | None = None,
    cutoff: float = 7.0,
    chains: list[str] | None = None,
) -> dict:
    """{chain_id: sorted [resnum, ...]} for residues with any heavy atom
    within `cutoff` of the ligand (or of `center`)."""
    prot = parse_pdb(prot_pdb)
    if ligand_file is not None:
        ref = parse_ligand_file(ligand_file)[0].coords
    elif center is not None:
        ref = np.asarray(center, np.float32).reshape(1, 3)
    else:
        raise ValueError("need ligand_file or center")
    out: dict = {}
    for i in range(prot.num_res):
        cid = prot.chain_ids[prot.chain_index[i]]
        if chains and cid not in chains:
            continue
        m = prot.atom_mask[i] > 0
        if not m.any():
            continue
        d = np.linalg.norm(
            prot.atom_positions[i][m][:, None, :] - ref[None, :, :], axis=-1
        )
        if d.min() <= cutoff:
            out.setdefault(cid, []).append(int(prot.residue_index[i]))
    return {c: sorted(set(v)) for c, v in out.items()}


def to_nglview_selection(resnums: dict) -> str:
    """nglview/NGL syntax: '( 12 or 15 ) and :A' groups joined by 'or'
    (resnum_dict_to_nv_str parity)."""
    parts = [
        "( " + " or ".join(str(r) for r in nums) + f" ) and :{cid}"
        for cid, nums in resnums.items()
    ]
    return " or ".join(parts)


def to_prody_selection(resnums: dict) -> str:
    """ProDy syntax: 'chain A and resnum 12 15 ...' groups joined by or."""
    parts = [
        f"(chain {cid} and resnum " + " ".join(str(r) for r in nums) + ")"
        for cid, nums in resnums.items()
    ]
    return " or ".join(parts)


def to_pymol_selection(resnums: dict) -> str:
    """PyMOL syntax: '(chain A and resi 12+15+...)' groups joined by or."""
    parts = [
        f"(chain {cid} and resi " + "+".join(str(r) for r in nums) + ")"
        for cid, nums in resnums.items()
    ]
    return " or ".join(parts)


def write_pymol_script(
    path: str,
    prot_pdb: str,
    lig_files: list[str],
    resnums: dict,
    crystal_lig: str | None = None,
) -> None:
    """Standalone .pml: protein cartoon, pocket side chains as sticks,
    predicted pose(s) and optional crystal ligand (show_pocket_ligand
    analogue, pocket.py:93-143)."""
    sel = to_pymol_selection(resnums) or "none"
    lines = [
        f"load {prot_pdb}, receptor",
        "hide everything, receptor",
        "show cartoon, receptor",
        "color grey80, receptor",
        f"select pocket, receptor and ({sel})",
        "show sticks, pocket and not (name C+N+O)",
        "color cyan, pocket",
    ]
    for i, lf in enumerate(lig_files):
        lines += [
            f"load {lf}, pose_{i}",
            f"show sticks, pose_{i}",
            f"color yellow, pose_{i} and elem C",
        ]
    if crystal_lig:
        lines += [
            f"load {crystal_lig}, crystal",
            "show sticks, crystal",
            "color green, crystal and elem C",
        ]
    lines += ["zoom pocket", "set ray_opaque_background, 0"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
