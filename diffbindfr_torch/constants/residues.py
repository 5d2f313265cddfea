"""Residue vocabularies and tables the port reads (counterpart of
diffbindfr_tpu/constants/residues.py; AlphaFold2 literature constants).

The ideal rigid-group atom positions are read from the port's own copy of
that data, `rigid_group_positions.txt` beside this module; the default
frames, template positions and group ids are derived from them here (AF2
supplementary Algorithm 24 frame conventions), as the JAX package derives
them.

Residue type ids follow `restypes` (20 standard residues, then 20 for
unknown); atom14 slots are N, CA, C, O, CB, then the side chain. The derived
arrays have the JAX package's shapes and dtypes ([21, ...], unknown last).
"""
from __future__ import annotations

import os

import numpy as np

restypes = ["A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
            "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V"]
restype_num = len(restypes)  # 20
restypes_with_x = restypes + ["X"]
restype_order = {r: i for i, r in enumerate(restypes)}
unk_restype_index = restype_num

restype_1to3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}
restype_3to1 = {v: k for k, v in restype_1to3.items()}

_BB = ["N", "CA", "C", "O"]
_SIDE = {
    "ALA": ["CB"],
    "ARG": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["CB", "CG", "OD1", "ND2"],
    "ASP": ["CB", "CG", "OD1", "OD2"],
    "CYS": ["CB", "SG"],
    "GLN": ["CB", "CG", "CD", "OE1", "NE2"],
    "GLU": ["CB", "CG", "CD", "OE1", "OE2"],
    "GLY": [],
    "HIS": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["CB", "CG1", "CG2", "CD1"],
    "LEU": ["CB", "CG", "CD1", "CD2"],
    "LYS": ["CB", "CG", "CD", "CE", "NZ"],
    "MET": ["CB", "CG", "SD", "CE"],
    "PHE": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["CB", "CG", "CD"],
    "SER": ["CB", "OG"],
    "THR": ["CB", "OG1", "CG2"],
    "TRP": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
    "VAL": ["CB", "CG1", "CG2"],
    "UNK": ["CB"],
}
# atom14 naming per residue ('' for an empty slot)
restype_name_to_atom14_names = {
    res3: (_BB + side + [""] * 14)[:14] for res3, side in _SIDE.items()
}

atom37_names = ["N", "CA", "C", "CB", "O", "CG", "CG1", "CG2", "OG", "OG1", "SG", "CD",
                "CD1", "CD2", "ND1", "ND2", "OD1", "OD2", "SD", "CE", "CE1", "CE2", "CE3",
                "NE", "NE1", "NE2", "OE1", "OE2", "CH2", "NH1", "NH2", "OH", "CZ", "CZ2",
                "CZ3", "NZ", "OXT"]
atom37_order = {a: i for i, a in enumerate(atom37_names)}
atom37_num = len(atom37_names)  # 37

# chi dihedral atom quadruples per residue, chi1 first
_CHI_ATOMS = {
    "ARG": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD"], ["CB", "CG", "CD", "NE"],
            ["CG", "CD", "NE", "CZ"]],
    "ASN": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "OD1"]],
    "ASP": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "OD1"]],
    "CYS": [["N", "CA", "CB", "SG"]],
    "GLN": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD"], ["CB", "CG", "CD", "OE1"]],
    "GLU": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD"], ["CB", "CG", "CD", "OE1"]],
    "HIS": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "ND1"]],
    "ILE": [["N", "CA", "CB", "CG1"], ["CA", "CB", "CG1", "CD1"]],
    "LEU": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD1"]],
    "LYS": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD"], ["CB", "CG", "CD", "CE"],
            ["CG", "CD", "CE", "NZ"]],
    "MET": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "SD"], ["CB", "CG", "SD", "CE"]],
    "PHE": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD1"]],
    "PRO": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD"]],
    "SER": [["N", "CA", "CB", "OG"]],
    "THR": [["N", "CA", "CB", "OG1"]],
    "TRP": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD1"]],
    "TYR": [["N", "CA", "CB", "CG"], ["CA", "CB", "CG", "CD1"]],
    "VAL": [["N", "CA", "CB", "CG1"]],
}
# chis whose value is defined only up to pi (symmetric ring or carboxylate)
_CHI_PI_PERIODIC = {"ASP": 1, "GLU": 2, "PHE": 1, "TYR": 1}  # res3 -> chi index

chi_angles_mask = np.zeros((21, 4), dtype=np.float32)
chi_angles_to_atom14 = np.zeros((21, 4, 4), dtype=np.int64)
chi_pi_periodic = np.zeros((21, 4), dtype=np.float32)
restype_atom14_to_atom37 = np.zeros((21, 14), dtype=np.int64)
restype_atom14_mask = np.zeros((21, 14), dtype=np.float32)


def _fill_tables():
    for res3, chis in _CHI_ATOMS.items():
        ri = restype_order[restype_3to1[res3]]
        chi_angles_mask[ri, : len(chis)] = 1.0
        names = restype_name_to_atom14_names[res3]
        for ci, quad in enumerate(chis):
            chi_angles_to_atom14[ri, ci] = [names.index(a) for a in quad]
    for res3, ci in _CHI_PI_PERIODIC.items():
        chi_pi_periodic[restype_order[restype_3to1[res3]], ci] = 1.0
    for res3, names in restype_name_to_atom14_names.items():
        ri = unk_restype_index if res3 == "UNK" else restype_order[restype_3to1[res3]]
        for slot, name in enumerate(names):
            if name:
                restype_atom14_to_atom37[ri, slot] = atom37_order[name]
                restype_atom14_mask[ri, slot] = 1.0


_fill_tables()


# ---------------------------------------------------------------------------
# Rigid-group frames (AF2 Algorithm 24 conventions)
# ---------------------------------------------------------------------------


def _read_rigid_group_positions():
    """res3 -> [(atom name, rigid group, xyz float64)] in file order."""
    out = {res3: [] for res3 in _SIDE if res3 != "UNK"}
    path = os.path.join(os.path.dirname(__file__), "rigid_group_positions.txt")
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            out[parts[0]].append(
                (parts[1], int(parts[2]), np.array([float(x) for x in parts[3:6]])))
    return out


rigid_group_atom_positions = _read_rigid_group_positions()


def _rigid_4x4(ex: np.ndarray, ey: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rigid transform whose x-axis is ex, xy-plane spans (ex, ey), origin t."""
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0] = ex
    m[:3, 1] = ey
    m[:3, 2] = ez
    m[:3, 3] = t
    return m


restype_atom14_to_rigid_group = np.zeros((21, 14), dtype=np.int64)
restype_atom14_rigid_group_positions = np.zeros((21, 14, 3), dtype=np.float32)
restype_rigid_group_default_frame = np.zeros((21, 8, 4, 4), dtype=np.float32)
restype_rigid_group_default_frame[:] = np.eye(4)
# torsion rotation-axis edges i->j, j->k, k<-l of each chi in atom14 slots
restype_atom14_torsion_edges = np.zeros((21, 4, 3, 2), dtype=np.int64)


def _fill_rigid_groups():
    for res3, atoms in rigid_group_atom_positions.items():
        ri = restype_order[restype_3to1[res3]]
        a14 = restype_name_to_atom14_names[res3]
        pos = {name: xyz for name, _, xyz in atoms}
        for name, group, xyz in atoms:
            slot = a14.index(name)
            restype_atom14_to_rigid_group[ri, slot] = group
            restype_atom14_rigid_group_positions[ri, slot] = xyz
        # groups 0 (backbone) and 1 (pre-omega) stay identity
        restype_rigid_group_default_frame[ri, 2] = _rigid_4x4(
            pos["N"] - pos["CA"], np.array([1.0, 0.0, 0.0]), pos["N"])
        restype_rigid_group_default_frame[ri, 3] = _rigid_4x4(
            pos["C"] - pos["CA"], pos["CA"] - pos["N"], pos["C"])
        for ci, quad in enumerate(_CHI_ATOMS.get(res3, ())):
            for k in range(3):
                restype_atom14_torsion_edges[ri, ci, k] = [a14.index(quad[k]),
                                                           a14.index(quad[k + 1])]
            if ci == 0:
                p = [pos[n] for n in quad]
                mat = _rigid_4x4(p[2] - p[1], p[0] - p[1], p[2])
            else:
                axis_end = pos[quad[2]]
                mat = _rigid_4x4(axis_end, np.array([-1.0, 0.0, 0.0]), axis_end)
            restype_rigid_group_default_frame[ri, 4 + ci] = mat
    # flip the l->k pair so edges read i->j->k<-l
    restype_atom14_torsion_edges[..., -1, :] = restype_atom14_torsion_edges[..., -1, ::-1]


_fill_rigid_groups()

# chi rotation-bond (j, k) pairs in atom14 slots: the middle edge of each chi
restype_chi_bond_atom14 = restype_atom14_torsion_edges[:, :, 1, :].copy()

# coarse atom typing of the pocket featurizer (reference
# protein_constants.py:600-618)
atom_elements = ["C", "N", "O", "S"]
coarse_atom_types = [
    "C*", "CA", "CB", "CD", "CE", "CG", "CH", "CZ", "N*", "ND", "NE",
    "NH", "NZ", "O*", "OD", "OE", "OG", "OH", "OX", "S*", "SD", "SG",
]
atom37_to_element = np.array([atom_elements.index(a[0]) for a in atom37_names],
                             dtype=np.int64)
atom37_to_coarse = np.array([coarse_atom_types.index((a + "*")[:2]) for a in atom37_names],
                            dtype=np.int64)


def aatype_from_resname(res3: str) -> int:
    """Residue type id of a three-letter name; unknown names map to 20."""
    one = restype_3to1.get(res3)
    if one is None:
        return unk_restype_index
    return restype_order[one]
