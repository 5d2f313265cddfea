"""Minimal periodic-table data used by the SDF/PDB parsers and featurizers:
the port's copy of diffbindfr_tpu/constants/periodic.py.

Atomic weights (IUPAC 2021 standard) and covalent radii (Cordero 2008) for
the elements that occur in drug-like ligands and proteins; plus Gasteiger
PEOE electronegativity parameters (Gasteiger & Marsili 1980, Tetrahedron 36)
keyed by (element, hybridization).
"""
from __future__ import annotations

ATOMIC_NUMBER = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Zn": 30, "Se": 34, "Br": 35, "I": 53, "Fe": 26,
    "Mg": 12, "Ca": 20, "Na": 11, "K": 19, "Mn": 25, "Cu": 29, "Ni": 28,
    "Co": 27, "As": 33, "Li": 3, "Al": 13, "Be": 4,
}
SYMBOL_BY_NUMBER = {v: k for k, v in ATOMIC_NUMBER.items()}

ATOMIC_WEIGHT = {
    "H": 1.008, "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Si": 28.085, "P": 30.974, "S": 32.06, "Cl": 35.45,
    "Zn": 65.38, "Se": 78.971, "Br": 79.904, "I": 126.904, "Fe": 55.845,
    "Mg": 24.305, "Ca": 40.078, "Na": 22.990, "K": 39.098, "Mn": 54.938,
    "Cu": 63.546, "Ni": 58.693, "Co": 58.933, "As": 74.922, "Li": 6.94,
    "Al": 26.982, "Be": 9.012,
}

COVALENT_RADIUS = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Zn": 1.22, "Se": 1.20,
    "Br": 1.20, "I": 1.39, "Fe": 1.32, "Mg": 1.41, "Ca": 1.76, "Na": 1.66,
    "K": 2.03, "Mn": 1.39, "Cu": 1.32, "Ni": 1.24, "Co": 1.26, "As": 1.19,
}

VDW_RADIUS = {
    "H": 1.10, "B": 1.92, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47,
    "Si": 2.10, "P": 1.80, "S": 1.80, "Cl": 1.75, "Zn": 1.39, "Se": 1.90,
    "Br": 1.85, "I": 1.98, "Fe": 2.05, "Mg": 1.73,
}

# usual valences for implicit-H inference (most common neutral valence)
DEFAULT_VALENCE = {
    "H": 1, "B": 3, "C": 4, "N": 3, "O": 2, "F": 1, "Si": 4, "P": 3,
    "S": 2, "Cl": 1, "Br": 1, "I": 1, "Se": 2,
}

# Gasteiger PEOE parameters (a, b, c) of chi = a + b*q + c*q^2, by element and
# hybridization class. From Gasteiger & Marsili 1980, Table 1.
GASTEIGER_PARAMS = {
    ("H", "*"): (7.17, 6.24, -0.56),
    ("C", "SP3"): (7.98, 9.18, 1.88),
    ("C", "SP2"): (8.79, 9.32, 1.51),
    ("C", "SP"): (10.39, 9.45, 0.73),
    ("N", "SP3"): (11.54, 10.82, 1.36),
    ("N", "SP2"): (12.87, 11.15, 0.85),
    ("N", "SP"): (15.68, 11.70, -0.27),
    ("O", "SP3"): (14.18, 12.92, 1.39),
    ("O", "SP2"): (17.07, 13.79, 0.47),
    ("F", "*"): (14.66, 13.85, 2.31),
    ("Cl", "*"): (11.00, 9.69, 1.35),
    ("Br", "*"): (10.08, 8.47, 1.16),
    ("I", "*"): (9.90, 7.96, 0.96),
    ("S", "*"): (10.14, 9.13, 1.38),
    ("P", "*"): (8.90, 8.24, 0.96),
}


def gasteiger_params(element: str, hyb: str):
    p = GASTEIGER_PARAMS.get((element, hyb))
    if p is None:
        p = GASTEIGER_PARAMS.get((element, "*"))
    if p is None:
        p = (7.98, 9.18, 1.88)  # carbon sp3 fallback
    return p
