"""Gasteiger PEOE partial charges (Gasteiger & Marsili 1980): the port's copy
of diffbindfr_tpu/chem/gasteiger.py.

Stands in for RDKit's ComputeGasteigerCharges used by the reference ligand
featurizer (druglib/utils/obj/ligand.py:516, 'partialcharge'). Implicit
hydrogens are treated as attached pseudo-atoms so heavy-atom charges absorb
their contribution.
"""
from __future__ import annotations

import numpy as np

from ..constants.periodic import gasteiger_params
from .mol import Molecule

_N_ITER = 8
_DAMP = 0.5


def gasteiger_charges(mol: Molecule) -> np.ndarray:
    """Heavy-atom partial charges [A] (implicit Hs folded in)."""
    na = mol.num_atoms
    # nodes: heavy atoms then one pseudo-H per implicit/explicit hydrogen
    params = [gasteiger_params(el, hyb) for el, hyb in zip(mol.elements, mol.hybridization)]
    h_parent = []
    n_h = int(mol.implicit_h.sum())
    for i in range(na):
        h_parent.extend([i] * int(mol.implicit_h[i]))
    hp = gasteiger_params("H", "*")

    a = np.array([p[0] for p in params] + [hp[0]] * n_h)
    b = np.array([p[1] for p in params] + [hp[1]] * n_h)
    c = np.array([p[2] for p in params] + [hp[2]] * n_h)
    # electronegativity of the cation (q=+1) bounds the transfer denominator
    chi_plus = a + b + c
    chi_plus = np.where(chi_plus <= 0, 20.02, chi_plus)  # H special case

    edges = [(int(u), int(v)) for u, v in mol.bonds]
    edges += [(na + k, p) for k, p in enumerate(h_parent)]

    q = np.zeros(na + n_h)
    q[:na] = mol.formal_charges.astype(np.float64)
    damp = _DAMP
    for _ in range(_N_ITER):
        chi = a + b * q + c * q * q
        dq = np.zeros_like(q)
        for u, v in edges:
            if chi[u] > chi[v]:
                t = (chi[u] - chi[v]) / chi_plus[v]
            else:
                t = (chi[u] - chi[v]) / chi_plus[u]
            dq[u] -= t * damp
            dq[v] += t * damp
        q = q + dq
        damp *= _DAMP

    out = q[:na].copy()
    for k, p in enumerate(h_parent):
        out[p] += q[na + k]
    return out.astype(np.float32)
