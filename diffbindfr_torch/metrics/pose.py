"""Docking pose metrics: symmetric L-RMSD, centroid, chi1 accuracy, sc-RMSD
(the port's copy of diffbindfr_tpu/metrics/pose.py, without networkx).

  * ligand_rmsd: symmetry-corrected heavy-atom RMSD, the minimum over
    element- and bond-preserving graph automorphisms (enumerated here by
    the VF2 search in networkx's order). No alignment: docking RMSD is
    computed in the common receptor frame.
  * centroid_distance: distance between heavy-atom centroids.
  * chi1_accuracy: fraction of pocket residues whose chi1 deviates < 15
    deg, with pi-periodic chi handling.
  * sidechain_rmsd: per-residue side-chain heavy-atom RMSD with
    180-deg-symmetric alternative naming (ASP OD1/OD2 etc.) resolved to the
    minimum.
"""
from __future__ import annotations

import itertools
import sys

import numpy as np

from ..constants import residues as rc

# ---------------------------------------------------------------------------
# ligand RMSD
# ---------------------------------------------------------------------------

_MAX_AUTOMORPHISMS = 10_000


class _VF2:
    """Element-preserving automorphisms of a molecular graph by the VF2
    search, in the order of networkx's `GraphMatcher(g, g, node_match=
    categorical_node_match("el", "")).isomorphisms_iter()` on the graph the
    JAX package builds (nodes 0..n-1, then one edge per bond in order).

    The order depends on the search's bookkeeping: candidate pairs come
    from the terminal sets in the insertion order of `inout_1`, whose new
    entries are gathered in a Python set per state. So this keeps the same
    containers and fills them in the same order: a neighbour dict per node
    in edge-insertion order, the core and inout dicts, and the set."""

    def __init__(self, bonds: np.ndarray, elements: list, n_atoms: int):
        self.n = n_atoms
        self.adj = [dict() for _ in range(n_atoms)]
        for a, b in map(tuple, bonds):
            a, b = int(a), int(b)
            self.adj[a][b] = None
            self.adj[b][a] = None
        self.el = [""] * n_atoms
        for i, e in enumerate(elements):
            self.el[i] = e
        self.core_1: dict = {}
        self.core_2: dict = {}
        self.inout_1: dict = {}
        self.inout_2: dict = {}

    def _candidates(self):
        core_1, core_2 = self.core_1, self.core_2
        t1 = [v for v in self.inout_1 if v not in core_1]
        t2 = [v for v in self.inout_2 if v not in core_2]
        if t1 and t2:
            node_2 = min(t2)
            for node_1 in t1:
                yield node_1, node_2
        else:
            other = min(set(range(self.n)) - set(core_2))
            for node in range(self.n):
                if node not in core_1:
                    yield node, other

    def _feasible(self, n1: int, n2: int) -> bool:
        adj, core_1, core_2 = self.adj, self.core_1, self.core_2
        inout_1, inout_2 = self.inout_1, self.inout_2
        if (n1 in adj[n1]) != (n2 in adj[n2]):  # self loops
            return False
        for nb in adj[n1]:
            if nb in core_1 and core_1[nb] not in adj[n2]:
                return False
        for nb in adj[n2]:
            if nb in core_2 and core_2[nb] not in adj[n1]:
                return False
        t1 = sum(1 for nb in adj[n1] if nb in inout_1 and nb not in core_1)
        t2 = sum(1 for nb in adj[n2] if nb in inout_2 and nb not in core_2)
        if t1 != t2:
            return False
        r1 = sum(1 for nb in adj[n1] if nb not in inout_1)
        r2 = sum(1 for nb in adj[n2] if nb not in inout_2)
        if r1 != r2:
            return False
        return self.el[n1] == self.el[n2]

    def _push(self, n1: int, n2: int) -> int:
        core_1, core_2 = self.core_1, self.core_2
        core_1[n1] = n2
        core_2[n2] = n1
        depth = len(core_1)
        for core, inout, node in ((core_1, self.inout_1, n1), (core_2, self.inout_2, n2)):
            if node not in inout:
                inout[node] = depth
            new = set()
            for v in core:
                new.update([nb for nb in self.adj[v] if nb not in core])
            for v in new:
                if v not in inout:
                    inout[v] = depth
        return depth

    def _pop(self, n1: int, n2: int, depth: int) -> None:
        del self.core_1[n1]
        del self.core_2[n2]
        for inout in (self.inout_1, self.inout_2):
            for v in list(inout):
                if inout[v] == depth:
                    del inout[v]

    def mappings(self):
        """Yields each automorphism as the dict atom -> image."""
        if len(self.core_1) == self.n:
            yield dict(self.core_1)
            return
        for n1, n2 in self._candidates():
            if self._feasible(n1, n2):
                depth = self._push(n1, n2)
                yield from self.mappings()
                self._pop(n1, n2, depth)


def _automorphisms(bonds: np.ndarray, elements: list, n_atoms: int):
    """At most _MAX_AUTOMORPHISMS element-preserving automorphisms [n_atoms]
    (int64), in networkx's VF2 order (see _VF2)."""
    limit = sys.getrecursionlimit()
    if limit < 1.5 * n_atoms + 50:
        sys.setrecursionlimit(int(1.5 * n_atoms) + 50)
    try:
        out = []
        for m in _VF2(bonds, elements, n_atoms).mappings():
            out.append(np.array([m[i] for i in range(n_atoms)], dtype=np.int64))
            if len(out) >= _MAX_AUTOMORPHISMS:
                break
        return out
    finally:
        sys.setrecursionlimit(limit)


def ligand_rmsd(
    pred: np.ndarray,  # [A, 3]
    ref: np.ndarray,  # [A, 3]
    bonds: np.ndarray,  # [B, 2] undirected
    elements: list,
) -> float:
    """Symmetry-corrected RMSD in the receptor frame (no superposition)."""
    perms = _automorphisms(bonds, elements, pred.shape[0])
    if not perms:
        perms = [np.arange(pred.shape[0])]
    best = np.inf
    for p in perms:
        r = float(np.sqrt(np.mean(np.sum((pred[p] - ref) ** 2, axis=-1))))
        best = min(best, r)
    return best


def centroid_distance(pred: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(pred.mean(axis=0) - ref.mean(axis=0)))


# ---------------------------------------------------------------------------
# side chains
# ---------------------------------------------------------------------------


def _dihedral(p: np.ndarray) -> float:
    """p: [4, 3] -> dihedral angle in radians."""
    b0, b1, b2 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1 = np.cross(b0, b1)
    n2 = np.cross(b1, b2)
    m1 = np.cross(n1, b1 / max(np.linalg.norm(b1), 1e-9))
    x = np.dot(n1, n2)
    y = np.dot(m1, n2)
    return float(np.arctan2(y, x))


def _ang_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = abs(a - b) % period
    return min(d, period - d)


def chi1_accuracy(
    aatype: np.ndarray,  # [R]
    pred14: np.ndarray,  # [R, 14, 3]
    ref14: np.ndarray,  # [R, 14, 3]
    mask14: np.ndarray,  # [R, 14]
    cutoff_deg: float = 15.0,
) -> float:
    """Fraction of chi1-bearing residues with |chi1_pred - chi1_ref| < cutoff."""
    ok, tot = 0, 0
    for i, aa in enumerate(aatype):
        if not rc.chi_angles_mask[aa][0]:
            continue
        quad = rc.chi_angles_to_atom14[aa, 0]
        if not mask14[i, quad].all():
            continue
        period = np.pi if rc.chi_pi_periodic[aa, 0] else 2 * np.pi
        d = _ang_diff(_dihedral(pred14[i, quad]), _dihedral(ref14[i, quad]), period)
        tot += 1
        ok += int(np.degrees(d) < cutoff_deg)
    return ok / tot if tot else float("nan")


# 180-deg-equivalent atom14 index swaps per residue type (reference
# scrmsd.py symmetric-alternative handling; same set as AF2's
# residue_atom_renaming_swaps)
_SYMM_SWAPS = {
    "D": [("OD1", "OD2")],
    "E": [("OE1", "OE2")],
    "F": [("CD1", "CD2"), ("CE1", "CE2")],
    "Y": [("CD1", "CD2"), ("CE1", "CE2")],
    "R": [("NH1", "NH2")],
}


def _swap_indices(aa: int):
    """Returns list of (i, j) atom14 index pairs that may be exchanged."""
    letter = rc.restypes_with_x[aa]
    if letter not in _SYMM_SWAPS:
        return []
    names = rc.restype_name_to_atom14_names[rc.restype_1to3[letter]]
    return [(names.index(a), names.index(b)) for a, b in _SYMM_SWAPS[letter]]


def sidechain_rmsd(
    aatype: np.ndarray,
    pred14: np.ndarray,
    ref14: np.ndarray,
    mask14: np.ndarray,
) -> float:
    """Pocket side-chain heavy-atom RMSD (atoms beyond the backbone 4),
    minimizing over 180-deg-symmetric naming per residue."""
    se_sum, n_sum = 0.0, 0
    for i, aa in enumerate(aatype):
        sc = np.asarray(mask14[i], dtype=bool).copy()
        sc[:4] = False  # N, CA, C, O are backbone (atom14 layout slots 0-3)
        if not sc.any():
            continue
        swaps = _swap_indices(int(aa))
        best = None
        # at most 2 swap pairs -> enumerate all subsets
        for pick in itertools.product([False, True], repeat=len(swaps)):
            p = pred14[i].copy()
            for do, (a, b) in zip(pick, swaps):
                if do:
                    p[[a, b]] = p[[b, a]]
            se = float(np.sum((p[sc] - ref14[i][sc]) ** 2))
            best = se if best is None else min(best, se)
        se_sum += best
        n_sum += int(sc.sum())
    return float(np.sqrt(se_sum / n_sum)) if n_sum else float("nan")
