"""Pose clustering for budgeted ranking: the port's copy of
diffbindfr_tpu/app/cluster.py.

Clustering poses (symmetric-RMSD single linkage) and ranking cluster
representatives instead of raw poses keeps scorer noise on any single pose
from deciding the top-1. Distances are symmetry-corrected ligand RMSDs in
the common receptor frame (metrics/pose.py); the molecule's automorphisms
are enumerated once per complex and the [P, P] matrix is vectorised over
the first _MAX_PERMS of them, in the JAX package's order.
"""
from __future__ import annotations

import numpy as np

from ..metrics.pose import _automorphisms

_MAX_PERMS = 32


def pose_rmsd_matrix(
    poses: np.ndarray,  # [P, A, 3] same molecule, common frame
    bonds: np.ndarray,
    elements: list,
) -> np.ndarray:
    """[P, P] symmetric min-over-automorphism RMSD (no superposition —
    docking RMSD in the shared receptor frame)."""
    poses = np.asarray(poses, np.float64)
    perms = _automorphisms(np.asarray(bonds), list(elements),
                           poses.shape[1])
    if not perms:
        perms = [np.arange(poses.shape[1])]
    if len(perms) > _MAX_PERMS:
        # highly symmetric ligand: correction is truncated (min over a
        # subset is an upper bound on the true symmetric RMSD)
        print(f"[cluster] {len(perms)} automorphisms, using first "
              f"{_MAX_PERMS}")
        perms = perms[:_MAX_PERMS]
    best = None
    for p in perms:
        d = poses[:, None, p, :] - poses[None, :, :, :]  # [P, P, A, 3]
        r = np.sqrt((d * d).sum(-1).mean(-1))
        best = r if best is None else np.minimum(best, r)
    # RMSD(i,j) under p equals RMSD(j,i) under p^-1; if truncation broke
    # closure under inverse the matrix would be asymmetric and clustering
    # would depend on pose order — symmetrizing by min restores exactly
    # the inverse-closed result
    return np.minimum(best, best.T)


def single_linkage(dist: np.ndarray, cutoff: float) -> np.ndarray:
    """[P] cluster labels: union-find over pairs with dist < cutoff."""
    n = dist.shape[0]
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    ii, jj = np.nonzero(np.triu(dist < cutoff, k=1))
    for i, j in zip(ii, jj):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def cluster_rank(
    labels: np.ndarray,  # [P]
    scores: np.ndarray,  # [P] LOWER = better (mdn_nll / vina convention)
    mode: str = "best",
) -> np.ndarray:
    """Pose indices ranked cluster-first: clusters ordered by `mode`
    (`best` member score, `mean` member score, `size` descending with
    best-score tiebreak), one representative (best member) per cluster,
    then remaining poses. Index 0 is the clustered top-1."""
    scores = np.asarray(scores, np.float64)
    order = []
    clusters = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        best_i = idx[np.argmin(scores[idx])]
        key = {
            "best": scores[idx].min(),
            "mean": scores[idx].mean(),
            "size": (-len(idx), scores[idx].min()),
        }[mode]
        clusters.append((key, best_i, idx))
    clusters.sort(key=lambda t: t[0] if isinstance(t[0], tuple) else (t[0],))
    seen = set()
    for _, rep, _ in clusters:
        order.append(rep)
        seen.add(rep)
    for i in np.argsort(scores):
        if i not in seen:
            order.append(i)
    return np.asarray(order)
