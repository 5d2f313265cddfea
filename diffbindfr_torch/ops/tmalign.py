"""In-process TM-align, structural alignment + TM-score without an external
binary: the port's copy of diffbindfr_tpu/ops/tmalign.py (numpy, f64, the
same operations in the same order). The published algorithm (Y. Zhang &
J. Skolnick, NAR 2005, 33:2302):

  * fragment-seeded (gapless-threading) initial superpositions
  * iterative refinement: TM-score rotation search over aligned subsets,
    score-matrix Needleman-Wunsch realignment, repeat to convergence
  * the standard length-dependent normalization d0(L) = 1.24 (L-15)^1/3 - 1.8

Host-side analysis utility; it never touches the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TMResult(NamedTuple):
    tm_target: float  # TM-score normalized by target length (standard)
    tm_mobile: float  # normalized by mobile length
    rmsd: float  # RMSD over the aligned pairs
    n_aligned: int
    rotation: np.ndarray  # [3, 3] mobile -> target frame
    translation: np.ndarray  # [3]
    pairs: np.ndarray  # [n_aligned, 2] (mobile_idx, target_idx)


def _d0(n: int) -> float:
    if n <= 21:
        return 0.5
    return max(1.24 * (n - 15.0) ** (1.0 / 3.0) - 1.8, 0.5)


def _kabsch(P: np.ndarray, Q: np.ndarray):
    """R, t minimizing ||P @ R.T + t - Q||."""
    pc, qc = P.mean(0), Q.mean(0)
    H = (P - pc).T @ (Q - qc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    return R, qc - pc @ R.T


def _tm_refine(mob: np.ndarray, tgt: np.ndarray, pairs: np.ndarray,
               d0: float, l_norm: int, max_iter: int = 10):
    """TM-score rotation search for a FIXED alignment: superpose on
    shrinking inlier subsets so outlier pairs cannot dominate the Kabsch
    fit, keep the best TM rotation (TMscore's iterative cutoff scheme)."""
    mi, ti = pairs[:, 0], pairs[:, 1]
    P, Q = mob[mi], tgt[ti]
    best = (-1.0, None, None)
    sel = np.ones(len(pairs), bool)
    d_cut = max(d0, 3.5)
    for _ in range(max_iter):
        if sel.sum() < 3:
            break
        R, t = _kabsch(P[sel], Q[sel])
        d2 = ((P @ R.T + t - Q) ** 2).sum(-1)
        tm = float(np.sum(1.0 / (1.0 + d2 / d0**2)) / l_norm)
        if tm > best[0]:
            best = (tm, R, t)
        new_sel = d2 < d_cut**2
        if new_sel.sum() < 3:
            d_cut += 0.5
            continue
        if (new_sel == sel).all():
            break
        sel = new_sel
    return best


def _nw_align(S: np.ndarray, gap: float = -0.6) -> np.ndarray:
    """Needleman-Wunsch with linear gap penalty; returns [n, 2] index
    pairs of the best global alignment path."""
    n, m = S.shape
    F = np.zeros((n + 1, m + 1))
    F[1:, 0] = np.arange(1, n + 1) * gap
    F[0, 1:] = np.arange(1, m + 1) * gap
    PTR = np.zeros((n + 1, m + 1), np.int8)  # 0=diag 1=up 2=left
    for i in range(1, n + 1):
        diag = F[i - 1, :-1] + S[i - 1]
        up = F[i - 1, 1:] + gap
        row = F[i]
        # candidate without the 'left' move (diag preferred on ties)
        c = np.where(up > diag, up, diag)
        ptr0 = (up > diag).astype(np.int8)
        # the sequential 'left' recurrence row[j] = max(c[j], row[j-1]+gap)
        # is a prefix max: row[j] = max_k<=j (c'[k] - k*gap) + j*gap with
        # c'[0] = row[0] — fully vectorized via maximum.accumulate
        jj = np.arange(m + 1)
        g = np.empty(m + 1)
        g[0] = row[0]
        g[1:] = c - jj[1:] * gap
        R = np.maximum.accumulate(g)
        row[1:] = R[1:] + jj[1:] * gap
        # 'left' only when strictly better than both diag and up; compare
        # in the shifted domain (row[j-1]+gap > c[j] <=> R[j-1] > g[j]) to
        # avoid the +-j*gap round-trip turning exact ties into strict wins
        PTR[i, 1:] = np.where(R[:-1] > g[1:], np.int8(2), ptr0)
    pairs = []
    i, j = n, m
    while i > 0 and j > 0:
        p = PTR[i, j]
        if p == 0:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif p == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(pairs[::-1], np.int64).reshape(-1, 2)


def tmalign(mobile: np.ndarray, target: np.ndarray,
            max_rounds: int = 8) -> TMResult:
    """Align mobile CA coordinates onto target; returns TM-scores under
    both normalizations plus the rigid transform and residue pairing."""
    mob = np.asarray(mobile, np.float64)
    tgt = np.asarray(target, np.float64)
    n, m = len(mob), len(tgt)
    d0t = _d0(m)
    # ---- initial alignments: gapless threading at a coarse offset grid
    seeds = []
    offsets = sorted(set(
        list(range(-(n - 8), m - 8, max(1, min(n, m) // 8)))
        + [0, m - n if m >= n else -(n - m)]
    ))
    for off in offsets:
        lo_m = max(0, -off)
        lo_t = max(0, off)
        ln = min(n - lo_m, m - lo_t)
        if ln < 8:
            continue
        pr = np.stack(
            [np.arange(lo_m, lo_m + ln), np.arange(lo_t, lo_t + ln)], -1
        )
        tm, R, t = _tm_refine(mob, tgt, pr, d0t, m, max_iter=4)
        if R is not None:
            seeds.append((tm, pr))
    seeds.sort(key=lambda s: -s[0])
    seeds = [s[1] for s in seeds[:3]] or [
        np.stack([np.arange(min(n, m)), np.arange(min(n, m))], -1)
    ]

    best = (-1.0, None, None, None)  # tm, R, t, pairs
    for pr in seeds:
        pairs = pr
        for _ in range(max_rounds):
            tm, R, t = _tm_refine(mob, tgt, pairs, d0t, m)
            if R is None:
                break
            if tm > best[0]:
                best = (tm, R, t, pairs)
            moved = mob @ R.T + t
            d2 = ((moved[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
            S = 1.0 / (1.0 + d2 / d0t**2)
            new_pairs = _nw_align(S)
            if new_pairs.shape == pairs.shape and (new_pairs == pairs).all():
                break
            pairs = new_pairs

    tm_t, R, t, pairs = best
    if R is None:  # degenerate inputs
        return TMResult(0.0, 0.0, float("inf"), 0, np.eye(3), np.zeros(3),
                        np.zeros((0, 2), np.int64))
    moved = mob @ R.T + t
    d2 = ((moved[pairs[:, 0]] - tgt[pairs[:, 1]]) ** 2).sum(-1)
    d0m = _d0(n)
    tm_m = float(np.sum(1.0 / (1.0 + d2 / d0m**2)) / n)
    return TMResult(
        tm_target=float(tm_t),
        tm_mobile=tm_m,
        rmsd=float(np.sqrt(d2.mean())) if len(d2) else float("inf"),
        n_aligned=int(len(pairs)),
        rotation=R,
        translation=t,
        pairs=pairs,
    )
