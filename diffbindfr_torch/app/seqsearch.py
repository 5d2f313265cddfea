"""Offline homolog search over local structure libraries: the port's copy
of diffbindfr_tpu/app/seqsearch.py, on the port's PDB parser.

The reference pairs apo/holo structures by BLASTing a query sequence —
remotely against the PDB (``DiffBindFR/utils/blast.py:201 blastp_prody``)
or through a local ``blastp`` subprocess (``blast.py:220 blastp_local``),
then maps chains to UniProt over the web (``utils/uniprot.py
pdb2uniprot``).  Both need network or an external binary; this
environment has neither, so this module covers the same role offline: a
vectorized BLOSUM62 semi-global alignment ranks every chain of a local
PDB library against the query, reporting identity, coverage, and the
alignment score.  (Web-dependent UniProt ID retrieval has no offline
equivalent and is out of scope by design.)

Alignment: Needleman–Wunsch with free end gaps on the library sequence
(semi-global — the right regime for matching a construct against
full-length chains), linear gap penalty, numpy prefix-sweep inner loop
(same vectorization trick as ops/tmalign._nw_align).

CLI: python -m diffbindfr_torch.app.seqsearch query.pdb LIB [LIB ...] [-n N]
where LIB entries are .pdb files or directories of them.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass

import numpy as np

from ..constants.residues import restypes
from ..io.pdb import Protein, parse_pdb

# BLOSUM62 (standard public substitution matrix), row/col order = restypes
_B62_ALPHA = "ARNDCQEGHILKMFPSTWYV"
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -2
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -2  4
"""


def _blosum62() -> np.ndarray:
    """[21, 21] matrix in restypes(+X) order; X scores -1 vs everything."""
    m62 = np.array([r.split() for r in _B62.strip().splitlines()], np.float32)
    idx = [_B62_ALPHA.index(a) for a in restypes]
    m = np.full((21, 21), -1.0, np.float32)
    m[:20, :20] = m62[np.ix_(idx, idx)]
    return m


_BLOSUM = _blosum62()
GAP = -4.0


def chain_sequences(prot: Protein) -> dict:
    """chain id -> (sequence string, aatype array)."""
    out = {}
    for cid in sorted(set(prot.chain_index.tolist())):
        sel = prot.chain_index == cid
        aat = prot.aatype[sel]
        seq = "".join(restypes[a] if a < 20 else "X" for a in aat)
        name = prot.chain_ids[int(cid)] if cid < len(prot.chain_ids) else cid
        out[name] = (seq, aat)
    return out


def _aat(seq) -> np.ndarray:
    if isinstance(seq, str):
        lut = {r: i for i, r in enumerate(restypes)}
        return np.array([lut.get(c, 20) for c in seq], np.int64)
    return np.asarray(seq, np.int64)


@dataclass
class Hit:
    score: float
    identity: float  # matched identical / aligned (non-gap) columns
    coverage: float  # aligned query residues / query length
    n_aligned: int
    source: str
    chain: str
    length: int


def align_stats(query, target) -> tuple:
    """Semi-global NW (free end gaps on target). Returns
    (score, identity, coverage, n_aligned)."""
    qa, ta = _aat(query), _aat(target)
    n, m = len(qa), len(ta)
    S = _BLOSUM[np.ix_(qa, ta)]  # [n, m]
    # score DP with a vectorized column sweep: H[i, j] =
    #   max(H[i-1, j-1] + S, H[i-1, j] + GAP, H[i, j-1] + GAP)
    H = np.zeros(m + 1, np.float32)  # row 0: free leading target gaps
    P = [np.zeros(m + 1, np.int8)]  # 0 diag, 1 up (query gap), 2 left
    jj = np.arange(m + 1, dtype=np.float32)
    for i in range(n):
        row = np.empty(m + 1, np.float32)
        ptr_row = np.empty(m + 1, np.int8)
        diag = H[:-1] + S[i]
        up = H[1:] + GAP
        row[0], ptr_row[0] = H[0] + GAP, 1  # leading query gap
        row[1:] = np.maximum(diag, up)
        ptr_row[1:] = np.where(diag >= up, 0, 1)
        # left (target-gap) moves: row[j] = max_k<=j (row[k] + GAP*(j-k)),
        # via a prefix max of row[k] - GAP*k (same trick as tmalign's NW)
        adj = row - GAP * jj
        best = np.maximum.accumulate(adj)
        take_left = best[:-1] > adj[1:]
        row[1:] = np.where(take_left, best[:-1] + GAP * jj[1:], row[1:])
        ptr_row[1:] = np.where(take_left, 2, ptr_row[1:])
        H = row
        P.append(ptr_row)
    # free trailing target gaps: end anywhere in the last row
    j = int(np.argmax(H))
    score = float(H[j])
    # traceback for identity/coverage
    i = n
    ident = aligned = 0
    while i > 0 and j > 0:
        move = P[i][j]
        if move == 0:
            aligned += 1
            ident += int(qa[i - 1] == ta[j - 1])
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    identity = ident / max(aligned, 1)
    coverage = aligned / max(n, 1)
    return score, identity, coverage, aligned


def search(query, library: list, top: int = 10) -> list:
    """Rank every chain of every library structure against the query
    sequence (str, aatype array, or Protein — first chain)."""
    if isinstance(query, Protein):
        query = next(iter(chain_sequences(query).values()))[0]
    paths = []
    for entry in library:
        if os.path.isdir(entry):
            paths += sorted(
                os.path.join(entry, f) for f in os.listdir(entry)
                if f.endswith(".pdb"))
        else:
            paths.append(entry)
    hits = []
    for p in paths:
        try:
            prot = parse_pdb(p)
        except Exception as e:  # unreadable entries are reported, not fatal
            print(f"[seqsearch] skip {p}: {e}", file=sys.stderr)
            continue
        for cid, (seq, aat) in chain_sequences(prot).items():
            if len(seq) < 8:
                continue
            score, ident, cov, na = align_stats(query, aat)
            hits.append(Hit(score, ident, cov, na, p, str(cid), len(seq)))
    hits.sort(key=lambda h: -h.score)
    return hits[:top]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Offline homolog search (blastp_local role, "
                    "DiffBindFR/utils/blast.py:220) over local PDB files.")
    ap.add_argument("query", help="query .pdb (first chain) or sequence")
    ap.add_argument("library", nargs="+", help=".pdb files or directories")
    ap.add_argument("-n", "--top", type=int, default=10)
    args = ap.parse_args(argv)

    q = (parse_pdb(args.query) if args.query.endswith(".pdb")
         else args.query)
    hits = search(q, args.library, top=args.top)
    print(f"{'score':>8} {'ident':>7} {'cover':>7} {'len':>5}  source:chain")
    for h in hits:
        print(f"{h.score:8.1f} {h.identity:6.1%} {h.coverage:6.1%} "
              f"{h.length:5d}  {h.source}:{h.chain}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
