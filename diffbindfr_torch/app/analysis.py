"""Apo/holo binding-site analysis: the port's copy of
diffbindfr_tpu/app/analysis.py (`HoloRef` is chem/records.py's,
re-exported here). Prep of an apo->holo job builds the holo side-chain
reference with `build_holo_ref`; `compare_binding_sites` and the command
line report how far an apo binding site (e.g. an AlphaFold model) is from
the holo one: pocket CA-RMSD after a Kabsch fit of the pocket CAs,
side-chain RMSD with 180-deg-symmetric naming, chi1 accuracy and the
global TM-score (ops/tmalign.py). Host numpy.

    python -m diffbindfr_torch.app.analysis apo.pdb holo.pdb ref_ligand.sdf [cutoff]

Residues are matched by author (chain letter, residue number, residue
type), then chain-blind, then by the best constant numbering offset.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..chem.protein_feats import atom37_to_atom14, select_pocket
from ..chem.records import HoloRef
from ..io.pdb import Protein, parse_pdb
from ..metrics import chi1_accuracy, sidechain_rmsd


def _kabsch_np(a: np.ndarray, b: np.ndarray):
    """Rotation/translation superposing a onto b (numpy Kabsch)."""
    ca_, cb_ = a.mean(0), b.mean(0)
    h = (a - ca_).T @ (b - cb_)
    u, s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, cb_ - r @ ca_


def _match_residues(apo: Protein, holo: Protein, holo_idx: np.ndarray):
    """Pairs (apo_i, holo_i) for the holo pocket residues."""
    key = lambda p, i: (int(p.residue_index[i]),
                        p.insertion_codes[i] if p.insertion_codes else " ",
                        int(p.aatype[i]))
    apo_map = {key(apo, i): i for i in range(apo.num_res)}
    pairs = [(apo_map[key(holo, j)], int(j)) for j in holo_idx
             if key(holo, j) in apo_map]
    if len(pairs) >= max(3, len(holo_idx) // 2):
        return pairs
    # numbering mismatch: align by pocket sequence window
    apo_seq = apo.aatype.tolist()
    holo_seq = holo.aatype.tolist()
    best, best_score = 0, -1
    span = max(holo_idx) - min(holo_idx) + 1
    for off in range(-(apo.num_res), apo.num_res):
        score = sum(
            1
            for j in holo_idx
            if 0 <= j + off < apo.num_res and apo_seq[j + off] == holo_seq[j]
        )
        if score > best_score:
            best, best_score = off, score
    return [
        (int(j) + best, int(j))
        for j in holo_idx
        if 0 <= j + best < apo.num_res
        and apo_seq[j + best] == holo_seq[j]
    ]


def build_holo_ref(pocket, holo) -> HoloRef:
    """Build the holo side-chain reference for an apo pocket record
    (chem.protein_feats.PocketRecord). `holo` is a holo-structure Protein
    or PDB path. Residues are matched by (author residue number, residue
    type) — the AF2-demo convention where the apo model shares the holo's
    numbering (reference notebooks/AF2_model_docking.ipynb grades the
    refined pocket against 2zec this way)."""
    if isinstance(holo, str):
        holo = parse_pdb(holo)
    nres = pocket.num_res
    enough = max(3, nres // 2)

    def _letter(struct, chain_ids, j):
        ids = chain_ids or getattr(struct, "chain_ids", None)
        if not ids:
            return None
        ci = int(struct.chain_index[j])
        return ids[ci] if ci < len(ids) else None

    # tier 1 — chain-aware: (chain letter, resnum, aatype). Multi-chain
    # receptors (homodimers, antibody H/L) commonly number both chains
    # from 1; without the chain in the key a chain-B pocket residue
    # silently grades against chain-A holo coordinates.
    pocket_chains = getattr(pocket, "chain_ids", None)
    holo_map_c: dict = {}
    for j in range(holo.num_res):
        key = (_letter(holo, None, j), int(holo.residue_index[j]),
               int(holo.aatype[j]))
        holo_map_c.setdefault(key, int(j))
    pairs = []
    if pocket_chains:
        for k in range(nres):
            key = (_letter(pocket, pocket_chains, k),
                   int(pocket.residue_index[k]), int(pocket.aatype[k]))
            if key[0] is not None and key in holo_map_c:
                pairs.append((k, holo_map_c[key]))

    # tier 2 — chain-blind (apo/holo from different depositions rarely
    # share chain letters): (resnum, aatype)
    holo_map: dict = {}
    for j in range(holo.num_res):
        key = (int(holo.residue_index[j]), int(holo.aatype[j]))
        holo_map.setdefault(key, int(j))

    def _match(offset: int):
        out = []
        for k in range(nres):
            key = (int(pocket.residue_index[k]) + offset,
                   int(pocket.aatype[k]))
            if key in holo_map:
                out.append((k, holo_map[key]))
        return out

    if len(pairs) < enough:
        cand = _match(0)
        if len(cand) > len(pairs):
            pairs = cand
    if len(pairs) < enough:
        # author numbering differs (the AF2 fixtures are offset by a
        # constant: AF2 res 31 == 2zec res 16); vote the best constant
        # offset over aatype-compatible (holo, pocket) residue pairs
        votes: Counter = Counter()
        by_aa: dict = {}
        for j in range(holo.num_res):
            by_aa.setdefault(int(holo.aatype[j]), []).append(
                int(holo.residue_index[j]))
        for k in range(nres):
            for hres in by_aa.get(int(pocket.aatype[k]), ()):
                votes[hres - int(pocket.residue_index[k])] += 1
        for off, _n in votes.most_common(5):
            cand = _match(off)
            if len(cand) > len(pairs):
                pairs = cand
    if len(pairs) < 3:
        raise ValueError(
            f"could not match apo pocket to holo: {len(pairs)} of "
            f"{nres} residues matched by (resnum, aatype)"
        )
    ki = np.array([p[0] for p in pairs])
    hi = np.array([p[1] for p in pairs])
    holo14, holo14_mask = atom37_to_atom14(holo.select(hi))

    # superpose holo onto the apo world frame by pocket CAs
    apo_ca_world = pocket.atom14_pos[ki, 1] + pocket.center[None, :]
    ca_ok = (holo14_mask[:, 1] > 0) & (pocket.atom14_mask[ki, 1] > 0)
    r, t = _kabsch_np(holo14[ca_ok, 1], apo_ca_world[ca_ok])
    holo14_fit = holo14 @ r.T + t[None, None, :]
    ca_rmsd = float(np.sqrt(np.mean(np.sum(
        (holo14_fit[ca_ok, 1] - apo_ca_world[ca_ok]) ** 2, -1))))

    pos = np.zeros((nres, 14, 3), np.float32)
    mask = np.zeros((nres, 14), np.float32)
    pos[ki] = holo14_fit * holo14_mask[..., None]
    mask[ki] = holo14_mask
    return HoloRef(
        aatype=pocket.aatype.copy(),
        atom14_pos=pos,
        atom14_mask=mask,
        center=np.zeros(3, np.float32),
        n_matched=len(pairs),
        ca_rmsd=ca_rmsd,
    )


def compare_binding_sites(
    apo, holo, ref_lig_points: np.ndarray, cutoff: float = 12.0
) -> dict:
    """apo/holo: paths or Protein objects. Returns
    {n_pocket, n_matched, pocket_ca_rmsd, sc_rmsd, chi1_rate, tm_score}."""
    if isinstance(apo, str):
        apo = parse_pdb(apo)
    if isinstance(holo, str):
        holo = parse_pdb(holo)
    holo_idx = select_pocket(holo, ref_lig_points, cutoff)
    pairs = _match_residues(apo, holo, holo_idx)
    if len(pairs) < 3:
        raise ValueError("could not match apo/holo pocket residues")
    ai = np.array([p[0] for p in pairs])
    hi = np.array([p[1] for p in pairs])

    apo14, apo14_mask = atom37_to_atom14(apo.select(ai))
    holo14, holo14_mask = atom37_to_atom14(holo.select(hi))
    mask = apo14_mask * holo14_mask
    aat = holo.aatype[hi]

    # superpose apo pocket onto holo by CA
    ca_ok = mask[:, 1] > 0
    r, t = _kabsch_np(apo14[ca_ok, 1], holo14[ca_ok, 1])
    apo14_s = apo14 @ r.T + t

    ca_rmsd = float(
        np.sqrt(np.mean(np.sum((apo14_s[ca_ok, 1] - holo14[ca_ok, 1]) ** 2, -1)))
    )

    # global fold agreement via in-process TM-align (the reference shells
    # out to the TMalign binary here; ops/tmalign.py is the in-repo codec)
    from ..ops.tmalign import tmalign

    a14_full, a14m = atom37_to_atom14(apo)
    h14_full, h14m = atom37_to_atom14(holo)
    tm = tmalign(a14_full[a14m[:, 1] > 0, 1], h14_full[h14m[:, 1] > 0, 1])

    return {
        "n_pocket": int(len(holo_idx)),
        "n_matched": int(len(pairs)),
        "pocket_ca_rmsd": ca_rmsd,
        "sc_rmsd": sidechain_rmsd(aat, apo14_s, holo14, mask),
        "chi1_rate": chi1_accuracy(aat, apo14_s, holo14, mask),
        "tm_score": float(tm.tm_target),
    }


def main(argv=None):
    import sys

    from ..io.sdf import parse_ligand_file

    args = argv or sys.argv[1:]
    if len(args) < 3:
        print("usage: analysis.py apo.pdb holo.pdb ref_ligand.sdf [cutoff]")
        return 1
    ref = parse_ligand_file(args[2])[0].coords
    cutoff = float(args[3]) if len(args) > 3 else 12.0
    out = compare_binding_sites(args[0], args[1], ref, cutoff)
    for k, v in out.items():
        print(f"{k}: {v:.3f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
