"""Pose physical-validity checks, the PoseBusters "redock" suite: the
port's copy of diffbindfr_tpu/app/validity.py, host numpy with the same
seeds, so every check and ratio is the JAX package's to the bit.

The checks (PoseBusters, Buttenschoen et al. 2024, without RDKit, from the
perceived ligand graph):

geometry (vs the input conformer, tolerance 0.25 as in PoseBusters):
  * bond_lengths      lengths within 25% of the input conformer
  * bond_angles       angles within 25% of the input conformer
  * internal_clash    non-bonded pairs (>= 3 bonds apart or unconnected)
                      no closer than 0.7 x sum of vdW radii (per-atom Bondi
                      radii, not a blanket threshold)
chemistry (stereo preservation, PoseBusters tetrahedral/double-bond checks):
  * tetrahedral_stereo signed volume at every atom with >= 3 neighbors
                      keeps its sign vs the input conformer
  * double_bond_stereo cis/trans assignment across every stereo-capable
                      double bond is preserved
flatness (threshold 0.25 A as in PoseBusters):
  * aromatic_flatness  aromatic 5/6-ring atoms within 0.25 A of their
                      best-fit plane
  * double_bond_flatness the 4 substituent atoms around each non-ring
                      double bond within 0.25 A of their plane
energy:
  * internal_energy   UFF-lite intra energy ratio: E(pose) over the mean
                      of a 50-conformer torsion-resampled ensemble <= 100
                      (PoseBusters uses UFF/ETKDG; here bond+angle harmonic
                      terms about the input geometry + a 12-6 clash term,
                      the ensemble from this framework's own torsion
                      machinery)
protein context:
  * protein_clash     ligand-heavy-atom to pocket-heavy-atom distance
                      >= 0.75 x sum of per-atom vdW radii
  * volume_overlap    <= 7.5% of the ligand vdW volume inside the protein
                      vdW volume (Monte-Carlo estimate, fixed seed)
  * in_pocket         ligand centroid inside the pocket bounding sphere

Each check returns bool; `check_pose` aggregates into a dict + `pass` flag.
"""
from __future__ import annotations

import numpy as np

from ..chem.mol import MolGraph, cycle_basis
from ..chem.records import LigandRecord, PocketRecord
from ..constants import residues as rc

# Bondi van-der-Waals radii (A)
VDW = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "P": 1.80,
    "F": 1.47, "Cl": 1.75, "Br": 1.85, "I": 1.98, "B": 1.92, "Se": 1.90,
}
VDW_DEFAULT = 1.70

FLATNESS_TOL = 0.25  # A (PoseBusters default)
GEOMETRY_TOL = 0.25  # relative (PoseBusters default)
CLASH_SCALE_INTERNAL = 0.7
CLASH_SCALE_PROTEIN = 0.75
ENERGY_RATIO_MAX = 100.0
VOLUME_OVERLAP_MAX = 0.075


def _vdw_radii(elements) -> np.ndarray:
    return np.array([VDW.get(e, VDW_DEFAULT) for e in elements], np.float32)


_A14_ELEMENTS: dict = {}


def _pocket_radii(pocket: PocketRecord) -> np.ndarray:
    """Per-atom vdW radii of the packed existing pocket atoms [P]."""
    if not _A14_ELEMENTS:
        for res3, names in rc.restype_name_to_atom14_names.items():
            _A14_ELEMENTS[res3] = [n[:1] if n else "" for n in names]
    rests = rc.restypes_with_x  # index -> 1-letter
    out = []
    exists = pocket.atom14_mask.astype(bool)
    for r in range(pocket.aatype.shape[0]):
        res3 = rc.restype_1to3.get(rests[pocket.aatype[r]], "UNK")
        els = _A14_ELEMENTS[res3]
        for a in range(14):
            if exists[r, a]:
                out.append(VDW.get(els[a], VDW_DEFAULT))
    return np.asarray(out, np.float32)


def _bond_vectors(pos, bonds):
    return pos[bonds[:, 0]] - pos[bonds[:, 1]]


def _neighbor_lists(bonds, na):
    nbrs: dict = {i: [] for i in range(na)}
    for a, b in map(tuple, bonds):
        nbrs[a].append(b)
        nbrs[b].append(a)
    return nbrs


def _angles(pos, bonds):
    """All bonded angle triplets (j is the apex)."""
    nbrs = _neighbor_lists(bonds, pos.shape[0])
    trips = []
    for j, ns in nbrs.items():
        for x in range(len(ns)):
            for y in range(x + 1, len(ns)):
                trips.append((ns[x], j, ns[y]))
    if not trips:
        return np.zeros((0,))
    t = np.asarray(trips)
    v1 = pos[t[:, 0]] - pos[t[:, 1]]
    v2 = pos[t[:, 2]] - pos[t[:, 1]]
    cos = np.sum(v1 * v2, -1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9
    )
    return np.arccos(np.clip(cos, -1, 1))


def _graph_distance_ge3(bonds, na):
    """Bool [A, A]: pairs at graph distance >= 3 (the non-bonded set for
    clash/LJ checks — 1-2 and 1-3 pairs are governed by bonds/angles)."""
    adj = np.zeros((na, na), bool)
    adj[bonds[:, 0], bonds[:, 1]] = True
    adj |= adj.T
    two = (adj @ adj) | adj
    np.fill_diagonal(two, True)
    return ~two


def _plane_dev(points: np.ndarray) -> float:
    """Max distance of points from their best-fit plane."""
    c = points.mean(0)
    x = points - c
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    normal = vt[-1]
    return float(np.abs(x @ normal).max())


def _graph(lig: LigandRecord) -> MolGraph:
    """The ligand's bond graph: atoms 0..n-1, then the bonds in order."""
    g = MolGraph(lig.num_atoms)
    for (a, b), o in zip(map(tuple, lig.bonds), lig.bond_orders):
        g.add_edge(int(a), int(b), int(o))
    return g


def _sp2_rings(lig: LigandRecord):
    """5/6-membered rings where every ring bond is aromatic (order 4) or
    part of an alternating pattern with at least 2 double bonds — the
    aromatic-ring set for the flatness check. The rings of a fused system
    depend on the cycle basis: chem/mol.py's is networkx's, cycle for
    cycle, on this graph."""
    g = _graph(lig)
    rings = []
    for ring in cycle_basis(g):
        if len(ring) not in (5, 6):
            continue
        ros = [g.order(ring[k], ring[(k + 1) % len(ring)]) for k in range(len(ring))]
        if all(o == 4 for o in ros) or (
            all(o in (1, 2, 4) for o in ros)
            and sum(o in (2, 4) for o in ros) >= 2
        ):
            rings.append(ring)
    return rings


def _stereo_double_bonds(lig: LigandRecord):
    """Non-ring double bonds with >= 1 heavy substituent on each end:
    (i, j, si, sj) tuples for cis/trans comparison + flatness. A ring bond
    is an edge of some cycle of the basis; their union is the graph's
    non-bridge edges whatever the basis."""
    nbrs = _neighbor_lists(lig.bonds, lig.num_atoms)
    ring_edges = set()
    for ring in cycle_basis(_graph(lig)):
        for k in range(len(ring)):
            e = (ring[k], ring[(k + 1) % len(ring)])
            ring_edges.add(e)
            ring_edges.add(e[::-1])
    out = []
    for (a, b), o in zip(map(tuple, lig.bonds), lig.bond_orders):
        if int(o) != 2 or (a, b) in ring_edges:
            continue
        sa = [n for n in nbrs[a] if n != b]
        sb = [n for n in nbrs[b] if n != a]
        if sa and sb:
            out.append((a, b, sa[0], sb[0], sa, sb))
    return out


def _chiral_volumes(pos, nbrs):
    """Signed volume at every atom with >= 3 neighbors: (idx, sign)."""
    out = []
    for j, ns in nbrs.items():
        if len(ns) < 3:
            continue
        ns = sorted(ns)[:4]
        v1 = pos[ns[0]] - pos[j]
        v2 = pos[ns[1]] - pos[j]
        v3 = pos[ns[2]] - pos[j]
        vol = float(np.dot(np.cross(v1, v2), v3))
        out.append((j, vol))
    return out


# ---------------------------------------------------------------------------
# UFF-lite internal energy (for the PoseBusters energy-ratio check)
# ---------------------------------------------------------------------------

_KBOND = 300.0  # kcal/mol/A^2 (UFF-scale stretch constant)
_KANGLE = 60.0  # kcal/mol/rad^2


def _intra_energy(pos, ref_len, ref_ang, bonds, ang_bonds, nb_mask, radii):
    e_bond = _KBOND * np.sum(
        (np.linalg.norm(_bond_vectors(pos, bonds), axis=-1) - ref_len) ** 2
    )
    ang = _angles(pos, ang_bonds)
    e_ang = _KANGLE * np.sum((ang - ref_ang) ** 2) if ang.size else 0.0
    d = np.linalg.norm(pos[:, None] - pos[None, :] + 1e-9, axis=-1)
    sig = 0.8 * (radii[:, None] + radii[None, :])
    r6 = np.clip(sig / np.maximum(d, 0.3), 0.0, 4.0) ** 6
    lj = np.where(nb_mask, r6 * r6 - 2 * r6 + 1.0, 0.0)
    e_lj = 0.1 * np.sum(np.where(nb_mask & (d < sig), lj, 0.0))
    return float(e_bond + e_ang + e_lj)


def _resample_torsions(pos, lig: LigandRecord, rng):
    """Apply uniform-random rotations about every rotatable bond (numpy
    Rodrigues; the on-host analogue of the ETKDG baseline ensemble)."""
    out = pos.copy()
    tor_src = lig.edge_index[0][lig.tor_edge_mask]
    tor_dst = lig.edge_index[1][lig.tor_edge_mask]
    for t in range(tor_src.shape[0]):
        u, v = int(tor_src[t]), int(tor_dst[t])
        axis = out[v] - out[u]
        n = axis / (np.linalg.norm(axis) + 1e-9)
        theta = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(theta), np.sin(theta)
        K = np.array(
            [[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]]
        )
        R = np.eye(3) + s * K + (1 - c) * (K @ K)
        mask = lig.rot_node_mask[t][: pos.shape[0]].astype(bool)
        out[mask] = (out[mask] - out[u]) @ R.T + out[u]
    return out


def internal_energy_ratio(
    lig: LigandRecord, pos: np.ndarray, n_baseline: int = 50, seed: int = 0
) -> float:
    """E(pose) / mean E(torsion-resampled ensemble) with UFF-lite terms."""
    na = lig.num_atoms
    ref = lig.pos[:na]
    bonds = np.asarray(lig.bonds)
    ref_len = np.linalg.norm(_bond_vectors(ref, bonds), axis=-1)
    ref_ang = _angles(ref, bonds)
    nb = _graph_distance_ge3(bonds, na)
    radii = _vdw_radii(lig.elements)
    args = (ref_len, ref_ang, bonds, bonds, nb, radii)

    e_pose = _intra_energy(pos[:na], *args)
    rng = np.random.default_rng(seed)
    es = [
        _intra_energy(_resample_torsions(ref, lig, rng), *args)
        for _ in range(n_baseline)
    ]
    # +1 kcal/mol floor keeps the ratio meaningful for rigid ligands whose
    # baseline ensemble is strain-free
    return e_pose / (float(np.mean(es)) + 1.0)


def volume_overlap_fraction(
    lig_pos, lig_radii, pocket_pos, pocket_radii, n_samples: int = 4000,
    seed: int = 0,
) -> float:
    """Monte-Carlo share of the ligand vdW volume inside the protein vdW
    volume (PoseBusters volume-overlap check; grid method -> MC here)."""
    rng = np.random.default_rng(seed)
    na = lig_pos.shape[0]
    # sample points uniformly inside ligand spheres (weighted by r^3)
    w = lig_radii**3
    w = w / w.sum()
    idx = rng.choice(na, size=n_samples, p=w)
    u = rng.normal(size=(n_samples, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True) + 1e-12
    rad = lig_radii[idx] * rng.uniform(0, 1, n_samples) ** (1 / 3)
    pts = lig_pos[idx] + u * rad[:, None]
    d = np.linalg.norm(pts[:, None, :] - pocket_pos[None, :, :], axis=-1)
    inside = np.any(d < pocket_radii[None, :], axis=1)
    return float(inside.mean())


def check_pose(
    lig: LigandRecord,
    pocket: PocketRecord,
    lig_pos_pocket_frame: np.ndarray,
    tol: float = GEOMETRY_TOL,
    full: bool = True,
    atom14_pos: np.ndarray | None = None,
) -> dict:
    """`atom14_pos` overrides the pocket's receptor coordinates for the
    protein-context checks — pass the per-pose (post-diffusion, post-relax)
    atom14 so clash/overlap are judged against the receptor conformation
    the exporter actually writes, matching the reference protocol (pb.py
    runs PoseBusters on the exported per-pose prot_final.pdb). Without it
    the checks use the INPUT pocket conformation, which phantom-flags
    poses whose predicted side chains moved out of the way."""
    na = lig.num_atoms
    pos = np.asarray(lig_pos_pocket_frame)[:na].astype(np.float64)
    ref = lig.pos[:na] if lig.pos.shape[0] >= na else lig.pos
    bonds = np.asarray(lig.bonds)
    radii = _vdw_radii(lig.elements)
    nbrs = _neighbor_lists(bonds, na)

    out = {}
    # ---- geometry vs input conformer
    d_out = np.linalg.norm(_bond_vectors(pos, bonds), axis=-1)
    d_ref = np.linalg.norm(_bond_vectors(ref, bonds), axis=-1)
    out["bond_lengths"] = bool(
        np.all(np.abs(d_out - d_ref) <= tol * np.maximum(d_ref, 1e-6))
    )
    a_out = _angles(pos, bonds)
    a_ref = _angles(ref, bonds)
    out["bond_angles"] = bool(
        a_out.size == 0
        or np.all(np.abs(a_out - a_ref) <= tol * np.maximum(a_ref, 1e-2))
    )
    # internal clash: graph-distance >= 3 pairs vs per-atom vdW radii
    nb = _graph_distance_ge3(bonds, na)
    d = np.linalg.norm(pos[:, None] - pos[None, :] + 1e-12, axis=-1)
    lim = CLASH_SCALE_INTERNAL * (radii[:, None] + radii[None, :])
    out["internal_clash"] = bool(np.all(d[nb] > lim[nb]))

    if full:
        # ---- flatness
        rings = _sp2_rings(lig)
        out["aromatic_flatness"] = bool(
            all(_plane_dev(pos[r]) <= FLATNESS_TOL for r in rings)
        )
        dbs = _stereo_double_bonds(lig)
        flat_ok = True
        stereo_ok = True
        for a, b, sa, sb, all_a, all_b in dbs:
            grp = [a, b] + list(all_a) + list(all_b)
            if len(grp) >= 4:
                flat_ok &= _plane_dev(pos[grp]) <= FLATNESS_TOL
            # cis/trans: sign of the sa-a-b-sb dihedral
            def dihedral(p):
                b0, b1, b2 = p[a] - p[sa], p[b] - p[a], p[sb] - p[b]
                n1, n2 = np.cross(b0, b1), np.cross(b1, b2)
                m = np.cross(n1, b1 / (np.linalg.norm(b1) + 1e-12))
                return np.arctan2(np.dot(m, n2), np.dot(n1, n2))

            if abs(abs(dihedral(ref)) - np.pi / 2) > 0.35:  # defined stereo
                stereo_ok &= (abs(dihedral(pos)) > np.pi / 2) == (
                    abs(dihedral(ref)) > np.pi / 2
                )
        out["double_bond_flatness"] = bool(flat_ok)
        out["double_bond_stereo"] = bool(stereo_ok)

        # ---- tetrahedral stereo: signed volumes keep their sign
        ref_vols = dict(_chiral_volumes(ref, nbrs))
        ok = True
        for j, vol in _chiral_volumes(pos, nbrs):
            rv = ref_vols.get(j, 0.0)
            if abs(rv) > 0.5:  # well-defined pyramidal/tetrahedral center
                ok &= np.sign(vol) == np.sign(rv)
        out["tetrahedral_stereo"] = bool(ok)

        # ---- internal energy ratio
        out["internal_energy"] = bool(
            internal_energy_ratio(lig, pos) <= ENERGY_RATIO_MAX
        )

    # ---- protein context (per-atom radii)
    exists = pocket.atom14_mask.astype(bool)
    rec14 = pocket.atom14_pos if atom14_pos is None else np.asarray(
        atom14_pos)[: pocket.num_res]  # engine outputs are bucket-padded
    ppos = rec14[exists]
    pradii = _pocket_radii(pocket)
    dd = np.linalg.norm(pos[:, None] - ppos[None, :], axis=-1)
    plim = CLASH_SCALE_PROTEIN * (radii[:, None] + pradii[None, :])
    out["protein_clash"] = bool(np.all(dd > plim))
    if full:
        out["volume_overlap"] = bool(
            volume_overlap_fraction(pos, radii, ppos, pradii)
            <= VOLUME_OVERLAP_MAX
        )
    ca = pocket.atom14_pos[:, 1][pocket.atom14_mask[:, 1] > 0]
    rad = np.linalg.norm(ca, axis=-1).max() + 5.0
    out["in_pocket"] = bool(np.linalg.norm(pos.mean(0)) < rad)
    out["pass"] = all(v for k, v in out.items() if k != "pass")
    return out


# ---------------------------------------------------------------------------
# standalone CLI: run the suite over any exported results table
# (reference: DiffBindFR/evaluation/pb.py:418-440 — pb.py is its own entry
# point over an existing results_ec.csv; this mirrors that surface)
# ---------------------------------------------------------------------------


def run_table(results_csv: str, out_csv: str | None = None,
              pocket_radius: float = 12.0, verbose: bool = True) -> str:
    """PoseBusters-style checks for every pose row of a results.csv
    (needs lig_sdf + prot_pdb columns, as written by pipeline.export).
    Writes validity.csv next to the input (or to out_csv) and returns
    its path."""
    import csv
    import os

    from ..chem.ligand_feats import featurize_ligand
    from ..chem.mol import perceive
    from ..chem.protein_feats import build_pocket_record
    from ..io.pdb import parse_pdb
    from ..io.sdf import parse_ligand_file

    rows = list(csv.DictReader(open(results_csv)))
    if not rows:
        raise ValueError(f"empty results table: {results_csv}")
    prot_cache: dict = {}
    vrows = []
    for row in rows:
        lig_raw = parse_ligand_file(row["lig_sdf"])[0]
        lig = featurize_ligand(perceive(lig_raw), lig_raw.name)
        ppath = row["prot_pdb"]
        if ppath not in prot_cache:
            prot_cache[ppath] = parse_pdb(ppath)
        pocket = build_pocket_record(
            prot_cache[ppath], lig.pos, cutoff=pocket_radius)
        checks = check_pose(lig, pocket, lig.pos - pocket.center)
        vrows.append({
            "complex_name": row.get("complex_name", ""),
            "pose": row.get("pose", ""),
            "lig_sdf": row["lig_sdf"],
            **{k: int(bool(v)) for k, v in checks.items()},
        })

    out_csv = out_csv or os.path.join(
        os.path.dirname(os.path.abspath(results_csv)), "validity.csv")
    with open(out_csv, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(vrows[0]))
        w.writeheader()
        w.writerows(vrows)
    if verbose:
        n = len(vrows)
        checks = [k for k in vrows[0]
                  if k not in ("complex_name", "pose", "lig_sdf")]
        print(f"[validity] {n} poses from {results_csv}")
        for c in checks:
            frac = sum(v[c] for v in vrows) / n
            print(f"  {c:>22s}: {frac:6.1%}")
        print(f"[validity] wrote {out_csv}")
    return out_csv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m diffbindfr_torch.app.validity",
        description="PoseBusters-style validity checks over a results.csv "
                    "(standalone; eval_cli also runs these inline)")
    ap.add_argument("results_csv")
    ap.add_argument("-o", "--out", default=None,
                    help="output csv (default: validity.csv next to input)")
    ap.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    args = ap.parse_args(argv)
    run_table(args.results_csv, args.out, args.pocket_radius)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
