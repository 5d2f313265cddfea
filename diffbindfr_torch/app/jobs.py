"""Job table construction, which (receptor, ligand) pairs to dock: the
port's copy of diffbindfr_tpu/app/jobs.py.

CSV schema: `protein, protein_name, ligand, ligand_name, complex_name`
plus a pocket definition, either `crystal_ligand` (a reference ligand file)
or `center` ("x,y,z"; takes priority). From receptor/ligand file lists, a
`<stem>_crystal.sdf` or `<stem>_box.csv` next to each receptor is picked up,
and the receptor x ligand product forms the table.

Two differences from the JAX package, both on `expand_ligand_library`:
names taken from SDF title lines are sanitised before they become
complex names (and so file names), and only each library's record count is
kept while the jobs are emitted.
"""
from __future__ import annotations

import csv
import dataclasses
import glob
import os
import re

LIGAND_EXTS = (".sdf", ".mol2", ".mol")
RECEPTOR_EXTS = (".pdb",)


@dataclasses.dataclass
class Job:
    protein: str
    protein_name: str
    ligand: str
    ligand_name: str
    complex_name: str
    crystal_ligand: str | None = None
    center: tuple | None = None  # (x, y, z)
    # optional holo-structure PDB for apo->holo side-chain grading (the
    # AF2-refinement workflow): chi1/sc-RMSD are measured against this
    # structure's pocket instead of the input (apo) pocket
    holo_protein: str | None = None

    def pocket_ref(self):
        """Returns ('center', xyz) or ('crystal', path). Center wins."""
        if self.center is not None:
            return "center", self.center
        if self.crystal_ligand:
            return "crystal", self.crystal_ligand
        raise ValueError(
            f"job {self.complex_name}: no pocket definition "
            "(need crystal_ligand or center)"
        )


def _parse_center(s: str):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 3:
        raise ValueError(f"bad center spec {s!r}")
    return tuple(float(p) for p in parts)


def load_jobs_csv(path: str) -> list:
    jobs = []
    with open(path, newline="") as fh:
        for row in csv.DictReader(fh):
            center = row.get("center") or None
            jobs.append(
                Job(
                    protein=row["protein"],
                    protein_name=row.get("protein_name")
                    or _stem(row["protein"]),
                    ligand=row["ligand"],
                    ligand_name=row.get("ligand_name") or _stem(row["ligand"]),
                    complex_name=row.get("complex_name")
                    or f"{_stem(row['protein'])}_{_stem(row['ligand'])}",
                    crystal_ligand=row.get("crystal_ligand") or None,
                    center=_parse_center(center) if center else None,
                    holo_protein=row.get("holo_protein") or None,
                )
            )
    return jobs


def save_jobs_csv(path: str, jobs: list) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(
            ["protein", "protein_name", "ligand", "ligand_name",
             "complex_name", "crystal_ligand", "center", "holo_protein"]
        )
        for j in jobs:
            w.writerow(
                [j.protein, j.protein_name, j.ligand, j.ligand_name,
                 j.complex_name, j.crystal_ligand or "",
                 ",".join(map(str, j.center)) if j.center else "",
                 j.holo_protein or ""]
            )


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _expand(paths, exts) -> list:
    """A file, a directory, or a glob -> list of files with allowed exts."""
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            for ext in exts:
                out.extend(sorted(glob.glob(os.path.join(p, f"*{ext}"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return out


def discover_pocket_ref(receptor: str):
    """<stem>_crystal.sdf / <stem>_box.csv next to the receptor
    (reference README.md:109 convention)."""
    stem = os.path.splitext(receptor)[0]
    for suffix in ("_crystal.sdf", "_crystal.mol2"):
        if os.path.exists(stem + suffix):
            return "crystal", stem + suffix
    box = stem + "_box.csv"
    if os.path.exists(box):
        with open(box) as fh:
            rows = list(csv.reader(fh))
        vals = rows[-1]
        return "center", tuple(float(v) for v in vals[:3])
    return None, None


def make_jobs(ligands, receptors) -> list:
    """Cartesian product of receptor x ligand (reverse docking included)."""
    ligs = _expand(ligands, LIGAND_EXTS)
    recs = _expand(receptors, RECEPTOR_EXTS)
    jobs = []
    for rec in recs:
        kind, ref = discover_pocket_ref(rec)
        for lig in ligs:
            jobs.append(
                Job(
                    protein=rec,
                    protein_name=_stem(rec),
                    ligand=lig,
                    ligand_name=_stem(lig),
                    complex_name=f"{_stem(rec)}_{_stem(lig)}",
                    crystal_ligand=ref if kind == "crystal" else None,
                    center=ref if kind == "center" else None,
                )
            )
    return jobs


def _safe_name(title: str) -> str:
    """An SDF title made safe for a file name: every character outside
    [A-Za-z0-9._-] becomes '_', and names of dots only are refused (''),
    so no title can climb out of a directory."""
    name = re.sub(r"[^A-Za-z0-9._-]", "_", (title or "").strip())
    return "" if set(name) <= {"."} else name


def expand_ligand_library(jobs: list) -> list:
    """Expand jobs whose ligand file holds MULTIPLE molecules (a library
    SDF) into one job per record, addressed as `path#<i>` (understood by
    io.sdf.parse_ligand_file and so by every stage and cache key
    downstream). Single-molecule jobs pass through untouched. Record names
    come from the SDF title line, sanitised (`_safe_name`), falling back to
    `<stem>_<i>`; duplicate names are suffixed to keep complex_name unique.
    Only each file's record titles are kept once its jobs are emitted, not
    the parsed molecules: prep parses each record again through the path#i
    cache."""
    from ..io.sdf import parse_ligand_file

    titles: dict = {}  # ligand path -> record titles (None: unparseable)
    out = []
    seen: dict = {}
    for j in jobs:
        if "#" in j.ligand and not os.path.exists(j.ligand):
            out.append(j)  # already record-addressed
            continue
        if j.ligand not in titles:
            try:
                titles[j.ligand] = [m.name for m in parse_ligand_file(j.ligand)]
            except Exception:
                titles[j.ligand] = None  # unparseable: left to prep's
                # quarantine path on the original job
        names = titles[j.ligand]
        if names is None or len(names) <= 1:
            out.append(j)
            continue
        for i, title in enumerate(names):
            lname = _safe_name(title) or f"{_stem(j.ligand)}_{i}"
            base = f"{j.protein_name}_{lname}"
            n = seen.get(base, 0)
            seen[base] = n + 1
            cname = base if n == 0 else f"{base}_{n}"
            out.append(dataclasses.replace(
                j, ligand=f"{j.ligand}#{i}", ligand_name=lname,
                complex_name=cname))
    return out


def job_slice(jobs: list, start: int = 0, end: int | None = None,
              interval: int = 1) -> list:
    """SLURM-array style slicing (reference JobSlice, dataframe.py:203)."""
    end = len(jobs) if end is None else min(end, len(jobs))
    return jobs[start:end:interval]
