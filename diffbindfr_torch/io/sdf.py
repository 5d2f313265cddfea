"""Pure-Python SDF (MDL V2000) and MOL2 molecule reading and writing: the
port's copy of diffbindfr_tpu/io/sdf.py.

No RDKit: ligand structure, bond orders and formal charges come straight
from the file. `to_sdf_block` writes the same bytes as the JAX package's,
program line included, so exports of the two packages compare equal.
"""
from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np


@dataclasses.dataclass
class RawMol:
    """Parsed molecule: atoms, bonds, coordinates, file properties."""

    name: str
    elements: list[str]  # [A]
    coords: np.ndarray  # [A, 3] float32
    bonds: np.ndarray  # [B, 2] int (0-based)
    bond_orders: np.ndarray  # [B] int: 1, 2, 3, 4(aromatic)
    formal_charges: np.ndarray  # [A] int
    props: dict

    @property
    def num_atoms(self) -> int:
        return len(self.elements)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def parse_sdf(path: str, max_mols: int | None = None) -> list[RawMol]:
    """Parse all molecules from an SDF/MOL file (V2000)."""
    with _open(path) as fh:
        text = fh.read()
    mols = []
    for block in text.split("$$$$"):
        if not block.strip():
            continue
        mol = _parse_molblock(block)
        if mol is not None:
            mols.append(mol)
        if max_mols and len(mols) >= max_mols:
            break
    return mols


def _parse_molblock(block: str) -> RawMol | None:
    lines = block.lstrip("\n").splitlines()
    if len(lines) < 4:
        return None
    name = lines[0].strip()
    # counts line is nominally line 4, but files missing a header line
    # exist in the wild (e.g. Schrodinger exports with no title) — locate
    # the first V2000 counts line within the header window
    ci = None
    for k in range(min(6, len(lines))):
        if lines[k].rstrip().endswith("V2000"):
            ci = k
            break
    if ci is None:
        ci = 3
        if name.endswith("3D") or not name:
            name = ""
    elif ci != 3 and (name.endswith("3D") or not name):
        name = ""
    counts = lines[ci]
    try:
        na = int(counts[0:3])
        nb = int(counts[3:6])
    except ValueError:
        return None
    base = ci + 1
    elements, coords = [], []
    charges = {}
    for i in range(na):
        ln = lines[base + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        el = ln[31:34].strip()
        coords.append((x, y, z))
        elements.append(el)
        # old-style charge column (chg code: 0 none, 1=+3 ... 7=-3, 4=radical)
        try:
            cc = int(ln[36:39])
            if cc and cc != 4:
                charges[i] = 4 - cc
        except (ValueError, IndexError):
            pass
    bonds, orders = [], []
    for i in range(nb):
        ln = lines[base + na + i]
        a1, a2, bt = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        bonds.append((a1, a2))
        orders.append(bt)
    # property block
    props: dict = {}
    idx = base + na + nb
    prop_key = None
    for ln in lines[idx:]:
        if ln.startswith("M  CHG"):
            parts = ln.split()
            n = int(parts[2])
            for k in range(n):
                charges[int(parts[3 + 2 * k]) - 1] = int(parts[4 + 2 * k])
        elif ln.startswith("> "):
            # data header: >  <key>
            start = ln.find("<")
            end = ln.find(">", start)
            prop_key = ln[start + 1 : end] if start >= 0 and end > start else None
            if prop_key is not None:
                props[prop_key] = []
        elif prop_key is not None:
            if ln.strip() == "":
                prop_key = None
            else:
                props[prop_key].append(ln)
    props = {k: "\n".join(v).strip() for k, v in props.items()}

    fc = np.zeros(na, dtype=np.int64)
    for i, c in charges.items():
        fc[i] = c
    return RawMol(
        name=name,
        elements=elements,
        coords=np.array(coords, dtype=np.float32),
        bonds=np.array(bonds, dtype=np.int64).reshape(-1, 2),
        bond_orders=np.array(orders, dtype=np.int64),
        formal_charges=fc,
        props=props,
    )


_MOL2_BOND = {"1": 1, "2": 2, "3": 3, "ar": 4, "am": 1, "du": 1, "un": 1, "nc": 0}


def parse_mol2(path: str) -> list[RawMol]:
    with _open(path) as fh:
        text = fh.read()
    mols = []
    for chunk in text.split("@<TRIPOS>MOLECULE")[1:]:
        lines = chunk.splitlines()
        name = lines[1].strip() if len(lines) > 1 else ""
        sec = None
        elements, coords, charges = [], [], []
        bonds, orders = [], []
        for ln in lines:
            s = ln.strip()
            if s.startswith("@<TRIPOS>"):
                sec = s[9:]
                continue
            if not s:
                continue
            if sec == "ATOM":
                p = s.split()
                x, y, z = float(p[2]), float(p[3]), float(p[4])
                el = p[5].split(".")[0]
                elements.append(el)
                coords.append((x, y, z))
                charges.append(float(p[8]) if len(p) > 8 else 0.0)
            elif sec == "BOND":
                p = s.split()
                bt = _MOL2_BOND.get(p[3].lower(), 1)
                if bt == 0:
                    continue
                bonds.append((int(p[1]) - 1, int(p[2]) - 1))
                orders.append(bt)
        if elements:
            mols.append(
                RawMol(
                    name=name,
                    elements=elements,
                    coords=np.array(coords, dtype=np.float32),
                    bonds=np.array(bonds, dtype=np.int64).reshape(-1, 2),
                    bond_orders=np.array(orders, dtype=np.int64),
                    # mol2 carries partial (not formal) charges; formal
                    # charges default to 0 here
                    formal_charges=np.zeros(len(elements), dtype=np.int64),
                    props={},
                )
            )
    return mols


def parse_ligand_file(path: str) -> list[RawMol]:
    """Parse an SDF/MOL2 ligand file. A `path#<i>` suffix selects record i
    of a multi-molecule file and returns it as a one-element list — the
    addressing used by screening jobs expanded from a library SDF
    (app/jobs.py expand_ligand_library). The suffix is only honored when
    `path` itself does not name an existing file, so files whose names
    legitimately contain '#' keep working."""
    idx = None
    if "#" in path and not os.path.exists(path):
        base, _, tail = path.rpartition("#")
        if tail.isdigit() and os.path.exists(base):
            path, idx = base, int(tail)
    if idx is not None:
        # record-addressed lookups arrive once per record of the SAME
        # library file (one prep job each); re-parsing the whole file per
        # record would make an N-record screen O(N^2) in records parsed.
        # Cache the parsed list keyed by (path, mtime, size); parsed
        # RawMols are treated as immutable everywhere downstream.
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        mols = _PARSED_CACHE.get(key)
        if mols is None:
            _PARSED_CACHE.clear()  # one library at a time; bound memory
            mols = _parse_by_ext(path)
            _PARSED_CACHE[key] = mols
        if idx >= len(mols):
            raise IndexError(
                f"{path} has {len(mols)} molecules; record #{idx} requested"
            )
        return [mols[idx]]
    return _parse_by_ext(path)


_PARSED_CACHE: dict = {}


def _parse_by_ext(path: str) -> list[RawMol]:
    if path.lower().endswith((".mol2", ".mol2.gz")):
        return parse_mol2(path)
    return parse_sdf(path)


def to_sdf_block(mol: RawMol, coords: np.ndarray | None = None, props: dict | None = None) -> str:
    """Serialize one molecule to an SDF block (V2000), incl. $$$$."""
    coords = mol.coords if coords is None else coords
    na, nb = mol.num_atoms, len(mol.bonds)
    # the JAX package's program line: both packages write the same bytes
    out = [mol.name or "ligand", "  diffbindfr_tpu", ""]
    out.append(f"{na:>3}{nb:>3}  0  0  0  0  0  0  0  0999 V2000")
    for i in range(na):
        x, y, z = coords[i]
        out.append(
            f"{x:>10.4f}{y:>10.4f}{z:>10.4f} {mol.elements[i]:<3} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for (a1, a2), bt in zip(mol.bonds, mol.bond_orders):
        out.append(f"{a1 + 1:>3}{a2 + 1:>3}{bt:>3}  0")
    chg = [(i + 1, c) for i, c in enumerate(mol.formal_charges) if c]
    for i in range(0, len(chg), 8):
        batch = chg[i : i + 8]
        out.append(
            "M  CHG" + f"{len(batch):>3}" + "".join(f"{a:>4}{c:>4}" for a, c in batch)
        )
    out.append("M  END")
    merged = dict(mol.props)
    if props:
        merged.update(props)
    for k, v in merged.items():
        out.append(f">  <{k}>")
        out.append(str(v))
        out.append("")
    out.append("$$$$")
    return "\n".join(out) + "\n"


def write_sdf(path: str, mols, coords_list=None, props_list=None) -> None:
    if isinstance(mols, RawMol):
        mols = [mols]
    with open(path, "w") as fh:
        for i, m in enumerate(mols):
            c = coords_list[i] if coords_list is not None else None
            p = props_list[i] if props_list is not None else None
            fh.write(to_sdf_block(m, coords=c, props=p))
