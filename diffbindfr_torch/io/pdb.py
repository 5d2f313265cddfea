"""Pure-Python PDB reading and writing into atom37 protein records: the
port's copy of diffbindfr_tpu/io/pdb.py.

No biopython. Only the fields the docking pipeline reads are parsed:
coordinates, atom/residue/chain identity, b-factors, altloc filtering. The
JAX package first tries a native C++ parser (io/native.py there); the port
has only the line parser, which gives the same arrays.
"""
from __future__ import annotations

import dataclasses
import gzip

import numpy as np

from ..constants import residues as rc

# non-standard residue name normalization (common HETATM aliases)
_RESNAME_FIX = {
    "MSE": "MET", "SEC": "CYS", "HSD": "HIS", "HSE": "HIS", "HSP": "HIS",
    "HID": "HIS", "HIE": "HIS", "HIP": "HIS", "CYX": "CYS", "CYM": "CYS",
    "ASH": "ASP", "GLH": "GLU", "LYN": "LYS", "ARN": "ARG",
}


@dataclasses.dataclass
class Protein:
    """atom37 protein record (mirrors the reference Protein fields)."""

    atom_positions: np.ndarray  # [N, 37, 3]
    atom_mask: np.ndarray  # [N, 37]
    aatype: np.ndarray  # [N] in [0, 20]
    residue_index: np.ndarray  # [N] author residue numbers
    chain_index: np.ndarray  # [N]
    b_factors: np.ndarray  # [N, 37]
    chain_ids: list[str] = dataclasses.field(default_factory=list)
    resnames: list[str] = dataclasses.field(default_factory=list)
    insertion_codes: list[str] = dataclasses.field(default_factory=list)

    @property
    def num_res(self) -> int:
        return self.aatype.shape[0]

    def select(self, idx: np.ndarray) -> "Protein":
        return Protein(
            atom_positions=self.atom_positions[idx],
            atom_mask=self.atom_mask[idx],
            aatype=self.aatype[idx],
            residue_index=self.residue_index[idx],
            chain_index=self.chain_index[idx],
            b_factors=self.b_factors[idx],
            chain_ids=self.chain_ids,
            resnames=[self.resnames[i] for i in np.atleast_1d(idx)],
            insertion_codes=[self.insertion_codes[i] for i in np.atleast_1d(idx)],
        )


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def parse_pdb(
    path_or_str: str,
    is_string: bool = False,
    model: int = 1,
    keep_hetero: bool = False,
) -> Protein:
    """Parse a PDB file (or string) into an atom37 Protein.

    Hydrogens, waters, and non-standard hetero residues are skipped; altloc
    keeps 'A'/' ' (or the first seen). MSE and protonation-variant residue
    names are normalized to their standard parents.
    """
    if is_string:
        lines = path_or_str.splitlines()
    else:
        if model == 1 and not keep_hetero and not path_or_str.endswith(".gz"):
            # the native C++ parser (io/native.py), where the JAX package
            # uses it; it leaves a file it cannot open, or one with more
            # residues than its max_res, to the line parser below
            from .native import parse_pdb_native

            prot = parse_pdb_native(path_or_str)
            if prot is not None:
                return prot
        with _open(path_or_str) as fh:
            lines = fh.read().splitlines()

    residues: dict[tuple, dict] = {}
    order: list[tuple] = []
    current_model = 1
    for line in lines:
        rec = line[:6]
        if rec == "MODEL ":
            current_model = int(line[10:14])
            continue
        if rec == "ENDMDL":
            current_model = -1
            continue
        if rec not in ("ATOM  ", "HETATM"):
            continue
        if current_model not in (1, model) and current_model != -1:
            continue
        if current_model == -1:
            break
        resname = line[17:20].strip()
        is_het = rec == "HETATM"
        if is_het:
            resname_fixed = _RESNAME_FIX.get(resname)
            if resname_fixed is None:
                continue  # waters, ligands, ions are not protein residues
            resname = resname_fixed
        else:
            resname = _RESNAME_FIX.get(resname, resname)
        if resname not in rc.restype_3to1 and not keep_hetero:
            # unknown residue: keep as UNK so backbone geometry survives
            if resname == "HOH":
                continue
        atom_name = line[12:16].strip()
        element = line[76:78].strip() if len(line) >= 78 else ""
        if element == "H" or atom_name.startswith(("H", "1H", "2H", "3H", "D")):
            if element in ("H", "D") or (not element and atom_name[:1] in "123H"):
                continue
        altloc = line[16]
        if altloc not in (" ", "A", "1"):
            continue
        chain = line[21]
        resnum = int(line[22:26])
        icode = line[26]
        key = (chain, resnum, icode, resname)
        if key not in residues:
            residues[key] = {
                "pos": np.zeros((37, 3), dtype=np.float32),
                "mask": np.zeros(37, dtype=np.float32),
                "bfac": np.zeros(37, dtype=np.float32),
            }
            order.append(key)
        r = residues[key]
        a37 = rc.atom37_order.get(atom_name)
        if a37 is None:
            if atom_name == "SE" and resname == "MET":
                a37 = rc.atom37_order["SD"]
            else:
                continue
        if r["mask"][a37]:
            continue  # duplicate atom record
        x = float(line[30:38])
        y = float(line[38:46])
        z = float(line[46:54])
        try:
            b = float(line[60:66])
        except ValueError:
            b = 0.0
        r["pos"][a37] = (x, y, z)
        r["mask"][a37] = 1.0
        r["bfac"][a37] = b

    n = len(order)
    pos = np.zeros((n, 37, 3), dtype=np.float32)
    mask = np.zeros((n, 37), dtype=np.float32)
    bfac = np.zeros((n, 37), dtype=np.float32)
    aatype = np.zeros(n, dtype=np.int64)
    resnum = np.zeros(n, dtype=np.int64)
    chain_idx = np.zeros(n, dtype=np.int64)
    chain_ids: list[str] = []
    resnames: list[str] = []
    icodes: list[str] = []
    for i, key in enumerate(order):
        chain, num, icode, resname = key
        r = residues[key]
        pos[i] = r["pos"]
        mask[i] = r["mask"]
        bfac[i] = r["bfac"]
        aatype[i] = rc.aatype_from_resname(resname)
        resnum[i] = num
        if chain not in chain_ids:
            chain_ids.append(chain)
        chain_idx[i] = chain_ids.index(chain)
        resnames.append(resname)
        icodes.append(icode)

    return Protein(
        atom_positions=pos,
        atom_mask=mask,
        aatype=aatype,
        residue_index=resnum,
        chain_index=chain_idx,
        b_factors=bfac,
        chain_ids=chain_ids,
        resnames=resnames,
        insertion_codes=icodes,
    )


def to_pdb_string(
    prot: Protein,
    atom14_pos: np.ndarray | None = None,
    atom14_mask: np.ndarray | None = None,
) -> str:
    """Serialize a Protein to PDB text. If atom14 arrays are given they
    override the atom37 coordinates (used to export rebuilt pockets)."""
    pos = prot.atom_positions
    mask = prot.atom_mask
    if atom14_pos is not None:
        pos = pos.copy()
        mask = np.zeros_like(prot.atom_mask)
        a14_to_37 = rc.restype_atom14_to_atom37[prot.aatype]  # [N, 14]
        m14 = (
            atom14_mask
            if atom14_mask is not None
            else rc.restype_atom14_mask[prot.aatype]
        )
        for i in range(prot.num_res):
            for s in range(14):
                if m14[i, s]:
                    pos[i, a14_to_37[i, s]] = atom14_pos[i, s]
                    mask[i, a14_to_37[i, s]] = 1.0

    lines = []
    serial = 1
    for i in range(prot.num_res):
        resname = (
            prot.resnames[i]
            if prot.resnames
            else rc.restype_1to3.get(
                rc.restypes[prot.aatype[i]] if prot.aatype[i] < 20 else "X", "UNK"
            )
        )
        chain = prot.chain_ids[prot.chain_index[i]] if prot.chain_ids else "A"
        icode = prot.insertion_codes[i] if prot.insertion_codes else " "
        for a37 in range(37):
            if not mask[i, a37]:
                continue
            name = rc.atom37_names[a37]
            el = name[0]
            pad_name = f" {name:<3}" if len(name) < 4 else name
            x, y, z = pos[i, a37]
            b = prot.b_factors[i, a37]
            lines.append(
                f"ATOM  {serial:>5} {pad_name}{'':1}{resname:>3} {chain}"
                f"{prot.residue_index[i]:>4}{icode}   "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{b:6.2f}"
                f"          {el:>2}  "
            )
            serial += 1
    lines.append("END")
    return "\n".join(lines) + "\n"


def write_pdb(path: str, prot: Protein, **kw) -> None:
    with open(path, "w") as fh:
        fh.write(to_pdb_string(prot, **kw))


class PdbTemplate:
    """Incremental PDB serializer for the per-pose export hot path.

    At screen/eval scale the reference writes a full per-pose protein PDB
    (evaluation/export.py:106-313) and so do we — but across poses of the
    same (protein, pocket) only the swapped pocket atoms' coordinates
    change. This template precomputes every constant byte of the file
    once (serials, names, the non-pocket atoms' coordinate fields) and
    `render()` re-formats only the variable atoms, producing output
    byte-identical to `to_pdb_string` on the swapped protein.

    Args:
      prot: the full input protein (constant coordinates come from here).
      mask37: [N, 37] post-swap atom mask (constant across poses; swapped
        pocket slots may add atoms the input lacked).
      var_res / var_a37: [K] parallel arrays naming the variable atom
        slots, i.e. the pocket-swapped (residue, atom37) positions.
        render(var_pos) supplies their world coordinates in this order.
    """

    def __init__(self, prot: Protein, mask37: np.ndarray,
                 var_res: np.ndarray, var_a37: np.ndarray):
        var_set = {(int(r), int(a)) for r, a in zip(var_res, var_a37)}
        var_slot = {(int(r), int(a)): j
                    for j, (r, a) in enumerate(zip(var_res, var_a37))}
        pos = prot.atom_positions
        segments: list = []  # str (constant chunk) | (var_j, prefix, suffix)
        buf: list[str] = []
        serial = 1
        for i in range(prot.num_res):
            resname = (
                prot.resnames[i]
                if prot.resnames
                else rc.restype_1to3.get(
                    rc.restypes[prot.aatype[i]] if prot.aatype[i] < 20
                    else "X", "UNK")
            )
            chain = prot.chain_ids[prot.chain_index[i]] if prot.chain_ids else "A"
            icode = prot.insertion_codes[i] if prot.insertion_codes else " "
            for a37 in range(37):
                if not mask37[i, a37]:
                    continue
                name = rc.atom37_names[a37]
                el = name[0]
                pad_name = f" {name:<3}" if len(name) < 4 else name
                b = prot.b_factors[i, a37]
                prefix = (
                    f"ATOM  {serial:>5} {pad_name}{'':1}{resname:>3} {chain}"
                    f"{prot.residue_index[i]:>4}{icode}   "
                )
                suffix = f"{1.0:6.2f}{b:6.2f}          {el:>2}  \n"
                if (i, a37) in var_set:
                    if buf:
                        segments.append("".join(buf))
                        buf = []
                    segments.append((var_slot[(i, a37)], prefix, suffix))
                else:
                    x, y, z = pos[i, a37]
                    buf.append(f"{prefix}{x:8.3f}{y:8.3f}{z:8.3f}{suffix}")
                serial += 1
        buf.append("END\n")
        segments.append("".join(buf))
        self._segments = segments

    def render(self, var_pos: np.ndarray) -> str:
        """var_pos: [K, 3] world-frame coordinates of the variable atoms,
        in the (var_res, var_a37) construction order."""
        vp = np.asarray(var_pos, dtype=np.float64)
        out = []
        for seg in self._segments:
            if isinstance(seg, str):
                out.append(seg)
            else:
                j, prefix, suffix = seg
                x, y, z = vp[j]
                out.append(f"{prefix}{x:8.3f}{y:8.3f}{z:8.3f}{suffix}")
        return "".join(out)
