"""AutoDock-VinaFR flexible-side-chain output remodelling: the port's copy
of diffbindfr_tpu/app/vinafr.py, on the port's PDB parser and writer.

Interop parity with DiffBindFR/utils/vinafr_remodel.py:17-196: take a
VinaFR docked PDBQT (rigid receptor + BEGIN_RES/END_RES flexible
side-chain blocks per MODEL), extract the top-1 model's side-chain
coordinates, and swap them back into the full receptor PDB so downstream
tools see one consistent holo structure. (Within this framework the same
role is played natively by `relax --flex`; this module exists for users
bringing external VinaFR results.)
"""
from __future__ import annotations

import numpy as np

from ..io.pdb import Protein, parse_pdb, to_pdb_string


def split_top1_flex_pdbqt(docked_pdbqt: str) -> list[str]:
    """Lines of the first MODEL's flexible-residue blocks."""
    with open(docked_pdbqt) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    out: list[str] = []
    in_top1 = False
    in_sc = False
    for ln in lines:
        s = ln.strip()
        if not s:
            continue
        if s.startswith("ENDMDL"):
            if in_top1:
                break
            continue
        if s.startswith("MODEL"):
            fields = s.split()
            in_top1 = len(fields) > 1 and fields[1] == "1"
            continue
        if in_top1 and s.startswith("BEGIN_RES"):
            in_sc = True
        if in_top1 and in_sc:
            out.append(s)
        if in_top1 and s.startswith("END_RES"):
            in_sc = False
    if not out:
        raise ValueError(f"no flexible residues in top-1 of {docked_pdbqt}")
    return out


def parse_flex_pdbqt(flex_lines: list[str]) -> dict:
    """{(chain_id, resnum, resname): {atom_name: xyz}} from BEGIN_RES
    blocks. PDBQT ATOM records share the PDB column layout for names and
    coordinates (cols 13-16, 31-54)."""
    mapping: dict = {}
    current = None
    for ln in flex_lines:
        if ln.startswith("BEGIN_RES"):
            # 'BEGIN_RES LYS A 123' (chain may be absent in some writers)
            f = ln.split()
            if len(f) >= 4:
                current = (f[2], int(f[3]), f[1])
            elif len(f) == 3:
                current = ("", int(f[2]), f[1])
            else:
                raise ValueError(f"unparseable BEGIN_RES line: {ln}")
            mapping.setdefault(current, {})
        elif ln.startswith("END_RES"):
            current = None
        elif ln.startswith(("ATOM", "HETATM")) and current is not None:
            name = ln[12:16].strip()
            xyz = np.array(
                [float(ln[30:38]), float(ln[38:46]), float(ln[46:54])],
                np.float64,
            )
            if name and not name.startswith("H"):
                mapping[current][name] = xyz
    return {k: v for k, v in mapping.items() if v}


def remodel(prot: Protein, flex_map: dict) -> Protein:
    """Swap the flexible residues' side-chain coordinates into the full
    protein (matched by chain, author resnum, and atom name)."""
    from ..constants import residues as rc

    pos37 = prot.atom_positions.copy()
    by_key = {}
    for i in range(prot.num_res):
        cid = prot.chain_ids[prot.chain_index[i]]
        by_key[(cid, int(prot.residue_index[i]))] = i
    n_swapped = 0
    for (cid, resnum, resname), atoms in flex_map.items():
        i = by_key.get((cid, resnum))
        if i is None and cid == "":
            # chain-less PDBQT: match on resnum alone if unambiguous
            cands = [k for k in by_key if k[1] == resnum]
            i = by_key[cands[0]] if len(cands) == 1 else None
        if i is None:
            continue
        for name, xyz in atoms.items():
            if name in rc.atom37_order:
                j = rc.atom37_order[name]
                if prot.atom_mask[i, j] > 0:
                    pos37[i, j] = xyz
                    n_swapped += 1
    if n_swapped == 0:
        raise ValueError("no flexible atoms matched the receptor")
    return Protein(
        atom_positions=pos37, atom_mask=prot.atom_mask,
        aatype=prot.aatype, residue_index=prot.residue_index,
        chain_index=prot.chain_index, b_factors=prot.b_factors,
        chain_ids=prot.chain_ids, resnames=prot.resnames,
        insertion_codes=prot.insertion_codes,
    )


def build_vinafr_protein(prot_pdb: str, docked_pdbqt: str,
                         out_pdb: str) -> int:
    """CLI-style entry (build_vinafr_protein parity): returns the number
    of remodelled residues."""
    prot = parse_pdb(prot_pdb)
    flex = parse_flex_pdbqt(split_top1_flex_pdbqt(docked_pdbqt))
    out = remodel(prot, flex)
    with open(out_pdb, "w") as fh:
        fh.write(to_pdb_string(out))
    return len(flex)
