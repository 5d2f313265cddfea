"""Host pocket prep of the PyTorch port (diffbindfr_torch/geometry/chi.py's
numpy half, chem/protein_feats.py, chem/secondary_structure.py,
data/sample.py make_sample and app/analysis.py build_holo_ref) against the
JAX package's, on the CPU.

Inputs: the five pb_bench pairs (`<id>_protein_contact_chains.pdb` with the
complex's own ligand as the pocket reference, radius 12 A), a copy of 3mhw
with one chi atom deleted (the SCFixer repair), and 3mhw's protein with its
side chains moved, rigidly displaced and renumbered (the holo reference).
Every comparison is exact (value, dtype, shape): the port runs the same
numpy operations in the same order, the per-residue SASA and depth
included.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import analysis as JA
from diffbindfr_tpu.chem import protein_feats as JPF
from diffbindfr_tpu.chem import secondary_structure as JSS
from diffbindfr_tpu.data import sample as JS
from diffbindfr_tpu.geometry import chi as JCHI
from diffbindfr_tpu.io.pdb import parse_pdb as jparse_pdb
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse_lig
from diffbindfr_torch.app import analysis as TA
from diffbindfr_torch.chem import protein_feats as TPF
from diffbindfr_torch.chem import records as R
from diffbindfr_torch.chem import secondary_structure as TSS
from diffbindfr_torch.data import sample as TS
from diffbindfr_torch.geometry import chi as TCHI
from diffbindfr_torch.io.pdb import parse_pdb as tparse_pdb
from diffbindfr_torch.io.sdf import parse_ligand_file as tparse_lig

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


def _files(name):
    d = os.path.join(ROOT, "runs/pb_bench", name)
    return f"{d}/{name}_protein_contact_chains.pdb", f"{d}/{name}_ligand.sdf"


def _same(a, b, what):
    if dataclasses.is_dataclass(b) or isinstance(b, tuple) and hasattr(b, "_fields"):
        names = [f.name for f in dataclasses.fields(b)] if dataclasses.is_dataclass(b) \
            else list(b._fields)
        for f in names:
            _same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    elif isinstance(b, float) and np.isnan(b):
        assert isinstance(a, float) and np.isnan(a), what
    else:
        assert type(a) is type(b) and a == b, what


def _pockets(pdb, ref_sdf, **kw):
    jp, tp = jparse_pdb(pdb), tparse_pdb(pdb)
    ref_j, ref_t = jparse_lig(ref_sdf)[0].coords, tparse_lig(ref_sdf)[0].coords
    return (JPF.build_pocket_record(jp, ref_j, 12.0, **kw),
            TPF.build_pocket_record(tp, ref_t, 12.0, **kw), jp, tp)


@pytest.mark.parametrize("name", NAMES)
def test_chi_template_matches_jax(name):
    """select_pocket, atom37_to_atom14, extract_chi_and_template and
    chi_exists_mask on the pocket residues."""
    pdb, sdf = _files(name)
    jp, tp = jparse_pdb(pdb), tparse_pdb(pdb)
    ref = tparse_lig(sdf)[0].coords
    sel = TPF.select_pocket(tp, ref, 12.0)
    _same(sel, JPF.select_pocket(jp, ref, 12.0), "select_pocket")
    assert sel.size > 20
    pos14, mask14 = TPF.atom37_to_atom14(tp.select(sel))
    jpos14, jmask14 = JPF.atom37_to_atom14(jp.select(sel))
    _same(pos14, jpos14, "pos14")
    _same(mask14, jmask14, "mask14")
    aatype = tp.aatype[sel]
    _same(TCHI.extract_chi_and_template(aatype, pos14, mask14),
          JCHI.extract_chi_and_template(aatype, jpos14, jmask14), "template")
    _same(TPF.chi_exists_mask(aatype, mask14), JPF.chi_exists_mask(aatype, jmask14), "chi")


@pytest.mark.parametrize("name", NAMES)
def test_pocket_record_and_sample_match_jax(name):
    """build_pocket_record field by field, then make_sample of the decentred
    ligand in that pocket, and choose_bucket."""
    from diffbindfr_tpu.chem.ligand_feats import featurize_ligand as jfeat
    from diffbindfr_tpu.chem.mol import perceive as jperceive
    from diffbindfr_torch.chem.ligand_feats import featurize_ligand as tfeat
    from diffbindfr_torch.chem.mol import perceive as tperceive

    pdb, sdf = _files(name)
    jpk, tpk, _, _ = _pockets(pdb, sdf)
    assert isinstance(tpk, R.PocketRecord)
    _same(tpk, jpk, "pocket")
    jl, tl = jfeat(jperceive(jparse_lig(sdf)[0])), tfeat(tperceive(tparse_lig(sdf)[0]))
    jl.pos, tl.pos = jl.pos - jpk.center, tl.pos - tpk.center
    js, ts = JS.make_sample(jl, jpk), TS.make_sample(tl, tpk)
    _same(ts, js, "sample")
    assert TS.bucket_of(ts) == TS.choose_bucket(
        tl.num_atoms, tl.edge_index.shape[1], tl.num_torsions, tpk.num_res,
        int(tpk.atom14_mask.sum()))


def _residue_lines_without(pdb_text, chain, resnum, atom):
    out = []
    for line in pdb_text.splitlines(keepends=True):
        if (line.startswith("ATOM") and line[21] == chain and int(line[22:26]) == resnum
                and line[12:16].strip() == atom):
            continue
        out.append(line)
    return "".join(out)


def test_scfixer_repairs_a_missing_chi_atom(tmp_path):
    """3mhw with the CD of a pocket residue that has chi2 deleted: its chi
    mask, template, default frames and atom14 mask come from the ideal AF2
    tables (SCFixer), the input mask keeps the hole, and the port's record
    equals the JAX package's."""
    from diffbindfr_torch.constants import residues as rc

    pdb, sdf = _files("3mhw")
    tp = tparse_pdb(pdb)
    pk = TPF.build_pocket_record(tp, tparse_lig(sdf)[0].coords, 12.0)
    cd_res = [rc.restype_order[rc.restype_3to1[r]] for r in ("LYS", "ARG", "GLU", "GLN", "PRO")]
    k = int(np.nonzero(np.isin(pk.aatype, cd_res) & pk.chi_mask[:, 1])[0][0])
    chain = pk.chain_ids[int(pk.chain_index[k])]
    broken = tmp_path / "3mhw_broken.pdb"
    broken.write_text(_residue_lines_without(open(pdb).read(), chain,
                                             int(pk.residue_index[k]), "CD"))
    jpk, tpk, _, _ = _pockets(str(broken), sdf)
    _same(tpk, jpk, "pocket")
    names = rc.restype_name_to_atom14_names[rc.restype_1to3[rc.restypes[tpk.aatype[k]]]]
    slot = names.index("CD")
    assert tpk.atom14_input_mask[k, slot] == 0 and tpk.atom14_mask[k, slot] == 1
    assert bool(tpk.chi_mask[k, 1])
    np.testing.assert_array_equal(tpk.default_frame[k],
                                  rc.restype_rigid_group_default_frame[tpk.aatype[k]])
    np.testing.assert_array_equal(tpk.rigid_group_positions[k],
                                  rc.restype_atom14_rigid_group_positions[tpk.aatype[k]])
    np.testing.assert_array_equal(tpk.atom14_input_mask[np.arange(tpk.num_res) != k],
                                  tpk.atom14_mask[np.arange(tpk.num_res) != k])


def test_extra_residue_features_match_jax():
    """build_pocket_record(extra_res_feats=("rasa", "depth")) on 3mhw: the
    Shrake-Rupley relative SASA and the residue depth, exact (3dbs's larger
    protein takes the JAX package ~24 s, so 3mhw only)."""
    pdb, sdf = _files("3mhw")
    jpk, tpk, jp, tp = _pockets(pdb, sdf, extra_res_feats=("rasa", "depth"))
    _same(tpk, jpk, "pocket")
    assert tpk.res_extra.shape == (tpk.num_res, 2) and np.ptp(tpk.res_extra[:, 1]) > 1.0
    # the order of the requested features is kept
    _, tpk2, _, _ = _pockets(pdb, sdf, extra_res_feats=("depth",))
    np.testing.assert_array_equal(tpk2.res_extra[:, 0], tpk.res_extra[:, 1])
    with pytest.raises(ValueError, match="unknown extra residue feature"):
        TPF.build_pocket_record(tp, tparse_lig(sdf)[0].coords, 12.0, extra_res_feats=("dssp",))


def test_secondary_structure_matches_jax():
    """assign_ss, backbone_dihedrals, the Kabsch-Sander energies, the SASA
    pair and the depth on 3mhw's protein."""
    pdb, _ = _files("3mhw")
    jp, tp = jparse_pdb(pdb), tparse_pdb(pdb)
    _same(TSS.hbond_energy_matrix(tp), JSS.hbond_energy_matrix(jp), "energies")
    ss = TSS.assign_ss(tp)
    _same(ss, JSS.assign_ss(jp), "ss")
    assert {"H", "E", "C"} <= set(ss.tolist())
    for got, want in zip(TSS.backbone_dihedrals(tp), JSS.backbone_dihedrals(jp)):
        _same(got, want, "dihedrals")
    for got, want in zip(TSS.shrake_rupley_sasa(tp), JSS.shrake_rupley_sasa(jp)):
        _same(got, want, "sasa")
    _same(TSS.residue_depth(tp), JSS.residue_depth(jp), "depth")


def _holo_variant(prot, shift_sc, offset, rot):
    """A holo structure of `prot`: side chains past CB moved by `shift_sc`,
    then the whole rotated by `rot` about the origin and moved 3 A, and
    residue numbers shifted by `offset`."""
    pos = prot.atom_positions.copy()
    pos[:, 5:] += np.float32(shift_sc)
    pos = (pos @ rot.T.astype(np.float32) + np.float32(3.0)) * prot.atom_mask[..., None]
    return dataclasses.replace(prot, atom_positions=pos.astype(np.float32),
                               residue_index=prot.residue_index + offset)


@pytest.mark.parametrize("offset", [0, 15])
def test_holo_reference_matches_jax(offset):
    """build_holo_ref of 3mhw's pocket against its protein with the side
    chains moved 0.5 A and displaced rigidly; renumbered by 15, the match
    falls to the voted numbering offset. Every HoloRef field is equal, and
    the fit recovers the apo frame (pocket CA RMSD ~0)."""
    pdb, sdf = _files("3mhw")
    jpk, tpk, jp, tp = _pockets(pdb, sdf)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    jh = JA.build_holo_ref(jpk, _holo_variant(jp, 0.5, offset, rot))
    th = TA.build_holo_ref(tpk, _holo_variant(tp, 0.5, offset, rot))
    assert isinstance(th, R.HoloRef) and TA.HoloRef is R.HoloRef
    _same(th, jh, "holo_ref")
    assert th.n_matched == tpk.num_res and th.ca_rmsd < 1e-3
    r, t = TA._kabsch_np(tpk.atom14_pos[:, 1], tpk.atom14_pos[:, 1] + 1.0)
    jr, jt = JA._kabsch_np(jpk.atom14_pos[:, 1], jpk.atom14_pos[:, 1] + 1.0)
    _same(r, jr, "kabsch r")
    _same(t, jt, "kabsch t")


def test_match_residues_matches_jax():
    """_match_residues by author key, and by the sequence window when the
    numbering differs."""
    pdb, sdf = _files("3mhw")
    jp, tp = jparse_pdb(pdb), tparse_pdb(pdb)
    idx = TPF.select_pocket(tp, tparse_lig(sdf)[0].coords, 12.0)
    for off in (0, 40):
        tq = dataclasses.replace(tp, residue_index=tp.residue_index + off)
        jq = dataclasses.replace(jp, residue_index=jp.residue_index + off)
        got = TA._match_residues(tp, tq, idx)
        assert got == JA._match_residues(jp, jq, idx)
        assert got == [(int(j), int(j)) for j in idx]
