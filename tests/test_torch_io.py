"""The port's file readers and writers (diffbindfr_torch/io/) against the JAX
package's on the tracked inputs: the five ligands and proteins under
runs/pb_bench. Equality is exact: parsed arrays value, dtype and shape;
written files byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from diffbindfr_tpu.io import pdb as JPDB
from diffbindfr_tpu.io import sdf as JSDF
from diffbindfr_tpu.io import xtc as JXTC
from diffbindfr_torch.io import pdb as TPDB
from diffbindfr_torch.io import sdf as TSDF
from diffbindfr_torch.io import xtc as TXTC

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


def _bench(name, what):
    return os.path.join(ROOT, "runs/pb_bench", name, f"{name}_{what}")


def _same(a, b, what):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("name", NAMES)
def test_sdf_parse_and_write_match_jax(name, tmp_path):
    """parse_sdf field for field, to_sdf_block and write_sdf byte for byte
    (with moved coordinates and added properties), and `path#i`
    addressing of a two-record library."""
    path = _bench(name, "ligand.sdf")
    got, want = TSDF.parse_sdf(path), JSDF.parse_sdf(path)
    assert len(got) == len(want) == 1
    for f in ("name", "elements", "coords", "bonds", "bond_orders", "formal_charges", "props"):
        _same(getattr(got[0], f), getattr(want[0], f), f"{name} {f}")
    moved = want[0].coords + np.float32(1.2345)
    props = {"mdn_score": "1.250000", "step": "3"}
    assert (TSDF.to_sdf_block(got[0], moved, props)
            == JSDF.to_sdf_block(want[0], moved, props))
    lib = str(tmp_path / "lib.sdf")
    TSDF.write_sdf(lib, [got[0], got[0]], coords_list=[None, moved])
    JSDF.write_sdf(str(tmp_path / "jlib.sdf"), [want[0], want[0]], coords_list=[None, moved])
    assert open(lib, "rb").read() == open(tmp_path / "jlib.sdf", "rb").read()
    rec = TSDF.parse_ligand_file(lib + "#1")
    want_rec = JSDF.parse_ligand_file(lib + "#1")
    assert len(rec) == 1 and np.array_equal(rec[0].coords, want_rec[0].coords)
    with pytest.raises(IndexError):
        TSDF.parse_ligand_file(lib + "#2")


@pytest.mark.parametrize("name", NAMES)
def test_pdb_parse_and_write_match_jax(name):
    """parse_pdb's arrays equal the JAX call's (which may take the native
    parser), to_pdb_string is byte-identical, and PdbTemplate.render gives
    to_pdb_string's bytes for the protein with moved pocket atoms."""
    path = _bench(name, "protein_contact_chains.pdb")
    got, want = TPDB.parse_pdb(path), JPDB.parse_pdb(path)
    for f in ("atom_positions", "atom_mask", "aatype", "residue_index", "chain_index",
              "b_factors", "chain_ids", "resnames", "insertion_codes"):
        _same(getattr(got, f), getattr(want, f), f"{name} {f}")
    text = TPDB.to_pdb_string(got)
    assert text == JPDB.to_pdb_string(want)
    sel = np.arange(3, got.num_res, 7)
    assert TPDB.to_pdb_string(got.select(sel)) == JPDB.to_pdb_string(want.select(sel))
    # a template over 12 residues' present atoms plus one atom they lack
    rng = np.random.default_rng(0)
    res = np.sort(rng.choice(got.num_res, 12, replace=False))
    ri, a37 = np.nonzero(got.atom_mask[res])
    ri = res[ri]
    absent = np.argwhere(got.atom_mask[res[0]] == 0)[0, 0]
    ri, a37 = np.append(ri, res[0]), np.append(a37, absent)
    mask37 = got.atom_mask.copy()
    mask37[ri, a37] = 1.0
    var = rng.normal(size=(len(ri), 3)) * 20.0
    swapped = TPDB.Protein(**{**got.__dict__, "atom_mask": mask37,
                              "atom_positions": got.atom_positions.copy()})
    swapped.atom_positions[ri, a37] = var
    want_text = JPDB.to_pdb_string(swapped)
    assert TPDB.PdbTemplate(got, mask37, ri, a37).render(var) == want_text
    assert TPDB.to_pdb_string(swapped) == want_text
    assert TPDB.parse_pdb(text, is_string=True).atom_mask.sum() == got.atom_mask.sum()


@pytest.mark.parametrize("case", ["ligand", "pocket", "plain_float", "wide"])
def test_xtc_writer_matches_jax_and_reads_back(case, tmp_path):
    """write_xtc is byte-identical to the JAX writer on a ligand- and a
    pocket-sized trajectory, the <= 9 atom plain-float path and the
    per-dimension bit path (> 2^24 range); the JAX reader reads it back
    within the format's 0.01 A quantisation (exactly on the float path)."""
    rng = np.random.default_rng(3)
    shape, scale = {"ligand": ((20, 35, 3), 12.0), "pocket": ((20, 900, 3), 15.0),
                    "plain_float": ((4, 7, 3), 5.0), "wide": ((2, 300, 3), 9000.0)}[case]
    coords = rng.normal(size=shape) * scale + 30.0
    p, q = str(tmp_path / "t.xtc"), str(tmp_path / "j.xtc")
    TXTC.write_xtc(p, coords, time_ps=np.arange(shape[0]) * 0.5)
    JXTC.write_xtc(q, coords, time_ps=np.arange(shape[0]) * 0.5)
    assert open(p, "rb").read() == open(q, "rb").read()
    back, times = JXTC.read_xtc(p)
    np.testing.assert_allclose(back, coords, atol=1e-4 if case == "plain_float" else 0.02)
    np.testing.assert_allclose(times, np.arange(shape[0]) * 0.5)
