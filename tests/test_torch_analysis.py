"""TM-align (diffbindfr_torch/ops/tmalign.py) and the apo/holo binding-site
comparison (app/analysis.py compare_binding_sites and its command line) of
the port against the JAX package's, on the CPU.

CA traces of the runs/pb_bench proteins: 3dbs against 3mhw (two unrelated
folds), and each against a seeded rotated, jittered copy of itself. The
binding-site comparison on each package's parse of the same files: the
full protein against its contact chains, and against a seeded perturbed
copy. Both are host numpy (f64): values within 1e-6, alignments equal.
"""
import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import analysis as JA
from diffbindfr_tpu.chem.protein_feats import atom37_to_atom14 as j37to14
from diffbindfr_tpu.io.pdb import parse_pdb as jparse_pdb
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse
from diffbindfr_tpu.ops.tmalign import tmalign as jtmalign
from diffbindfr_torch.app import analysis as TA
from diffbindfr_torch.chem.protein_feats import atom37_to_atom14 as t37to14
from diffbindfr_torch.io.pdb import parse_pdb as tparse_pdb
from diffbindfr_torch.io.sdf import parse_ligand_file as tparse
from diffbindfr_torch.ops.tmalign import tmalign as ttmalign

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
TOL = 1e-6


def _ca(name):
    """CA trace of a contact-chains receptor (the port's parse; the JAX
    parse gives the same array, checked in test_torch_io.py)."""
    p14, m14 = t37to14(tparse_pdb(os.path.join(PB, name, f"{name}_protein_contact_chains.pdb")))
    return p14[m14[:, 1] > 0, 1].astype(np.float64)


def _moved(x, seed):
    """A seeded rigid motion of x plus 0.3 A jitter."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return x @ q.T + rng.normal(size=3) * 5.0 + rng.normal(scale=0.3, size=x.shape)


def _same_result(got, want):
    for f in ("tm_target", "tm_mobile", "rmsd"):
        assert abs(getattr(got, f) - getattr(want, f)) <= TOL * max(1.0, abs(getattr(want, f))), f
    assert got.n_aligned == want.n_aligned
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_allclose(got.rotation, want.rotation, atol=TOL)
    np.testing.assert_allclose(got.translation, want.translation, atol=TOL)


@pytest.mark.parametrize("case", ["3dbs-3mhw", "3dbs-moved", "3mhw-moved"])
def test_tmalign_matches_jax(case):
    a, b = case.split("-")
    mob = _ca(a)
    tgt = _ca(b) if b != "moved" else _moved(mob, len(a) + ord(a[1]))
    want, got = jtmalign(mob, tgt), ttmalign(mob, tgt)
    _same_result(got, want)
    if b == "moved":  # a copy of itself aligns almost everywhere
        assert got.tm_target > 0.9
    else:
        assert got.tm_target < 0.5


def _perturbed(prot, seed):
    rng = np.random.default_rng(seed)
    pos = prot.atom_positions + rng.normal(scale=0.4, size=prot.atom_positions.shape).astype(
        prot.atom_positions.dtype)
    return dataclasses.replace(prot, atom_positions=pos * prot.atom_mask[..., None])


@pytest.mark.parametrize("name", ["2zec", "3mhw"])
def test_compare_binding_sites_matches_jax(name):
    """Protein vs its contact chains (one chain kept: the same site), and
    vs a perturbed copy: every number within TOL of the JAX function's."""
    d = os.path.join(PB, name)
    prot, cc = os.path.join(d, f"{name}_protein.pdb"), os.path.join(
        d, f"{name}_protein_contact_chains.pdb")
    lig = os.path.join(d, f"{name}_ligand.sdf")
    jref, tref = jparse(lig)[0].coords, tparse(lig)[0].coords
    np.testing.assert_array_equal(jref, tref)
    cases = [((prot, cc), (prot, cc)),
             ((_perturbed(jparse_pdb(cc), 5), jparse_pdb(cc)),
              (_perturbed(tparse_pdb(cc), 5), tparse_pdb(cc)))]
    for (japo, jholo), (tapo, tholo) in cases:
        want = JA.compare_binding_sites(japo, jholo, jref)
        got = TA.compare_binding_sites(tapo, tholo, tref)
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(got[k] - w) <= TOL * max(1.0, abs(w)), k
    assert want["sc_rmsd"] > 0.3  # the perturbed copy moved its side chains


def test_analysis_command_prints_the_jax_report():
    """`python -m ...analysis apo holo ligand cutoff` prints the JAX text."""
    d = os.path.join(PB, "3mhw")
    argv = [os.path.join(d, "3mhw_protein.pdb"),
            os.path.join(d, "3mhw_protein_contact_chains.pdb"),
            os.path.join(d, "3mhw_ligand.sdf"), "10"]
    outs = []
    for main in (JA.main, TA.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and "tm_score: 1.000" in outs[0]
