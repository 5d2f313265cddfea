"""Prep records of the PyTorch port (diffbindfr_torch/chem/records.py) and
the stages that read them, against the JAX package's own unpickle.

The five tracked `rec.pkl` files name the JAX package's record classes; the
port's restricted unpickler maps them onto its copies, so that reading a
record (and running error correction and MDN scoring on it) imports neither
JAX nor the JAX package nor networkx. Equality is exact: field for field,
value, dtype and shape.
"""
import dataclasses
import io
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem import records as R
from diffbindfr_torch.data.sample import bucket_of

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


def _path(name):
    return os.path.join(PREP, f"{name}_r12.rec.pkl")


def _assert_same(a, b, what):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("name", NAMES)
def test_record_equals_the_jax_unpickle(name):
    """Every key of the record dict, and every field of the ligand, pocket
    and bucket, equals the JAX package's unpickle of the same file."""
    with open(_path(name), "rb") as fh:
        ref = pickle.load(fh)  # imports the JAX package's classes
    got = R.load_prep_record(_path(name))
    assert set(got) == set(ref)
    assert isinstance(got["lig"], R.LigandRecord)
    assert isinstance(got["pocket"], R.PocketRecord)
    for key in ("lig", "pocket", "bucket"):
        fields = [f.name for f in dataclasses.fields(ref[key])]
        assert fields == [f.name for f in dataclasses.fields(got[key])], key
        for f in fields:
            _assert_same(getattr(got[key], f), getattr(ref[key], f), f"{name} {key}.{f}")
    for key in set(ref) - {"lig", "pocket", "bucket"}:
        _assert_same(got[key], ref[key], f"{name} {key}")
    assert got["lig"].num_atoms == ref["lig"].num_atoms
    assert got["lig"].num_torsions == ref["lig"].num_torsions
    assert got["pocket"].num_res == ref["pocket"].num_res


def test_records_ec_and_mdn_load_no_jax_or_networkx():
    """In a fresh interpreter: all five records load through PreparedPair,
    3mhw's ligand has 0 torsions, and two EC steps and the full-width MDN
    (runs/mdn_r4b) run on the CPU, with two Cartesian relax steps between
    them (the relax and protonation modules imported); host prep from raw
    files (every module of it imported, 3dbs prepared as an apo->holo job
    against itself, its record read back) runs too; the serving daemon and the evaluation
    modules import, and validity, the reporter and TM-align run on that
    pair; the training modules (train_cli, mdn_train) import and rebuild a
    crystal atom14; jax, the JAX package and networkx stay out of
    sys.modules."""
    code = """
import os, sys, tempfile
import torch
torch.set_num_threads(1)
from diffbindfr_torch.app import analysis, jobs, pipeline as TP
from diffbindfr_torch.chem import gasteiger, ligand_feats, mol, protein_feats, records
from diffbindfr_torch.chem import secondary_structure
from diffbindfr_torch.constants import ligands, periodic, residues
from diffbindfr_torch.data import sample
from diffbindfr_torch.geometry import chi
from diffbindfr_torch.models import mdn_scorer as mdn
from diffbindfr_torch.utils.checkpoint import load_checkpoint
from diffbindfr_torch.app import cli, eval_cli, reporter, rescore_cli, serve, validity
from diffbindfr_torch.chem import protonate
from diffbindfr_torch.ops import cartesian, tmalign
from diffbindfr_torch import mdn_train
from diffbindfr_torch.app import train_cli
d = 'runs/pb_bench/3dbs/'
job = jobs.Job(d + '3dbs_protein_contact_chains.pdb', '3dbs', d + '3dbs_ligand.sdf', '3dbs',
               '3dbs', crystal_ligand=d + '3dbs_ligand.sdf',
               holo_protein=d + '3dbs_protein_contact_chains.pdb')
tmp = tempfile.mkdtemp()
fresh, fails = TP.prep([job], 12.0, cache_dir=tmp, verbose=False)
assert not fails and fresh[0].bucket.n_lig == 64 and fresh[0].holo_ref is not None
assert records.load_prep_record(os.path.join(tmp, '3dbs_r12.rec.pkl'))['lig_src'][0] == job.ligand
prep = 'runs/eval_r5_scsrc/prep_cache'
pairs = [TP.PreparedPair.from_prep_cache(os.path.join(prep, n + '_r12.npz'))
         for n in ('2src', '2zec', '3dbs', '3mhw', '3pp0')]
assert all(p.lig is not None and p.pocket is not None for p in pairs)
assert pairs[3].lig.rot_node_mask.shape[0] == 0
res = [TP.PoseResult(i, 0, p.sample.lig_pos.copy(), p.sample.template_pos, None)
       for i, p in enumerate(pairs) if p.name in ('3dbs', '3mhw')]
assert len(res) == 2
TP.error_correct(pairs, res, steps=2, batch_size=1, device='cpu', verbose=False)
params, _ = load_checkpoint('runs/mdn_r4b/ckpt_best.npz', device='cpu')
TP.cartesian_relax(pairs, res, steps=2, batch_size=1, device='cpu', verbose=False)
TP.score_mdn(pairs, res, params, mdn.MDNConfig(), batch_size=1, device='cpu', verbose=False)
assert all(r.vina_score is not None and r.mdn_score is not None for r in res)
assert validity.check_pose(fresh[0].lig, fresh[0].pocket, fresh[0].lig.pos)['pass']
assert 'Enrichment report' in reporter.format_report(reporter.load_results(
    'runs/eval_r4_mdn/results.csv'))
ca = fresh[0].pocket.atom14_pos[:, 1]
assert tmalign.tmalign(ca, ca).tm_target > 0.99
assert mdn_train.crystal_atom14(pairs[3].sample).shape == (96, 14, 3)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'diffbindfr_tpu',
                                                     'networkx')]
print(bad)
sys.exit(1 if bad else 0)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr


def test_prepared_pair_reads_the_record_beside_the_npz(tmp_path):
    """from_prep_cache attaches lig, pocket and crystal_pos from
    `<stem>.rec.pkl`, its bucket equals the sample's; without the record the
    three are None and the dock stage still reads the pair."""
    for name in NAMES:
        pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{name}_r12.npz"))
        rec = R.load_prep_record(_path(name))
        assert pair.bucket == bucket_of(pair.sample) == rec["bucket"]
        assert pair.lig.name == rec["lig"].name
        np.testing.assert_array_equal(pair.crystal_pos, rec["crystal_pos"])
        np.testing.assert_array_equal(pair.pocket.atom14_pos, rec["pocket"].atom14_pos)
    shutil.copy(os.path.join(PREP, "3mhw_r12.npz"), tmp_path / "x_r12.npz")
    bare = TP.PreparedPair.from_prep_cache(str(tmp_path / "x_r12.npz"))
    assert bare.name == "x" and bare.lig is None and bare.pocket is None
    assert bare.crystal_pos is None and bare.bucket == bucket_of(bare.sample)
    with pytest.raises(ValueError, match="record"):
        TP.error_correct([bare], [TP.PoseResult(0, 0, bare.sample.lig_pos, None, None)],
                         steps=1, device="cpu", verbose=False)


def test_unpickler_refuses_other_classes_and_reads_either_numpy_name():
    """Anything but the record classes, numpy arrays and plain containers is
    refused; an array pickled under numpy.core reads as under numpy._core."""

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    for obj in (Evil(), {"x": io.BytesIO()}, {"c": __import__("collections").OrderedDict()}):
        with pytest.raises(pickle.UnpicklingError, match="not allowed"):
            R._RecordUnpickler(io.BytesIO(pickle.dumps(obj))).load()
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    raw = pickle.dumps({"a": arr}, protocol=2)  # text GLOBAL opcodes: names in plain lines
    core = b"numpy.core.multiarray" if b"numpy.core.multiarray" in raw else b"numpy._core.multiarray"
    for name in (b"numpy._core.multiarray", b"numpy.core.multiarray"):
        got = R._RecordUnpickler(io.BytesIO(raw.replace(core, name))).load()
        np.testing.assert_array_equal(got["a"], arr)


def test_ec_engine_pads_the_last_batch_and_saves_scores(tmp_path):
    """Four 3mhw poses in batches of 3 (the second padded by repetition)
    give the poses and scores of one batch of 4; save_poses writes the
    vina scores; the entry points default to the card."""
    pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, "3mhw_r12.npz"))
    rng = np.random.default_rng(0)
    starts = [(pair.sample.lig_pos + rng.normal(scale=0.5, size=pair.sample.lig_pos.shape)
               * pair.sample.lig_mask[:, None]).astype(np.float32) for _ in range(4)]
    runs = []
    for bs in (3, 4):
        res = [TP.PoseResult(0, k, s.copy(), pair.sample.template_pos, None)
               for k, s in enumerate(starts)]
        TP.error_correct([pair], res, steps=5, batch_size=bs, device="cpu", verbose=False)
        runs.append(res)
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.lig_pos, b.lig_pos, atol=1e-6)
        assert abs(a.vina_score - b.vina_score) <= 1e-6 * abs(b.vina_score)
    path = TP.save_poses(str(tmp_path), [pair], runs[1])
    with np.load(path) as data:
        np.testing.assert_allclose(data["3mhw|vina"], [r.vina_score for r in runs[1]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.ECEngine()
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.MDNEngine({}, None)
