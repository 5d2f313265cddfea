"""Host prep of the PyTorch port from raw PDB/SDF files
(diffbindfr_torch/app/prepare.py prep, `_prep_one` and its spawn workers;
app/cli.py `predict -j prep` and `-nw`) against the JAX package's prep, on
the CPU.

Inputs: the five pb_bench pairs (`<id>_protein_contact_chains.pdb` +
`<id>_ligand.sdf`, that ligand as the crystal ligand) and the 16 ligands of
runs/screen_demo/mols against 3dbs's pocket, 21 pairs. The JAX package's
`prep` (serial `_prep_one`) writes one cache, the port's another: every npz
array is bit-identical, every record field equal (value, dtype, shape);
the port's records add `lig_src`. Failures carry the JAX stage names. Then
`predict -j prep` followed by `predict` (a small net on the CPU) writes the
same results.csv, byte for byte, as `predict` from a cache that the JAX
package's prep wrote.
"""
import csv
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import jobs as JJ
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.geometry import so3 as JSO3
from diffbindfr_tpu.geometry import torus as JTOR
from diffbindfr_torch.app import cli
from diffbindfr_torch.app import jobs as TJ
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.app import prepare as TPR
from diffbindfr_torch.chem import records as R
from diffbindfr_torch.geometry import so3 as TSO3
from diffbindfr_torch.geometry import torus as TTOR
from diffbindfr_torch.io import sdf as TSDF
from diffbindfr_torch.io.sdf import RawMol, write_sdf

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
MOLS = os.path.join(ROOT, "runs/screen_demo/mols")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
SMALL = ["--cfg-options", "score_net.ns=8", "score_net.nv=4", "score_net.num_conv_layers=2"]


def _rows():
    """(protein, protein_name, ligand, ligand_name, complex_name, crystal)
    of the 21 pairs."""
    rows = []
    for n in NAMES:
        lig = f"{PB}/{n}/{n}_ligand.sdf"
        rows.append((f"{PB}/{n}/{n}_protein_contact_chains.pdb", n, lig, n, n, lig))
    for f in sorted(os.listdir(MOLS)):
        stem = f[: -len(".sdf")]
        rows.append((f"{PB}/3dbs/3dbs_protein_contact_chains.pdb", "3dbs", f"{MOLS}/{f}", stem,
                     f"3dbs_{stem}", f"{PB}/3dbs/3dbs_ligand.sdf"))
    return rows


def _jobs(mod, rows=None):
    return [mod.Job(protein=p, protein_name=pn, ligand=lg, ligand_name=ln, complex_name=cn,
                    crystal_ligand=cr) for p, pn, lg, ln, cn, cr in (rows or _rows())]


def _same(a, b, what):
    if dataclasses.is_dataclass(b):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    elif isinstance(b, float) and np.isnan(b):
        assert isinstance(a, float) and np.isnan(a), what
    else:
        assert type(a) is type(b) and a == b, what


def _same_entry(tdir, jdir, name):
    """The port's cache entry `name` equals the JAX package's: every npz
    array bit for bit, every record key of the JAX record field by field;
    the port's record adds lig_src."""
    with np.load(os.path.join(jdir, f"{name}_r12.npz")) as j, \
            np.load(os.path.join(tdir, f"{name}_r12.npz")) as t:
        assert t.files == j.files
        for k in j.files:
            _same(t[k], j[k], f"{name} npz {k}")
    with open(os.path.join(jdir, f"{name}_r12.rec.pkl"), "rb") as fh:
        jrec = pickle.load(fh)
    trec = R.load_prep_record(os.path.join(tdir, f"{name}_r12.rec.pkl"))
    assert set(trec) == set(jrec) | {"lig_src"}
    for k in jrec:
        _same(trec[k], jrec[k], f"{name} {k}")
    return trec


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The 21 pairs through the JAX package's prep and the port's (-nw 0)."""
    d = tmp_path_factory.mktemp("prep")
    jpairs, jfails = JP.prep(_jobs(JJ), 12.0, verbose=False, cache_dir=str(d / "jax"))
    tpairs, tfails = TP.prep(_jobs(TJ), 12.0, verbose=False, cache_dir=str(d / "port"))
    assert not jfails and not tfails
    return str(d / "jax"), str(d / "port"), jpairs, tpairs


@pytest.mark.parametrize("row", _rows(), ids=[r[4] for r in _rows()])
def test_prep_matches_jax(row, caches):
    jdir, tdir, jpairs, tpairs = caches
    name = row[4]
    trec = _same_entry(tdir, jdir, name)
    assert trec["lig_src"] == R.ligand_source(row[2])
    (tp,) = [p for p in tpairs if p.name == name]
    (jp,) = [p for p in jpairs if p.job.complex_name == name]
    assert tp.bucket == trec["bucket"]
    assert dataclasses.astuple(tp.bucket) == dataclasses.astuple(jp.bucket)
    for f in tp.sample._fields:  # the pair in memory is the one on disk
        _same(getattr(tp.sample, f), getattr(jp.sample, f), f)
    _same(tp.crystal_pos, jp.crystal_pos, "crystal_pos")
    assert tp.job.complex_name == name and tp.holo_ref is None


def test_prep_keeps_job_order_and_the_new_buckets(caches):
    """Pairs come back in job order; a fresh prep puts 3dbs at n_lig 64 /
    n_atm 1024 and 3mhw at n_lig 32 / n_atm 768 (the ligand and pocket
    ladders are independent; the tracked caches hold 128 and 96)."""
    _, _, _, tpairs = caches
    assert [p.name for p in tpairs] == [r[4] for r in _rows()]
    by = {p.name: p.bucket for p in tpairs}
    assert (by["3dbs"].n_lig, by["3dbs"].n_atm) == (64, 1024)
    assert (by["3mhw"].n_lig, by["3mhw"].n_atm) == (32, 768)


def test_workers_give_the_records_of_a_serial_prep(caches, tmp_path, capsys):
    """-nw 2 (spawn workers, which start with no CUDA device visible): the
    same npz and records as the serial prep, pairs in job order; a second
    run serves every pair from the cache in the parent."""
    jdir, _, _, _ = caches
    pairs, fails = TP.prep(_jobs(TJ), 12.0, verbose=True, cache_dir=str(tmp_path),
                           num_workers=2)
    assert not fails and [p.name for p in pairs] == [r[4] for r in _rows()]
    for r in _rows():
        _same_entry(str(tmp_path), jdir, r[4])
    before = {f: os.stat(tmp_path / f).st_mtime_ns for f in os.listdir(tmp_path)}
    capsys.readouterr()
    again, _ = TP.prep(_jobs(TJ), 12.0, verbose=True, cache_dir=str(tmp_path), num_workers=2)
    assert "[prep] 21/21 pairs from cache" in capsys.readouterr().out
    assert {f: os.stat(tmp_path / f).st_mtime_ns for f in os.listdir(tmp_path)} == before
    for a, b in zip(again, pairs):
        assert a.name == b.name and a.bucket == b.bucket
        for f in a.sample._fields:
            _same(getattr(a.sample, f), getattr(b.sample, f), f)


def test_worker_sees_no_cuda_device(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    TPR._worker_init()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_a_long_job_list_keeps_no_sample_in_memory(monkeypatch, tmp_path):
    """Over RETAIN_PAIRS pairs, prep keeps no padded sample: each pair reads
    its npz on every use, and the sample read is the one prep made. At or
    under it, the fresh samples stay in memory. Without a cache the fresh
    sample is the only copy, and stays."""
    rows = _rows()[5:8]  # three screen ligands on 3dbs's pocket
    monkeypatch.setattr(TPR, "RETAIN_PAIRS", 2)
    long, fails = TP.prep(_jobs(TJ, rows), 12.0, verbose=False, cache_dir=str(tmp_path / "a"))
    assert not fails and all(p._sample is None and not p.retain for p in long)
    kept, _ = TP.prep(_jobs(TJ, rows[:2]), 12.0, verbose=False, cache_dir=str(tmp_path / "b"))
    assert all(p._sample is not None for p in kept)
    for a, b in zip(long, kept):
        for f in b.sample._fields:
            _same(getattr(a.sample, f), getattr(b.sample, f), f)
    assert all(p._sample is None for p in long)
    mem, _ = TP.prep(_jobs(TJ, rows), 12.0, verbose=False)
    assert all(p._sample is not None and p.sample_path is None for p in mem)


def test_prep_imports_no_torch(tmp_path):
    """In a fresh interpreter, the prep module and a prep of 3dbs (what a
    spawn worker runs) load neither torch nor jax."""
    code = f"""
import sys
from diffbindfr_torch.app import jobs, prepare
d = 'runs/pb_bench/3dbs/'
job = jobs.Job(d + '3dbs_protein_contact_chains.pdb', '3dbs', d + '3dbs_ligand.sdf', '3dbs',
               '3dbs', crystal_ligand=d + '3dbs_ligand.sdf')
pairs, fails = prepare.prep([job], 12.0, cache_dir={str(tmp_path)!r}, verbose=False)
assert not fails and pairs[0].sample.lig_feat.shape[0] == 64
print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'diffbindfr_tpu')))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_library_records_parse_once(monkeypatch, tmp_path):
    """The molecule of `lib#i` and its lig_src digest come from one pass
    over the library: each record is parsed once for both, whatever the
    order of the calls."""
    lib = tmp_path / "lib.sdf"
    _library(lib, ("ZINC01921759", "ZINC04181650"))
    parsed = []
    real = TSDF._parse_molblock
    monkeypatch.setattr(TSDF, "_parse_molblock", lambda b: parsed.append(1) or real(b))
    TSDF._RECORDS.clear()
    for i in (0, 1):
        assert R.ligand_source(f"{lib}#{i}")[1] == TSDF.read_record(f"{lib}#{i}")[1]
        assert TSDF.parse_ligand_file(f"{lib}#{i}")[0] is TSDF.read_record(f"{lib}#{i}")[0]
    assert len(parsed) == 2


def _too_large_ligand(path):
    """A chain of 130 carbons by the 3dbs pocket: too large for every bucket."""
    n = 130
    coords = np.zeros((n, 3), np.float32)
    coords[:, 0] = np.arange(n) * 1.5
    write_sdf(str(path), [RawMol(name="chain", elements=["C"] * n, coords=coords,
                                 bonds=np.stack([np.arange(n - 1), np.arange(1, n)], 1),
                                 bond_orders=np.ones(n - 1, np.int64),
                                 formal_charges=np.zeros(n, np.int64), props={})])


def test_failures_carry_the_jax_stages(tmp_path):
    """An unreadable ligand file (stage 'ligand'), a job with no pocket
    definition and a centre 1000 A from the protein ('pocket': no
    definition, empty selection), a ligand too large for every bucket
    ('sample'): the JAX package's `_prep_one` fails each at the same stage
    (and, where the error comes from the same code, with the same error);
    the run goes on, and write_failures lists them in job order."""
    bad = tmp_path / "bad.sdf"
    bad.write_text("not a molecule\n")
    big = tmp_path / "big.sdf"
    _too_large_ligand(big)
    p3 = f"{PB}/3dbs/3dbs_protein_contact_chains.pdb"
    l3 = f"{PB}/3dbs/3dbs_ligand.sdf"
    cases = [("bad_ligand", dict(ligand=str(bad), crystal_ligand=l3), "ligand", False),
             ("no_pocket", dict(ligand=l3), "pocket", True),
             ("far_centre", dict(ligand=l3, center=(1000.0, 1000.0, 1000.0)), "pocket", True),
             ("too_large", dict(ligand=str(big), crystal_ligand=l3), "sample", True)]
    tjobs, jjobs = [], []
    for name, kw, _, _ in cases:
        for mod, out in ((TJ, tjobs), (JJ, jjobs)):
            out.append(mod.Job(protein=p3, protein_name="3dbs", ligand_name=name,
                               complex_name=name, **kw))
    tjobs.insert(2, _jobs(TJ)[3])  # a good pair between them
    prepared, failures = TP.prep(tjobs, 12.0, verbose=False, cache_dir=str(tmp_path / "c"))
    assert [p.name for p in prepared] == ["3mhw"]
    assert [(f.complex_name, f.stage) for f in failures] == [(c[0], c[2]) for c in cases]
    for (name, _, stage, same_error), f, jjob in zip(cases, failures, jjobs):
        status, jf = JP._prep_one(jjob, 12.0, None, {}, {}, {})
        assert status == "fail" and jf.stage == stage
        if same_error:
            assert f.error == jf.error
    assert "no pocket definition" in failures[1].error
    assert "empty pocket selection" in failures[2].error
    assert "ligand too large" in failures[3].error
    assert sorted(os.listdir(tmp_path / "c")) == ["3mhw_r12.npz", "3mhw_r12.rec.pkl"]
    TP.write_failures(str(tmp_path), failures)
    with open(tmp_path / "failed.csv", newline="") as fh:
        assert [r["stage"] for r in csv.DictReader(fh)] == [c[2] for c in cases]


def test_holo_job_matches_jax(tmp_path):
    """An apo->holo job (3mhw against itself as the holo structure): the
    record's holo_ref and holo_src equal the JAX package's; a redock job on
    that record is served without the reference, as the JAX `_cache_hit`
    serves it."""
    row = _rows()[3]
    tjob = dataclasses.replace(_jobs(TJ, [row])[0], holo_protein=row[0])
    jjob = dataclasses.replace(_jobs(JJ, [row])[0], holo_protein=row[0])
    JP.prep([jjob], 12.0, verbose=False, cache_dir=str(tmp_path / "jax"))
    pairs, fails = TP.prep([tjob], 12.0, verbose=False, cache_dir=str(tmp_path / "port"))
    assert not fails and isinstance(pairs[0].holo_ref, R.HoloRef)
    trec = _same_entry(str(tmp_path / "port"), str(tmp_path / "jax"), "3mhw")
    assert trec["holo_src"] == row[0] and trec["holo_ref"].n_matched == trec["pocket"].num_res
    redock, _ = TP.prep(_jobs(TJ, [row]), 12.0, verbose=False, cache_dir=str(tmp_path / "port"))
    assert redock[0].holo_ref is None
    assert R.load_prep_record(str(tmp_path / "port/3mhw_r12.rec.pkl"))["holo_ref"] is not None


def _library(path, stems):
    """A library SDF of screen_demo molecules (their files end without $$$$)."""
    with open(path, "w") as out:
        for s in stems:
            with open(f"{MOLS}/{s}.sdf") as fh:
                out.write(fh.read().rstrip("\n") + "\n$$$$\n")


def test_cache_identity_follows_the_ligand_record(tmp_path):
    """A record the port wrote carries lig_src (path with its #i, sha256 of
    the record's text) and is recomputed when they no longer match: the job
    names another file, or the library's records were reordered (same path,
    same mtime: the text decides). A record without lig_src, as the JAX
    package writes them, is served as the JAX `_cache_hit` serves it, even
    for another ligand, and is not rewritten."""
    lib = tmp_path / "lib.sdf"
    _library(lib, ("ZINC01921759", "ZINC04181650"))
    row = list(_rows()[2])
    row[2], row[4] = f"{lib}#0", "x"
    cache = tmp_path / "cache"
    first, _ = TP.prep(_jobs(TJ, [row]), 12.0, verbose=False, cache_dir=str(cache))
    rpath = cache / "x_r12.rec.pkl"
    src0 = R.load_prep_record(str(rpath))["lig_src"]
    assert src0 == (f"{lib}#0", R.ligand_source(f"{MOLS}/ZINC01921759.sdf")[1])
    # reorder the library, keeping its mtime: record #0 is now the other ligand
    st = os.stat(lib)
    _library(lib, ("ZINC04181650", "ZINC01921759"))
    os.utime(lib, ns=(st.st_atime_ns, st.st_mtime_ns))
    again, _ = TP.prep(_jobs(TJ, [row]), 12.0, verbose=False, cache_dir=str(cache))
    src1 = R.load_prep_record(str(rpath))["lig_src"]
    assert src1[0] == src0[0] and src1[1] != src0[1]
    assert not np.array_equal(again[0].lig.pos, first[0].lig.pos)
    # another file under the same complex name
    row[2] = f"{MOLS}/ZINC02029177.sdf"
    other, _ = TP.prep(_jobs(TJ, [row]), 12.0, verbose=False, cache_dir=str(cache))
    assert R.load_prep_record(str(rpath))["lig_src"] == R.ligand_source(row[2])
    # a record the JAX package wrote: served, untouched
    jcache = tmp_path / "jcache"
    jrow = list(_rows()[3])
    JP.prep(_jobs(JJ, [jrow]), 12.0, verbose=False, cache_dir=str(jcache))
    mtimes = {f: os.stat(jcache / f).st_mtime_ns for f in os.listdir(jcache)}
    jrow[2] = f"{MOLS}/ZINC02029177.sdf"
    served, fails = TP.prep(_jobs(TJ, [jrow]), 12.0, verbose=False, cache_dir=str(jcache))
    with open(jcache / "3mhw_r12.rec.pkl", "rb") as fh:
        jrec = pickle.load(fh)
    assert JP._cache_hit(jrec, _jobs(JJ, [jrow])[0], str(jcache / "3mhw_r12.npz"), 0)
    assert not fails and served[0].lig.num_atoms == jrec["lig"].num_atoms
    assert {f: os.stat(jcache / f).st_mtime_ns for f in os.listdir(jcache)} == mtimes
    assert "lig_src" not in R.load_prep_record(str(jcache / "3mhw_r12.rec.pkl"))


def test_ligand_source_addresses_records(tmp_path):
    """lig_src of `lib#i` is record i's text digest, of a plain path record
    0's; a missing record raises."""
    lib = tmp_path / "lib.sdf"
    _library(lib, ("ZINC01921759", "ZINC04181650"))
    one = R.ligand_source(f"{MOLS}/ZINC04181650.sdf")[1]
    assert R.ligand_source(f"{lib}#1") == (f"{lib}#1", one)
    assert R.ligand_source(str(lib))[1] == R.ligand_source(f"{lib}#0")[1] != one
    with pytest.raises(IndexError):
        R.ligand_source(f"{lib}#2")


@pytest.fixture
def jax_tables():
    """Hand the JAX package's SO(3)/torus tables to the port on the CPU (the
    port's own table computation is held to them in test_torch_geometry.py)."""
    saved = dict(TSO3._tables), dict(TTOR._tables)
    TSO3.set_tables(TSO3.SO3Tables.from_numpy("cpu", **JSO3.tables()._asdict()))
    tt = JTOR.tables()
    TTOR.set_tables(TTOR.TorusTables.from_numpy("cpu", score=tt.score, score_norm=tt.score_norm))
    yield
    for mod, old in zip((TSO3, TTOR), saved):
        mod._tables.clear()
        mod._tables.update(old)


def test_predict_from_raw_files_equals_predict_from_a_jax_cache(tmp_path, jax_tables):
    """`predict -j prep -nw 2` (no --cpu: prep touches no device) writes the
    cache and stops; `predict --cpu` then docks from it (small net, 2 poses,
    2 steps, 2 EC steps, random MDN). The same two commands' second half
    run on a cache that the JAX package's prep wrote, in the same outdir,
    write the same results.csv byte for byte."""
    rows = [_rows()[2], _rows()[3]]
    jobs = tmp_path / "jobs.csv"
    with open(jobs, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name",
                    "crystal_ligand"])
        w.writerows(rows)
    out = tmp_path / "out"
    assert cli.main(["predict", "-j", "prep", "-nw", "2", "-i", str(jobs), "-o", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["prep_cache"]
    assert len(os.listdir(out / "prep_cache")) == 4
    run = ["predict", "--cpu", "-i", str(jobs), "-o", str(out), "-np", "2", "-bs", "2",
           "-st", "2", "--ec-steps", "2"] + SMALL
    assert cli.main(run) == 0
    port_csv = (out / "results.csv").read_bytes()
    shutil.rmtree(out)
    JP.prep(JJ.load_jobs_csv(str(jobs)), 12.0, verbose=False, cache_dir=str(out / "prep_cache"))
    assert cli.main(run) == 0
    assert (out / "results.csv").read_bytes() == port_csv
    assert len(port_csv.decode().splitlines()) == 5


@pytest.mark.parametrize("flags,item", [
    (["--cart-relax"], "A10"), (["-nc", "4"], "A14"), (["--conv-mode", "fc"], "A3")])
def test_prep_and_workers_leave_the_other_refusals(flags, item, tmp_path):
    """`-j prep` and `-nw` run now; -nc, --cart-relax and --conv-mode fc
    still exit naming their ROADMAP items, before any work."""
    with pytest.raises(SystemExit) as e:
        cli.main(["predict", "-j", "prep", "-nw", "2", "-i", "none.csv", "-o",
                  str(tmp_path)] + flags)
    assert f"ROADMAP {item}" in str(e.value.code)
    assert not os.listdir(tmp_path)
