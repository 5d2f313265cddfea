"""The port's host tools against the JAX package's on the CPU:
utils/observe.py, the XTC reader (io/xtc.py), app/seqsearch.py,
app/vinafr.py, app/pocket_viz.py and the native parser (io/native.py).

  * observe: MetricsLogger writes the JAX logger's lines (the clock
    pinned); trace writes a Chrome trace naming the ops it ran; timed;
  * read_xtc equals the JAX reader on files from either writer (the three
    paths of the format: plain floats, the packed big number, per-axis
    bits), and on a frame in the run mode the writers never emit, encoded
    here with the JAX package's own _BitWriter/_encodeints;
  * seqsearch, vinafr and pocket_viz give the JAX outputs on
    runs/pb_bench's five complexes and on the JAX tests' inputs;
  * the native parser and pocket hits give the line parser's and numpy's
    arrays on every PDB under runs/pb_bench (and JAX's parse); a failed
    build raises with the compiler's message.
"""
import glob
import io
import json
import os
import struct
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import pocket_viz as JPV
from diffbindfr_tpu.app import seqsearch as JSS
from diffbindfr_tpu.app import vinafr as JVF
from diffbindfr_tpu.io import pdb as JPDB
from diffbindfr_tpu.io import xtc as JX
from diffbindfr_tpu.utils import observe as JOBS
from diffbindfr_torch.app import pocket_viz as TPV
from diffbindfr_torch.app import seqsearch as TSS
from diffbindfr_torch.app import vinafr as TVF
from diffbindfr_torch.constants import residues as rc
from diffbindfr_torch.io import native
from diffbindfr_torch.io import pdb as TPDB
from diffbindfr_torch.io import xtc as TX
from diffbindfr_torch.io.sdf import parse_ligand_file
from diffbindfr_torch.utils import observe as TOBS

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "runs/pb_bench")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
PDBS = sorted(glob.glob(os.path.join(BENCH, "*", "*.pdb")))


def _same_protein(a, b):
    for f in ("atom_positions", "atom_mask", "aatype", "residue_index", "chain_index",
              "b_factors"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and np.array_equal(x, y), f
    for f in ("chain_ids", "resnames", "insertion_codes"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f


# ---------------------------------------------------------------- observe


def test_metrics_logger_writes_the_jax_lines(tmp_path, monkeypatch):
    monkeypatch.setattr(JOBS.time, "time", lambda: 1234.5)
    monkeypatch.setattr(TOBS.time, "time", lambda: 1234.5)
    paths = {}
    for name, mod in (("jax", JOBS), ("port", TOBS)):
        paths[name] = str(tmp_path / name / "metrics.jsonl")
        log = mod.MetricsLogger(paths[name])
        for step in range(3):
            log.log(step, loss=torch.tensor(0.5 + step) if name == "port" else 0.5 + step,
                    lr=np.float32(1e-3))
        assert log.average("loss") == 1.5 and np.isnan(log.average("nope"))
        log.close()
    lines = {k: open(v).read() for k, v in paths.items()}
    assert lines["port"] == lines["jax"] and len(lines["port"].splitlines()) == 3
    logfile = str(tmp_path / "logs" / "run.log")
    TOBS.get_logger("diffbindfr_torch_test", log_file=logfile).info("hello")
    assert "hello" in open(logfile).read()


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with TOBS.trace(str(tmp_path / "tr")) as prof:
        torch.mm(x, x).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
    best, out = TOBS.timed(lambda: torch.mm(x, x), warmup=1, iters=2)
    assert best > 0 and torch.equal(out, torch.mm(x, x))
    t = TOBS.Timer()
    assert t.elapsed(out) >= 0


# ---------------------------------------------------------------- xtc


@pytest.mark.parametrize("case", ["small", "plain", "large"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_xtc_matches_jax(tmp_path, case, writer):
    rng = np.random.default_rng(len(case))
    coords = {"small": rng.normal(size=(5, 40, 3)) * 8.0,
              "plain": rng.normal(size=(3, 7, 3)) * 5.0,
              "large": rng.normal(size=(2, 12, 3)) * 2e5}[case].astype(np.float32)
    path = str(tmp_path / "t.xtc")
    (JX if writer == "jax" else TX).write_xtc(path, coords, time_ps=np.arange(len(coords)) * 2.0)
    got, gt = TX.read_xtc(path)
    want, wt = JX.read_xtc(path)
    assert np.array_equal(got, want) and np.array_equal(gt, wt)
    tol = 1e-4 if case == "plain" else 0.01 * (1 + np.abs(coords).max() * 1e-6)
    assert np.abs(got - coords).max() <= tol
    assert np.array_equal(TX.read_xtc(path, units="nm")[0], JX.read_xtc(path, units="nm")[0])


def _run_mode_frame():
    """One 12-atom frame (ints, precision 1000) whose bitstream uses the
    small-diff run mode twice. File order: atom 1 full-size with a run of
    two (atom 0 relative to atom 1, atom 2 relative to atom 0; is_smaller
    +1 widens the small range after it), atoms 3-5 full-size, atom 7 with a
    run of one (atom 6 relative to atom 7, at the widened range; is_smaller
    -1), atoms 8-11. The codec decodes a run's first small atom before its
    anchor, so the atoms come out in order 0-11. Returns (bytes, ints)."""
    want = np.array([[1000, 2000, 3000], [1003, 1998, 3001], [1001, 2001, 2999],
                     [5000, 100, 200], [5100, 150, 260], [900, 4000, 1500],
                     [905, 3996, 1504], [903, 3999, 1501], [7000, 300, 4200],
                     [6000, 800, 1000], [3000, 3300, 3600], [4000, 4100, 4200]], np.int64)
    minint, maxint = want.min(0), want.max(0)
    sizeint = maxint - minint + 1
    bitsize = JX._sizeofints(sizeint)
    bw = JX._BitWriter()

    def full(i, flag):
        JX._encodeints(bw, bitsize, sizeint, want[i] - minint)
        bw.send(1, flag)

    def small(rel, idx):
        sizes = [JX._MAGICINTS[idx]] * 3
        JX._encodeints(bw, JX._sizeofints(sizes), sizes, rel + JX._MAGICINTS[idx] // 2)

    full(1, 1)
    bw.send(5, 6 + 2)  # a run of 2 atoms (3 ints each), is_smaller +1
    small(want[0] - want[1], JX._FIRSTIDX)
    small(want[2] - want[0], JX._FIRSTIDX)
    for i in (3, 4, 5):
        full(i, 0)
    full(7, 1)
    bw.send(5, 3 + 0)  # a run of 1 atom, is_smaller -1
    small(want[6] - want[7], JX._FIRSTIDX + 1)
    for i in (8, 9, 10, 11):
        full(i, 0)
    data = bw.finish()
    head = struct.pack(">iiif", JX._MAGIC, 12, 0, 0.0) + struct.pack(">9f", *[0.0] * 9)
    head += struct.pack(">i", 12) + struct.pack(">f", 1000.0)
    head += struct.pack(">3i", *minint) + struct.pack(">3i", *maxint)
    head += struct.pack(">i", JX._FIRSTIDX) + struct.pack(">i", len(data))
    return head + data + b"\x00" * ((-len(data)) % 4), want


def test_read_xtc_run_mode(tmp_path):
    frame, ints = _run_mode_frame()
    path = str(tmp_path / "run.xtc")
    with open(path, "wb") as fh:
        fh.write(frame * 2)
    got, _ = TX.read_xtc(path, units="nm")
    want, _ = JX.read_xtc(path, units="nm")
    assert np.array_equal(got, want) and got.shape == (2, 12, 3)
    np.testing.assert_allclose(got[1], ints / 1000.0, atol=1e-9)


# ---------------------------------------------------------------- seqsearch


def test_align_stats_match_jax():
    rng = np.random.default_rng(0)
    for n, m in ((12, 15), (20, 9), (7, 30), (40, 41)):
        qa, ta = rng.integers(0, 21, n), rng.integers(0, 21, m)
        assert TSS.align_stats(qa, ta) == JSS.align_stats(qa, ta)
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"
    assert TSS.align_stats(seq, "GGGG" + seq + "PPPP") == JSS.align_stats(seq, "GGGG" + seq
                                                                           + "PPPP")


def test_search_and_cli_match_jax(tmp_path):
    lib = [os.path.join(BENCH, n, f"{n}_protein.pdb") for n in NAMES] + [
        str(tmp_path / "missing.pdb")]
    for n in ("3dbs", "2zec"):
        q = os.path.join(BENCH, n, f"{n}_protein.pdb")
        got = TSS.search(TPDB.parse_pdb(q), lib, top=20)
        want = JSS.search(JPDB.parse_pdb(q), lib, top=20)
        assert [vars(h) for h in got] == [vars(h) for h in want]
        assert got[0].source.endswith(f"{n}_protein.pdb") and got[0].identity == 1.0
    outs = []
    for mod in (TSS, JSS):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main([os.path.join(BENCH, "3mhw", "3mhw_protein.pdb"), BENCH + "/3mhw",
                             BENCH + "/3pp0", "-n", "5"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "3mhw_protein.pdb" in outs[0]


# ---------------------------------------------------------------- vinafr


def _fake_pdbqt(path, prot, res_ids, shift):
    """tests/test_vinafr.py's VinaFR docked PDBQT: 2 MODELs, the flexible
    side chains of `res_ids`, shifted by `shift` in model 1."""
    lines = []
    for model in (1, 2):
        lines += [f"MODEL {model}", "REMARK VINA RESULT:   -7.0  0.000  0.000"]
        for i in res_ids:
            resname = rc.restype_1to3[rc.restypes[prot.aatype[i]]]
            cid = prot.chain_ids[prot.chain_index[i]]
            resnum = int(prot.residue_index[i])
            lines.append(f"BEGIN_RES {resname} {cid} {resnum}")
            for name, j in rc.atom37_order.items():
                if prot.atom_mask[i, j] and name not in ("N", "CA", "C", "O"):
                    x, y, z = prot.atom_positions[i, j] + (shift if model == 1 else 0.0)
                    lines.append(f"ATOM      1 {name:<4}{resname} {cid}{resnum:>4}    "
                                 f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00    +0.000 C")
            lines.append(f"END_RES {resname} {cid} {resnum}")
        lines.append("ENDMDL")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("name", ["3dbs", "2src"])
def test_vinafr_matches_jax(tmp_path, name):
    pdb = os.path.join(BENCH, name, f"{name}_protein.pdb")
    prot = TPDB.parse_pdb(pdb)
    res_ids = [i for i in range(prot.num_res) if prot.atom_mask[i].sum() > 5][:4]
    pdbqt = str(tmp_path / "docked.pdbqt")
    _fake_pdbqt(pdbqt, prot, res_ids, shift=np.array([1.5, 0.0, -0.5]))
    lines = TVF.split_top1_flex_pdbqt(pdbqt)
    assert lines == JVF.split_top1_flex_pdbqt(pdbqt)
    flex, jflex = TVF.parse_flex_pdbqt(lines), JVF.parse_flex_pdbqt(lines)
    assert flex.keys() == jflex.keys() and all(
        flex[k].keys() == jflex[k].keys() and all(np.array_equal(flex[k][a], jflex[k][a])
                                                  for a in flex[k]) for k in flex)
    outs = [str(tmp_path / f"{t}.pdb") for t in ("port", "jax")]
    assert TVF.build_vinafr_protein(pdb, pdbqt, outs[0]) == JVF.build_vinafr_protein(
        pdb, pdbqt, outs[1]) == len(res_ids)
    assert open(outs[0]).read() == open(outs[1]).read()
    out = TPDB.parse_pdb(outs[0])
    cb, ca, i = rc.atom37_order["CB"], rc.atom37_order["CA"], res_ids[0]
    np.testing.assert_allclose(out.atom_positions[i, cb],
                               prot.atom_positions[i, cb] + [1.5, 0.0, -0.5], atol=1e-2)
    np.testing.assert_allclose(out.atom_positions[i, ca], prot.atom_positions[i, ca], atol=1e-2)
    with pytest.raises(ValueError, match="no flexible"):
        TVF.split_top1_flex_pdbqt(pdb)


# ---------------------------------------------------------------- pocket_viz


@pytest.mark.parametrize("name", NAMES)
def test_pocket_viz_matches_jax(tmp_path, name):
    pdb = os.path.join(BENCH, name, f"{name}_protein.pdb")
    sdf = os.path.join(BENCH, name, f"{name}_ligand.sdf")
    res = TPV.pocket_resnums(pdb, ligand_file=sdf, cutoff=7.0)
    assert res == JPV.pocket_resnums(pdb, ligand_file=sdf, cutoff=7.0) and res
    c = parse_ligand_file(sdf)[0].coords.mean(0)
    res_c = TPV.pocket_resnums(pdb, center=c, cutoff=14.0, chains=sorted(res)[:1])
    assert res_c == JPV.pocket_resnums(pdb, center=c, cutoff=14.0, chains=sorted(res)[:1])
    for f in ("to_nglview_selection", "to_prody_selection", "to_pymol_selection"):
        assert getattr(TPV, f)(res) == getattr(JPV, f)(res), f
    pmls = [str(tmp_path / f"{t}.pml") for t in ("port", "jax")]
    TPV.write_pymol_script(pmls[0], pdb, ["pose0.sdf", "pose1.sdf"], res, crystal_lig=sdf)
    JPV.write_pymol_script(pmls[1], pdb, ["pose0.sdf", "pose1.sdf"], res, crystal_lig=sdf)
    assert open(pmls[0]).read() == open(pmls[1]).read()
    with pytest.raises(ValueError, match="need ligand_file or center"):
        TPV.pocket_resnums(pdb)


# ---------------------------------------------------------------- native


@pytest.mark.parametrize("path", PDBS, ids=[os.path.basename(p) for p in PDBS])
def test_native_parser_and_pocket_hits(path):
    """The native parse equals the line parser's and the JAX parse; the
    native pocket hits equal numpy's (the ligand of the complex, and a
    point far from the protein)."""
    nat = native.parse_pdb_native(path)
    line = TPDB.parse_pdb(open(path).read(), is_string=True)
    _same_protein(nat, line)
    _same_protein(TPDB.parse_pdb(path), JPDB.parse_pdb(path))
    name = os.path.basename(os.path.dirname(path))
    lig = parse_ligand_file(os.path.join(BENCH, name, f"{name}_ligand.sdf"))[0].coords
    ridx, aidx = np.nonzero(nat.atom_mask > 0)
    flat = nat.atom_positions[ridx, aidx]
    for ref, cut in ((lig, 12.0), (lig, 4.0), (flat.mean(0)[None] + 500.0, 8.0)):
        ref = np.asarray(ref, np.float32)
        got = native.pocket_hits_native(flat, ridx, nat.num_res, ref, cut)
        d2 = ((flat[:, None, :] - ref[None]) ** 2).sum(-1).min(axis=1)
        want = np.zeros(nat.num_res, bool)
        np.logical_or.at(want, ridx, d2 < cut * cut)
        assert np.array_equal(got, want), cut


def test_native_leaves_what_it_does_not_take_to_the_line_parser(tmp_path, monkeypatch):
    path = os.path.join(BENCH, "3mhw", "3mhw_protein.pdb")
    assert native.parse_pdb_native(path, max_res=10) is None  # more residues than max_res
    assert native.parse_pdb_native(str(tmp_path / "none.pdb")) is None
    with pytest.raises(FileNotFoundError):
        TPDB.parse_pdb(str(tmp_path / "none.pdb"))
    calls = []
    monkeypatch.setattr(native, "parse_pdb_native", lambda *a, **k: calls.append(a))
    TPDB.parse_pdb(path, keep_hetero=True)
    TPDB.parse_pdb(path, model=2)
    assert not calls


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fastio.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exit") as e:
        native.build()
    assert "error" in str(e.value)
    assert not glob.glob(str(tmp_path / "build" / "*" / "*.so"))
