"""The evaluation protocol of the port (diffbindfr_torch/app/eval_cli.py,
reporter.py, rescore_cli.py, pipeline.export_and_rank(export_structures=)
and ECEngine's bounded cache) against the JAX package's, on the CPU.

The slice as a whole: `eval_cli.main --cpu` with a small net (the weights
of tests/fixtures/torch_predict_ref.npz: ns 8, nv 4, 2 layers), -st 2,
--ec-steps 5, -np 2 -bs 2 and runs/mdn_r4b on 2zec and 3mhw, copied from
runs/pb_bench. The JAX package is then handed the port's poses.npz (its
own prep of the same files, its load_poses, the port's MDN scores) and runs
its export_and_rank, reporter and validity suite: every file they write is
the port's, byte for byte. The job makers of the three dataset layouts and
the contact-chain extraction are held equal too; rescore's host side on
both paths, and its MDN scores against the JAX scores stored in
tests/fixtures/torch_mdn_ref.npz (1e-5 relative).
"""
import contextlib
import csv
import dataclasses
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import eval_cli as JE
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.app import reporter as JR
from diffbindfr_tpu.app import rescore_cli as JRS
from diffbindfr_tpu.app import validity as JV
from diffbindfr_torch.app import eval_cli as TE
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.app import reporter as TR
from diffbindfr_torch.app import rescore_cli as TRS
from diffbindfr_torch.app import serve as TS

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
SMALL_CKPT = os.path.join(ROOT, "tests/fixtures/torch_predict_ref.npz")
EC_FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_ec_ref.npz")
MDN_FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_mdn_ref.npz")
NAMES = ("2zec", "3mhw")
SMALL = ["--ns", "8", "--nv", "4", "--layers", "2", "-st", "2", "--ec-steps", "5", "-np", "2",
         "-bs", "2"]


def _copy_pb(dst, names, protein=False):
    """A pb-layout copy of `names` (ligand, contact chains; the full protein
    with `protein`) under dst."""
    for n in names:
        os.makedirs(os.path.join(dst, n))
        kinds = ["ligand.sdf", "protein_contact_chains.pdb"] + (["protein.pdb"] if protein else [])
        for k in kinds:
            shutil.copy(os.path.join(PB, n, f"{n}_{k}"), os.path.join(dst, n))
    return str(dst)


def _files(root):
    """relative path -> bytes of every file under root."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The port's eval on the CPU: (data dir, outdir, the prepared pairs
    and results that export_and_rank received, the files it wrote)."""
    tmp = tmp_path_factory.mktemp("eval")
    data = _copy_pb(tmp / "data", NAMES)
    out = str(tmp / "out")
    seen = {}
    export = TP.export_and_rank

    def spy(prepared, results, *a, **kw):
        seen["args"] = (prepared, results)
        return export(prepared, results, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "export_and_rank", spy)
        assert TE.main(["--cpu", "-d", data, "-o", out, "-ckt", SMALL_CKPT, "-mdn", MDN_CKPT]
                       + SMALL) == 0
    return data, out, *seen["args"], _files(out)


def test_eval_writes_its_files(evaluated):
    _, out, prepared, results, files = evaluated
    assert [p.name for p in prepared] == list(NAMES) and len(results) == 4
    for f in ("results.csv", "metrics_report.txt", "validity.csv", "poses.npz",
              "results_mdn_top1.csv", "results_mdn_nll_top1.csv", "results_vina_top1.csv"):
        assert f in files, f
    rows = list(csv.DictReader(io.StringIO(files["results.csv"].decode())))
    assert len(rows) == 4
    for col in ("mdn_score", "mdn_nll", "vina_score", "l_rmsd", "centroid", "chi1_rate",
                "sc_rmsd"):
        assert np.isfinite([float(r[col]) for r in rows]).all(), col


def test_jax_package_writes_the_same_files_from_the_ports_poses(evaluated, tmp_path):
    """The JAX export_and_rank, reporter and validity suite on the port's
    poses.npz (and MDN scores) write the port's files byte for byte: the
    tables, the report, validity.csv and every pose's structures."""
    data, out, _, _, files = evaluated
    jobs = JE.make_jobs("pb", data)
    jprep, fails = JP.prep(jobs, pocket_radius=12.0, cache_dir=str(tmp_path / "jax_prep"),
                           verbose=False)
    assert not fails
    jres = JP.load_poses(os.path.join(out, "poses.npz"), jprep)
    scores = {(r["complex_name"], int(r["pose"])): r
              for r in csv.DictReader(io.StringIO(files["results.csv"].decode()))}
    for r in jres:
        row = scores[(jprep[r.pair_idx].job.complex_name, r.pose_idx)]
        r.mdn_score, r.mdn_nll = float(row["mdn_score"]), float(row["mdn_nll"])
    jout = str(tmp_path / "jax_out")
    shutil.copytree(out, jout, ignore=shutil.ignore_patterns("*.csv", "*.txt", "pose_*"))
    res_csv = JP.export_and_rank(jprep, jres, jout, verbose=False)
    with open(os.path.join(jout, "metrics_report.txt"), "w") as fh:
        fh.write(JR.format_report(JR.load_results(res_csv)))
    vrows = []
    for r in jres:
        pr = jprep[r.pair_idx]
        checks = JV.check_pose(pr.lig, pr.pocket, r.lig_pos, atom14_pos=r.atom14_pos)
        vrows.append({"complex_name": pr.job.complex_name, "pose": r.pose_idx,
                      **{k: int(bool(v)) for k, v in checks.items()}})
    with open(os.path.join(jout, "validity.csv"), "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(vrows[0]))
        w.writeheader()
        w.writerows(vrows)
    got = {k: v.replace(out.encode(), b"OUT") for k, v in files.items()
           if not k.startswith("prep_cache")}
    want = {k: v.replace(jout.encode(), b"OUT") for k, v in _files(jout).items()
            if not k.startswith("prep_cache")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_reporter_matches_jax(evaluated):
    """format_report and success_rates of every mode equal the JAX
    reporter's on a tracked results table and on the one the port wrote."""
    tracked = os.path.join(ROOT, "runs/eval_r4_mdn/results.csv")
    for path in (tracked, os.path.join(evaluated[1], "results.csv")):
        jrows, trows = JR.load_results(path), TR.load_results(path)
        assert trows == jrows
        assert TR.format_report(trows) == JR.format_report(jrows)
        for mode in ("mdn", "mdn_nll", "vina", "oracle"):
            assert TR.success_rates(trows, mode) == JR.success_rates(jrows, mode)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TR.main([tracked])
    assert buf.getvalue() == JR.format_report(JR.load_results(tracked)) + "\n"


def test_export_without_structures_matches_jax(evaluated, tmp_path):
    """export_and_rank(export_structures=False) writes the tables only, the
    JAX function's tables."""
    data, out, prepared, results, _ = evaluated
    jprep, _ = JP.prep(JE.make_jobs("pb", data), cache_dir=str(tmp_path / "jp"), verbose=False)
    jres = JP.load_poses(os.path.join(out, "poses.npz"), jprep)
    for a, b in zip(jres, results):
        a.mdn_score, a.mdn_nll = b.mdn_score, b.mdn_nll
    TP.export_and_rank(prepared, results, str(tmp_path / "t"), export_structures=False,
                       cluster_rank=2.0, verbose=False)
    JP.export_and_rank(jprep, jres, str(tmp_path / "j"), export_structures=False,
                       cluster_rank=2.0, verbose=False)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(want) and all(k.endswith(".csv") for k in got)
    # the port's clustered table names its ranking score (rank_score), a
    # column the JAX one lacks (app/pipeline.py's export_and_rank)
    clustered = [{k: v for k, v in r.items() if k != "rank_score"}
                 for r in csv.DictReader(io.StringIO(got.pop("results_cluster_top1.csv").decode()))]
    assert clustered == list(csv.DictReader(io.StringIO(
        want.pop("results_cluster_top1.csv").decode())))
    assert all(got[k] == want[k] for k in want)


def _asdicts(jobs):
    return [dataclasses.asdict(j) for j in jobs]


def test_make_jobs_match_jax(tmp_path):
    """The three layouts' job lists equal the JAX job makers'; the pb maker
    writes nothing where the contact chains exist."""
    before = _files(PB)
    assert _asdicts(TE.make_jobs("pb", PB)) == _asdicts(JE.make_jobs("pb", PB))
    assert _files(PB) == before
    ts = tmp_path / "ts"
    for pid in ("1abc", "2xyz"):
        os.makedirs(ts / pid)
    (ts / "timesplit_test").write_text("1abc\n\n2xyz\n")
    cd = tmp_path / "cd"
    for cid in ("a_1", "b_2"):
        os.makedirs(cd / "crossdock-x" / cid)
    (cd / "crossdock-x" / "notes.txt").write_text("")
    for lib, root in (("pdbbind_ts", ts), ("crossdock-x", cd)):
        got, want = TE.make_jobs(lib, str(root)), JE.make_jobs(lib, str(root))
        assert len(got) == 2 and _asdicts(got) == _asdicts(want)


def test_contact_chain_extraction_matches_jax(tmp_path):
    """Where a pb complex lacks its contact chains, both makers extract them
    into the dataset directory: the same bytes, and the same jobs."""
    outs = {}
    for key, mod in (("port", TE), ("jax", JE)):
        data = _copy_pb(tmp_path / key, NAMES, protein=True)
        for n in NAMES:
            os.remove(os.path.join(data, n, f"{n}_protein_contact_chains.pdb"))
        jobs = mod.make_jobs("pb", data)
        outs[key] = (_asdicts(jobs), _files(data))
    (tj, tf), (jj, jf) = outs["port"], outs["jax"]
    assert [j["protein"].replace(str(tmp_path / "port"), "D") for j in tj] == \
        [j["protein"].replace(str(tmp_path / "jax"), "D") for j in jj]
    assert tf == jf and len(tf) == 3 * len(NAMES)


def test_refused_flags_name_their_item(tmp_path):
    for flags, item in ((["--cart-relax"], "A10"), (["-nc", "2"], "A14"),
                        (["--conv-mode", "fc"], "A3")):
        with pytest.raises(SystemExit) as e:
            TE.main(["--cpu", "-d", PB, "-o", str(tmp_path), "-ckt", SMALL_CKPT] + flags)
        assert item in str(e.value.code), flags


def test_entry_points_need_cuda_without_cpu(tmp_path):
    """Without --cpu on a machine without CUDA, eval_cli exits non-zero
    naming CUDA (as a command), and rescore_cli and serve raise before
    touching anything."""
    proc = subprocess.run(
        [sys.executable, "-m", "diffbindfr_torch.app.eval_cli", "-d", PB, "-o",
         str(tmp_path / "o"), "-ckt", SMALL_CKPT], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert not os.path.exists(tmp_path / "o")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRS.main(["--poses", str(tmp_path), "-d", PB, "-mdn", MDN_CKPT, "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(["-ckt", SMALL_CKPT])


def _same_record(a, b, what):
    """Two packages' records (dataclasses, namedtuples) field for field."""
    if dataclasses.is_dataclass(b) or hasattr(b, "_fields"):
        names = ([f.name for f in dataclasses.fields(b)] if dataclasses.is_dataclass(b)
                 else list(b._fields))
        for f in names:
            _same_record(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a == b, what


def _same_poses(tp, tr, jp, jr):
    assert [p.name for p in tp] == [p.job.complex_name for p in jp]
    for a, b in zip(tp, jp):
        for f in ("lig", "pocket", "bucket", "sample"):
            _same_record(getattr(a, f), getattr(b, f), f"{a.name}.{f}")
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert (a.pair_idx, a.pose_idx, a.vina_score) == (b.pair_idx, b.pose_idx, b.vina_score)
        np.testing.assert_array_equal(a.lig_pos, b.lig_pos)
        np.testing.assert_array_equal(a.atom14_pos, b.atom14_pos)


def test_rescore_generic_path_matches_jax(evaluated, tmp_path):
    """`-i results.csv`: the pairs and poses rebuilt from the exported
    structures equal the JAX `_pairs_from_csv`'s; the command scores them."""
    res_csv = os.path.join(evaluated[1], "results.csv")
    _same_poses(*TRS._pairs_from_csv(res_csv, 12.0), *JRS._pairs_from_csv(res_csv, 12.0))
    out = str(tmp_path / "r")
    assert TRS.main(["--cpu", "-i", res_csv, "-mdn", MDN_CKPT, "-o", out, "--score-bs", "4"]) == 0
    rows = list(csv.DictReader(open(os.path.join(out, "results.csv"))))
    assert len(rows) == 4 and all(r["lig_sdf"] == "" for r in rows)
    assert np.isfinite([float(r["mdn_nll"]) for r in rows]).all()


def test_rescore_poses_path_matches_jax(tmp_path):
    """`--poses`: a run directory holding the tracked 3dbs and 3mhw prep
    caches and the EC fixture's first two poses of each after EC. The job
    list, pairs and poses equal the JAX rescore's host side; the MDN scores
    equal the JAX package's stored ones within 1e-5 relative."""
    names = ("3dbs", "3mhw")
    data = _copy_pb(tmp_path / "data", names)
    run = tmp_path / "run"
    os.makedirs(run / "prep_cache")
    ec, ref = np.load(EC_FIXTURE), np.load(MDN_FIXTURE)
    arrs = {}
    for n in names:
        for ext in (".npz", ".rec.pkl"):
            shutil.copy(os.path.join(PREP, f"{n}_r12{ext}"), run / "prep_cache")
        pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{n}_r12.npz"))
        pk, nres = pair.pocket, pair.bucket.n_res
        a14 = np.zeros((nres, 14, 3), np.float32)
        a14[: pk.num_res] = pk.atom14_pos * pk.atom14_mask[..., None]
        arrs[n + "|lig_pos"] = ec[n + "|ec_pos"][:2]
        arrs[n + "|atom14_pos"] = np.stack([a14, a14])
        arrs[n + "|pose_idx"] = np.arange(2, dtype=np.int32)
        arrs[n + "|vina"] = ec[n + "|ec_aff"][:2]
    np.savez(run / "poses.npz", **arrs)
    args = TRS.build_parser().parse_args(["--poses", str(run), "-d", data, "-mdn", MDN_CKPT,
                                          "-o", str(tmp_path / "o")])
    jargs = JRS.build_parser().parse_args(["--poses", str(run), "-d", data, "-mdn", MDN_CKPT,
                                           "-o", str(tmp_path / "o")])
    jjobs = JE.make_jobs(jargs.lib, jargs.data_dir)
    jprep, _ = JP.prep(jjobs, pocket_radius=12.0, cache_dir=str(run / "prep_cache"),
                       verbose=False)
    _same_poses(*TRS._pairs_from_poses(args, TP), jprep,
                JP.load_poses(str(run / "poses.npz"), jprep))
    out = str(tmp_path / "o")
    assert TRS.main(["--cpu", "--poses", str(run), "-d", data, "-mdn", MDN_CKPT, "-o", out,
                     "--score-bs", "4"]) == 0
    rows = {(r["complex_name"], int(r["pose"])): r
            for r in csv.DictReader(open(os.path.join(out, "results.csv")))}
    for n in names:
        for k in range(2):
            for col, key in (("mdn_score", "sum_prob"), ("mdn_nll", "mean_nll")):
                want = float(ref[f"{n}|after|{key}"][k])
                assert abs(float(rows[(n, k)][col]) - want) <= 1e-5 * abs(want), (n, k, col)


def test_ec_cache_stays_within_its_bound():
    """A stream of 40 distinct pairs (copies of 3mhw's) through one
    ECEngine keeps at most max(2 * batch_size, 32) systems on the device,
    least recently used evicted; every result equals a fresh engine's."""
    base = TP.PreparedPair.from_prep_cache(os.path.join(PREP, "3mhw_r12.npz"))
    ec_pose = np.load(EC_FIXTURE)["3mhw|pose0"][0]

    def result(pi=0):
        return TP.PoseResult(pi, 0, ec_pose.copy(), base.sample.template_pos, None)

    want = result()
    TP.error_correct([base], [want], steps=2, batch_size=1, device="cpu", verbose=False)
    eng = TP.ECEngine(steps=2, batch_size=1, device="cpu", verbose=False)
    assert eng.capacity == 32
    pairs = [dataclasses.replace(base) for _ in range(40)]
    for i, pair in enumerate(pairs):
        got = result()
        eng.run([pair], [got])
        assert len(eng._systems) == min(i + 1, 32)
        np.testing.assert_array_equal(got.lig_pos, want.lig_pos)
        assert got.vina_score == want.vina_score
    assert id(pairs[0]) not in eng._systems and id(pairs[-1]) in eng._systems
    got = result()
    eng.run([pairs[0]], [got])  # evicted: built again, the same answer
    np.testing.assert_array_equal(got.lig_pos, want.lig_pos)
    assert id(pairs[8]) not in eng._systems and len(eng._systems) == 32
