"""Export and ranking of the port (`app/pipeline.py` export_and_rank,
`app/export.py`) against the JAX package's on the same poses: 4 saved poses
each of 3dbs, 3mhw and 2src (runs/eval_r5_scsrc/poses.npz, the JAX
package's own), with their prep records and the tracked proteins.

Byte for byte: results.csv and the mdn, mdn_nll and vina top-1 tables (the
output directory's name aside), every SDF, PDB and XTC. The clustered top-1
table equals the JAX one apart from the port's added `rank_score` column.
Also: poses.npz round trips between the packages in both directions, keyed
by complex name, and the prep records' crystal pose is in the world frame.
"""
import csv
import os
import pickle

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import jobs as JJ
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_torch.app import jobs as TJ
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem.records import load_prep_record

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
POSES = os.path.join(ROOT, "runs/eval_r5_scsrc/poses.npz")
NAMES = ("3dbs", "3mhw", "2src")
N_POSES = 4


def _write_jobs(path):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name"])
        for n in NAMES:
            d = os.path.join(ROOT, "runs/pb_bench", n)
            w.writerow([f"{d}/{n}_protein_contact_chains.pdb", n, f"{d}/{n}_ligand.sdf", n, n])
    return path


def _jax_pairs(jobs):
    out = []
    for job in jobs:
        stem = os.path.join(PREP, f"{job.complex_name}_r12")
        with open(stem + ".rec.pkl", "rb") as fh:
            rec = pickle.load(fh)
        out.append(JP.PreparedPair(job=job, lig=rec["lig"], pocket=rec["pocket"],
                                   bucket=rec["bucket"], crystal_pos=rec["crystal_pos"],
                                   sample_path=stem + ".npz"))
    return out


def _scored(results, with_mdn, seed):
    """The first N_POSES poses of each pair with seeded scores (one mdn tie
    per pair, so the top-1 tables must keep the first row of a tie) and a
    3-frame trajectory on pose 0."""
    rng = np.random.default_rng(seed)
    keep = [r for r in results if r.pose_idx < N_POSES]
    for r in keep:
        if with_mdn:
            r.mdn_score = float(np.round(rng.normal() * 5 + 20, 3))
            r.mdn_nll = float(rng.normal() + 3)
        if r.pose_idx == 0:
            r.lig_traj = np.stack([r.lig_pos + k for k in (2.0, 1.0, 0.0)]).astype(np.float32)
            r.atom14_traj = np.stack([r.atom14_pos] * 3)
    if with_mdn:
        for a, b in zip(keep[::N_POSES], keep[1::N_POSES]):
            b.mdn_score = a.mdn_score
    return keep


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    jobs_csv = _write_jobs(str(tmp_path_factory.mktemp("jobs") / "jobs.csv"))
    tjobs, jjobs = TJ.load_jobs_csv(jobs_csv), JJ.load_jobs_csv(jobs_csv)
    tpairs, fails = TP.prep(tjobs, 12.0, cache_dir=PREP, verbose=False)
    assert not fails and [p.name for p in tpairs] == list(NAMES)
    return tpairs, _jax_pairs(jjobs)


def _files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d) for a, _, fs in os.walk(d) for f in fs)


def _text(path, outdir):
    with open(path) as fh:
        return fh.read().replace(str(outdir), "OUT")


def _rows(path, outdir):
    with open(path, newline="") as fh:
        return [{k: v.replace(str(outdir), "OUT") for k, v in row.items()}
                for row in csv.DictReader(fh)]


@pytest.mark.parametrize("mode", ["pocket_top2_mdn", "template_all_vina"])
def test_export_and_rank_matches_jax(pairs, mode, tmp_path):
    """`pocket_top2_mdn`: export_pocket (full to_pdb_string and
    pocket_final.pdb), export_top=2, mdn scores, clusters at 2 A ranked by
    mdn_nll. `template_all_vina`: the PdbTemplate writer for every pose, no
    MDN, clusters ranked by vina_score."""
    tpairs, jpairs = pairs
    with_mdn = mode == "pocket_top2_mdn"
    kw = dict(export_pocket=with_mdn, export_top=2 if with_mdn else -1, cluster_rank=2.0,
              cluster_mode="mean", verbose=False)
    tres = _scored(TP.load_poses(POSES, tpairs), with_mdn, 0)
    jres = _scored(JP.load_poses(POSES, jpairs), with_mdn, 0)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    TP.export_and_rank(tpairs, tres, str(tdir), **kw)
    JP.export_and_rank(jpairs, jres, str(jdir), **kw)
    tables = ["results.csv", "results_vina_top1.csv"]
    if with_mdn:
        tables += ["results_mdn_top1.csv", "results_mdn_nll_top1.csv"]
    for t in tables:
        assert _text(tdir / t, tdir) == _text(jdir / t, jdir), t
    got, want = _rows(tdir / "results_cluster_top1.csv", tdir), _rows(
        jdir / "results_cluster_top1.csv", jdir)
    assert [r.pop("rank_score") for r in got] == ["mdn_nll" if with_mdn else "vina_score"] * 3
    assert got == want
    files = _files(tdir)
    assert files == _files(jdir)
    structs = [f for f in files if f.endswith((".sdf", ".pdb", ".xtc"))]
    n_exported = 2 if with_mdn else N_POSES
    assert sum(f.endswith("lig_final.sdf") for f in structs) == 3 * n_exported
    assert sum(f.endswith("pocket_final.pdb") for f in structs) == (6 if with_mdn else 0)
    if not with_mdn:  # every pose exported: pose 0's trajectory files too
        for f in ("lig_traj.sdf", "lig_traj.xtc", "pocket_traj.pdb", "pocket_traj.xtc"):
            assert sum(s.endswith(f) for s in structs) == 3, f
    for f in structs:
        with open(tdir / f, "rb") as a, open(jdir / f, "rb") as b:
            assert a.read() == b.read(), f


def test_poses_round_trip_between_packages(pairs, tmp_path):
    """Port save_poses -> JAX load_poses and JAX save_poses -> port
    load_poses give the same poses, pose indices and vina scores, keyed by
    complex name (`3dbs|lig_pos`, ...)."""
    tpairs, jpairs = pairs
    tres = [r for r in TP.load_poses(POSES, tpairs) if r.pose_idx < N_POSES]
    for r in tres[::2]:
        r.vina_score = None  # saved as nan, read back as None
    path = TP.save_poses(str(tmp_path), tpairs, tres, name="port.npz")
    assert {k.split("|")[0] for k in np.load(path).files} == set(NAMES)
    back = JP.load_poses(path, jpairs)
    jres = [r for r in JP.load_poses(POSES, jpairs) if r.pose_idx < N_POSES]
    jpath = JP.save_poses(str(tmp_path), jpairs, jres, name="jax.npz")
    back2 = TP.load_poses(jpath, tpairs)
    for got, want in ((back, tres), (back2, jres)):
        assert len(got) == len(want) == 3 * N_POSES
        for g, w in zip(got, want):
            assert (g.pair_idx, g.pose_idx, g.vina_score) == (w.pair_idx, w.pose_idx,
                                                               w.vina_score)
            np.testing.assert_array_equal(g.lig_pos, w.lig_pos)
            np.testing.assert_array_equal(g.atom14_pos, w.atom14_pos)


@pytest.mark.parametrize("name", ("2src", "2zec", "3dbs", "3mhw", "3pp0"))
def test_crystal_pos_is_the_world_frame(name):
    """The record's crystal pose is the input ligand in the world frame: less
    the pocket centre it is exactly the pocket-frame ligand, and the pair
    names itself by the complex (the cache stem without `_r12`)."""
    rec = load_prep_record(os.path.join(PREP, f"{name}_r12.rec.pkl"))
    assert np.array_equal(rec["crystal_pos"] - rec["pocket"].center, rec["lig"].pos)
    assert np.abs(rec["pocket"].center).max() > 1.0  # the two frames differ
    pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{name}_r12.npz"))
    assert pair.name == name
    np.testing.assert_array_equal(pair.crystal_pos, rec["crystal_pos"])


def test_record_with_a_holo_reference_serves_redock_and_holo_jobs(tmp_path):
    """A 3mhw record written for an apo->holo job carries the JAX package's
    HoloRef (built from the 3mhw protein, its side chains then moved 0.5 A
    so that it differs from the input pocket). The port reads it as its
    own HoloRef; as the JAX package's `_cache_hit` does, a redock job is
    served and grades against the input pocket, a job naming the record's
    holo structure is served and grades against the HoloRef, and a job
    naming another holo structure is not served (prepared again, it fails at
    its pocket: the job has no pocket definition). results.csv of each
    served job is byte-identical to the JAX package's."""
    from diffbindfr_tpu.app.analysis import build_holo_ref
    from diffbindfr_torch.chem.records import HoloRef

    holo_pdb = os.path.join(ROOT, "runs/pb_bench/3mhw/3mhw_protein_contact_chains.pdb")
    with open(os.path.join(PREP, "3mhw_r12.rec.pkl"), "rb") as fh:
        rec = pickle.load(fh)
    holo = build_holo_ref(rec["pocket"], holo_pdb)
    holo.atom14_pos = holo.atom14_pos.copy()
    holo.atom14_pos[:, 5:] += np.float32(0.5)  # past CB: the side chains
    rec.update(holo_ref=holo, holo_src=holo_pdb)
    with open(tmp_path / "3mhw_r12.rec.pkl", "wb") as fh:
        pickle.dump(rec, fh)
    os.symlink(os.path.join(PREP, "3mhw_r12.npz"), tmp_path / "3mhw_r12.npz")
    d = os.path.join(ROOT, "runs/pb_bench/3mhw")
    job_kw = dict(protein=f"{d}/3mhw_protein_contact_chains.pdb", protein_name="3mhw",
                  ligand=f"{d}/3mhw_ligand.sdf", ligand_name="3mhw", complex_name="3mhw")
    sc = {}
    for kind, holo_protein in (("redock", None), ("holo", holo_pdb)):
        tjob = TJ.Job(**job_kw, holo_protein=holo_protein)
        jjob = JJ.Job(**job_kw, holo_protein=holo_protein)
        tpairs, fails = TP.prep([tjob], 12.0, cache_dir=str(tmp_path), verbose=False)
        assert not fails
        spath = str(tmp_path / "3mhw_r12.npz")
        jpairs = [JP.PreparedPair(**JP._cache_hit(rec, jjob, spath, 0))]
        if kind == "redock":
            assert tpairs[0].holo_ref is None and jpairs[0].holo_ref is None
        else:
            assert isinstance(tpairs[0].holo_ref, HoloRef)
            for f in ("aatype", "atom14_pos", "atom14_mask", "center", "n_matched", "ca_rmsd"):
                np.testing.assert_array_equal(getattr(tpairs[0].holo_ref, f), getattr(holo, f))
        tres = [r for r in TP.load_poses(POSES, tpairs) if r.pose_idx < 2]
        jres = [r for r in JP.load_poses(POSES, jpairs) if r.pose_idx < 2]
        tdir, jdir = tmp_path / f"port_{kind}", tmp_path / f"jax_{kind}"
        TP.export_and_rank(tpairs, tres, str(tdir), verbose=False)
        JP.export_and_rank(jpairs, jres, str(jdir), verbose=False)
        assert _text(tdir / "results.csv", tdir) == _text(jdir / "results.csv", jdir), kind
        sc[kind] = [float(r["sc_rmsd"]) for r in _rows(tdir / "results.csv", tdir)]
    assert min(abs(a - b) for a, b in zip(sc["redock"], sc["holo"])) > 0.1
    other = TJ.Job(**job_kw, holo_protein=os.path.join(d, "3mhw_ligand.sdf"))
    prepared, fails = TP.prep([other], 12.0, cache_dir=str(tmp_path), verbose=False)
    # not served, so prepared again from the raw files: the job has no pocket definition
    assert not prepared and fails[0].stage == "pocket" and "no pocket" in fails[0].error
