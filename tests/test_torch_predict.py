"""`predict` of the port end to end at a small size, against the JAX package:
the sampler's SDE and ODE with trajectories, then error correction, MDN
scoring and export_and_rank; the CLI in a fresh interpreter without JAX;
the refused flags; cache misses; the job tables.

Small config (ns=8, nv=4, 2 layers), 3 of the default schedule's steps, on
3dbs and 3mhw (no torsions, a smaller bucket), BSZ poses each. The JAX side
(its init_params weights, sampler outputs with trajectories, then 5 EC
steps, the full-width MDN of runs/mdn_r4b and export_and_rank's rows and
top-1 choices) is tests/fixtures/torch_predict_ref.npz, written on the CPU
by the `slow` test_write_predict_fixture: the JAX compiles of that chain
take minutes. The port runs live on the fixture's weights carried across by
load_checkpoint; the two frameworks' random streams differ, so the JAX key
splits are replayed and handed to the port as a SamplerNoise (as
tests/test_torch_sampler.py does). Tolerances: poses and every trajectory
frame 1e-3 A, chi 1e-3 rad (f32 dynamics over 3 steps); after EC and MDN,
metrics 1e-3 A and scores 1e-3 relative, and the top-1 choice of each table
the same unless its two best scores lie within 1e-4.

The free-running comparison uses the default grid (inference_steps 22).
On the 5-point grid that `predict -st 3` runs, each step is 4.4 times
longer and the run reaches t = 0.4, and the two packages' runs part
further: 1.9e-3 A on 3mhw; on 3dbs their states, 7.6e-4 A apart before
step 2, fall on the two sides of the atom graph's 4 A cutoff for one atom
pair, and are 5.4e-2 A apart after it. tests/torch_sampler_divergence.py
prints that witness on six grids. The steps are held one by one instead:
test_each_step_matches_jax_from_its_state starts every step of both grids
from the JAX state before it.
"""
import csv
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu import sampler as JSP
from diffbindfr_tpu.app import jobs as JJ
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.geometry import so3 as JSO3
from diffbindfr_tpu.geometry import torus as JTOR
from diffbindfr_tpu.models import mdn_scorer as jmdn
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.utils import load_checkpoint as jload_checkpoint
from diffbindfr_torch import sampler as TSP
from diffbindfr_torch.app import cli
from diffbindfr_torch.app import jobs as TJ
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.data.sample import stack_samples, to_device
from diffbindfr_torch.geometry import so3 as TSO3
from diffbindfr_torch.geometry import torus as TTOR
from diffbindfr_torch.models import mdn_scorer as tmdn
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
NAMES = ("3dbs", "3mhw")  # 3mhw: no torsions, a smaller bucket (nl 96)
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_predict_ref.npz")
STEPS, BSZ, EC_STEPS = 3, 2, 5
GRIDS = (22, 5)  # inference_steps: the default grid, and the one `predict -st 3` runs
TCFG = tsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
SMALL = ["--cfg-options", "score_net.ns=8", "score_net.nv=4", "score_net.num_conv_layers=2"]


def _job_rows(names):
    rows = []
    for n in names:
        d = os.path.join(ROOT, "runs/pb_bench", n)
        rows.append([f"{d}/{n}_protein_contact_chains.pdb", n, f"{d}/{n}_ligand.sdf", n, n])
    return rows


def _write_jobs(path, names):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name"])
        w.writerows(_job_rows(names))
    return str(path)


def _replay_noise(key, s, cfg):
    """The draws of diffbindfr_tpu.sampler.sample(init=None) for a batch of
    BSZ copies of s, as a SamplerNoise (the ODE reads only the prior)."""
    keys = jax.random.split(key, BSZ + 1)
    prior = []
    for b in range(BSZ):
        k_tor, k_rot, k_tr, k_chi = jax.random.split(keys[b + 1], 4)
        prior.append((
            jax.random.uniform(k_tor, s.tor_mask.shape, minval=-jnp.pi, maxval=jnp.pi),
            JSP.so3_uniform(k_rot),
            jax.random.normal(k_tr, (3,)) * cfg.tr_sigma_max_init,
            jax.random.uniform(k_chi, s.chi_mask.shape, minval=-jnp.pi, maxval=jnp.pi)))
    key = keys[0]
    zs = []
    for _ in range(cfg.actual_steps):
        key, k_tr, k_rot, k_tor, k_sc = jax.random.split(key, 5)
        zs.append((jax.random.normal(k_tr, (BSZ, 3)), jax.random.normal(k_rot, (BSZ, 3)),
                   jax.random.normal(k_tor, (BSZ,) + s.tor_mask.shape),
                   jax.random.normal(k_sc, (BSZ,) + s.chi_mask.shape)))
    cols = [np.stack([np.asarray(p[i]) for p in prior]) for i in range(4)]
    cols += [np.stack([np.asarray(z[i]) for z in zs]) for i in range(4)]
    return TSP.SamplerNoise(*[torch.from_numpy(np.asarray(c, np.float32)) for c in cols])


@pytest.fixture(scope="module", autouse=True)
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


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The port's pairs of 3dbs and 3mhw from the tracked prep cache and the
    fixture's small-net weights (the JAX init_params tree)."""
    jobs_csv = _write_jobs(tmp_path_factory.mktemp("jobs") / "jobs.csv", NAMES)
    tpairs, fails = TP.prep(TJ.load_jobs_csv(jobs_csv), 12.0, cache_dir=PREP, verbose=False)
    assert not fails
    tp, _ = load_checkpoint(FIXTURE, use_ema=False, device="cpu")
    return tpairs, tp, np.load(FIXTURE)


def _sampler_cfg(mod, kind, inference_steps=22):
    return mod.SamplerConfig(kind=kind, inference_steps=inference_steps, actual_steps=STEPS)


def _jax_steps(jp, jcfg, kind, inference_steps, s, key):
    """The JAX sampler's state before and after each step on BSZ copies of
    s: init_lig, init_chi, lig_traj, atom14_traj and chi_steps [STEPS, ...]
    (chi after step k from a run of k steps with the last step's noise
    kept, which draws the full run's first k steps; XLA compiles that run
    apart, so its atom14 agrees with the full run's to 1e-4 A, not bit
    for bit)."""
    cfg = _sampler_cfg(JSP, kind, inference_steps)
    jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * BSZ)), s)
    lig0, chi0, _ = jax.vmap(lambda k, x: JSP.init_pose(k, x, cfg))(
        jax.random.split(key, BSZ + 1)[1:], jb)
    full = JSP.sample(jp, jcfg, cfg, jb, key, keep_trajectory=True)
    chis = []
    for k in range(1, STEPS):
        part = JSP.sample(jp, jcfg, dataclasses.replace(
            cfg, actual_steps=k, no_final_step_noise=False), jb, key)
        np.testing.assert_allclose(np.asarray(part.atom14_pos),
                                   np.asarray(full.atom14_traj[k - 1]), atol=1e-4)
        chis.append(np.asarray(part.chi))
    chis.append(np.asarray(full.chi))
    return dict(init_lig=np.asarray(lig0), init_chi=np.asarray(chi0),
                lig_traj=np.asarray(full.lig_traj), atom14_traj=np.asarray(full.atom14_traj),
                chi_steps=np.stack(chis))


def _port_sample(tpairs, tp, kind, pi):
    s = tpairs[pi].sample
    with torch.no_grad():
        return TSP.sample(tp, TCFG, _sampler_cfg(TSP, kind),
                          to_device(stack_samples([s] * BSZ), "cpu"),
                          _replay_noise(jax.random.PRNGKey(20 + pi), s,
                                        _sampler_cfg(JSP, kind)), keep_trajectory=True)


def _chain(prepared, results, mod, ec_steps, mdn_params, outdir, **kw):
    """EC, the full-width MDN and export_and_rank (clusters at 2 A) of one
    package on its own poses, as predict runs them; returns results.csv's
    rows."""
    mod.error_correct(prepared, results, steps=ec_steps, batch_size=BSZ, verbose=False, **kw)
    mdn_mod = tmdn if mod is TP else jmdn
    mod.score_mdn(prepared, results, mdn_params, mdn_mod.MDNConfig(), batch_size=BSZ,
                  verbose=False, **kw)
    mod.export_and_rank(prepared, results, outdir, cluster_rank=2.0, verbose=False)
    with open(os.path.join(outdir, "results.csv"), newline="") as fh:
        return list(csv.DictReader(fh))


def _top1(outdir, table):
    with open(os.path.join(outdir, table), newline="") as fh:
        return [int(r["pose"]) for r in csv.DictReader(fh)]


TABLES = (("results_mdn_top1.csv", "mdn_score", False),
          ("results_mdn_nll_top1.csv", "mdn_nll", True),
          ("results_vina_top1.csv", "vina_score", True),
          ("results_cluster_top1.csv", "mdn_nll", True))
COLS = ("l_rmsd", "centroid", "sc_rmsd", "chi1_rate", "vina_score", "mdn_score", "mdn_nll")


@pytest.mark.slow
def test_write_predict_fixture(tmp_path):
    """Regenerates tests/fixtures/torch_predict_ref.npz from the JAX package
    on the CPU (a few minutes): the small net's init_params (PRNGKey(0)),
    per kind and complex the sampler's outputs with trajectories (key
    20 + pair index), then for the SDE poses 5 EC steps, the full-width MDN
    and export_and_rank: results.csv's COLS per row and each table's top-1
    pose per complex; and per kind, grid (inference_steps 22 and 5) and
    complex the state before and after each step (_jax_steps)."""
    from diffbindfr_tpu.utils.checkpoint import _flatten

    jobs_csv = _write_jobs(tmp_path / "jobs.csv", NAMES)
    jpairs, jfails = JP.prep(JJ.load_jobs_csv(jobs_csv), 12.0, verbose=False, cache_dir=PREP)
    assert not jfails
    jcfg = jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2, dropout=0.0)
    jp = jsn.init_params(jax.random.PRNGKey(0), jcfg)
    out = {f"params/{k}": np.asarray(v) for k, v in _flatten(jp).items()}
    jres = []
    for kind in ("sde", "ode"):
        for pi, name in enumerate(NAMES):
            s = jpairs[pi].sample
            jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * BSZ)), s)
            res = JSP.sample(jp, jcfg, _sampler_cfg(JSP, kind), jb, jax.random.PRNGKey(20 + pi),
                             keep_trajectory=True)
            for f in ("lig_pos", "atom14_pos", "chi", "lig_traj", "atom14_traj"):
                out[f"{kind}|{name}|{f}"] = np.asarray(getattr(res, f))
            if kind == "sde":
                jres += [JP.PoseResult(pi, b, np.asarray(res.lig_pos[b]),
                                       np.asarray(res.atom14_pos[b]), np.asarray(res.chi[b]))
                         for b in range(BSZ)]
    for kind in ("sde", "ode"):
        for inf in GRIDS:
            for pi, name in enumerate(NAMES):
                steps = _jax_steps(jp, jcfg, kind, inf, jpairs[pi].sample,
                                   jax.random.PRNGKey(20 + pi))
                out.update({f"step|{kind}|{inf}|{name}|{f}": v for f, v in steps.items()})
    mdn_params, _ = jload_checkpoint(MDN_CKPT, use_ema=True)
    rows = _chain(jpairs, jres, JP, EC_STEPS, mdn_params, str(tmp_path / "jax"))
    out["rows|pose"] = np.asarray([int(r["pose"]) for r in rows])
    out["rows|cols"] = np.asarray([[float(r[c]) for c in COLS] for r in rows])
    for table, _, _ in TABLES:
        out["top1|" + table] = np.asarray(_top1(str(tmp_path / "jax"), table))
    np.savez_compressed(FIXTURE, **out)


@pytest.mark.parametrize("kind", ["sde", "ode"])
def test_sampler_with_trajectory_matches_jax(small, kind):
    """Final poses and every trajectory frame within 1e-3 A and chi within
    1e-3 rad of the JAX sampler's, on 3dbs and 3mhw; the ODE's control: its
    poses are not the SDE's, and it draws no per-step noise."""
    tpairs, tp, ref = small
    for pi, name in enumerate(NAMES):
        got = _port_sample(tpairs, tp, kind, pi)
        assert got.lig_traj.shape == (STEPS, BSZ) + tuple(got.lig_pos.shape[1:])
        assert got.atom14_traj.shape == (STEPS, BSZ) + tuple(got.atom14_pos.shape[1:])
        for f in ("lig_pos", "atom14_pos", "lig_traj", "atom14_traj", "chi"):
            np.testing.assert_allclose(getattr(got, f).numpy(), ref[f"{kind}|{name}|{f}"],
                                       atol=1e-3, err_msg=f"{name} {f}")
        np.testing.assert_array_equal(got.lig_traj[-1].numpy(), got.lig_pos.numpy())
    if kind == "ode":
        assert np.abs(ref["ode|3dbs|lig_pos"] - ref["sde|3dbs|lig_pos"]).max() > 1e-2
        noise = TSP.draw_noise(to_device(stack_samples([tpairs[0].sample]), "cpu"),
                               TSP.SamplerConfig(kind="ode"), torch.Generator().manual_seed(0))
        assert noise.z_tr.shape[0] == 0 and noise.prior_tr.shape == (1, 3)


@pytest.mark.parametrize("inference_steps", GRIDS)
@pytest.mark.parametrize("kind", ["sde", "ode"])
def test_each_step_matches_jax_from_its_state(small, kind, inference_steps):
    """Every step of the port's sampler (`sampler._step`), started from the
    JAX sampler's state before it with the same noise, lands within 1e-3 A
    (ligand, atom14) and 1e-3 rad (chi) of the JAX state after it, on the
    default grid and on the 5-point grid of `predict -st 3`."""
    tpairs, tp, ref = small
    for pi, name in enumerate(NAMES):
        s = tpairs[pi].sample
        batch = to_device(stack_samples([s] * BSZ), "cpu")
        cfg = _sampler_cfg(TSP, kind, inference_steps)
        noise = _replay_noise(jax.random.PRNGKey(20 + pi), s,
                              _sampler_cfg(JSP, kind, inference_steps))
        sched = TSP._schedule(cfg, "cpu")
        want = {f: torch.from_numpy(ref[f"step|{kind}|{inference_steps}|{name}|{f}"])
                for f in ("init_lig", "init_chi", "lig_traj", "atom14_traj", "chi_steps")}
        lig, chi = want["init_lig"], want["init_chi"]
        for i in range(STEPS):
            atm = TSP._pack_atoms(batch, TSP._rebuild_atom14(batch, chi))
            with torch.no_grad():
                got = TSP._step(tp, TCFG, cfg, batch, sched, noise, i, lig, chi, atm)
            for g, f in zip(got[:3], ("lig_traj", "chi_steps", "atom14_traj")):
                np.testing.assert_allclose(g.numpy(), want[f][i].numpy(), atol=1e-3,
                                           err_msg=f"{name} step {i} {f}")
            lig, chi = want["lig_traj"][i], want["chi_steps"][i]


def test_slice_from_sampler_to_export_matches_jax(small, tmp_path):
    """The port's SDE poses of 3dbs and 3mhw through 5 EC steps, the
    full-width MDN and export_and_rank against the JAX chain's rows: metrics
    within 1e-3 A, scores within 1e-3 relative, every table's top-1 choice
    the same unless its two best scores lie within 1e-4."""
    tpairs, tp, ref = small
    tres = []
    for pi in range(len(NAMES)):
        got = _port_sample(tpairs, tp, "sde", pi)
        tres += [TP.PoseResult(pi, b, got.lig_pos[b].numpy(), got.atom14_pos[b].numpy(),
                               got.chi[b].numpy()) for b in range(BSZ)]
    mdn_params, _ = load_checkpoint(MDN_CKPT, device="cpu")
    outdir = str(tmp_path / "port")
    rows = _chain(tpairs, tres, TP, EC_STEPS, mdn_params, outdir, device="cpu")
    want = ref["rows|cols"]
    assert [int(r["pose"]) for r in rows] == ref["rows|pose"].tolist()
    assert [r["complex_name"] for r in rows] == [n for n in NAMES for _ in range(BSZ)]
    got = np.asarray([[float(r[c]) for c in COLS] for r in rows])
    for j, c in enumerate(COLS):
        tol = 1e-3 if j < 4 else 1e-3 * np.maximum(np.abs(want[:, j]), 1.0)
        assert (np.abs(got[:, j] - want[:, j]) <= tol).all(), (c, got[:, j], want[:, j])
    for table, col, lower in TABLES:
        for ci, (g, w) in enumerate(zip(_top1(outdir, table), ref["top1|" + table])):
            if g != w:  # allowed only on a near tie
                sc = np.sort(want[ci * BSZ:(ci + 1) * BSZ, COLS.index(col)])
                best = sc[:2] if lower else sc[-2:]
                assert abs(best[1] - best[0]) <= 1e-4, (table, ci, g, w)


def test_predict_cli_without_jax(tmp_path):
    """`python -m diffbindfr_torch.app.cli predict --cpu` in a fresh
    interpreter on a copy of the 3dbs and 3mhw caches (a third job, 2src, has
    none, and no pocket definition to prepare it from): every output file,
    `failed.csv` naming 2src's missing pocket definition, and no jax, JAX
    package or networkx module loaded. The SO(3)/torus tables are the
    JAX package's, saved to a file here and handed in."""
    out = tmp_path / "out"
    os.makedirs(out / "prep_cache")
    for n in NAMES:
        for ext in (".npz", ".rec.pkl"):
            shutil.copy(os.path.join(PREP, f"{n}_r12{ext}"), out / "prep_cache")
    jobs = _write_jobs(tmp_path / "jobs.csv", NAMES + ("2src",))
    tt = JTOR.tables()
    np.savez(tmp_path / "tables.npz", **{f"so3_{k}": v for k, v in JSO3.tables()._asdict().items()},
             torus_score=tt.score, torus_score_norm=tt.score_norm)
    argv = ["predict", "--cpu", "-i", jobs, "-o", str(out), "-np", "2", "-bs", "2", "-st", "2",
            "--ec-steps", "2", "-mdn", MDN_CKPT, "--cluster-rank", "2.0", "--save-poses",
            "-traj", "-es", "--pallas"] + SMALL
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from diffbindfr_torch.app import cli
from diffbindfr_torch.geometry import so3, torus
t = np.load({str(tmp_path / 'tables.npz')!r})
so3_arrays = {{k[4:]: t[k] for k in t.files if k.startswith('so3_')}}
so3.set_tables(so3.SO3Tables.from_numpy('cpu', **so3_arrays))
torus.set_tables(torus.TorusTables.from_numpy('cpu', score=t['torus_score'],
                                              score_norm=t['torus_score_norm']))
rc = cli.main({argv!r})
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'diffbindfr_tpu', 'networkx')]
print('BAD', bad)
sys.exit(rc or (1 if bad else 0))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "BAD []" in r.stdout
    with open(out / "results.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 4 and {r_["complex_name"] for r_ in rows} == set(NAMES)
    assert all(np.isfinite(float(r_[k])) for r_ in rows
               for k in ("mdn_nll", "vina_score", "l_rmsd"))
    for t in ("results_mdn_top1.csv", "results_mdn_nll_top1.csv", "results_vina_top1.csv",
              "results_cluster_top1.csv", "poses.npz", "failed.csv"):
        assert (out / t).exists(), t
    for n in NAMES:
        for p in range(2):
            for f in ("lig_final.sdf", "prot_final.pdb", "pocket_final.pdb", "lig_traj.xtc",
                      "lig_traj.sdf", "pocket_traj.pdb", "pocket_traj.xtc"):
                assert (out / n / f"pose_{p}" / f).exists(), (n, p, f)
    with open(out / "failed.csv", newline="") as fh:
        fail = list(csv.DictReader(fh))
    assert [(f["complex_name"], f["stage"]) for f in fail] == [("2src", "pocket")]
    assert "no pocket definition" in fail[0]["error"]


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--cart-relax"], "A10", id="flags0-A10"),
    pytest.param(["-nc", "4"], "A14", id="flags3-A14"),
    pytest.param(["--conv-mode", "fc"], "A3", id="flags4-A3")])
def test_unported_flags_exit_naming_their_item(flags, item, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["predict", "--cpu", "-i", "none.csv", "-o", str(tmp_path)] + flags)
    assert e.value.code != 0 and f"ROADMAP {item}" in str(e.value.code)
    assert not os.listdir(tmp_path)  # refused before any work


def test_unknown_config_option_is_refused(tmp_path):
    jobs = _write_jobs(tmp_path / "jobs.csv", ("3mhw",))
    os.makedirs(tmp_path / "prep_cache")
    for ext in (".npz", ".rec.pkl"):
        shutil.copy(os.path.join(PREP, f"3mhw_r12{ext}"), tmp_path / "prep_cache")
    with pytest.raises(SystemExit, match="use_pallas"):
        cli.main(["predict", "--cpu", "-i", jobs, "-o", str(tmp_path), "--cfg-options",
                  "score_net.use_pallas=True"])


def test_cache_miss_and_unusable_records_are_failures(tmp_path):
    """A job without a cache entry, and one whose record carries conformers
    (which the port cannot dock from: ROADMAP A14), are prepared again from
    their raw files; neither job has a pocket definition, so both are
    Failures at stage 'pocket', and write_failures lists them. The third,
    a JAX-written entry, is served."""
    import pickle

    for ext in (".npz", ".rec.pkl"):
        shutil.copy(os.path.join(PREP, f"3mhw_r12{ext}"), tmp_path)
    shutil.copy(os.path.join(PREP, "3dbs_r12.npz"), tmp_path)
    with open(os.path.join(PREP, "3dbs_r12.rec.pkl"), "rb") as fh:
        rec = pickle.load(fh)
    rec["conformers"] = np.zeros((2, rec["lig"].num_atoms, 3), np.float32)
    with open(tmp_path / "3dbs_r12.rec.pkl", "wb") as fh:
        pickle.dump(rec, fh)
    jobs = TJ.load_jobs_csv(_write_jobs(tmp_path / "jobs.csv", ("3dbs", "3mhw", "2zec")))
    prepared, failures = TP.prep(jobs, 12.0, cache_dir=str(tmp_path), verbose=False)
    assert [p.name for p in prepared] == ["3mhw"]
    assert prepared[0].job is jobs[1] and prepared[0].protein.num_res == 246
    assert [(f.complex_name, f.stage) for f in failures] == [("3dbs", "pocket"),
                                                            ("2zec", "pocket")]
    assert all("no pocket definition" in f.error for f in failures)
    TP.write_failures(str(tmp_path), failures)
    with open(tmp_path / "failed.csv", newline="") as fh:
        assert [r["complex_name"] for r in csv.DictReader(fh)] == ["3dbs", "2zec"]


def _job_tuples(jobs):
    return [(j.protein, j.protein_name, j.ligand, j.ligand_name, j.complex_name,
             j.crystal_ligand, j.center, j.holo_protein) for j in jobs]


def test_job_tables_match_jax(tmp_path):
    """load_jobs_csv (with centres, crystal ligands, defaults), save_jobs_csv,
    make_jobs (pocket discovery beside the receptor) and job_slice equal the
    JAX package's."""
    rec_dir = tmp_path / "rec"
    os.makedirs(rec_dir)
    for n in ("3dbs", "3mhw"):
        shutil.copy(os.path.join(ROOT, f"runs/pb_bench/{n}/{n}_protein_contact_chains.pdb"),
                    rec_dir / f"{n}.pdb")
    shutil.copy(os.path.join(ROOT, "runs/pb_bench/3dbs/3dbs_ligand.sdf"),
                rec_dir / "3dbs_crystal.sdf")
    with open(rec_dir / "3mhw_box.csv", "w") as fh:
        fh.write("x,y,z\n1.5,-2,3.25\n")
    ligs = [os.path.join(ROOT, f"runs/pb_bench/{n}/{n}_ligand.sdf") for n in ("2src", "3pp0")]
    got, want = TJ.make_jobs(ligs, str(rec_dir)), JJ.make_jobs(ligs, str(rec_dir))
    assert _job_tuples(got) == _job_tuples(want) and len(got) == 4
    assert got[0].pocket_ref()[0] == "crystal"
    assert got[2].pocket_ref() == ("center", (1.5, -2.0, 3.25))
    TJ.save_jobs_csv(str(tmp_path / "t.csv"), got)
    JJ.save_jobs_csv(str(tmp_path / "j.csv"), want)
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()
    with open(tmp_path / "mixed.csv", "w") as fh:
        fh.write("protein,ligand,center,holo_protein\na/p.pdb,b/l.sdf,\"1,2,3\",h.pdb\n"
                 "a/q.pdb,b/m.sdf,,\n")
    for path in (tmp_path / "t.csv", tmp_path / "mixed.csv"):
        got, want = TJ.load_jobs_csv(str(path)), JJ.load_jobs_csv(str(path))
        assert _job_tuples(got) == _job_tuples(want)
    for args in ((0, None, 1), (1, 3, 1), (0, None, 2), (2, 99, 1)):
        assert (_job_tuples(TJ.job_slice(got * 3, *args))
                == _job_tuples(JJ.job_slice(want * 3, *args)))


def test_expand_ligand_library_sanitises_titles(tmp_path):
    """Library records titled with '/' and '..' get safe complex names (no
    path separator, never a name of dots), the others keep the JAX
    package's names, and each record is addressed as path#i."""
    from diffbindfr_torch.io.sdf import parse_sdf, to_sdf_block

    mol = parse_sdf(os.path.join(ROOT, "runs/pb_bench/3mhw/3mhw_ligand.sdf"))[0]
    titles = ["../../etc/x", "..", "ok_name", "a b/c", "ok_name"]
    lib = tmp_path / "lib.sdf"
    with open(lib, "w") as fh:
        for t in titles:
            mol.name = t
            fh.write(to_sdf_block(mol))
    base = TJ.Job(protein="p.pdb", protein_name="rec", ligand=str(lib), ligand_name="lib",
                  complex_name="rec_lib")
    out = TJ.expand_ligand_library([base])
    assert [j.ligand for j in out] == [f"{lib}#{i}" for i in range(5)]
    assert [j.complex_name for j in out] == [
        "rec_.._.._etc_x", "rec_lib_1", "rec_ok_name", "rec_a_b_c", "rec_ok_name_1"]
    assert all("/" not in j.complex_name and "/" not in j.ligand_name for j in out)
    jout = JJ.expand_ligand_library([JJ.Job(**{k: getattr(base, k) for k in (
        "protein", "protein_name", "ligand", "ligand_name", "complex_name")})])
    assert [j.complex_name for j in jout][2] == "rec_ok_name"  # clean titles agree
    single = TJ.Job("p.pdb", "rec", os.path.join(ROOT, "runs/pb_bench/3mhw/3mhw_ligand.sdf"),
                    "l", "c")
    assert TJ.expand_ligand_library([single]) == [single]
