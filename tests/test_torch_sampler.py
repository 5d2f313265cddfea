"""Sampler and dock stage of the PyTorch port against the JAX package, plus
the port's package-level contracts (no JAX imports, CUDA by default).

The two frameworks' random streams differ, so the JAX key splits of
sampler.py (:101 prior keys, :163-165 init_pose draws, :188 per-step noise)
are replayed here and the draws handed to the port as a SamplerNoise.
Small config (ns=8, nv=4, 2 layers), JAX init_params weights, 3 steps on
the 3dbs prep-cache sample. Tolerance: f32 dynamics over 3 steps ->
atol 1e-3 A on coordinates and 1e-3 rad on chi.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu import sampler as JSP
from diffbindfr_tpu.app.pipeline import _load_sample_npz as jload
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_torch import sampler as TSP
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.data.sample import stack_samples, to_device
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.utils.checkpoint import params_from_numpy

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
STEPS, BSZ = 3, 2


def _replay_noise(key, s, cfg):
    """The draws of diffbindfr_tpu.sampler.sample(init=None) for a batch of
    BSZ copies of s, as numpy arrays in SamplerNoise order."""
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


@pytest.fixture(scope="module")
def setup():
    s = jload(SAMPLE)
    jcfg = jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2, dropout=0.0)
    tcfg = tsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
    jp = jsn.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jscfg = JSP.SamplerConfig(actual_steps=STEPS)
    tscfg = TSP.SamplerConfig(actual_steps=STEPS)
    key = jax.random.PRNGKey(5)
    jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * BSZ)), s)
    tb = to_device(stack_samples([s] * BSZ), "cpu")
    return s, jcfg, tcfg, jp, tp, jscfg, tscfg, key, jb, tb, _replay_noise(key, s, jscfg)


def test_init_pose_matches_replayed_prior(setup):
    s, _, _, _, _, jscfg, tscfg, key, jb, tb, noise = setup
    keys = jax.random.split(key, BSZ + 1)
    want = jax.vmap(lambda k, s_: JSP.init_pose(k, s_, jscfg))(keys[1:], jb)
    got = TSP.init_pose(tb, tscfg, noise)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_sampler_matches_jax_with_injected_noise(setup):
    s, jcfg, tcfg, jp, tp, jscfg, tscfg, key, jb, tb, noise = setup
    want = jax.jit(lambda p, b, k: JSP.sample(p, jcfg, jscfg, b, k))(jp, jb, key)
    with torch.no_grad():
        got = TSP.sample(tp, tcfg, tscfg, tb, noise, use_kernels=True)
    np.testing.assert_allclose(got.lig_pos.numpy(), np.asarray(want.lig_pos), atol=1e-3)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(want.chi), atol=1e-3)
    np.testing.assert_allclose(got.atom14_pos.numpy(), np.asarray(want.atom14_pos), atol=1e-3)


def test_dock_engine_replays_its_noise_and_saves_poses(setup, tmp_path):
    s, _, tcfg, _, tp, _, _, _, _, _, _ = setup
    scfg = TSP.SamplerConfig(actual_steps=2)
    pair = TP.PreparedPair.from_prep_cache(SAMPLE)
    assert pair.name == "3dbs_r12" and pair.bucket.n_atm == 1024
    res = TP.dock([pair], tp, tcfg, scfg, num_poses=3, batch_size=2, seed=4, device="cpu",
                  verbose=False)
    assert [(r.pair_idx, r.pose_idx) for r in res] == [(0, 0), (0, 1), (0, 2)]
    assert all(np.isfinite(r.lig_pos).all() and np.isfinite(r.atom14_pos).all() for r in res)
    # the engine's documented noise contract: one generator seeded with `seed`,
    # batches in order, padding replicas included
    gen = torch.Generator().manual_seed(4)
    batch = to_device(stack_samples([s] * 2), "cpu")
    with torch.no_grad():
        again = TSP.sample(tp, tcfg, scfg, batch, TSP.draw_noise(batch, scfg, gen))
    np.testing.assert_allclose(again.lig_pos[1].numpy(), res[1].lig_pos, atol=1e-6)
    path = TP.save_poses(str(tmp_path), [pair], res)
    data = np.load(path)
    assert data["3dbs_r12|lig_pos"].shape == (3, 128, 3)
    np.testing.assert_array_equal(data["3dbs_r12|pose_idx"], [0, 1, 2])


def test_dock_engine_fused_layer_mode_gives_the_cmt_poses(setup):
    """The whole-layer configuration (B10's plain version here) docks the
    same poses as the default one on the same noise: 2 steps, atol 1e-5 A."""
    s, _, tcfg, _, tp, _, _, _, _, _, _ = setup
    scfg = TSP.SamplerConfig(actual_steps=2)
    pair = TP.PreparedPair.from_prep_cache(SAMPLE)
    poses = {}
    for name, cfg in (("cmt", tcfg), ("layer", dataclasses.replace(
            tcfg, pallas_layout="rowmajor", fused_layer=True))):
        eng = TP.DockEngine(tp, cfg, scfg, batch_size=2, device="cpu", verbose=False)
        assert eng.net_cfg is cfg
        poses[name] = eng.run([pair], num_poses=2, seed=6)
    for a, b in zip(poses["cmt"], poses["layer"]):
        np.testing.assert_allclose(b.lig_pos, a.lig_pos, atol=1e-5)
        np.testing.assert_allclose(b.atom14_pos, a.atom14_pos, atol=1e-5)
        np.testing.assert_allclose(b.chi, a.chi, atol=1e-5)


def test_import_loads_no_jax():
    code = ("import sys, diffbindfr_torch, diffbindfr_torch.app.pipeline, "
            "diffbindfr_torch.nn.trunk_convs, diffbindfr_torch.utils.cuda_build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'diffbindfr_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_sources_never_import_jax():
    pkg = os.path.join(ROOT, "diffbindfr_torch")
    for files in ([os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
                   if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]):
        with open(files) as fh:
            src = fh.read()
        for bad in ("import jax", "from jax", "diffbindfr_tpu import", "from diffbindfr_tpu"):
            assert bad not in src, (files, bad)


def test_entry_points_default_to_cuda_and_raise_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, _, tcfg, _, tp, _, _, _, _, _, _ = setup
    pair = TP.PreparedPair.from_prep_cache(SAMPLE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.dock([pair], tp, tcfg, TSP.SamplerConfig(), num_poses=1, batch_size=1)
    from diffbindfr_torch.utils.checkpoint import load_checkpoint

    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(os.path.join(ROOT, "runs/diff_r2/ckpt_best.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
