"""Score network: the PyTorch port against the JAX package.

Small config (ns=8, nv=4, 2 layers) with JAX `init_params` weights carried
across, the port's plain path and its kernel configurations (cmt, and the
row-major ones: plain, fused_epilogue, fused_layer) against JAX
use_pallas=False;
full width (diff_r2 EMA) against a stored JAX fixture. Tolerances: f32 vs f32
through ~20 layers of sums in another order -> max|err| <= 1e-4 * max|ref|
at the small config; 1e-3 of max|ref| at full width (the acceptance bound
of the card run; what the port reaches is printed by the fixture test).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app.pipeline import _load_sample_npz as jax_load_sample
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.utils.checkpoint import load_checkpoint, params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
CKPT = os.path.join(ROOT, "runs/diff_r2/ckpt_best.npz")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_port_ref.npz")
SCHED = {"tr_sigma_min": 0.1, "tr_sigma_max": 6.0, "rot_sigma_min": 0.03,
         "rot_sigma_max": 1.55, "tor_sigma_min": 0.0314, "tor_sigma_max": 3.14,
         "sc_tor_sigma_min": 0.0314, "sc_tor_sigma_max": 3.14}
FIELDS = ("tr", "rot", "tor", "sc_tor")
# fixed forward state of the full-width fixture: the prep-cache (crystal)
# pose, shifted so the cross cutoff cuts through the pocket, at this t
FIX_T = 0.45
FIX_SHIFT = np.array([0.8, -0.5, 0.3], np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _fixture_sample(s):
    return s._replace(lig_pos=(s.lig_pos + FIX_SHIFT) * s.lig_mask[:, None])


@pytest.fixture(scope="module")
def small():
    jcfg = jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2, dropout=0.0)
    tcfg = tsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
    jp = jsn.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    s = jax_load_sample(SAMPLE)
    # two replicas: the crystal pose and a shifted, rotated copy
    s2 = s._replace(lig_pos=((s.lig_pos + rng.normal(size=3).astype(np.float32) * 2.0)
                             * s.lig_mask[:, None]).astype(np.float32))
    t = np.array([0.7, 0.25], np.float32)
    jb = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), s, s2)
    jsig = jsn.sigmas_from_t(jnp.asarray(t), SCHED)
    jo = jax.jit(lambda p, b, t_, sg: jsn.apply_batched(p, jcfg, b, t_, sg))(
        jp, jb, jnp.asarray(t), jsig)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tb = to_device(stack_samples([s, s2]), "cpu")
    tt = torch.from_numpy(t)
    return tcfg, tp, tb, tt, jo


# the kernel configurations of the port (use_kernels=True: ScoreNetConfig's
# kernel fields) and its plain path, each against the JAX XLA path
MODES = {"True": {}, "False": None, "rowmajor": dict(pallas_layout="rowmajor"),
         "rowmajor+fused_epilogue": dict(pallas_layout="rowmajor", fused_epilogue=True),
         "rowmajor+fused_layer": dict(pallas_layout="rowmajor", fused_layer=True)}


@pytest.mark.parametrize("use_kernels", list(MODES))
def test_small_config_matches_jax(small, use_kernels):
    tcfg, tp, tb, tt, jo = small
    fields = MODES[use_kernels]
    cfg = tcfg if fields is None else dataclasses.replace(tcfg, **fields)
    with torch.no_grad():
        out = tsn.apply(tp, cfg, tb, tt, tsn.sigmas_from_t(tt, SCHED),
                        use_kernels=fields is not None)
    for f in FIELDS:
        got = getattr(out, f).numpy()
        assert np.isfinite(got).all()
        assert _rel(got, np.asarray(getattr(jo, f))) <= 1e-4, f


def test_full_width_plain_path_matches_jax_fixture():
    ref = np.load(FIXTURE)
    params, _ = load_checkpoint(CKPT, use_ema=True, device="cpu")
    s = _fixture_sample(_load_sample_npz(SAMPLE))
    batch = to_device(stack_samples([s]), "cpu")
    t = torch.tensor([FIX_T], dtype=torch.float32)
    with torch.no_grad():
        out = tsn.apply(params, tsn.ScoreNetConfig(), batch, t, tsn.sigmas_from_t(t, SCHED),
                        use_kernels=True)
    for f in FIELDS:
        got = getattr(out, f)[0].numpy()
        err = _rel(got, ref[f])
        print(f"full width {f}: max|err|/max|ref| = {err:.3e}")
        assert err <= 1e-3, f


@pytest.mark.slow
def test_write_full_width_fixture():
    """Regenerates tests/fixtures/torch_port_ref.npz from the JAX package
    (XLA path, CPU): diff_r2 EMA on 3dbs at t = FIX_T, B = 1."""
    params, _ = jax_load_checkpoint(CKPT, use_ema=True)
    cfg = jsn.ScoreNetConfig()
    s = _fixture_sample(jax_load_sample(SAMPLE))
    t = jnp.float32(FIX_T)
    out = jax.jit(lambda p, s_, t_: jsn.apply(p, cfg, s_, t_, jsn.sigmas_from_t(t_, SCHED)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, s), t)
    np.savez_compressed(FIXTURE, t=np.float32(FIX_T), shift=FIX_SHIFT,
                        **{f: np.asarray(getattr(out, f), np.float32) for f in FIELDS})
    assert all(np.isfinite(np.load(FIXTURE)[f]).all() for f in FIELDS)


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def test_small_config_is_se3_equivariant(small):
    """Rotating and translating the whole complex rotates tr/rot and leaves
    the torsion scores unchanged (f32 -> atol 1e-4 at outputs of order 1)."""
    tcfg, tp, tb, tt, _ = small
    R = torch.from_numpy(_rotation(3))
    shift = torch.tensor([1.5, -2.0, 0.5])
    moved = tb._replace(lig_pos=(tb.lig_pos @ R.T + shift) * tb.lig_mask[..., None],
                        atm_pos=(tb.atm_pos @ R.T + shift) * tb.atm_mask[..., None])
    sig = tsn.sigmas_from_t(tt, SCHED)
    with torch.no_grad():
        a = tsn.apply(tp, tcfg, tb, tt, sig, use_kernels=True)
        b = tsn.apply(tp, tcfg, moved, tt, sig, use_kernels=True)
    np.testing.assert_allclose(b.tr.numpy(), (a.tr @ R.T).numpy(), atol=1e-4)
    np.testing.assert_allclose(b.rot.numpy(), (a.rot @ R.T).numpy(), atol=1e-4)
    np.testing.assert_allclose(b.tor.numpy(), a.tor.numpy(), atol=1e-4)
    np.testing.assert_allclose(b.sc_tor.numpy(), a.sc_tor.numpy(), atol=1e-4)


def test_small_config_is_padding_invariant(small):
    """The same pair in a smaller ligand bucket (64 atoms, 160 edges, 24
    torsions instead of 128/288/48) gives the same scores: padded rows leak
    into no sum (the kernel plain versions skip them)."""
    tcfg, tp, tb, tt, _ = small
    cut = {"lig_feat": (64,), "lig_pos": (64,), "lig_ref_pos": (64,), "lig_mask": (64,),
           "lig_e_src": (160,), "lig_e_dst": (160,), "lig_e_feat": (160,),
           "lig_e_mask": (160,), "tor_src": (24,), "tor_dst": (24,), "tor_mask": (24,),
           "rot_node_mask": (24, 64)}
    small_b = tb._replace(**{k: getattr(tb, k)[(slice(None),) + tuple(slice(n) for n in v)]
                             for k, v in cut.items()})
    assert float(tb.lig_mask[:, 64:].sum()) == 0 and float(tb.tor_mask[:, 24:].sum()) == 0
    sig = tsn.sigmas_from_t(tt, SCHED)
    with torch.no_grad():
        a = tsn.apply(tp, tcfg, tb, tt, sig, use_kernels=True)
        b = tsn.apply(tp, tcfg, small_b, tt, sig, use_kernels=True)
    for f in ("tr", "rot", "sc_tor"):
        np.testing.assert_allclose(getattr(b, f).numpy(), getattr(a, f).numpy(), atol=1e-5)
    np.testing.assert_allclose(b.tor.numpy(), a.tor[:, :24].numpy(), atol=1e-5)
