"""KarmaDock of the port (diffbindfr_torch/models/karmadock.py) against the
JAX package's model (diffbindfr_tpu/models/karmadock.py) on the CPU.

The small config of tests/test_karmadock.py (hidden 32, one GVP and one
graph-transformer layer, two EGNN layers), JAX init_params weights carried
by params_from_jax, two synthetic samples (tests/test_mdn_scorer.py's
_sample) batched in the port and run one by one by JAX (one compile): the
refined pose, the MDN score and the side-chain (sin, cos) pairs within 1e-4
of max|ref|. As the JAX test checks: padded ligand atoms do not move, the
pairs are unit vectors, the refined pose rotates with the input frame
(3e-3 A) and the score does not (2e-3 relative).
"""
import jax
import numpy as np
import pytest
import torch
from test_mdn_scorer import _sample

from diffbindfr_tpu.models import karmadock as JKD
from diffbindfr_tpu.models import mdn_scorer as JMDN
from diffbindfr_torch.data.sample import stack_samples, to_device
from diffbindfr_torch.models import karmadock as TKD
from diffbindfr_torch.models import mdn_scorer as TMDN

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

JCFG = JKD.KarmaDockConfig(
    mdn=JMDN.MDNConfig(hidden=32, gvp_layers=1, gt_layers=1, pro_vector_hidden=4),
    egnn_layers=2)
TCFG = TKD.KarmaDockConfig(
    mdn=TMDN.MDNConfig(hidden=32, gvp_layers=1, gt_layers=1, pro_vector_hidden=4),
    egnn_layers=2)
FIELDS = ("lig_pos", "mdn_score", "chi_sincos")


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, [(sample, lig_pos, pos14)] numpy, JAX
    outputs per sample)."""
    jp = JKD.init_params(jax.random.PRNGKey(0), JCFG)
    tp = TKD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    samples = [jax.tree.map(np.asarray, _sample(seed)) for seed in (0, 1)]
    fn = jax.jit(lambda p, s, lp, p14: JKD.apply(p, JCFG, s, lp, p14))
    outs = [jax.tree.map(np.asarray, fn(jp, *x)) for x in samples]
    return jp, tp, samples, outs, fn


def _port(tp, samples, rot=None):
    s = to_device(stack_samples([x[0] for x in samples]), "cpu")
    lig = torch.from_numpy(np.stack([x[1] for x in samples]))
    p14 = torch.from_numpy(np.stack([x[2] for x in samples]))
    if rot is not None:
        r = torch.from_numpy(rot)
        lig = (lig @ r.T) * s.lig_mask[..., None]
        p14 = (p14 @ r.T) * s.atom14_mask[..., None]
    with torch.no_grad():
        return TKD.apply(tp, TCFG, s, lig, p14)


def test_apply_matches_jax(model):
    _, tp, samples, outs, _ = model
    got = _port(tp, samples)
    for f in FIELDS:
        want = np.stack([np.asarray(getattr(o, f)) for o in outs])
        g = getattr(got, f).numpy()
        assert g.shape == want.shape, f
        err = np.abs(g - want).max() / np.abs(want).max()
        print(f"{f}: {err:.2e} of max|ref|")
        assert err <= 1e-4, f
    for (s, lig_pos, _), pos in zip(samples, got.lig_pos.numpy()):
        pad = s.lig_mask == 0
        np.testing.assert_array_equal(pos[pad], lig_pos[pad])
    np.testing.assert_allclose(np.linalg.norm(got.chi_sincos.numpy(), axis=-1), 1.0, atol=5e-4)


def test_pose_equivariance(model):
    _, tp, samples, _, _ = model
    rot = _rotation(1)
    out0, out_r = _port(tp, samples), _port(tp, samples, rot)
    for b, (s, _, _) in enumerate(samples):
        m = s.lig_mask > 0
        np.testing.assert_allclose(out_r.lig_pos[b].numpy()[m],
                                   (out0.lig_pos[b].numpy() @ rot.T)[m], atol=3e-3)
    np.testing.assert_allclose(out_r.mdn_score.numpy(), out0.mdn_score.numpy(), rtol=2e-3)


def test_init_params_tree_matches_jax(model):
    """The port's init_params: the JAX tree's keys and shapes (less the
    gate's unused key leaf), xavier-uniform weights within their bound."""
    jp, tp, _, _, _ = model
    fresh = TKD.init_params(torch.Generator().manual_seed(0), TCFG)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(fresh) == shapes(tp)
    w = fresh["egnn"][0]["q"]["w"]
    assert float(w.abs().max()) <= np.sqrt(6.0 / 64) and float(w.std()) > 0
    assert "ln" in jp["node_gate"] and "ln" not in fresh["node_gate"]
