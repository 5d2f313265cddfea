"""MDN scoring of the PyTorch port (diffbindfr_torch/models/mdn_scorer.py,
app/pipeline.py MDNEngine) against the JAX package's
diffbindfr_tpu/models/mdn_scorer.py on the same inputs.

Small config (hidden 16, 2 GVP and 2 transformer layers) with JAX
init_params weights carried across by `params_from_jax`, both branches of
the pair normalisation (LayerNorm; `pair_norm`, the folded BatchNorm of
imported weights), on the 3dbs and 2zec prep-cache samples with seeded
perturbed crystal poses and one pose moved out of the pocket. Full width:
runs/mdn_r4b EMA weights on the EC fixture's poses before and after EC,
against tests/fixtures/torch_mdn_ref.npz. Tolerances: summed probability
and mean NLL 1e-4 relative (f32 sums in another order); the no-contact pose
gives NO_CONTACT_NLL exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app.pipeline import _load_sample_npz as jload
from diffbindfr_tpu.models import mdn_scorer as jmdn
from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.data.sample import stack_samples, to_device
from diffbindfr_torch.models import mdn_scorer as tmdn
from diffbindfr_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
EC_FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_ec_ref.npz")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_mdn_ref.npz")
FIX_NAMES = ("3dbs", "3mhw")
SMALL = jmdn.MDNConfig(hidden=16, pro_vector_hidden=4, gvp_layers=2, gt_layers=2,
                       gt_heads=4, n_gaussians=4)


def _pos14(name, n_res):
    """The pocket's atom14 positions (pocket frame) padded to the bucket."""
    pocket = load_prep_record(os.path.join(PREP, f"{name}_r12.rec.pkl"))["pocket"]
    pos14 = np.zeros((n_res, 14, 3), np.float32)
    pos14[: pocket.num_res] = pocket.atom14_pos * pocket.atom14_mask[..., None]
    return pos14


def _small_inputs():
    """3dbs and 2zec samples, 2 perturbed crystal poses each and one 3dbs
    pose moved 40 A out of the pocket (no contact)."""
    samples, poses, p14 = [], [], []
    rng = np.random.default_rng(7)
    for name, shifts in (("3dbs", (0.0, 0.0, 40.0)), ("2zec", (0.0, 0.0))):
        s = jload(os.path.join(PREP, f"{name}_r12.npz"))
        pos14 = _pos14(name, s.aatype.shape[0])
        for sh in shifts:
            m = s.lig_mask[:, None]
            noise = rng.normal(scale=0.5, size=s.lig_pos.shape).astype(np.float32)
            poses.append(((s.lig_pos + noise + sh) * m).astype(np.float32))
            samples.append(s)
            p14.append(pos14)
    return samples, np.stack(poses), np.stack(p14)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


@pytest.mark.parametrize("branch", ["layer_norm", "pair_norm"])
def test_small_config_matches_jax(branch):
    """score_batch_both at the small config, both normalisation branches:
    sum_prob and mean_nll within 1e-4 relative; the pose out of the pocket
    gets NO_CONTACT_NLL exactly and a summed probability of 0."""
    jp = jmdn.init_params(jax.random.PRNGKey(0), SMALL)
    jp = jax.tree.map(np.asarray, jp)
    if branch == "pair_norm":
        rng = np.random.default_rng(1)
        jp["pair_norm"] = {"scale": rng.uniform(0.5, 1.5, SMALL.hidden).astype(np.float32),
                           "shift": rng.normal(scale=0.1, size=SMALL.hidden).astype(np.float32)}
    samples, poses, p14 = _small_inputs()
    jb = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *samples)
    jsum, jnll = jax.jit(lambda p, b, lp, a: jmdn.score_batch_both(p, SMALL, b, lp, a))(
        jax.tree.map(jnp.asarray, jp), jb, jnp.asarray(poses), jnp.asarray(p14))
    jsum, jnll = np.asarray(jsum), np.asarray(jnll)
    tp = tmdn.params_from_jax(jp, device="cpu")
    tcfg = tmdn.MDNConfig(**{f: getattr(SMALL, f) for f in SMALL.__dataclass_fields__})
    tb = to_device(stack_samples([TP._load_sample_npz(os.path.join(PREP, f"{n}_r12.npz"))
                                  for n in ("3dbs", "3dbs", "3dbs", "2zec", "2zec")]), "cpu")
    with torch.no_grad():
        tsum, tnll = tmdn.score_batch_both(tp, tcfg, tb, torch.from_numpy(poses),
                                           torch.from_numpy(p14))
    tsum, tnll = tsum.numpy(), tnll.numpy()
    print(f"{branch}: sum_prob {tsum} vs {jsum}; mean_nll {tnll} vs {jnll}")
    real = [0, 1, 3, 4]
    assert (jsum[real] > 0).all()
    assert _rel(tsum[real], jsum[real]).max() <= 1e-4
    assert _rel(tnll[real], jnll[real]).max() <= 1e-4
    assert jnll[2] == tmdn.NO_CONTACT_NLL and tnll[2] == tmdn.NO_CONTACT_NLL
    assert jsum[2] == 0.0 and tsum[2] == 0.0
    # one pose at a time gives the batch's numbers
    s0 = type(tb)(*[v[0] for v in tb])
    with torch.no_grad():
        one = tmdn.score_sample_both(tp, tcfg, s0, torch.from_numpy(poses[0]),
                                     torch.from_numpy(p14[0]))
    np.testing.assert_allclose([float(one[0]), float(one[1])], [tsum[0], tnll[0]], rtol=1e-6)


def test_protein_graph_features_match_jax():
    """Node and edge features of the knn-30 CA graph (3dbs, padded residues
    included): neighbour indices and mask equal, features within 1e-5."""
    s = jload(os.path.join(PREP, "3dbs_r12.npz"))
    pos14 = _pos14("3dbs", s.aatype.shape[0])
    want = jmdn.protein_graph_features(jnp.asarray(s.aatype), jnp.asarray(pos14),
                                       jnp.asarray(s.atom14_mask), jnp.asarray(s.res_mask),
                                       30, 16)
    got = tmdn.protein_graph_features(torch.from_numpy(s.aatype[None]).long(),
                                      torch.from_numpy(pos14[None]),
                                      torch.from_numpy(s.atom14_mask[None]),
                                      torch.from_numpy(s.res_mask[None]), 30, 16)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[0].numpy(), np.asarray(w)
        if i in (2, 3):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5)


def _fixture_results(prepared, ec):
    """PoseResults of the EC fixture's poses: before EC, then after."""
    out = []
    for stage in ("pose0", "ec_pos"):
        rs = []
        for i, (n, pair) in enumerate(zip(FIX_NAMES, prepared)):
            a14 = _pos14(n, pair.sample.aatype.shape[0])
            for k, lp in enumerate(ec[f"{n}|{stage}"]):
                rs.append(TP.PoseResult(i, k, lp, a14, np.zeros(1)))
        out.append(rs)
    return out


def test_mdn_engine_matches_fixture():
    """The port's MDNEngine on the CPU with runs/mdn_r4b weights, on the EC
    fixture's poses before and after EC, against the JAX score_batch_both
    stored in tests/fixtures/torch_mdn_ref.npz: 1e-4 relative; the change
    that EC makes to the scores printed as the control."""
    ref, ec = np.load(FIXTURE), np.load(EC_FIXTURE)
    prepared = [TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{n}_r12.npz"))
                for n in FIX_NAMES]
    params, _ = load_checkpoint(MDN_CKPT, use_ema=True, device="cpu")
    for stage, rs in zip(("before", "after"), _fixture_results(prepared, ec)):
        TP.score_mdn(prepared, rs, params, tmdn.MDNConfig(), batch_size=4, device="cpu",
                     verbose=False)
        for i, n in enumerate(FIX_NAMES):
            got_s = np.array([r.mdn_score for r in rs if r.pair_idx == i])
            got_n = np.array([r.mdn_nll for r in rs if r.pair_idx == i])
            ws, wn = ref[f"{n}|{stage}|sum_prob"], ref[f"{n}|{stage}|mean_nll"]
            print(f"{n} {stage}: sum_prob rel {_rel(got_s, ws).max():.2e}, mean_nll rel "
                  f"{_rel(got_n, wn).max():.2e}; EC changed sum_prob by up to "
                  f"{_rel(ref[f'{n}|after|sum_prob'], ref[f'{n}|before|sum_prob']).max():.2e}")
            assert _rel(got_s, ws).max() <= 1e-4, (n, stage)
            assert _rel(got_n, wn).max() <= 1e-4, (n, stage)


@pytest.mark.slow
def test_write_mdn_fixture():
    """Regenerates tests/fixtures/torch_mdn_ref.npz from the JAX package on
    the CPU: runs/mdn_r4b EMA weights, score_batch_both on the EC fixture's
    poses before and after EC (3dbs and 3mhw at their buckets)."""
    params, _ = jax_load_checkpoint(MDN_CKPT, use_ema=True)
    params = jax.tree.map(jnp.asarray, params)
    cfg = jmdn.MDNConfig()
    ec = np.load(EC_FIXTURE)
    fn = jax.jit(lambda p, b, lp, a: jmdn.score_batch_both(p, cfg, b, lp, a))
    out = {}
    for n in FIX_NAMES:
        s = jload(os.path.join(PREP, f"{n}_r12.npz"))
        pos14 = _pos14(n, s.aatype.shape[0])
        P = ec[n + "|pose0"].shape[0]
        b = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * P)), s)
        for stage, key in (("before", "pose0"), ("after", "ec_pos")):
            sp_, nll = fn(params, b, jnp.asarray(ec[f"{n}|{key}"]),
                          jnp.asarray(np.stack([pos14] * P)))
            out[f"{n}|{stage}|sum_prob"] = np.asarray(sp_, np.float32)
            out[f"{n}|{stage}|mean_nll"] = np.asarray(nll, np.float32)
    np.savez_compressed(FIXTURE, **out)
    assert all(np.isfinite(v).all() for v in np.load(FIXTURE).values())
