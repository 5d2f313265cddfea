"""MDN scorer training of the port (models/mdn_scorer.py `mdn_loss`,
diffbindfr_torch/mdn_train.py, `train_cli --model mdn`) against the JAX
package (diffbindfr_tpu/models/mdn_scorer.py, mdn_train.py, app/train_cli.py).

Inputs: the runs/mdn_r4b scorer (its `params/` tree, what `--resume` loads),
the tracked prep caches, and a pose set that chip_smoke.scorer_pose_set makes
with a numpy seed from the tracked prep records (self-dock 2zec and 3mhw,
L-RMSD 0.5-6 A, and one cross-dock entry, 3mhw's ligand in 2zec's pocket,
in 2zec's bucket).
Tolerances (f32 on both sides, sums in another order): losses and metrics
1e-5 relative; every parameter gradient within 1e-4 * max|ref| of JAX's,
but for the key and edge-bias biases of the graph transformer (`k/b`,
`eb/b`), whose gradient is 0 in exact arithmetic (a softmax ignores a shift
of its logits): both sides return rounding noise there, held below 1e-5 of
the largest gradient entry;
pose batches equal (the draws bit for bit; the rebuilt crystal atom14 within
1e-4 A); the CLI's per-step losses within 1e-4 relative of a JAX `train_cli
--model mdn --cpu` run stored in tests/fixtures/torch_mdn_train_ref.npz by
the `slow` writer below (no JAX randomness enters that path, so both runs
see the same batches).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu import mdn_train as JMT
from diffbindfr_tpu.app.pipeline import _load_sample_npz as jload
from diffbindfr_tpu.models import mdn_scorer as jmdn
from diffbindfr_tpu.sampler import _rebuild_atom14 as j_rebuild
from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffbindfr_torch import mdn_train as TMT
from diffbindfr_torch import train as TTR
from diffbindfr_torch.app import train_cli
from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
from diffbindfr_torch.models import mdn_scorer as tmdn
from diffbindfr_torch.sampler import _rebuild_atom14
from diffbindfr_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (scorer_pose_set, shared with the card run)

PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
PB = os.path.join(ROOT, "runs/pb_bench")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_mdn_train_ref.npz")
CFG = tmdn.MDNConfig()
# the CLI runs of the fixture: (name, extra argv); `{jobs}` / `{poses}` are
# filled with the tmp job table / pose set
CLI_RUNS = {"crystal": ["-i", "{jobs}"], "pose": ["--pose-dir", "{poses}"]}
CLI_COMMON = ["--model", "mdn", "--resume", MDN_CKPT, "--steps", "3", "--warmup", "2", "-bs", "2",
              "--log-every", "1", "--seed", "3"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _like(tree, template):
    """`tree`'s leaves in `template`'s key order (JAX sorts dict keys)."""
    if isinstance(template, dict):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_like(a, b) for a, b in zip(tree, template)]
    return tree


@pytest.fixture(scope="module")
def params():
    """(JAX tree, port tree) of runs/mdn_r4b's raw parameters."""
    jp, _ = jax_load_checkpoint(MDN_CKPT)
    tp, _ = load_checkpoint(MDN_CKPT, use_ema=False, device="cpu")
    return jax.tree.map(jnp.asarray, jp), tp


@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("poses"))
    chip_smoke.scorer_pose_set(np, out)
    return out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}#{i}/")]
    return [prefix[:-1]]


def _grads_match(tp, tgrads, jgrads, tol):
    want = TTR.tree_leaves(_like(jax.tree.map(np.asarray, jgrads), tp))
    assert len(want) == len(tgrads)
    top = max(np.abs(w).max() for w in want)
    errs = {}
    for path, g, w in zip(_paths(tp), tgrads, want):
        if path.endswith(("/k/b", "/eb/b")):  # 0 in exact arithmetic
            assert max(np.abs(w).max(), float(g.abs().max())) <= 1e-5 * top, path
        else:
            errs[path] = _rel(g.numpy(), w)
    worst = max(errs, key=errs.get)
    print(f"gradients: worst max|err|/max|ref| {errs[worst]:.2e} ({worst}) over "
          f"{len(errs)} tensors")
    assert errs[worst] <= tol


def test_mdn_loss_and_gradients_match_jax(params):
    """mdn_loss on 3mhw's crystal complex and a perturbed copy (B = 2):
    per-sample NLL within 1e-5 relative, every gradient of their mean within
    1e-4 * max|ref| of jax.grad of the JAX mdn_loss."""
    jp, tp = params
    s = jload(os.path.join(PREP, "3mhw_r12.npz"))
    moved = s._replace(lig_pos=((s.lig_pos + np.random.default_rng(2).normal(
        scale=0.7, size=s.lig_pos.shape)) * s.lig_mask[:, None]).astype(np.float32))
    samples = [s, moved]
    jb = jax.tree.map(jnp.asarray, stack_samples(samples))
    p14 = jax.vmap(lambda x: j_rebuild(x, x.torsion_angle[:, 1:]))(jb)

    def jloss(p):
        losses = jax.vmap(lambda x, a: jmdn.mdn_loss(p, jmdn.MDNConfig(), x, x.lig_pos, a))(
            jb, p14)
        return jnp.mean(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tb = to_device(stack_samples(samples), "cpu")
    leaves = [p.detach().requires_grad_(True) for p in TTR.tree_leaves(tp)]
    tl = tmdn.mdn_loss(TTR.tree_unflatten(tp, leaves), CFG, tb, tb.lig_pos,
                       torch.from_numpy(np.asarray(p14)))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5)
    _grads_match(tp, TTR.leaf_grads(tl.mean(), leaves), jg, 1e-4)


def test_pose_entries_and_batches_match_jax(pose_dir):
    """load_pose_entries and make_pose_batch on the same pose set: every
    entry field equal (the crystal atom14 within 1e-4 A), and from one
    default_rng seed the same draws: the batch tuple's arrays equal, over
    batches that hold self and cross entries, and the generators end in the
    same state."""
    je, te = JMT.load_pose_entries(pose_dir), TMT.load_pose_entries(pose_dir)
    assert [e.name for e in te] == [e.name for e in je] == ["2zec", "2zec__3mhw", "3mhw"]
    for a, b in zip(te, je):
        assert a.is_self == b.is_self and a.bucket.n_atm == b.bucket.n_atm
        np.testing.assert_allclose(a.crystal_a14, np.asarray(b.crystal_a14), atol=1e-4)
        for f in ("lig_pos", "a14", "rmsd"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a in te:  # the JAX rebuild's atom14, so both sides batch the same arrays
        a.crystal_a14 = np.asarray(je[te.index(a)].crystal_a14)
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    for idxs in ([0, 1, 0, 1], [2, 2], [1, 0]):
        tb = TMT.make_pose_batch(te, idxs, rt, ref_ema=1.5)
        jb = JMT.make_pose_batch(je, idxs, rj, ref_ema=1.5)
        for x, y in zip(tb[1:], jb[1:]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(tb[0], jb[0]):
            np.testing.assert_array_equal(x, y)
    assert rt.random() == rj.random()


def _toy_scorer(xp, rowsum):
    """Stand-ins of the scorer for the loss's composition: (mean scoring NLL
    of one pose, training NLL of one pose) from the parameters z_mu/b,
    z_sigma/b and the pose, smooth and cheap in both frameworks."""

    def score(p, s, lig, a14):
        w, v = p["z_mu"]["b"], p["z_sigma"]["b"]
        m = s.lig_mask
        return (w.sum() * rowsum(lig * lig * m[..., None]) / rowsum(m) + (v * v).sum()
                * xp.cos(rowsum(a14) / 1e3))

    def train_nll(p, s, lig, a14):
        return (p["z_mu"]["b"] * p["z_sigma"]["b"]).sum() * xp.sin(rowsum(lig) / 50.0)

    return score, train_nll


def test_pose_loss_matches_jax(monkeypatch, params, pose_dir):
    """make_pose_loss's composition (the crystal NLL, the three hinges with
    their weights and masks, the stop-gradient ref with the host EMA
    fallback, the metrics) against the JAX make_pose_loss, with the scorer
    replaced on both sides by the same cheap smooth function of a few
    parameters and the poses (the scorer's own parity is held by the tests
    above and by test_mdn_cli_matches_jax_fixture): on a self + cross batch
    and on a cross-only batch, every metric within 1e-5 relative and the
    gradients within 1e-5 * max|ref|."""
    jscore, jtrain = _toy_scorer(jnp, lambda x: jnp.sum(x))
    monkeypatch.setattr(jmdn, "score_sample_both",
                        lambda p, cfg, s, lig, a14: (0.0, jscore(p, s, lig, a14)))
    monkeypatch.setattr(jmdn, "mdn_loss", lambda p, cfg, s, lig, a14: jtrain(p, s, lig, a14))
    tscore, ttrain = _toy_scorer(torch, lambda x: x.reshape(x.shape[0], -1).sum(-1))
    monkeypatch.setattr(tmdn, "score_batch_both",
                        lambda p, cfg, s, lig, a14: (None, tscore(p, s, lig, a14)))
    monkeypatch.setattr(tmdn, "mdn_loss", lambda p, cfg, s, lig, a14: ttrain(p, s, lig, a14))
    jp, tp = params
    je = JMT.load_pose_entries(pose_dir)
    jloss = jax.jit(jax.value_and_grad(JMT.make_pose_loss(jmdn.MDNConfig()), has_aux=True))
    tloss = TMT.make_pose_loss(CFG)
    active = set()
    for idxs in ([0, 1, 0, 1], [1, 1, 1, 1]):
        batch = JMT.make_pose_batch(je, idxs, np.random.default_rng(9), ref_ema=30.0)
        (_, jm), jg = jloss(jp, jax.tree.map(jnp.asarray, batch))
        leaves = [p.detach().requires_grad_(True) for p in TTR.tree_leaves(tp)]
        loss, tm = tloss(TTR.tree_unflatten(tp, leaves), TMT.pose_batch_to_device(batch, "cpu"))
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
            active |= {k} if float(v) > 0 else set()
        _grads_match(tp, TTR.leaf_grads(loss, leaves), jg, 1e-5)
    assert float(jm["n_self"]) == 0  # the last batch took the EMA ref
    assert {"pair_hinge", "abs_hinge", "rank_hinge"} <= active


def _cli_inputs(tmp_path, pose_dir):
    jobs = tmp_path / "jobs.csv"
    rows = ["protein,protein_name,ligand,ligand_name,complex_name,crystal_ligand"]
    for n in ("3mhw", "2zec"):
        rec = os.path.join(PB, n, f"{n}_protein_contact_chains.pdb")
        lig = os.path.join(PB, n, f"{n}_ligand.sdf")
        rows.append(f"{rec},{n}_protein,{lig},{n}_ligand,{n},{lig}")
    jobs.write_text("\n".join(rows) + "\n")
    return {"jobs": str(jobs), "poses": pose_dir}


def _argv(name, fill, out):
    return CLI_COMMON + [a.format(**fill) for a in CLI_RUNS[name]] + ["-o", out]


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.slow
def test_write_mdn_train_fixture(tmp_path, monkeypatch, pose_dir):
    """Regenerates tests/fixtures/torch_mdn_train_ref.npz: the JAX
    `train_cli --model mdn --cpu` runs of CLI_RUNS, each step's logged
    metrics."""
    from diffbindfr_tpu.app import train_cli as jcli

    monkeypatch.setenv("DIFFBINDFR_CACHE_DIR", "off")
    fill = _cli_inputs(tmp_path, pose_dir)
    arrays = {}
    for name in CLI_RUNS:
        out = str(tmp_path / name)
        assert jcli.main(_argv(name, fill, out) + ["--cpu"]) == 0
        recs = _log(out)
        for k in recs[0]:
            arrays[f"{name}/{k}"] = np.array([r[k] for r in recs], np.float64)
    np.savez_compressed(FIXTURE, **arrays)


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_mdn_cli_matches_jax_fixture(tmp_path, pose_dir, name):
    """`train_cli --model mdn` (crystal from a job table; --pose-dir),
    resumed from runs/mdn_r4b: each step's logged metrics within 1e-4
    relative of the JAX run's; mdn_ckpt_0000003.npz holds the parameters
    only, which the JAX load_checkpoint reads as the port does, and the
port's scorer scores with."""
    ref = np.load(FIXTURE)
    out = str(tmp_path / "out")
    res = train_cli.main(_argv(name, _cli_inputs(tmp_path, pose_dir), out) + ["--cpu"])
    recs = _log(out)
    assert [r["step"] for r in recs] == list(ref[f"{name}/step"]) == [1, 2, 3]
    for k in recs[0]:
        got = np.array([r[k] for r in recs])
        print(name, k, got, ref[f"{name}/{k}"])
        np.testing.assert_allclose(got, ref[f"{name}/{k}"], rtol=1e-4, atol=1e-6, err_msg=k)
    assert res["steps"] == 3 and len(res["losses"]) == 3
    ckpt = os.path.join(out, "mdn_ckpt_0000003.npz")
    with np.load(ckpt) as d:
        assert not any(k.startswith("ema/") for k in d.files) and int(d["meta/step"]) == 3
    jp, step = jax_load_checkpoint(ckpt)
    tp, _ = load_checkpoint(ckpt, device="cpu")  # as MDNEngine's callers read it
    assert step == 3
    for a, b in zip(TTR.tree_leaves(tp), TTR.tree_leaves(_like(jp, tp))):
        np.testing.assert_array_equal(a.numpy(), b)
    s = _load_sample_npz(os.path.join(PREP, "3mhw_r12.npz"))
    tb = to_device(stack_samples([s]), "cpu")
    with torch.no_grad():
        _, nll = tmdn.score_batch_both(tp, CFG, tb, tb.lig_pos,
                                       _rebuild_atom14(tb, tb.torsion_angle[..., 1:]))
    assert bool(torch.isfinite(nll).all())
