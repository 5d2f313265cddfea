"""Training of the port (diffbindfr_torch/train.py, app/train_cli.py) against
the JAX package (diffbindfr_tpu/train.py, models/score_net.py).

Small config (ns=8, nv=4, 2 layers; 1 layer where the network is not under
test), the port's `init_params` weights handed to JAX, the JAX draws (t and the four perturbations, rebuilt from its keys)
handed to the port as a TrainNoise, and the JAX SO(3)/torus tables handed to
the port so both sides look up the same values. Tolerances (f32 on both
sides, sums in another order):
  * loss terms rtol 2e-5; every parameter-gradient tensor within 5e-4 *
    max|ref| of JAX's by the tie-aware check of nn/relu_ties.py (the one
    the card tests and chip_smoke.py use): the port's gradients, with its
    trunk convs' MLP ReLUs recorded, may take JAX's decision at a
    pre-activation within f32 rounding of 0, and nowhere else. Such a tie
    moves one pair's share of a sum (measured 2.1e-3 on al layer 0's fc/l1
    for one 3mhw key and other weights); the perturbed coordinates also
    differ between the frameworks in the last bit. Measured without any
    tie taken: <= 6.4e-6 on the kernel path, <= 1.8e-4 on the plain path
    (whose MLPs, layers.mlp_apply, are not recorded: its tensors are held
    raw);
  * three train steps: parameters and EMA within 2e-6 but for at most 1%
    of the entries (a tie, through Adam), grad_norm rtol 5e-4; the
    optimizer alone on the same gradients equals optax to f32 rounding;
  * the full-width fixture (diff_r2 params, 3dbs, B=1, written by the slow
    test below from the JAX XLA path): loss terms rtol 1e-4, gradients
    max|err| <= 1e-3 max|ref|, the card run's bound.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu import train as JTR
from diffbindfr_tpu.app.pipeline import _load_sample_npz as jax_load_sample
from diffbindfr_tpu.data.sample import stack_samples as jax_stack
from diffbindfr_tpu.geometry import so3 as JSO3
from diffbindfr_tpu.geometry import torus as JTOR
from diffbindfr_tpu.models import score_net as JSN
from diffbindfr_tpu.sampler import SamplerConfig as JSamplerConfig
from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffbindfr_torch import train as TTR
from diffbindfr_torch.app import train_cli
from diffbindfr_torch.data.sample import stack_samples, to_device
from diffbindfr_torch.geometry import so3 as TSO3
from diffbindfr_torch.geometry import torus as TTOR
from diffbindfr_torch.models import score_net as TSN
from diffbindfr_torch.nn.relu_ties import ReluTies
from diffbindfr_torch.sampler import SamplerConfig
from diffbindfr_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
CKPT = os.path.join(ROOT, "runs/diff_r2/ckpt_best.npz")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_train_ref.npz")
FIX_KEY = 20261017
# gradients kept in the full-width fixture: the edge MLPs, and the TP-weight
# MLPs' first layer and biases of every trunk conv at layers 0 and 5
FIX_GRADS = [f"{e}/{l}/{w}" for e in ("lig_edge_emb", "la_edge_emb", "atom_edge_emb")
             for l in ("l1", "l2") for w in ("w", "b")]
FIX_GRADS += [f"{c}_convs/#{i}/fc/{leaf}" for i in (0, 5) for c in ("lig", "al", "la", "atom")
              for leaf in ("l1/w", "l1/b", "l2/b")]
SMALL = dict(ns=8, nv=4, num_conv_layers=2)
ONE_LAYER = dict(ns=8, nv=4, num_conv_layers=1)
# one compiled JAX loss + gradient, shared by every test with the same shapes
JAX_LOSS_AND_GRAD = jax.jit(jax.value_and_grad(JTR.loss_fn, has_aux=True),
                            static_argnums=(1, 2, 3))


@pytest.fixture(scope="module", autouse=True)
def jax_tables():
    """Hand the JAX package's tables to the port on the CPU (the port's own
    table computation is held to them in test_torch_geometry.py)."""
    saved = dict(TSO3._tables), dict(TTOR._tables)
    jt = JSO3.tables()
    TSO3.set_tables(TSO3.SO3Tables.from_numpy("cpu", **jt._asdict()))
    tt = JTOR.tables()
    TTOR.set_tables(TTOR.TorusTables.from_numpy("cpu", score=tt.score, score_norm=tt.score_norm))
    yield
    TSO3._tables.clear()
    TSO3._tables.update(saved[0])
    TTOR._tables.clear()
    TTOR._tables.update(saved[1])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) if b.size else 0.0


def _like(tree, template):
    """`tree`'s leaves in `template`'s key order (JAX sorts dict keys)."""
    if isinstance(template, dict):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_like(a, b) for a, b in zip(tree, template)]
    return tree


def jax_noise(key, batch, t_min=0.0) -> TTR.TrainNoise:
    """The draws JAX train.loss_fn makes from `key` (train.py:113-119,
    perturb_sample, so3.sample_vec, torus.sample), as a port TrainNoise."""
    bsz, nt = batch.tor_mask.shape
    nres = batch.chi_mask.shape[1]
    k_t, k_noise = jax.random.split(key)
    t = jax.random.uniform(k_t, (bsz,), minval=t_min, maxval=1.0)
    cols = {k: [] for k in ("tr", "rot_axis", "rot_u", "tor", "sc")}
    for k in jax.random.split(k_noise, bsz):
        k_tr, k_rot, k_tor, k_sc = jax.random.split(k, 4)
        k1, k2 = jax.random.split(k_rot)
        cols["tr"].append(jax.random.normal(k_tr, (3,)))
        cols["rot_axis"].append(jax.random.normal(k1, (3,)))
        cols["rot_u"].append(jax.random.uniform(k2, ()))
        cols["tor"].append(jax.random.normal(k_tor, (nt,)))
        cols["sc"].append(jax.random.normal(k_sc, (nres, 4)))
    return TTR.TrainNoise(t=torch.from_numpy(np.asarray(t)),
                          **{k: torch.from_numpy(np.asarray(jnp.stack(v))) for k, v in cols.items()})


def _batch(names, synthetic=False):
    """Stacked prep-cache samples; `synthetic` moves each ligand by a random
    offset and gives it random node features (same shapes)."""
    samples = [jax_load_sample(os.path.join(PREP, f"{n}_r12.npz")) for n in names]
    if synthetic:
        rng = np.random.default_rng(11)
        samples = [s._replace(
            lig_pos=((s.lig_pos + rng.normal(size=3) * 1.5) * s.lig_mask[:, None]).astype(
                np.float32),
            lig_feat=(rng.random(s.lig_feat.shape) * s.lig_mask[:, None]).astype(np.float32))
            for s in samples]
    jb = jax.tree.map(jnp.asarray, jax_stack(samples))
    return jb, to_device(stack_samples(samples), "cpu")


def _configs(shape, seed=1):
    """(JAX config, port config, JAX params, port params): the port's
    init_params, handed to JAX (init_params itself is compared below)."""
    tcfg = TSN.ScoreNetConfig(**shape)
    tp = TSN.init_params(torch.Generator().manual_seed(seed), tcfg)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return JSN.ScoreNetConfig(dropout=0.0, **shape), tcfg, jp, tp


@pytest.fixture(scope="module")
def small():
    return _configs(SMALL)


def _tie_aware_grads(params, batch, noise, cfg, use_kernels):
    """(metrics, ReluTies): the port's loss gradients (ties.ref, equal to
    loss_and_grads') from one forward and backward of train.loss_of_leaves,
    the function loss_and_grads differentiates, with the trunk convs' MLP
    ReLUs recorded."""
    leaves, loss_of = TTR.loss_of_leaves(params, batch, noise, cfg, SamplerConfig(),
                                         TTR.TrainConfig(), use_kernels)
    metrics = {}

    def loss(*ls):
        value, m = loss_of(*ls)
        metrics.update(m)
        return value

    return metrics, ReluTies(loss, leaves, leaves, [torch.ones(())])


@pytest.mark.parametrize("synthetic", [False, True])
def test_loss_terms_and_gradients_match_jax(small, synthetic):
    jcfg, tcfg, jp, tp = small
    jb, tb = _batch(("3mhw", "3mhw"), synthetic)
    key = jax.random.PRNGKey(766 + synthetic)
    (_, jm), jg = JAX_LOSS_AND_GRAD(jp, jcfg, JSamplerConfig(), JTR.TrainConfig(), jb, key)
    noise = jax_noise(key, tb)
    want = [torch.from_numpy(np.asarray(w)) for w in TTR.tree_leaves(_like(jg, tp))]
    for use_kernels in (True, False):
        tm, ties = _tie_aware_grads(tp, tb, noise, tcfg, use_kernels)
        for k in ("loss", "tr_loss", "rot_loss", "tor_loss", "sc_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, atol=1e-7)
        assert len(ties.ref) == len(want)
        raw, final, flips = ties.check(want, 5e-4)
        assert max(final) <= 5e-4, (use_kernels, max(raw), max(final), flips)
        em = TTR.eval_step(tp, tb, noise, tcfg, SamplerConfig(), TTR.TrainConfig(),
                           use_kernels=use_kernels)
        assert all(torch.equal(em[k], tm[k]) for k in tm)


def test_three_optimizer_steps_match_jax():
    """train_step against JAX make_train_step (gradients from each side): a
    ReLU tie moves one gradient column (module docstring), which Adam turns
    into a different update of up to ~2 lr on the entries it reaches, so at
    most 1% of the entries may differ by more than 2e-6 and none by more
    than 2e-3 (measured: 0.24%, 1.4e-5 after the tie of key 101), and
    grad_norm agrees to 5e-4 (that tie moved it by 1.3e-4). One trunk layer:
    the step, not the network, is under test here."""
    jcfg, tcfg, jp, tp = _configs(ONE_LAYER)
    jb, tb = _batch(("3mhw", "3mhw"))
    jt = JTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=8, ema_decay=0.9)
    tt = TTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=8, ema_decay=0.9)
    opt = JTR.make_optimizer(jt)
    jstate = JTR.TrainState(jp, jax.tree.map(lambda x: x, jp), opt.init(jp),
                            jnp.zeros((), jnp.int32))
    jstep = jax.jit(JTR.make_train_step(jcfg, JSamplerConfig(), jt))
    tstate = TTR.init_state(None, tcfg, tt, "cpu", params=tp)
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, jb, key)
        tstate, tm = TTR.train_step(tstate, tb, jax_noise(key, tb), tcfg, SamplerConfig(), tt,
                                    device="cpu")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-4)
        for got, want in ((tstate.params, jstate.params), (tstate.ema_params, jstate.ema_params)):
            diff = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for g, w in zip(
                TTR.tree_leaves(got), TTR.tree_leaves(_like(want, tp)))])
            assert (diff > 2e-6).mean() <= 1e-2 and diff.max() <= 2e-3, (i, diff.max())
    assert tstate.step == 3 and tstate.opt_state["count"] == 3


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_optimizer_updates_match_optax(scale):
    """Clip + Adam + warmup-cosine on the same gradients (clip inactive at
    scale 0.01, active at 10): the first update is zero (lr 0 at count 0),
    the next ones equal optax's to f32 rounding."""
    import optax

    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    jt = JTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    tt = TTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    jparams = [jnp.zeros(s_, jnp.float32) for s_ in shapes]
    jopt = JTR.make_optimizer(jt)
    jst = jopt.init(jparams)
    topt = TTR.make_optimizer(tt)
    tst = topt.init([torch.zeros(s_) for s_ in shapes])
    for step in range(4):
        grads = [(rng.normal(size=s_) * scale).astype(np.float32) for s_ in shapes]
        ju, jst = jopt.update([jnp.asarray(g) for g in grads], jst, jparams)
        tg = [torch.from_numpy(g) for g in grads]
        tu, tst = topt.update(tg, tst, TTR.global_norm(tg))
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-10)
        if step == 0:
            assert all(float(a.abs().max()) == 0.0 for a in tu)
        np.testing.assert_allclose(float(TTR.global_norm(tg)),
                                   float(optax.global_norm([jnp.asarray(g) for g in grads])),
                                   rtol=1e-6)


def test_remat_changes_no_number(small):
    _, tcfg, _, tp = small
    _, tb = _batch(("3mhw",))
    noise = TTR.draw_noise(tb, TTR.TrainConfig(), torch.Generator().manual_seed(0))
    args = (tp, tb, noise)
    m0, g0 = TTR.loss_and_grads(*args, tcfg, SamplerConfig(), TTR.TrainConfig())
    remat = TSN.ScoreNetConfig(remat=True, **SMALL)
    m1, g1 = TTR.loss_and_grads(*args, remat, SamplerConfig(), TTR.TrainConfig())
    # the same numbers up to the order in which autograd adds the layers'
    # shares of a shared parameter's gradient
    for k in m0:
        np.testing.assert_allclose(m1[k].numpy(), m0[k].numpy(), rtol=1e-6)
    assert max(_rel(b.numpy(), a.numpy()) for a, b in zip(g0, g1)) <= 1e-6


def test_init_params_tree_matches_jax():
    jcfg = JSN.ScoreNetConfig(dropout=0.0, **SMALL)
    jp = jax.jit(JSN.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = TSN.init_params(torch.Generator().manual_seed(0), TSN.ScoreNetConfig(**SMALL))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            got[path] = t

    walk(tp, ())
    keys = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): np.asarray(v)
            for p, v in want}
    assert set(keys) == set(got)
    for k, w in keys.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, k
        if k[-1] in ("b", "weight", "bias", "mean_shift"):
            np.testing.assert_array_equal(g, w)  # constant initialisers
        elif k[-1] in ("w", "emb"):
            # uniform draws: the same bound (xavier / kaiming), within it
            bound = (np.sqrt(6.0 / w.shape[0]) if k[-2] == "scalar_lin"
                     else np.sqrt(6.0 / (w.shape[0] + w.shape[-1])))
            assert np.abs(g).max() <= bound and np.abs(g).max() > 0.5 * bound, k


def _fixture_inputs():
    s = jax_load_sample(os.path.join(PREP, "3dbs_r12.npz"))
    jb = jax.tree.map(lambda x: jnp.asarray(x[None]), s)
    return jb, to_device(stack_samples([s]), "cpu")


@pytest.mark.slow
def test_write_train_fixture():
    """Regenerates tests/fixtures/torch_train_ref.npz from the JAX package
    (XLA path, CPU): diff_r2 params on 3dbs, B = 1, the draws of FIX_KEY."""
    params, _ = jax_load_checkpoint(CKPT)
    cfg = JSN.ScoreNetConfig(dropout=0.0)
    jb, tb = _fixture_inputs()
    key = jax.random.PRNGKey(FIX_KEY)
    vg = jax.jit(jax.value_and_grad(JTR.loss_fn, has_aux=True), static_argnums=(1, 2, 3))
    (_, m), g = vg(jax.tree.map(jnp.asarray, params), cfg, JSamplerConfig(), JTR.TrainConfig(),
                   jb, key)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}#{i}/")
        else:
            flat[path[:-1]] = np.asarray(t, np.float32)

    walk(g, "")
    noise = jax_noise(key, tb)
    np.savez_compressed(FIXTURE, **{f"loss/{k}": np.float32(v) for k, v in m.items()},
                        **{f"noise/{k}": v.numpy() for k, v in noise._asdict().items()},
                        **{f"grad/{k}": flat[k] for k in FIX_GRADS})
    assert os.path.getsize(FIXTURE) < 1.2e6


def test_full_width_loss_and_gradients_match_fixture():
    ref = np.load(FIXTURE)
    params, _ = load_checkpoint(CKPT, use_ema=False, device="cpu")
    _, tb = _fixture_inputs()
    noise = TTR.TrainNoise(**{k: torch.from_numpy(ref[f"noise/{k}"])
                              for k in TTR.TrainNoise._fields})
    m, grads = TTR.loss_and_grads(params, tb, noise, TSN.ScoreNetConfig(remat=True),
                                  SamplerConfig(), TTR.TrainConfig())
    for k in ("loss", "tr_loss", "rot_loss", "tor_loss", "sc_loss"):
        np.testing.assert_allclose(float(m[k]), float(ref[f"loss/{k}"]), rtol=1e-4, atol=1e-6)
    by_path = dict(zip(_paths(params), grads))
    errs = {k: _rel(by_path[k].numpy(), ref[f"grad/{k}"]) for k in FIX_GRADS}
    print("full width gradients, max|err|/max|ref|: worst", max(errs.values()))
    assert max(errs.values()) <= 1e-3, errs


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}#{i}/")]
    return [prefix[:-1]]


def _cache_copy(tmp_path, names):
    cache = tmp_path / "cache"
    cache.mkdir()
    for n in names:
        shutil.copy(os.path.join(PREP, f"{n}_r12.npz"), cache)
    return str(cache)


def test_cli_trains_and_writes_a_checkpoint_jax_reads(tmp_path):
    cache = _cache_copy(tmp_path, ("3mhw", "3dbs"))
    out = str(tmp_path / "out")
    small = ["--ns", "8", "--nv", "4", "--layers", "1", "--device", "cpu", "-bs", "4",
             "--log-every", "1", "--stream-cache", cache, "-o", out]
    res = train_cli.main(small + ["--steps", "2"])
    assert res["steps"] == 2 and res["samples"] == 2
    # every step's loss, and the rate after the first step
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["steady_steps"] == 1 and res["steady_samples"] == 1
    assert 0 < res["steady_seconds"] < res["seconds"]
    with open(os.path.join(out, "train_log.jsonl")) as fh:
        assert [json.loads(line)["loss"] for line in fh] == pytest.approx(res["losses"], rel=1e-6)
    for f in ("train_log.jsonl", "ckpt_0000002.npz", "train_state.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "train_log.jsonl")) as fh:
        assert [int(line.split('"step": ')[1].split(",")[0]) for line in fh] == [1, 2]
    # resuming the full state continues the step count
    assert train_cli.main(small + ["--steps", "3", "--resume",
                                   os.path.join(out, "train_state.npz")])["steps"] == 1
    jparams, step = jax_load_checkpoint(os.path.join(out, "ckpt_0000003.npz"))
    assert step == 3
    tparams, _ = load_checkpoint(os.path.join(out, "ckpt_0000003.npz"), use_ema=False,
                                 device="cpu")
    # the JAX forward on the written weights equals the port's
    jb, tb = _batch(("3dbs",))
    t = np.array([0.6], np.float32)
    sched = SamplerConfig().schedule
    jcfg = JSN.ScoreNetConfig(dropout=0.0, **ONE_LAYER)
    jout = jax.jit(lambda p, b, t_: JSN.apply_batched(p, jcfg, b, t_, JSN.sigmas_from_t(
        t_, sched)))(jax.tree.map(jnp.asarray, jparams), jb, jnp.asarray(t))
    tt = torch.from_numpy(t)
    with torch.no_grad():
        tout = TSN.apply(tparams, TSN.ScoreNetConfig(**ONE_LAYER), tb, tt,
                         TSN.sigmas_from_t(tt, sched))
    for f in ("tr", "rot", "tor", "sc_tor"):
        assert _rel(getattr(tout, f).numpy(), getattr(jout, f)) <= 1e-4, f


def test_cli_and_train_step_default_to_cuda_and_raise_without_it(tmp_path, small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, tcfg, _, tp = small
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--stream-cache", str(tmp_path), "-o", str(tmp_path / "out")])
    state = TTR.init_state(None, tcfg, TTR.TrainConfig(), "cpu", params=tp)
    _, tb = _batch(("3mhw",))
    noise = TTR.draw_noise(tb, TTR.TrainConfig(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TTR.train_step(state, tb, noise, tcfg, SamplerConfig(), TTR.TrainConfig())
