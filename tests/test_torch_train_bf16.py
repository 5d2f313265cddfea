"""bf16 training of the port (train.py under compute_dtype='bfloat16', the
JAX train_cli's default precision) against the JAX package's bf16 training
step, and the training pin of the depthwise chain (pallas_dw_dtype).

One step's loss and gradients at ns=8, nv=4, 2 layers on two copies of
2zec's sample (made again from its tracked prep record at a fresh prep's
bucket, n_lig 32, n_atm 1024; 5 torsions), the port's init_params weights
handed to JAX
and JAX's draws handed to the port (tests/test_torch_train.py's jax_noise),
in two pairings:
  * the port's plain path against the JAX XLA path, both bf16;
  * the port's kernel path (its convs are their plain versions on the CPU),
    with pallas_dw_dtype='float32', against JAX use_pallas=True,
    pallas_dw_dtype='float32' in interpret mode (`train_cli --pallas --dtype
    bfloat16`; with --pallas-bwd the JAX backward kernels give the twin's
    gradients, and the same distances here to three digits, in 14 s more).
The control is the JAX package's own bf16-vs-f32 distance on the same
inputs (its XLA f32 step against its bf16 step of the pairing).

Bounds. bf16 is chaotic at the element level: two implementations that
round at the same points differ where f32 sums taken in another order cross
a bf16 rounding boundary, and each such move spreads. So the gradients are
held as a whole: the relative L2 distance over every parameter gradient
(concatenated) must be below half of the control's (measured: 0.13 of it on
the plain pairing, 0.23 on the kernel pairing), and every gradient tensor
within 0.2 relative L2 of JAX's (measured <= 0.14; a tensor that is lost
scores 1.0, the control's worst is 0.31). The total loss must lie below half
of the control's distance too (measured 0.28 and 0.33 of it). The four loss
terms are scalars of that noise, each within 1e-2 relative (measured <=
3.9e-3): the JAX package's own XLA and Pallas bf16 steps differ by up to
3.2e-3 (tor_loss), and its bf16-vs-f32 distance per term is 2.4e-3 to
8.9e-3, so no bound per term can sit below half of the control. On 3mhw
(10 ligand atoms, no torsion) the noise of the total loss is larger than its
control (2.2e-3 against 1.8e-3) while the gradients keep a ratio of 0.35.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _like, jax_noise, jax_tables  # noqa: F401 (module fixture)

from diffbindfr_tpu import train as JTR
from diffbindfr_tpu.models import score_net as JSN
from diffbindfr_tpu.sampler import SamplerConfig as JSamplerConfig
from diffbindfr_torch import train as TTR
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.data.sample import make_sample, stack_samples, to_device
from diffbindfr_torch.models import score_net as TSN
from diffbindfr_torch.sampler import SamplerConfig

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/2zec_r12.rec.pkl")
SMALL = dict(ns=8, nv=4, num_conv_layers=2)
TERMS = ("loss", "tr_loss", "rot_loss", "tor_loss", "sc_loss")
# the port's use_kernels -> the JAX step of the same path
PAIRINGS = {"plain": (False, dict(compute_dtype="bfloat16")),
            "kernels": (True, dict(compute_dtype="bfloat16", use_pallas=True,
                                   pallas_dw_dtype="float32"))}
JAX_VG = jax.jit(jax.value_and_grad(JTR.loss_fn, has_aux=True), static_argnums=(1, 2, 3))


@pytest.fixture(scope="module")
def step_inputs():
    """(JAX batch, port batch, key, port noise, port params, JAX params, JAX
    f32 step (metrics, gradient leaves in the port's order))."""
    rec = load_prep_record(REC)
    s = make_sample(rec["lig"], rec["pocket"])
    jb = jax.tree.map(jnp.asarray, stack_samples([s, s]))
    tb = to_device(stack_samples([s, s]), "cpu")
    tp = TSN.init_params(torch.Generator().manual_seed(1), TSN.ScoreNetConfig(**SMALL))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    key = jax.random.PRNGKey(5)
    f32 = _jax_step(jp, tp, jb, key, compute_dtype="float32")
    return jb, tb, key, jax_noise(key, tb), tp, jp, f32


def _jax_step(jp, tp, jb, key, **kw):
    (_, m), g = JAX_VG(jp, JSN.ScoreNetConfig(dropout=0.0, **SMALL, **kw), JSamplerConfig(),
                       JTR.TrainConfig(), jb, key)
    return ({k: float(v) for k, v in m.items()},
            [np.asarray(x, np.float64) for x in TTR.tree_leaves(_like(g, tp))])


def _l2(a: list, b: list) -> float:
    """Relative L2 distance of the concatenated leaves of a to those of b."""
    fa, fb = (np.concatenate([np.ravel(x) for x in t]) for t in (a, b))
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


@pytest.mark.parametrize("path", list(PAIRINGS))
def test_bf16_step_matches_jax(step_inputs, path):
    jb, tb, key, noise, tp, jp, (m32, g32) = step_inputs
    use_kernels, jkw = PAIRINGS[path]
    m16, g16 = _jax_step(jp, tp, jb, key, **jkw)
    cfg = TSN.ScoreNetConfig(compute_dtype="bfloat16", pallas_dw_dtype="float32", **SMALL)
    tm, tg = TTR.loss_and_grads(tp, tb, noise, cfg, SamplerConfig(), TTR.TrainConfig(),
                                use_kernels=use_kernels)
    tg = [g.double().numpy() for g in tg]
    assert all(np.isfinite(g).all() for g in tg)
    for k in TERMS:
        err = abs(float(tm[k]) - m16[k]) / max(abs(m16[k]), 1e-12)
        ctl = abs(m32[k] - m16[k]) / max(abs(m16[k]), 1e-12)
        print(f"{path} {k}: {float(tm[k]):.6f} vs JAX bf16 {m16[k]:.6f} ({err:.2e}); JAX f32 "
              f"{m32[k]:.6f} ({ctl:.2e})")
        assert err <= 1e-2 and (k != "loss" or err < 0.5 * ctl), k
    err, ctl = _l2(tg, g16), _l2(g32, g16)
    live = [(a, b) for a, b in zip(tg, g16) if b.size and np.abs(b).max() > 0]
    per = max(_l2([a], [b]) for a, b in live)
    print(f"{path}: gradients' relative L2 distance to JAX bf16 {err:.4f}, JAX f32's "
          f"{ctl:.4f} (ratio {err / ctl:.2f}); worst tensor {per:.3f} over {len(live)}")
    assert err < 0.5 * ctl and per <= 0.2


def test_train_step_keeps_f32_state(step_inputs):
    """train_step and eval_step under bf16: the parameters, Adam moments and
    EMA stay f32 and finite, the metrics are f32, and eval_step's terms equal
    the step's loss terms at the same parameters."""
    _, tb, _, noise, tp, _, _ = step_inputs
    cfg = TSN.ScoreNetConfig(compute_dtype="bfloat16", pallas_dw_dtype="float32", **SMALL)
    tcfg = TTR.TrainConfig(warmup_steps=1, total_steps=4)
    state = TTR.init_state(None, cfg, tcfg, "cpu", params=tp)
    em = TTR.eval_step(state.params, tb, noise, cfg, SamplerConfig(), tcfg)
    new, m = TTR.train_step(state, tb, noise, cfg, SamplerConfig(), tcfg, device="cpu")
    for k in TERMS:
        assert torch.equal(em[k], m[k]) and m[k].dtype == torch.float32
    for tree in (new.params, new.ema_params, new.opt_state["mu"], new.opt_state["nu"]):
        leaves = TTR.tree_leaves(tree)
        assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all()) for x in leaves)
    assert new.step == 1 and new.opt_state["count"] == 1


@pytest.mark.parametrize("dw,compute,layout,chain", [
    ("auto", "bfloat16", "cmt", True), ("auto", "float32", "cmt", False),
    ("float32", "bfloat16", "cmt", False), ("bfloat16", "float32", "cmt", True),
    ("bfloat16", "bfloat16", "rowmajor", False)])
def test_dw_dtype_rule(dw, compute, layout, chain):
    """pallas_dw_dtype picks the kernel path's chain by the JAX rule
    (score_net.py:208-213 there): 'auto' follows compute_dtype, so
    inference at bf16 keeps B11, and training's 'float32' pin turns it off;
    only the cmt layout has a bf16 chain."""
    cfg = TSN.ScoreNetConfig(pallas_dw_dtype=dw, compute_dtype=compute, pallas_layout=layout)
    assert cfg.bf16_chain is chain
    with pytest.raises(ValueError, match="pallas_dw_dtype"):
        _ = TSN.ScoreNetConfig(pallas_dw_dtype="float16").bf16_chain


# ---------------------------------------------------------------------------
# the trunk's output under bf16 at full width (the sc_tor gate)
# ---------------------------------------------------------------------------

TRUNK_FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_bf16_trunk_ref.npz")
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
CKPT = os.path.join(ROOT, "runs/diff_r2/ckpt_best.npz")


def _sc_head_input(module, monkeypatch):
    """A list that receives node_x of every _pseudotorque call of `module`'s
    apply: the second call of a forward is the side-chain head, whose
    node_x is the trunk's final atom features."""
    seen, real = [], module._pseudotorque

    def spy(*a, **kw):
        seen.append(kw["node_x"])
        return real(*a, **kw)

    monkeypatch.setattr(module, "_pseudotorque", spy)
    return seen


def _dist(a, b):
    """(relative L2, max|a - b| / max|b|) of atom features over real rows."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(np.abs(a - b).max() / np.abs(b).max()))


@pytest.mark.slow
def test_write_bf16_trunk_fixture(monkeypatch):
    """Regenerates tests/fixtures/torch_bf16_trunk_ref.npz from the JAX
    package (use_pallas=True, interpret mode on the CPU; diff_r2 EMA on 3dbs
    at the bf16 fixture's state, tests/test_torch_bf16.py): the trunk's final
    atom features (the side-chain head's input) under compute_dtype=
    'bfloat16' over the real atoms, as bf16 bits, and their distance to the
    same features under float32, the control."""
    from test_torch_bf16 import FIX_SHIFT, FIX_T, SCHED, _fixture_batch

    from diffbindfr_tpu.app.pipeline import _load_sample_npz as jax_load_sample
    from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

    params, _ = jax_load_checkpoint(CKPT, use_ema=True)
    params = jax.tree.map(jnp.asarray, params)
    s = _fixture_batch(jax_load_sample(SAMPLE))
    real = s.atm_mask > 0
    seen = _sc_head_input(JSN, monkeypatch)
    feats = {}
    for dt in ("bfloat16", "float32"):
        cfg = JSN.ScoreNetConfig(use_pallas=True, compute_dtype=dt)
        fn = jax.jit(lambda p, s_, t_: (JSN.apply(p, cfg, s_, t_, JSN.sigmas_from_t(t_, SCHED)),
                                        seen[-1])[1])
        feats[dt] = np.asarray(fn(params, jax.tree.map(jnp.asarray, s), jnp.float32(FIX_T)),
                               np.float32)[real]
    rel_l2, max_rel = _dist(feats["float32"], feats["bfloat16"])
    bits = (feats["bfloat16"].view(np.uint32) >> 16).astype(np.uint16)
    np.savez_compressed(TRUNK_FIXTURE, t=np.float32(FIX_T), shift=FIX_SHIFT, atom_x_bf16=bits,
                        ctl_rel_l2=rel_l2, ctl_max_rel=max_rel)
    assert os.path.getsize(TRUNK_FIXTURE) < 4e5


def test_bf16_trunk_output_tells_bf16_from_f32(monkeypatch):
    """The sc_tor head's input, the trunk's final atom features, at full width
    (diff_r2 EMA, 3dbs, compute_dtype='bfloat16', kernel path: B11's plain
    versions on the CPU) against the JAX package's bf16 forward
    (TRUNK_FIXTURE): its relative L2 distance over the real atoms lies below
    the JAX package's own bf16-vs-f32 distance there (stored in the
    fixture; measured 3.2e-3 against 5.4e-3). sc_tor itself cannot tell bf16
    from f32 (tests/test_torch_bf16.py FULL_WIDTH_TOL); its input can. The
    max|err| / max|ref| (printed) cannot: one bf16 unit at the largest
    feature is 3.9e-3 of it, where the control reads 4.9e-3."""
    from test_torch_bf16 import SCHED, _fixture_batch

    from diffbindfr_torch.data.sample import _load_sample_npz
    from diffbindfr_torch.utils.checkpoint import load_checkpoint

    ref = np.load(TRUNK_FIXTURE)
    want = (ref["atom_x_bf16"].astype(np.uint32) << 16).view(np.float32)
    params, _ = load_checkpoint(CKPT, use_ema=True, device="cpu")
    s = _fixture_batch(_load_sample_npz(SAMPLE))
    seen = _sc_head_input(TSN, monkeypatch)
    t = torch.tensor([float(ref["t"])])
    with torch.no_grad():
        TSN.apply(params, TSN.ScoreNetConfig(compute_dtype="bfloat16"),
                  to_device(stack_samples([s]), "cpu"), t, TSN.sigmas_from_t(t, SCHED))
    got = seen[-1][0].float().numpy()[s.atm_mask > 0]
    assert seen[-1].dtype == torch.bfloat16 and got.shape == want.shape
    err = _dist(got, want)
    ctl = (float(ref["ctl_rel_l2"]), float(ref["ctl_max_rel"]))
    print(f"trunk atom features vs JAX bf16: relative L2 {err[0]:.3e}, max {err[1]:.3e}; "
          f"JAX bf16 vs f32: {ctl[0]:.3e}, {ctl[1]:.3e}")
    assert err[0] < ctl[0]
