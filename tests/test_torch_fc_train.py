"""'fc' training of the port (nn/layers.fc_conv_mean's recompute backward,
train.py and app/train_cli.py under conv_mode='fc') against the JAX package.

Small config (ns=8, nv=4, 2 layers, per-layer remat as train_cli runs it),
the port's init_params weights handed to JAX, JAX's draws handed to the port
(tests/test_torch_train.py's jax_noise) on the inputs of
tests/test_torch_train_bf16.py (two copies of 2zec's sample made again from
its tracked prep record, key 5). One JAX compile per dtype (the module
fixture), shared by the tests:
  * f32: loss terms rtol 2e-5, every parameter gradient within 5e-4 of
    max|ref| by nn/relu_ties.py's check (the bound of the 'sep' trainer's
    test, tests/test_torch_train.py);
  * bf16: the gradients by tests/test_torch_train_bf16.py's measures and
    bounds: the relative L2 distance to the JAX bf16 step over all
    gradients below half of the control's (the JAX step's own bf16-vs-f32
    distance; measured 0.29 of it), and every gradient tensor within 0.2
    of JAX's (measured <= 0.17, where the control's worst is 0.56); the
    loss terms within 1e-2. The TP's path constant alpha is where the two
    round differently unless the port rounds it to bf16 as JAX does (kept
    in f32, the port lies 0.54 of the control from JAX);
    tests/torch_fc_bf16_inputs.py measures the same on three more inputs;
  * three optimizer steps from each side's gradients: parameters within
    2e-6 but for at most 1% of the entries, grad_norm rtol 5e-4.
The recompute backward against plain autograd over the same chunks (1e-6
of max|ref|), the per-pair weights it keeps alive (saved_tensors_hooks:
never more than one chunk's; plain autograd, the control, keeps the whole
block's), how often a layer's chunks run in a remat step (three times), and
train_cli --conv-mode fc on the CPU: 2 steps whose checkpoint the JAX
loader reads, and --resume from a checkpoint converted by
utils/torch_import.py fine-tunes the imported weights.
"""
import os
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _cache_copy, _like, _tie_aware_grads, jax_noise
from test_torch_train import jax_tables  # noqa: F401 (module fixture)

from diffbindfr_tpu import train as JTR
from diffbindfr_tpu.data.sample import stack_samples as jax_stack
from diffbindfr_tpu.models import score_net as JSN
from diffbindfr_tpu.sampler import SamplerConfig as JSamplerConfig
from diffbindfr_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffbindfr_torch import train as TTR
from diffbindfr_torch.app import train_cli
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.data.sample import make_sample, stack_samples, to_device
from diffbindfr_torch.models import score_net as TSN
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.sampler import SamplerConfig
from diffbindfr_torch.utils.checkpoint import load_checkpoint, save_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

SMALL = dict(ns=8, nv=4, num_conv_layers=2)
TERMS = ("loss", "tr_loss", "rot_loss", "tor_loss", "sc_loss")
JAX_VG = jax.jit(jax.value_and_grad(JTR.loss_fn, has_aux=True), static_argnums=(1, 2, 3))
SH = "1x0e+1x1o+1x2e"
REC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "runs/eval_r5_scsrc/prep_cache/2zec_r12.rec.pkl")


def _jcfg(dtype):
    return JSN.ScoreNetConfig(conv_mode="fc", dropout=0.0, remat=True, compute_dtype=dtype,
                              **SMALL)


def _tcfg(dtype):
    return TSN.ScoreNetConfig(conv_mode="fc", remat=True, compute_dtype=dtype, **SMALL)


def _jax_step(jp, tp, jb, key, dtype):
    (_, m), g = JAX_VG(jp, _jcfg(dtype), JSamplerConfig(), JTR.TrainConfig(), jb, key)
    return ({k: float(v) for k, v in m.items()},
            [np.asarray(x, np.float64) for x in TTR.tree_leaves(_like(g, tp))])


@pytest.fixture(scope="module")
def fc_step():
    """(JAX batch, port batch, key, port noise, port params, JAX params,
    {dtype: JAX (metrics, gradient leaves in the port's order)})."""
    tp = TSN.init_params(torch.Generator().manual_seed(1), _tcfg("float32"))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    s = make_sample(*(lambda r: (r["lig"], r["pocket"]))(load_prep_record(REC)))
    jb = jax.tree.map(jnp.asarray, jax_stack([s, s]))
    tb = to_device(stack_samples([s, s]), "cpu")
    key = jax.random.PRNGKey(5)
    ref = {dt: _jax_step(jp, tp, jb, key, dt) for dt in ("float32", "bfloat16")}
    return jb, tb, key, jax_noise(key, tb), tp, jp, ref


def _l2(a: list, b: list) -> float:
    fa, fb = (np.concatenate([np.ravel(x) for x in t]) for t in (a, b))
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def test_fc_loss_and_gradients_match_jax_f32(fc_step):
    _, tb, _, noise, tp, _, ref = fc_step
    jm, jg = ref["float32"]
    tm, ties = _tie_aware_grads(tp, tb, noise, _tcfg("float32"), use_kernels=False)
    for k in TERMS:
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=2e-5, atol=1e-7)
    want = [torch.from_numpy(w.astype(np.float32)) for w in jg]
    assert len(ties.ref) == len(want)
    raw, final, flips = ties.check(want, 5e-4)
    print(f"f32 gradients: max raw {max(raw):.2e}, after ties {max(final):.2e}")
    assert max(final) <= 5e-4, (max(raw), max(final), flips)


def test_fc_bf16_step_matches_jax(fc_step):
    _, tb, _, noise, tp, _, ref = fc_step
    (m32, g32), (m16, g16) = ref["float32"], ref["bfloat16"]
    tm, tg = TTR.loss_and_grads(tp, tb, noise, _tcfg("bfloat16"), SamplerConfig(),
                                TTR.TrainConfig(), use_kernels=False)
    tg = [g.double().numpy() for g in tg]
    assert all(np.isfinite(g).all() for g in tg)
    for k in TERMS:
        err = abs(float(tm[k]) - m16[k]) / max(abs(m16[k]), 1e-12)
        print(f"bf16 {k}: {float(tm[k]):.6f} vs JAX {m16[k]:.6f} ({err:.2e}); JAX f32 "
              f"{m32[k]:.6f}")
        assert err <= 1e-2, k
    err, ctl = _l2(tg, g16), _l2(g32, g16)
    live = [(a, b) for a, b in zip(tg, g16) if b.size and np.abs(b).max() > 0]
    per = max(_l2([a], [b]) for a, b in live)
    print(f"bf16 gradients: relative L2 to JAX bf16 {err:.4f}, JAX f32's {ctl:.4f}; worst "
          f"tensor {per:.3f} over {len(live)}")
    assert err < 0.5 * ctl and per <= 0.2


def test_fc_three_optimizer_steps_match_jax(fc_step):
    """train_step (f32, 'fc') against the JAX optimizer on JAX's gradients,
    three steps from the same weights, each side's own gradients."""
    jb, tb, _, _, tp, jp, _ = fc_step
    jt = JTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=8, ema_decay=0.9)
    tt = TTR.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=8, ema_decay=0.9)
    opt = JTR.make_optimizer(jt)
    # one compile of the update (op by op, optax compiles each leaf's ops)
    update = jax.jit(lambda g, o, p: (lambda u, o2: (jax.tree.map(jnp.add, p, u), o2))(
        *opt.update(g, o, p)))
    jparams, jopt = jp, opt.init(jp)
    tstate = TTR.init_state(None, _tcfg("float32"), tt, "cpu", params=tp)
    for i in range(3):
        t0 = time.time()
        key = jax.random.PRNGKey(200 + i)
        # the loss reads no field that jt changes: the fixture's compile serves
        (_, jm), jg = JAX_VG(jparams, _jcfg("float32"), JSamplerConfig(), JTR.TrainConfig(), jb,
                             key)
        jparams, jopt = update(jg, jopt, jparams)
        tstate, tm = TTR.train_step(tstate, tb, jax_noise(key, tb), _tcfg("float32"),
                                    SamplerConfig(), tt, use_kernels=False, device="cpu")
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)
        diff = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for g, w in zip(
            TTR.tree_leaves(tstate.params), TTR.tree_leaves(_like(jparams, tp)))])
        print(f"step {i}: max |param diff| {diff.max():.2e}, share > 2e-6 "
              f"{(diff > 2e-6).mean():.4f} ({time.time() - t0:.1f} s)")
        assert (diff > 2e-6).mean() <= 1e-2 and diff.max() <= 2e-3, (i, diff.max())
    assert tstate.step == 3


def _block(dtype, k, seed):
    """A conv block with broadcast operands: (spec, params, src [B, 1, K],
    sh, parts (one [B, R, 1, 8]), mask with a dead row and a dead column)."""
    spec = TL.make_conv_spec("8x0e+4x1o", SH, "8x0e+4x1o+4x1e", "fc")
    g = torch.Generator().manual_seed(seed)
    p = TSN._tp_conv_init(g, spec, 24)
    bsz, rows, din = 2, 5, spec.fc.in1.dim
    src = torch.randn(bsz, 1, k, din, generator=g)
    sh = torch.randn(bsz, rows, k, 9, generator=g)
    parts = [torch.randn(bsz, rows, k, 16, generator=g), torch.randn(bsz, rows, 1, 8,
                                                                     generator=g)]
    mask = (torch.rand(bsz, rows, k, generator=g) > 0.4).float()
    mask[0, 1] = 0.0
    mask[..., 3] = 0.0
    if dtype == torch.bfloat16:
        p = TSN._cast_f32_leaves(p, dtype)
        src, sh, parts = src.to(dtype), sh.to(dtype), [x.to(dtype) for x in parts]
    return spec, p, src, sh, parts, mask


def _grads(fn, spec, p, src, sh, parts, mask, seed=0):
    """Gradients of <fn(...), c> for a seeded cotangent c, for the inputs
    and the fc MLP's leaves."""
    xs = [x.detach().requires_grad_() for x in (src, sh, *parts)]
    fc = {a: {b: v.detach().requires_grad_() for b, v in d.items()} for a, d in p["fc"].items()}
    out = fn({**p, "fc": fc}, spec, xs[0], xs[1], xs[2:], mask)
    c = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.dtype)
    leaves = TL._tree_leaves(fc)
    return out, torch.autograd.grad(out, xs + leaves, c)


def _plain_chunks(p, spec, src, sh, parts, mask, chunk_pairs=7):
    """fc_conv_mean's forward with plain autograd through every chunk: the
    chunks' graphs, and their per-pair weights, live until the backward."""
    bsz, nrow, k = mask.shape
    out = []
    full = [x.expand(bsz, nrow, k, x.shape[-1]) for x in (src, sh, *parts)]
    rows_per = max(1, chunk_pairs // k)
    flat = [x.reshape(bsz * nrow, k, -1) for x in full]
    fm = mask.reshape(bsz * nrow, k)
    for lo in range(0, bsz * nrow, rows_per):
        sl = slice(lo, lo + rows_per)
        m = TL.tp_conv_messages(p, spec, flat[0][sl], flat[1][sl],
                                torch.cat([x[sl] for x in flat[2:]], dim=-1))
        out.append(TL.masked_mean(m, fm[sl], dim=1))
    return torch.cat(out).reshape(bsz, nrow, -1)


@pytest.mark.parametrize("k,dtype", [(40, torch.float32), (16, torch.float32),
                                     (16, torch.bfloat16)])
def test_recompute_backward_matches_plain_autograd(k, dtype):
    """Every input's and fc parameter's gradient through the recompute
    backward (chunks of 7 pairs) against plain autograd over the block:
    1e-6 of max|ref| in f32; in bf16 (the chunk's sums in another order)
    1e-2."""
    spec, p, src, sh, parts, mask = _block(dtype, k, k)

    def recompute(p_, spec_, s_, h_, e_, m_):
        return TL.fc_conv_mean(p_, spec_, s_, h_, e_, m_, chunk_pairs=7)

    def plain(p_, spec_, s_, h_, e_, m_):
        full = [x.expand(*m_.shape, x.shape[-1]) for x in (s_, h_, *e_)]
        msg = TL.tp_conv_messages(p_, spec_, full[0], full[1], torch.cat(full[2:], dim=-1))
        return TL.masked_mean(msg, m_, dim=2)

    got_out, got = _grads(recompute, spec, p, src, sh, parts, mask)
    want_out, want = _grads(plain, spec, p, src, sh, parts, mask)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert float((got_out - want_out).abs().max()) <= tol * float(want_out.abs().max())
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
        assert err <= tol, (tuple(g.shape), err)


class _SavedWeights:
    """Tracks the per-pair TP weights (the fc MLP's outputs, recorded by a
    wrapper of layers.mlp_apply) among the tensors autograd saves, views of
    them included: the most weight entries alive at once."""

    def __init__(self, width):
        self.width, self.weights, self.alive, self.peak = width, {}, {}, 0

    def mlp_apply(self, p, x, act=torch.relu):
        out = self.real(p, x, act)
        if out.shape[-1] == self.width:
            self.weights[out.untyped_storage().data_ptr()] = out.numel()
        return out

    def pack(self, t):
        ptr = t.untyped_storage().data_ptr() if t.dim() else None
        if ptr not in self.weights:
            return t
        box = _Box(t)
        self.alive.setdefault(ptr, set()).add(id(box))
        self.peak = max(self.peak, sum(self.weights[q] for q in self.alive))
        weakref.finalize(box, self._drop, ptr, id(box))
        return box

    def _drop(self, ptr, key):
        held = self.alive.get(ptr)
        if held is not None:
            held.discard(key)
            if not held:
                del self.alive[ptr]

    @staticmethod
    def unpack(x):
        return x.t if isinstance(x, _Box) else x


class _Box:
    def __init__(self, t):
        self.t = t


@pytest.mark.parametrize("recompute", [True, False])
def test_backward_keeps_one_chunk_of_weights(recompute):
    """Through forward and backward of the conv over a 2 x 5 x 40 block in
    chunks of 80 pairs (2 rows), the tensors autograd saves hold at most
    one chunk's per-pair weights at a time; plain autograd through the same
    chunks (the control) holds every chunk's, the whole block's."""
    spec, p, src, sh, parts, mask = _block(torch.float32, 40, 5)
    mask = torch.ones_like(mask)
    width, chunk = spec.fc.weight_numel, 80
    hooks = _SavedWeights(width)
    hooks.real = TL.mlp_apply
    TL.mlp_apply = hooks.mlp_apply
    try:
        with torch.autograd.graph.saved_tensors_hooks(hooks.pack, hooks.unpack):
            if recompute:
                _grads(lambda *a: TL.fc_conv_mean(*a, chunk_pairs=chunk), spec, p, src, sh,
                       parts, mask)
            else:
                _grads(lambda *a: _plain_chunks(*a, chunk_pairs=chunk), spec, p, src, sh,
                       parts, mask)
    finally:
        TL.mlp_apply = hooks.real
    print(f"recompute={recompute}: at most {hooks.peak} per-pair weights saved at once "
          f"({hooks.peak / (chunk * width):.2f} chunks)")
    if recompute:
        assert 0 < hooks.peak <= chunk * width
    else:
        assert hooks.peak == mask.numel() * width


def test_remat_step_runs_each_chunk_three_times(fc_step):
    """One f32 train step under remat: every trunk conv's chunks run in the
    forward, again when remat recomputes the layer, and again (with grad)
    in the backward; the heads' three convs, outside remat, twice."""
    _, tb, _, noise, tp, _, _ = fc_step
    cfg = _tcfg("float32")
    calls, convs = [], []
    real_chunk, real_conv = TL._chunk_mean, TL.fc_conv_mean

    def chunk(*a):
        calls.append(torch.is_grad_enabled())
        return real_chunk(*a)

    def conv(*a, **kw):
        n0 = len(calls)
        out = real_conv(*a, **kw)
        convs.append(len(calls) - n0)
        return out

    TL._chunk_mean, TL.fc_conv_mean = chunk, conv
    try:
        with torch.no_grad():
            TTR.loss_fn(tp, cfg, SamplerConfig(), TTR.TrainConfig(), tb, noise,
                        use_kernels=False)
        per_conv = list(convs)
        calls.clear()
        TTR.loss_and_grads(tp, tb, noise, cfg, SamplerConfig(), TTR.TrainConfig(),
                           use_kernels=False)
    finally:
        TL._chunk_mean, TL.fc_conv_mean = real_chunk, real_conv
    n_trunk = 4 * cfg.num_conv_layers
    assert len(per_conv) == n_trunk + 3 and min(per_conv) >= 1
    trunk, heads = sum(per_conv[:n_trunk]), sum(per_conv[n_trunk:])
    print(f"chunks of one forward: trunk {trunk}, heads {heads}; a remat step ran "
          f"{calls.count(False)} without grad, {calls.count(True)} with grad")
    assert calls.count(False) == 2 * trunk + heads
    assert calls.count(True) == trunk + heads


def test_cli_fc_trains_and_writes_a_checkpoint_jax_reads(tmp_path):
    cache = _cache_copy(tmp_path, ("3mhw", "3dbs"))
    out = str(tmp_path / "out")
    argv = ["--ns", "8", "--nv", "4", "--layers", "2", "--cpu", "-bs", "4", "--log-every",
            "1", "--stream-cache", cache, "-o", out, "--conv-mode", "fc"]
    res = train_cli.main(argv + ["--steps", "2"])
    assert res["steps"] == 2 and len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    jparams, step = jax_load_checkpoint(os.path.join(out, "ckpt_0000002.npz"))
    assert step == 2
    tparams, _ = load_checkpoint(os.path.join(out, "ckpt_0000002.npz"), use_ema=False,
                                 device="cpu")
    want = TTR.tree_leaves(_like(jax.tree.map(np.asarray, jparams), tparams))
    got = TTR.tree_leaves(tparams)
    assert len(got) == len(want) and all(
        np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    # the 'fc' tree: per-pair weights of the fully connected TP
    in_s, out_s = TSN.ScoreNetConfig(**SMALL).layer_irreps(0)
    spec = TL.make_conv_spec(in_s, SH, out_s, "fc")
    assert tparams["lig_convs"][0]["fc"]["l2"]["w"].shape[1] == spec.fc.weight_numel


def test_resume_fine_tunes_a_converted_checkpoint(tmp_path):
    """A reference state dict of the small config, converted by
    utils/torch_import.py, resumed by train_cli --conv-mode fc: two steps
    move every trained leaf by at most ~2 lr from the import (Adam), keep
    the import's fixed readout rotation, and continue the step count."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from diffbindfr_torch.utils.torch_import import import_score_net

    cfg = TSN.ScoreNetConfig(conv_mode="fc", **SMALL)
    params, report = import_score_net(chip_smoke.fake_reference_sd(cfg), cfg)
    net = str(tmp_path / "net.npz")
    save_checkpoint(net, params)
    cache = _cache_copy(tmp_path, ("3mhw",))
    out = str(tmp_path / "out")
    res = train_cli.main(["--ns", "8", "--nv", "4", "--layers", "2", "--cpu", "-bs", "2",
                          "--stream-cache", cache, "-o", out, "--conv-mode", "fc",
                          "--lr", "1e-3", "--warmup", "1", "--steps", "2", "--resume", net])
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    start, _ = load_checkpoint(net, use_ema=False, device="cpu")
    tuned, step = load_checkpoint(os.path.join(out, "ckpt_0000002.npz"), use_ema=False,
                                  device="cpu")
    assert step == 2
    assert torch.equal(tuned["readout_rot"], start["readout_rot"])
    moved = [float((a - b).abs().max()) for a, b in zip(TTR.tree_leaves(tuned),
                                                        TTR.tree_leaves(start)) if a.numel()]
    assert max(moved) <= 2.5e-3 and sum(m > 0 for m in moved) >= len(moved) // 2
