"""conv_mode 'fc' of the port (nn/irreps.apply_fc_tensor_product,
nn/layers.fc_conv_mean, models/score_net.py under conv_mode='fc') against
the JAX package on the CPU.

The TP itself at every conv spec of the flagship width on random edges
(1e-5 of max|ref|); the chunked messages-and-mean against the unchunked
ones (1e-6); the small 'fc' net of the import harness (ns=8, nv=4, 3 layers,
sed = ded = 8, JAX init_params weights) on the tracked 3mhw cache at three t
values, f32 within 1e-4 of max|ref| and bf16 within the bf16 score net's
gates (tests/test_torch_bf16.py: 3e-2 per field, and at most 0.6 of the f32
control's distance summed over the fields); SE(3) equivariance; the refusal
of the kernel path; and the full-width net converted from the synthetic
reference state dict against tests/fixtures/torch_fc_ref.npz, which the
`slow` test_write_fc_fixture writes from the JAX package's import and 'fc'
forward (it also stores the input sample and a synthetic MDN head, so that
chip_smoke.py can hold the card to it without JAX).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app.pipeline import _load_sample_npz as jax_load_sample
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.nn import irreps as JI
from diffbindfr_torch.data.sample import DockingSample, stack_samples, to_device
from diffbindfr_torch.geometry.rotations import axis_angle_to_matrix
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.nn import irreps as TI
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.utils.checkpoint import params_from_numpy

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (fake_reference_sd, shared with the card run)

SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3mhw_r12.npz")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_fc_ref.npz")
SCHED = {"tr_sigma_min": 0.1, "tr_sigma_max": 6.0, "rot_sigma_min": 0.03,
         "rot_sigma_max": 1.55, "tor_sigma_min": 0.0314, "tor_sigma_max": 3.14,
         "sc_tor_sigma_min": 0.0314, "sc_tor_sigma_max": 3.14}
FIELDS = ("tr", "rot", "tor", "sc_tor")
T_VALUES = np.array([0.9, 0.5, 0.1], np.float32)
SMALL = dict(ns=8, nv=4, num_conv_layers=3, sigma_embed_dim=8, distance_embed_dim=8)
SH = "1x0e+1x1o+1x2e"
MDN_H = 128  # the MDN head of the fixture: MDNConfig's default width
# the fixture's synthetic sample: data/synthetic.py's default buckets with a
# pocket of 256 atoms. Its default 48 atoms (a Gaussian cloud of 6 A) leave
# each side-chain bond's midpoint with its own two atoms as its only
# neighbours, whose odd components cancel before a LayerNorm rescales them:
# there the f32 forward of either package lies up to 5e-2 (port) and 1.5e-1
# (JAX) of max|ref| from the float64 one on sc_tor, so f32 noise, not the
# port, would decide a 1e-4 comparison (measured with the port run in
# float64: 256 atoms bring every field's f32 error to <= 8.5e-5)
FIXTURE_BUCKETS = (16, 40, 6, 8, 256)  # n_lig, n_lig_edges, n_tor, n_res, n_atm
# the full-width net against the fixture, per field of max|ref|. On this
# sample the tor head at t = 0.1 (scaled x20 by the torus score norm) ends in
# differences of large features: the port's f32 forward lies 8.6e-5 and the
# JAX fixture 9.1e-5 from the port's float64 forward, so two f32 forwards can
# differ by their sum (measured 1.47e-4); tor is held at 2e-4, the other
# fields (<= 2.8e-5 from float64 on both sides) at 1e-4
FULL_WIDTH_TOL = {"tr": 1e-4, "rot": 1e-4, "tor": 2e-4, "sc_tor": 1e-4}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _full_width_specs():
    """name -> (in1, in2, out) of every distinct 'fc' TP of the flagship net."""
    cfg = jsn.ScoreNetConfig(conv_mode="fc")
    out = {f"layer{l}": (cfg.layer_irreps(l)[0], SH, cfg.layer_irreps(l)[1])
           for l in range(cfg.num_conv_layers)}
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    out["final"] = (final_in, SH, "2x1o+2x1e")
    tor_sh = JI.compile_full_tensor_product(SH, "1x2e", lmax_out=1)
    out["tor"] = (final_in, str(tor_sh.out), f"{cfg.ns}x0o+{cfg.ns}x0e")
    out["mul2"] = ("4x0e+2x1o", "2x0e+3x1o+2x1e", "3x0e+2x1o+2x1e+3x0o")  # mul2 > 1 paths
    return out


SPECS = _full_width_specs()


@pytest.mark.parametrize("name", list(SPECS))
def test_fc_tensor_product_matches_jax(name):
    """Path tables (enumeration, w_offset, alpha: the import's weight
    layout) identical, and the TP on 64 random edges within 1e-5 of
    max|ref| (measured <= 3e-7)."""
    in1, in2, out = SPECS[name]
    js, ts = JI.compile_fc_tensor_product(in1, in2, out), TI.compile_fc_tensor_product(in1, in2, out)
    assert [dataclasses.astuple(p) for p in ts.paths] == [dataclasses.astuple(p) for p in js.paths]
    assert ts.weight_numel == js.weight_numel and str(ts.out) == str(js.out)
    rng = np.random.default_rng(len(name))
    x1, x2, w = (rng.normal(size=(64, d)).astype(np.float32)
                 for d in (js.in1.dim, js.in2.dim, js.weight_numel))
    want = np.asarray(JI.apply_fc_tensor_product(js, *map(jnp.asarray, (x1, x2, w))))
    got = TI.apply_fc_tensor_product(ts, *map(torch.from_numpy, (x1, x2, w))).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("k,dtype", [(40, torch.float32), (16, torch.float32),
                                     (16, torch.bfloat16)])
def test_chunked_messages_match_unchunked(k, dtype):
    """fc_conv_mean (chunks of 7 pairs, dead rows and all-masked pair
    columns left out) against masked_mean of tp_conv_messages over the whole
    block, within 1e-6 of max|ref| in f32 (bit-equal sums in bf16, where
    each row's sum over its pairs is taken the same way)."""
    spec = TL.make_conv_spec("8x0e+4x1o", SH, "8x0e+4x1o+4x1e", "fc")
    g = torch.Generator().manual_seed(k)
    p = tsn._tp_conv_init(g, spec, 24)
    bsz, rows, din = 2, 5, spec.fc.in1.dim
    src = torch.randn(bsz, rows, k, din, generator=g)
    sh = torch.randn(bsz, rows, k, 9, generator=g)
    parts = [torch.randn(bsz, rows, k, 16, generator=g),
             torch.randn(bsz, rows, 1, 8, generator=g).expand(bsz, rows, k, 8)]
    mask = (torch.rand(bsz, rows, k, generator=g) > 0.4).float()
    mask[0, 1] = 0.0  # a dead row
    mask[..., 3] = 0.0  # a pair column masked everywhere
    if dtype == torch.bfloat16:
        p = tsn._cast_f32_leaves(p, dtype)
        src, sh, parts = src.to(dtype), sh.to(dtype), [x.to(dtype) for x in parts]
    m = TL.tp_conv_messages(p, spec, src, sh, torch.cat(parts, dim=-1))
    want = TL.masked_mean(m, mask, dim=2)
    got = TL.fc_conv_mean(p, spec, src, sh, parts, mask, chunk_pairs=7)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got[0, 1] == 0).all()
    assert _rel(got.float().numpy(), want.float().numpy()) <= (1e-6 if dtype == torch.float32
                                                                 else 1e-2)


@pytest.fixture(scope="module")
def small_net():
    """JAX init_params weights of the small 'fc' net, the tracked 3mhw cache
    sample (crystal pose and a shifted copy), and the JAX outputs at the
    three t values in f32 and bf16 (one compile per dtype)."""
    s = jax_load_sample(SAMPLE)
    rng = np.random.default_rng(3)
    s2 = s._replace(lig_pos=((s.lig_pos + rng.normal(size=3).astype(np.float32) * 1.5)
                             * s.lig_mask[:, None]).astype(np.float32))
    samples = [s, s2, s]
    jcfg = jsn.ScoreNetConfig(conv_mode="fc", dropout=0.0, **SMALL)
    jp = jsn.init_params(jax.random.PRNGKey(0), jcfg)
    jb = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *samples)
    outs = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(jcfg, compute_dtype=dt)
        o = jax.jit(lambda p, b, t_: jsn.apply_batched(p, c, b, t_, jsn.sigmas_from_t(t_, SCHED)))(
            jp, jb, jnp.asarray(T_VALUES))
        outs[dt] = {f: np.asarray(getattr(o, f)) for f in FIELDS}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return samples, tp, outs


def _port(small_net, dtype, use_kernels=False):
    samples, tp, _ = small_net
    cfg = tsn.ScoreNetConfig(conv_mode="fc", compute_dtype=dtype, **SMALL)
    t = torch.from_numpy(T_VALUES)
    with torch.no_grad():
        return tsn.apply(tp, cfg, to_device(stack_samples(samples), "cpu"),
                         t, tsn.sigmas_from_t(t, SCHED), use_kernels=use_kernels)


def test_small_fc_net_matches_jax_f32(small_net):
    """The small 'fc' net in f32 on the tracked 3mhw cache at t = 0.9, 0.5,
    0.1: every field within 1e-4 of max|ref|."""
    want = small_net[2]["float32"]
    out = _port(small_net, "float32")
    for f in FIELDS:
        err = _rel(getattr(out, f).numpy(), want[f])
        print(f"f32 {f}: {err:.2e}")
        assert err <= 1e-4, f


def test_small_fc_net_matches_jax_bf16(small_net):
    """compute_dtype='bfloat16': every field within 3e-2 of max|ref| of the
    JAX bf16 forward, and the port's distance to it summed over the fields
    at most 0.6 of the JAX f32 forward's (the control: a forward that
    ignored compute_dtype scores 1.0), the gates of the 'sep' net's bf16
    test."""
    want, ctl_ref = small_net[2]["bfloat16"], small_net[2]["float32"]
    out = _port(small_net, "bfloat16")
    errs, ctl = {}, {}
    for f in FIELDS:
        got = getattr(out, f)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        errs[f], ctl[f] = _rel(got.numpy(), want[f]), _rel(ctl_ref[f], want[f])
        print(f"bf16 {f}: {errs[f]:.2e} (f32 control {ctl[f]:.2e})")
        assert errs[f] <= 3e-2, f
    assert sum(errs.values()) / sum(ctl.values()) <= 0.6


def test_fc_kernel_path_is_refused(small_net):
    """apply(use_kernels=True) under conv_mode 'fc' raises, naming the
    missing kernel, instead of taking the plain path quietly."""
    with pytest.raises(ValueError, match="no kernel for 'fc'"):
        _port(small_net, "float32", use_kernels=True)


def test_fc_net_is_se3_equivariant():
    """A rotation and translation of the whole complex rotates tr and rot
    and leaves tor and sc_tor unchanged (1e-4 of max|ref|), on a synthetic
    sample with fresh port weights."""
    from test_score_net import random_sample

    s = random_sample(np.random.default_rng(11))
    cfg = tsn.ScoreNetConfig(conv_mode="fc", **SMALL)
    p = tsn.init_params(torch.Generator().manual_seed(4), cfg)
    R = axis_angle_to_matrix(torch.tensor([0.3, -1.1, 0.7])).numpy().astype(np.float32)
    shift = np.array([1.5, -0.5, 2.0], np.float32)
    s2 = s._replace(lig_pos=((s.lig_pos @ R.T + shift) * s.lig_mask[:, None]).astype(np.float32),
                    atm_pos=((s.atm_pos @ R.T + shift) * s.atm_mask[:, None]).astype(np.float32))
    t = torch.tensor([0.6, 0.6])
    with torch.no_grad():
        o = tsn.apply(p, cfg, to_device(stack_samples([s, s2]), "cpu"), t,
                      tsn.sigmas_from_t(t, SCHED), use_kernels=False)
    Rt = torch.from_numpy(R)
    for f in ("tr", "rot"):
        a, b = getattr(o, f)
        assert _rel(b.numpy(), (Rt @ a).numpy()) <= 1e-4, f
    for f in ("tor", "sc_tor"):
        a, b = getattr(o, f)
        assert _rel(b.numpy(), a.numpy()) <= 1e-4, f


def test_full_width_import_matches_jax_fixture():
    """The full-width synthetic reference state dict (chip_smoke's fake_reference_sd,
    seed 0) through the port's import_score_net, forward on the fixture's
    sample at t = 0.9, 0.5, 0.1 (f32, the plain path): every field within
    FULL_WIDTH_TOL of max|ref| of the JAX package's import and forward
    (measured: tr 1.4e-5, rot 4.8e-6, tor 1.5e-4, sc_tor <= 2.8e-5)."""
    from diffbindfr_torch.utils import torch_import as TTI

    ref = np.load(FIXTURE)
    cfg = tsn.ScoreNetConfig(conv_mode="fc")
    params, report = TTI.import_score_net(chip_smoke.fake_reference_sd(cfg), cfg)
    assert report.skipped == [] and report.untouched == []
    s = DockingSample(**{f: ref["sample|" + f] for f in DockingSample._fields})
    t = torch.from_numpy(ref["t"])
    sig = tsn.Sigmas(*[torch.from_numpy(ref["sig|" + k]) for k in ("tr", "rot", "tor", "sc_tor")])
    with torch.no_grad():
        out = tsn.apply(params_from_numpy(params, "cpu"), cfg,
                        to_device(stack_samples([s] * len(t)), "cpu"), t, sig, use_kernels=False)
    for f in FIELDS:
        err = _rel(getattr(out, f).numpy(), ref[f])
        print(f"full width {f}: {err:.2e}")
        assert err <= FULL_WIDTH_TOL[f], f


def _mdn_block(seed=0):
    """Torch modules and state dict of the reference MDN_Block head at
    hidden MDN_H (tests/test_torch_import.py's _synthetic_reference_block at the MDN's default
    width)."""
    torch.manual_seed(seed)
    h = MDN_H
    mods = {"MLP.0": torch.nn.Linear(2 * h, h), "MLP.1": torch.nn.BatchNorm1d(h),
            "z_pi": torch.nn.Linear(h, 10), "z_sigma": torch.nn.Linear(h, 10),
            "z_mu": torch.nn.Linear(h, 10), "atom_types": torch.nn.Linear(h, 18),
            "bond_types": torch.nn.Linear(2 * h, 5)}
    bn = mods["MLP.1"]
    bn.eval()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.normal_(1.0, 0.2)
        bn.bias.normal_(0.0, 0.3)
    return {f"mdn_layer.{name}.{k}": v.detach().numpy().astype(np.float32).copy()
            for name, m in mods.items() for k, v in m.state_dict().items()}


@pytest.mark.slow
def test_write_fc_fixture():
    """Regenerates tests/fixtures/torch_fc_ref.npz from the JAX package: its
    import_score_net of the full-width synthetic reference state dict
    (tests/test_e3nn_import.py `_fake_reference_sd`, seed 0) and
    conv_mode='fc' forward (f32, XLA path) on data/synthetic.py's sample of
    default_rng(0) (FIXTURE_BUCKETS) at t = 0.9, 0.5, 0.1; and its import_mdn_head of a
    synthetic reference MDN head with the head's pi, sigma, mu on random
    ligand and pocket features (~2 min)."""
    from types import SimpleNamespace

    from test_e3nn_import import _fake_reference_sd

    from diffbindfr_tpu.data.sample import Buckets
    from diffbindfr_tpu.data.synthetic import synthetic_sample
    from diffbindfr_tpu.models import mdn_scorer as jmdn
    from diffbindfr_tpu.sampler import SamplerConfig
    from diffbindfr_tpu.utils import torch_import as JTI

    jcfg = jsn.ScoreNetConfig(conv_mode="fc", compute_dtype="float32", dropout=0.0)
    params, _ = JTI.import_score_net(_fake_reference_sd(jcfg), jcfg)
    s = synthetic_sample(np.random.default_rng(0), Buckets(*FIXTURE_BUCKETS))
    t = jnp.asarray(T_VALUES)
    sig = jsn.sigmas_from_t(t, SamplerConfig().schedule)
    jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * len(T_VALUES))), s)
    out = jax.jit(lambda p, b, t_, sg: jsn.apply_batched(p, jcfg, b, t_, sg))(params, jb, t, sig)
    arrs = {"sample|" + f: np.asarray(getattr(s, f)) for f in s._fields}
    arrs.update({"t": T_VALUES, **{f"sig|{k}": np.asarray(v, np.float32)
                                   for k, v in sig._asdict().items()},
                 **{f: np.asarray(getattr(out, f)) for f in FIELDS}})

    sd = _mdn_block()
    mcfg = jmdn.MDNConfig()
    mp, report = JTI.import_mdn_head(sd, jmdn.init_params(jax.random.PRNGKey(0), mcfg))
    rng = np.random.default_rng(1)
    nl, nr = 5, 7
    lig_s = rng.normal(size=(nl, MDN_H)).astype(np.float32)
    pro_s = rng.normal(size=(nr, MDN_H)).astype(np.float32)
    ns_ = SimpleNamespace(atom14_mask=jnp.ones((nr, 14)), lig_mask=jnp.ones(nl),
                          res_mask=jnp.ones(nr), lig_e_src=jnp.zeros(1, jnp.int32),
                          lig_e_dst=jnp.zeros(1, jnp.int32))
    head = jmdn.mdn_head(mp, mcfg, jnp.asarray(lig_s), jnp.asarray(pro_s),
                         jnp.zeros((nl, 3)), jnp.zeros((nr, 14, 3)), ns_)
    arrs.update({"mdn|sd|" + k: v for k, v in sd.items()})
    arrs.update({"mdn|lig_s": lig_s, "mdn|pro_s": pro_s,
                 **{"mdn|" + f: np.asarray(getattr(head, f)) for f in ("pi", "sigma", "mu")}})
    for k, v in arrs.items():
        assert np.isfinite(v).all(), k
    np.savez(FIXTURE, **arrs)
