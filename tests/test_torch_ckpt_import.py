"""Reference-checkpoint import of the port (diffbindfr_torch/utils/
e3nn_compat.py and torch_import.py) against the JAX package's
(diffbindfr_tpu/utils/e3nn_compat.py, torch_import.py), on the CPU.

Every e3nn_compat function equals the JAX package's within 1e-12 (both are
numpy float64 over the same SH basis and Clebsch-Gordan solver).
import_score_net maps the synthetic reference state dicts
(tests/test_e3nn_import.py `_fake_reference_sd`) at the small config and at
full width onto the same leaves as the JAX import, bit for bit, with equal
reports; import_mdn_head likewise on tests/test_torch_import.py's
`_synthetic_reference_block`. The two packages fill the leaves they leave at
init from their own generators, so only the mapped leaves are compared. The
command line converts a .pth into an npz that the port's load_checkpoint
reads, and refuses the score net without --unverified-scorenet, with the
JAX package's text. chip_smoke.fake_reference_sd (the card run's copy of the
state-dict function) equals the JAX test's, key for key.
"""
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diffbindfr_tpu.models import mdn_scorer as jmdn
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.nn import irreps as JIR
from diffbindfr_tpu.utils import checkpoint as JCK
from diffbindfr_tpu.utils import e3nn_compat as JE
from diffbindfr_tpu.utils import torch_import as JTI
from diffbindfr_torch.models import mdn_scorer as tmdn
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.nn import irreps as TIR
from diffbindfr_torch.utils import checkpoint as TCK
from diffbindfr_torch.utils import e3nn_compat as TE
from diffbindfr_torch.utils import torch_import as TTI

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (fake_reference_sd, shared with the card run)
from test_e3nn_import import MODEL_TRIPLES, _fake_reference_sd  # noqa: E402
from test_torch_import import _synthetic_reference_block  # noqa: E402

SH = "1x0e+1x1o+1x2e"
SMALL = dict(ns=8, nv=4, num_conv_layers=3, sigma_embed_dim=8, distance_embed_dim=8)


def _same(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max(initial=0.0) <= tol


def _cfgs(full: bool):
    kw = {} if full else SMALL
    return (jsn.ScoreNetConfig(conv_mode="fc", compute_dtype="float32", dropout=0.0, **kw),
            tsn.ScoreNetConfig(conv_mode="fc", **kw))


def _rand_R(seed):
    q = np.random.default_rng(seed).normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


# ---------------------------------------------------------------------------
# e3nn_compat, function by function
# ---------------------------------------------------------------------------

def test_sh_and_basis_change_match_jax():
    """sh_e3nn, _csh, _q_real_to_complex, basis_change, _wigner_e3nn."""
    v = np.random.default_rng(0).normal(size=(32, 3))
    _same(TE.sh_e3nn(v), JE.sh_e3nn(v))
    for l in (0, 1, 2):
        _same(TE._csh(l, v), JE._csh(l, v))
        _same(TE._sh_e3nn_l(l, v), JE._sh_e3nn_l(l, v))
        _same(TE._q_real_to_complex(l), JE._q_real_to_complex(l))
        _same(TE.basis_change(l), JE.basis_change(l))
        _same(TE._wigner_e3nn(l, _rand_R(l)), JE._wigner_e3nn(l, _rand_R(l)))


@pytest.mark.parametrize("tri", MODEL_TRIPLES + [(2, 2, 1), (2, 2, 2)])
def test_w3j_and_path_scale_match_jax(tri):
    """_cg_complex, w3j_e3nn and path_scale of each coupling the score net
    uses (and two more)."""
    _same(TE._cg_complex(*tri), JE._cg_complex(*tri))
    _same(TE.w3j_e3nn(*tri), JE.w3j_e3nn(*tri))
    if max(tri) <= 2:
        assert TE.path_scale(*tri) == JE.path_scale(*tri)


def _full_width_convs():
    cfg = tsn.ScoreNetConfig(conv_mode="fc")
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    return [cfg.layer_irreps(l) for l in range(cfg.num_conv_layers)] + [(final_in, "2x1o+2x1e")]


@pytest.mark.parametrize("conv", range(7))
def test_fctp_weight_maps_match_jax(conv):
    """fctp_instructions, E3nnFCTP (offsets, alphas, outputs) and
    convert_fctp_weights of every full-width conv (6 trunk layers, the
    final conv)."""
    in_s, out_s = _full_width_convs()[conv]
    ti, tsh, to = (TIR.Irreps.parse(s) for s in (in_s, SH, out_s))
    ji, jsh, jo = (JIR.Irreps.parse(s) for s in (in_s, SH, out_s))
    assert TE.fctp_instructions(ti, tsh, to) == JE.fctp_instructions(ji, jsh, jo)
    tf, jf = TE.E3nnFCTP(ti, tsh, to), JE.E3nnFCTP(ji, jsh, jo)
    assert (tf.weight_numel, tf.offsets, tf.alphas) == (jf.weight_numel, jf.offsets, jf.alphas)
    rng = np.random.default_rng(conv)
    x1, x2, w = (rng.normal(size=(4, d)) for d in (ti.dim, tsh.dim, tf.weight_numel))
    _same(tf(x1, x2, w), jf(x1, x2, w), 1e-10)
    _same(TE.convert_fctp_weights(in_s, SH, out_s), JE.convert_fctp_weights(in_s, SH, out_s))
    _same(TE.irreps_basis_matrix(ti), JE.irreps_basis_matrix(ji))


def test_tor_weight_map_and_full_tp_match_jax():
    """full_tp_slots_e3nn, e3nn_full_tp and convert_tor_fctp_weights of the
    full-width torque convs."""
    cfg = tsn.ScoreNetConfig(conv_mode="fc")
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    out_s = f"{cfg.ns}x0o+{cfg.ns}x0e"
    ts, js = TIR.Irreps.parse(SH), JIR.Irreps.parse(SH)
    tb, jb = TIR.Irreps.parse("1x2e"), JIR.Irreps.parse("1x2e")
    assert TE.full_tp_slots_e3nn(ts, tb) == JE.full_tp_slots_e3nn(js, jb)
    rng = np.random.default_rng(5)
    x1, x2 = rng.normal(size=(6, 9)), rng.normal(size=(6, 5))
    (ty, tsl), (jy, jsl) = TE.e3nn_full_tp(ts, tb, x1, x2), JE.e3nn_full_tp(js, jb, x1, x2)
    _same(ty, jy)
    assert tsl == jsl
    tp, tsc, tfix = TE.convert_tor_fctp_weights(final_in, "1x2e", out_s)
    jp_, jsc, jfix = JE.convert_tor_fctp_weights(final_in, "1x2e", out_s)
    _same(tp, jp_)
    _same(tsc, jsc)
    assert tfix == jfix


# ---------------------------------------------------------------------------
# the importers
# ---------------------------------------------------------------------------

def _flat(tree, ck):
    return ck._flatten(tree)


@pytest.mark.parametrize("full", [False, True], ids=["small", "full_width"])
def test_import_score_net_matches_jax(full):
    """Every leaf of the converted tree (all are mapped: the report leaves
    none at init) equal to the JAX import's, bit for bit, and the reports
    equal (mapped, skipped, untouched)."""
    jcfg, tcfg = _cfgs(full)
    sd = _fake_reference_sd(jcfg)
    jp, jr = JTI.import_score_net(sd, jcfg)
    tp, tr = TTI.import_score_net(sd, tcfg)
    assert (tr.mapped, tr.skipped, tr.untouched) == (jr.mapped, jr.skipped, jr.untouched)
    assert tr.skipped == [] and tr.untouched == []
    fj, ft = _flat(jp, JCK), _flat(tp, TCK)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_array_equal(ft[k], np.asarray(fj[k]), err_msg=k)
    assert str(tr) == str(jr)


def test_import_mdn_head_matches_jax():
    """The synthetic reference MDN_Block onto each package's fresh MDN tree
    (hidden 32): the mapped leaves equal, bit for bit, and the reports
    equal; the encoders stay at init (reported)."""
    _, sd_t = _synthetic_reference_block()
    sd = {k: v.numpy().astype(np.float32) for k, v in sd_t.items()}
    jp, jr = JTI.import_mdn_head(dict(sd), jmdn.init_params(jax.random.PRNGKey(0),
                                                            jmdn.MDNConfig(hidden=32)))
    tp, tr = TTI.import_mdn_head(dict(sd), TTI._numpy_tree(tmdn.init_params(
        torch.Generator().manual_seed(0), tmdn.MDNConfig(hidden=32))))
    assert (tr.mapped, tr.skipped, tr.untouched) == (jr.mapped, jr.skipped, jr.untouched)
    assert "gt_layers" in tr.untouched and len(tr.mapped) == 16
    for name in ("pair_l", "pair_p", "pair_norm", "z_pi", "z_sigma", "z_mu", "atom_types",
                 "bond_types"):
        fj, ft = _flat(jp[name], JCK), _flat(tp[name], TCK)
        assert sorted(fj) == sorted(ft), name
        for k in fj:
            np.testing.assert_array_equal(ft[k], np.asarray(fj[k]), err_msg=f"{name}/{k}")


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(2)
    g, b, m, v = (rng.normal(size=8).astype(np.float32) for _ in range(4))
    v = np.abs(v) + 0.5
    for x, y in zip(TTI.fold_batchnorm(g, b, m, v), JTI.fold_batchnorm(g, b, m, v)):
        np.testing.assert_array_equal(x, y)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "diffbindfr_torch.utils.torch_import", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_converts_a_pth_that_load_checkpoint_reads(tmp_path):
    """`python -m diffbindfr_torch.utils.torch_import ref.pth -o net.npz
    --arch score_net --unverified-scorenet --ns 8 --nv 4 --layers 3 --sed 8
    --ded 8` on an mmcv-wrapped, DataParallel-prefixed synthetic reference
    state dict: the npz loads with the port's load_checkpoint into the tree
    import_score_net gives, and drives the 'fc' net to finite scores; the
    MDN arch likewise (the encoders' keys skipped and reported)."""
    jcfg, tcfg = _cfgs(False)
    sd = _fake_reference_sd(jcfg)
    pth, out = tmp_path / "ref.pth", tmp_path / "net.npz"
    torch.save({"meta": {"epoch": 1},
                "state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, pth)
    proc = _cli(str(pth), "-o", str(out), "--arch", "score_net", "--unverified-scorenet",
                "--ns", "8", "--nv", "4", "--layers", "3", "--sed", "8", "--ded", "8")
    assert proc.returncode == 0, proc.stderr
    assert f"wrote {out}" in proc.stdout and "mapped exactly" in proc.stdout
    params, _ = TCK.load_checkpoint(str(out), device="cpu")
    want, _ = TTI.import_score_net(sd, tcfg)
    fw, fg = TCK._flatten(want), TCK._flatten(params)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    from test_score_net import random_sample

    from diffbindfr_torch.data.sample import stack_samples, to_device

    t = torch.tensor([0.5])
    sched = {k: v for k, v in chip_smoke.SCHED.items()}
    with torch.no_grad():
        o = tsn.apply(params, tcfg, to_device(stack_samples([random_sample(
            np.random.default_rng(1))]), "cpu"), t, tsn.sigmas_from_t(t, sched),
            use_kernels=False)
    assert all(bool(torch.isfinite(getattr(o, f)).all()) for f in o._fields)

    _, msd = _synthetic_reference_block()
    mpth, mout = tmp_path / "mdn.pth", tmp_path / "mdn.npz"
    torch.save({"state_dict": {**msd, "lig_encoder.w": torch.zeros(3)}}, mpth)
    proc = _cli(str(mpth), "-o", str(mout), "--arch", "mdn")
    assert proc.returncode != 0 and "incompatible with hidden=128" in proc.stderr
    mp, mr = TTI.import_checkpoint(str(mpth), arch="mdn", cfg=tmdn.MDNConfig(hidden=32))
    assert mr.skipped == ["lig_encoder.w"] and "gt_layers" in mr.untouched
    TCK.save_checkpoint(str(mout), mp)
    back, _ = TCK.load_checkpoint(str(mout), device="cpu")
    np.testing.assert_array_equal(back["pair_norm"]["scale"].numpy(), mp["pair_norm"]["scale"])


def test_score_net_refused_without_the_flag(tmp_path):
    """Without --unverified-scorenet the score net is refused with the JAX
    package's text, by import_checkpoint and by the command line."""
    jcfg, tcfg = _cfgs(False)
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in _fake_reference_sd(jcfg).items()}}, pth)
    with pytest.raises(NotImplementedError) as te:
        TTI.import_checkpoint(str(pth), arch="score_net", cfg=tcfg)
    with pytest.raises(NotImplementedError) as je:
        JTI.import_checkpoint(str(pth), arch="score_net", cfg=jcfg)
    assert str(te.value) == str(je.value) and "--unverified-scorenet" in str(te.value)
    proc = _cli(str(pth), "-o", str(tmp_path / "x.npz"), "--arch", "score_net")
    assert proc.returncode != 0 and "--unverified-scorenet" in proc.stderr
    assert not os.path.exists(tmp_path / "x.npz")
    with pytest.raises(ValueError, match="conv_mode='fc'"):
        TTI.import_score_net({}, tsn.ScoreNetConfig())


@pytest.mark.parametrize("full", [False, True], ids=["small", "full_width"])
def test_chip_smoke_state_dict_equals_the_tests(full):
    """chip_smoke.fake_reference_sd (written against the port's
    e3nn_compat) and the JAX test's _fake_reference_sd give the same keys,
    shapes and values (both draw from numpy's default_rng(0))."""
    jcfg, tcfg = _cfgs(full)
    a, b = chip_smoke.fake_reference_sd(tcfg), _fake_reference_sd(jcfg)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert math.isfinite(sum(float(v.sum()) for v in a.values()))
