"""The probes P2-P4 of the port (diffbindfr_torch/probes/) against the JAX
tools they replace: tools/probe_mxu_ops.py (P2), tools/probe_mosaic.py
(P3) and tools/probe_timing.py (P4), run on the CPU with every pallas_call
in interpret mode. The tools have no interpret flag and are not edited:
`jax.experimental.pallas.pallas_call` is replaced, while they run, by a
wrapper that adds interpret=True and records each kernel and its specs.
Each plain version gets the tool's own inputs (numpy default_rng(0)) and is
held against the tool's output:

  * exact: the layout probes 3d_accum, onehot_matmul, precision, tile_lanes,
    4d_block (copies, products by 1 and 2, one rounded sum);
  * 1e-6 of max|ref|: bcast2d (exp), legality (a sum of 8 squares in another
    order), chain_vpu (every bf16 operation rounded as JAX rounds it; only
    the f32 sums over 32 lanes are taken in another order);
  * 1e-5 of max|ref|: msel, abt, mlps / P4, dwloop (f32 sums in another
    order), and chain_mxu's rows of d3 = 5 paths; its rows of d3 < 5 paths
    are bf16-rounded f32 sums, so each element may also differ by one bf16
    unit where the two orders put the sum on either side of a rounding
    boundary.

Also the port's cmT row plan (probes/cm_layout.py) against the JAX `_tmetas`
for both specs the probes use, and each wrapper's CPU path (the plain
version, no launch) and each `measure`'s refusal without a card.
"""
import contextlib
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from diffbindfr_tpu.nn import irreps as JIR
from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.nn.pallas_conv_t import _tmetas
from diffbindfr_torch.nn import irreps as TIR
from diffbindfr_torch.probes import cm_layout, mlp, mosaic, mxu_ops

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = "48x0e+12x1o+12x1e+12x0o"
SH = "1x0e+1x1o+1x2e"
# P2's chain at a small grid: 2 steps over 2 input blocks
REPS, NBLK = 2, 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_out():
    """Every probe of the three tools, run once in interpret mode: name ->
    (output, inputs) as numpy."""
    orig = pallas.pallas_call
    records = []

    def interpreted(kernel, **kw):
        records.append((kernel, kw))
        return orig(kernel, interpret=True, **kw)

    out = {}
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(pallas, "pallas_call", interpreted)
        mp.setenv("DIFFBINDFR_CACHE_DIR", "off")

        pm = _load("probe_mosaic")

        def run(name, fn, want, *args):
            out[name] = (np.asarray(jax.jit(fn)(*args)), [np.asarray(a) for a in args])

        mp.setattr(pm, "run", run)
        for p in ("3d_accum", "onehot_matmul", "tile_lanes", "bcast2d", "4d_block", "msel",
                  "precision", "abt"):
            getattr(pm, "probe_" + p)()
        # probe_dwloop and probe_mlps return nothing and pass their inputs
        # straight from jax.jit to the pallas_call: the tool module's `jax`
        # is replaced by one whose jit records the last call's arguments and
        # output
        jits = []

        class RecordingJax:
            def __getattr__(self, name):
                return getattr(jax, name)

            @staticmethod
            def jit(fn):
                def call(*args):
                    res = jax.jit(fn)(*args)
                    jits.append(([np.asarray(a) for a in args], np.asarray(res)))
                    return res
                return call

        mp.setattr(pm, "jax", RecordingJax())
        for p in ("dwloop", "mlps"):
            getattr(pm, "probe_" + p)()
            args, res = jits[-1]
            out[p] = (res, args)

        mx = _load("probe_mxu_ops")
        mx.legality()
        kernel, kw = records[-1]
        a = mxu_ops.legality_inputs().numpy()
        out["legality"] = (np.asarray(orig(kernel, interpret=True, **kw)(a)), [a])
        mp.setattr(mx, "REPS", REPS)
        mp.setattr(mx, "NBLK", NBLK)
        (fa, aa), (fb, ab), _, _ = mx.make_chain_kernels()
        out["chain_vpu"] = (np.asarray(fa(*aa)), [np.asarray(x) for x in aa])
        out["chain_mxu"] = (np.asarray(fb(*ab)), [np.asarray(x) for x in ab])

        pt = _load("probe_timing")  # runs its kernel 8 times at import
        out["p4"] = (np.asarray(pt.fn(*pt.args)), [np.asarray(x) for x in pt.args])
    return out


def _same_inputs(port, tool):
    assert len(port) == len(tool)
    for p, t in zip(port, tool):
        np.testing.assert_array_equal(np.asarray(p, np.float32), t)


# ---------------------------------------------------------------------------
# the cmT row plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,want", [
    ("p2", (18, 384, 160, 1216, 138)),
    ("dwloop", (12, 320, 192, 704, 68)),
])
def test_cm_layout_matches_jax_tmetas(which, want):
    """The port's tmetas equal the JAX _tmetas field by field, ck exactly,
    for P2's spec (compile_dw_tensor_product over 48x0e+12x1o+12x1e+12x0o)
    and P3 dwloop's (the sep conv spec's depthwise TP over the score net's
    ladder 48x0e+12x1o+12x1e+48x0o, as the tool builds it)."""
    if which == "p2":
        jspec = JIR.compile_dw_tensor_product(LADDER, SH, 2)
        tspec = TIR.compile_dw_tensor_product(LADDER, SH, 2)
    else:
        ladder = "48x0e+12x1o+12x1e+48x0o"
        jspec = JL.make_conv_spec(ladder, SH, ladder, "sep").dw
        tspec = mosaic.dw_spec()
    jm, jck, *jdims = _tmetas(jspec)
    tm, tck, *tdims = cm_layout.tmetas(tspec)
    assert tdims == jdims
    assert (len(tm), *tdims, tck.shape[1]) == want
    np.testing.assert_array_equal(tck, jck)
    for a, b in zip(tm, jm):
        assert a == b
    table = cm_layout.path_table(tm)
    assert table.shape == (len(tm), 16) and table.dtype == np.int32
    assert [tuple(r[:6]) for r in table] == [
        (m["mul_p"], m["d1"], m["d3"], m["w_row"], m["out_row"], m["cb_off"]) for m in jm]


# ---------------------------------------------------------------------------
# plain versions against the tools
# ---------------------------------------------------------------------------

# P3: tool probe -> argv word; tolerances mosaic.TOL (0 = exact)
MOSAIC = {"3d_accum": "3d", "onehot_matmul": "onehot", "tile_lanes": "tile", "bcast2d": "bcast",
          "4d_block": "4d", "msel": "msel", "precision_onehot": "prec", "abt": "abt",
          "dwloop": "dw", "mlps": "mlp"}


@pytest.mark.parametrize("probe", list(MOSAIC))
def test_mosaic_plain_matches_jax_probe(jax_out, probe):
    word = MOSAIC[probe]
    tol = mosaic.TOL[word]
    want, tool_args = jax_out[probe]
    args = mosaic.inputs(word)
    _same_inputs(args, tool_args[:len(args)])
    if word == "dw":  # the tool's fifth input: the group-sum one-hot
        np.testing.assert_array_equal(tool_args[4], mosaic.onehot_matrix(1024, 8, 128).numpy())
    got = mosaic.FUNCS[word][1](*args).numpy()
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= tol, _rel(got, want)


def test_p4_plain_matches_jax_probe(jax_out):
    want, tool_args = jax_out["p4"]
    args = mlp.inputs()
    _same_inputs(args, tool_args)
    got = mlp.mlp_plain(*args).numpy()
    assert got.shape == (480, 1024) and _rel(got, want) <= 1e-5


def test_legality_plain_matches_jax_probe(jax_out):
    want, (a,) = jax_out["legality"]
    got = mxu_ops.legality_plain(torch.from_numpy(a)).numpy()
    assert got.shape == (128, 16) and _rel(got, want) <= 1e-6
    assert not got[:, 10:].any()


def test_chain_vpu_plain_matches_jax_probe(jax_out):
    want, tool_args = jax_out["chain_vpu"]
    src, w, cb = mxu_ops.chain_inputs(NBLK)
    _same_inputs((src, w, cb), tool_args)
    got = mxu_ops.chain_vpu_plain(src, w, cb, REPS).numpy()
    assert got.shape == (REPS, 1216, 8) and _rel(got, want) <= 1e-6
    assert not got[..., 4:].any()


def test_chain_mxu_plain_matches_jax_probe(jax_out):
    want, tool_args = jax_out["chain_mxu"]
    src, w, cb = mxu_ops.chain_inputs(NBLK)
    cbT = mxu_ops.transpose_cb(cb)
    _same_inputs((src, w, cbT), tool_args)
    got = mxu_ops.chain_mxu_plain(src, w, cbT, REPS).numpy()
    assert got.shape == (REPS, 384, 40)
    e5, ratio = mxu_ops.mxu_errors(torch.tensor(got), torch.tensor(want))
    assert e5 <= 1e-5 and ratio <= 1.0, (e5, ratio)


# ---------------------------------------------------------------------------
# the wrappers' CPU path and the measurements' refusal without a card
# ---------------------------------------------------------------------------


def _cpu_calls():
    src, w, cb = mxu_ops.chain_inputs(1)
    calls = [(mlp, "probe_mlp", mlp.mlp, mlp.mlp_plain, mlp.inputs(32)),
             (mxu_ops, "probe_mxu_ops/legality", mxu_ops.legality, mxu_ops.legality_plain,
              (mxu_ops.legality_inputs(),)),
             (mxu_ops, "probe_mxu_ops/chain_vpu", lambda *a: mxu_ops.chain_vpu(*a, reps=3),
              lambda *a: mxu_ops.chain_vpu_plain(*a, reps=3), (src, w, cb)),
             (mxu_ops, "probe_mxu_ops/chain_mxu", lambda *a: mxu_ops.chain_mxu(*a, reps=3),
              lambda *a: mxu_ops.chain_mxu_plain(*a, reps=3),
              (src, w, mxu_ops.transpose_cb(cb)))]
    keys = {"3d": "3d_accum", "onehot": "onehot", "tile": "tile_lanes", "bcast": "bcast2d",
            "4d": "4d_block", "msel": "msel", "prec": "onehot", "dw": "dwloop", "abt": "abt"}
    for word, key in keys.items():
        fn, plain, _ = mosaic.FUNCS[word]
        calls.append((mosaic, f"probe_mosaic/{key}", fn, plain, mosaic.inputs(word)))
    return calls


def test_wrappers_take_the_plain_version_on_the_cpu():
    """Every wrapper, given CPU tensors, returns its plain version's result
    and launches nothing."""
    for mod in (mlp, mxu_ops, mosaic):
        mod.reset_launches()
    for mod, key, fn, plain, args in _cpu_calls():
        got, ref = fn(*args), plain(*args)
        assert got.device.type == "cpu" and torch.equal(got, ref), key
        assert mod.launches[key] == 0, key
    assert not any(mlp.launches.values()) and not any(mxu_ops.launches.values())
    assert not any(mosaic.launches.values())


@pytest.mark.parametrize("measure", [mlp.measure, mxu_ops.measure, mosaic.measure],
                         ids=["p4", "p2", "p3"])
def test_measure_refuses_the_cpu(measure):
    with pytest.raises(RuntimeError, match="CUDA device"):
        measure(device="cpu")


def test_probes_import_no_jax():
    """The probe modules import neither JAX, the JAX package nor tools/."""
    code = ("import sys; import diffbindfr_torch.probes.mlp, diffbindfr_torch.probes.mxu_ops, "
            "diffbindfr_torch.probes.mosaic, diffbindfr_torch.probes.cm_layout; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'diffbindfr_tpu', 'tools') or m.startswith('probe_')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr
