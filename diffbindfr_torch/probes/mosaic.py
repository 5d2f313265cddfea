"""P3: the cmT kernels' construct probes, on the card.

Counterpart of tools/probe_mosaic.py, whose ten pallas_calls checked on the
TPU that the cmT kernels' constructs lower and what they cost. Each computes
a plain function, and each gets a Hopper kernel for it (csrc/probe_mosaic.cu),
at the tool's shapes and on the tool's inputs (numpy default_rng(0)):

| argv   | function (TPU probe, call)          | here                          |
| 3d     | accum3d (probe_3d_accum, :40)       | (0 + x[:, :8]) + 2 x[:, 128:136] into rows 8-23 |
| onehot | onehot (probe_onehot_matmul, :68)   | gather out[:, p] = a[:, p // 128]: bit-exact |
| tile   | tile_lanes (probe_tile_lanes, :91)  | [48, 128] -> [48, 1024]       |
| bcast  | bcast2d (probe_bcast2d, :109)       | exp(-0.5 (d - offs)^2)        |
| 4d     | block4d (probe_4d_block, :129)      | 2 b[1, 1]: the last grid step wins |
| msel   | msel (probe_msel, :154)             | 128-lane group sums           |
| prec   | precision (probe_precision, :199)   | the onehot gather (one kernel serves both) |
| dw     | dwloop (probe_dwloop, :243)         | the f32 depthwise chain of the sep spec, masked, group sums |
| mlp    | mlps (probe_mlps, :291)             | the P4 kernel (probes/mlp.py) |
| abt    | abt (probe_abt, :343)               | a @ b^T, fp32 on CUDA cores, split-K (B4's contraction) |

Each wrapper runs its kernel for CUDA tensors (counted in `launches`) and
its plain version for CPU tensors. The plain versions of onehot and
precision are the fp32 matmul against the one-hot, as the TPU probe
computes them (exact with TF32 off); msel's and dwloop's sum each group in
the kernel's order. Run on the card:

    python -m diffbindfr_torch.probes.mosaic [3d onehot tile bcast 4d msel prec dw mlp abt]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..nn import contraction
from . import _cuda, cm_layout, mlp as P4

WORDS = ("3d", "onehot", "tile", "bcast", "4d", "msel", "prec", "dw", "mlp", "abt")
KERNELS = ("3d_accum", "onehot", "tile_lanes", "bcast2d", "4d_block", "msel", "dwloop", "abt")
launches = {f"probe_mosaic/{k}": 0 for k in KERNELS}
# calls of a probe in `main`: a first call, then RUNS timed ones (the tool's 5)
RUNS = 5
# kernel against plain version, max|err| / max|ref| (0: bit for bit): copies
# and single roundings are exact; exp within 1e-6; f32 sums in another order
# within 1e-5
TOL = {"3d": 0, "onehot": 0, "tile": 0, "bcast": 1e-6, "4d": 0, "msel": 1e-5, "prec": 0,
       "dw": 1e-5, "mlp": 1e-5, "abt": 1e-5}
NS, NV, R_DW, DW_REPS = 48, 12, 1024, 8
ABT = (480, 144, 1024)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _rng():
    return np.random.default_rng(0)


def _t(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the tool's inputs, per probe
# ---------------------------------------------------------------------------


def dw_spec():
    """The trunk's sep depthwise TP at flagship widths (ns 48, nv 12)."""
    from ..nn.layers import make_conv_spec

    ladder = f"{NS}x0e+{NV}x1o+{NV}x1e+{NS}x0o"
    return make_conv_spec(ladder, "1x0e+1x1o+1x2e", ladder).dw


def inputs(word: str, device="cpu"):
    """The TPU probe's inputs for `word`, as a tuple of f32 tensors."""
    rng = _rng()
    if word == "3d":
        return (_t(rng.normal(size=(16, 256)), device),)
    if word in ("onehot", "prec"):
        return (_t(rng.normal(size=(56, 64)), device),)
    if word == "tile":
        return (_t(rng.normal(size=(48, 128)), device),)
    if word == "bcast":
        d = rng.normal(size=(1, 1024))
        return _t(d, device), _t(rng.normal(size=(32, 1)), device)
    if word == "4d":
        return (_t(rng.normal(size=(2, 2, 16, 1024)), device),)
    if word == "msel":
        return (_t(rng.normal(size=(240, 1024)), device),)
    if word == "dw":
        _, ck, wn_p, din_p, _ = cm_layout.tmetas(dw_spec())
        src = rng.normal(size=(din_p, R_DW))
        w = rng.normal(size=(wn_p, R_DW))
        cb = rng.normal(size=(ck.shape[1], R_DW))
        mask = (rng.random((1, R_DW)) > 0.3).astype(np.float32)
        return tuple(_t(a, device) for a in (src, w, cb, mask))
    if word == "mlp":
        return P4.inputs(P4.R_BLOCK, device)
    if word == "abt":
        m, n, k = ABT
        return _t(rng.normal(size=(m, k)), device), _t(rng.normal(size=(n, k)), device)
    raise ValueError(f"unknown probe {word!r}: one of {WORDS}")


def want(word: str, args):
    """The TPU probe's own expectation in numpy, where it states one."""
    a = [x.cpu().numpy() for x in args]
    if word == "3d":
        out = np.zeros((2, 64, 8), np.float32)
        for j in range(2):
            out[:, 8:24, :] += a[0][:, j * 128 : j * 128 + 8] * (j + 1)
        return out
    if word in ("onehot", "prec"):
        return a[0][:, np.arange(1024) // 128]
    if word == "tile":
        return np.tile(a[0], (1, 8))
    if word == "bcast":
        return np.exp(-0.5 * (a[0] - a[1]) ** 2)
    if word == "4d":
        return a[0][1, 1] * 2.0
    if word == "msel":
        return a[0] @ onehot_matrix(1024, 8, 128).numpy()
    if word == "abt":
        return a[0] @ a[1].T
    return None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def onehot_matrix(rows: int, cols: int, group: int, transpose=False, device="cpu"):
    """[rows, cols] f32 one-hot: row r has its 1 in column r // group (with
    transpose, column c has its 1 in row c // group)."""
    if transpose:
        return onehot_matrix(cols, rows, group, device=device).t().contiguous()
    m = torch.zeros(rows, cols, dtype=torch.float32, device=device)
    m[torch.arange(rows, device=device), torch.arange(rows, device=device) // group] = 1.0
    return m


def accum3d_plain(x):
    out = torch.zeros(2, 64, 8, dtype=x.dtype, device=x.device)
    out[:, 8:24, :] = (torch.zeros_like(x[:, :8]) + x[:, 0:8] * 1.0) + x[:, 128:136] * 2.0
    return out


def onehot_plain(a):
    """a @ the [64, 1024] one-hot (column p takes row p // 128): the TPU
    probe's movement matmul, exact in fp32 without TF32."""
    return a @ onehot_matrix(a.shape[1], 1024, 128, transpose=True, device=a.device)


def tile_lanes_plain(a):
    return torch.cat([a] * 8, dim=1)


def bcast2d_plain(d, offs):
    return torch.exp(-0.5 * (d - offs) ** 2)


def block4d_plain(b):
    return b[1, 1] * 2.0


def msel_plain(z):
    """Sums of each 128-lane group in the kernel's order: each thread's 4
    lanes left to right, then the warp's butterfly over 32 threads."""
    v = z.reshape(z.shape[0], 8, 32, 4)
    return _cuda.butterfly_sum(((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3])


def _dw_tables():
    metas, _, _, _, dout_p = cm_layout.tmetas(dw_spec())
    return metas, dout_p


def dwloop_plain(src, w, cb, mask, reps: int = DW_REPS):
    """The f32 depthwise chain of _dw_paths_t (dwdt None) and the 128-lane
    group sums: per warp of 32 lanes by halving, then (w0 + w1) + (w2 + w3);
    `reps` identical blocks [reps, dout_p, R / 128]."""
    metas, dout_p = _dw_tables()
    R = src.shape[1]
    out = torch.zeros(dout_p, R // 128, dtype=torch.float32, device=src.device)
    for m in metas:
        mp, d1, d3 = m["mul_p"], m["d1"], m["d3"]
        wp = w[m["w_row"] : m["w_row"] + mp] * mask
        bs = [src[r0 : r0 + mp] * wp for r0 in m["src_rows"]]
        for k in range(d3):
            z = None
            for i2 in range(d1):
                row = m["cb_off"] + i2 * d3 + k
                t = bs[i2] * cb[row : row + 1]
                z = t if z is None else z + t
            s = _cuda.butterfly_sum(z.reshape(mp, R // 128, 4, 32))
            s = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
            out[m["out_row"] + k * mp : m["out_row"] + (k + 1) * mp] += s
    return out.expand(reps, -1, -1).contiguous()


def abt_plain(a, b):
    return a @ b.t()


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def _new(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def accum3d(x):
    if not x.is_cuda:
        return accum3d_plain(x)
    x = _cuda.check("x", x, (16, 256))
    out = _new((2, 64, 8), x)
    _cuda.launch("dbfr_probe_accum3d", (x, out))
    launches["probe_mosaic/3d_accum"] += 1
    return out


def onehot(a):
    """out [m, 1024], out[:, p] = a[:, p // 128] (a [m, >= 8])."""
    if not a.is_cuda:
        return onehot_plain(a)
    if a.shape[-1] < 8:
        raise ValueError(f"onehot: a {tuple(a.shape)} needs 8 columns")
    a = _cuda.check("a", a, a.shape)
    out = _new((a.shape[0], 1024), a)
    _cuda.launch("dbfr_probe_gather", (a, out), (a.shape[0], a.shape[1], 1024, 128))
    launches["probe_mosaic/onehot"] += 1
    return out


precision = onehot  # probe_precision: the same function at HIGHEST, one kernel


def tile_lanes(a):
    if not a.is_cuda:
        return tile_lanes_plain(a)
    a = _cuda.check("a", a, (a.shape[0], 128))
    out = _new((a.shape[0], 1024), a)
    _cuda.launch("dbfr_probe_tile", (a, out), (a.shape[0], 128, 8))
    launches["probe_mosaic/tile_lanes"] += 1
    return out


def bcast2d(d, offs):
    if not d.is_cuda:
        return bcast2d_plain(d, offs)
    n, c = d.shape[-1], offs.shape[0]
    d, offs = _cuda.check("d", d, (1, n)), _cuda.check("offs", offs, (c, 1))
    out = _new((c, n), d)
    _cuda.launch("dbfr_probe_bcast2d", (d, offs, out), (c, n))
    launches["probe_mosaic/bcast2d"] += 1
    return out


def block4d(b):
    if not b.is_cuda:
        return block4d_plain(b)
    b = _cuda.check("b", b, (2, 2) + tuple(b.shape[2:]))
    out = _new(b.shape[2:], b)
    _cuda.launch("dbfr_probe_block4d", (b, out), (out.numel(),))
    launches["probe_mosaic/4d_block"] += 1
    return out


def msel(z):
    if not z.is_cuda:
        return msel_plain(z)
    z = _cuda.check("z", z, (z.shape[0], 1024))
    out = _new((z.shape[0], 8), z)
    _cuda.launch("dbfr_probe_msel", (z, out), (z.shape[0],))
    launches["probe_mosaic/msel"] += 1
    return out


def dwloop(src, w, cb, mask, reps: int = DW_REPS):
    if not src.is_cuda:
        return dwloop_plain(src, w, cb, mask, reps)
    _, ck, wn_p, din_p, dout_p = cm_layout.tmetas(dw_spec())
    R = src.shape[1]
    if R % 128:
        raise ValueError(f"dwloop: R {R} is not a multiple of 128")
    src = _cuda.check("src", src, (din_p, R))
    w, cb = _cuda.check("w", w, (wn_p, R)), _cuda.check("cb", cb, (ck.shape[1], R))
    mask = _cuda.check("mask", mask, (1, R))
    paths = cm_layout.device_table(_dw_tables()[0], src.device)
    out = _new((reps, dout_p, R // 128), src)
    _cuda.launch("dbfr_probe_dwloop", (src, w, cb, mask, paths, out),
                 (paths.shape[0], reps, R, dout_p))
    launches["probe_mosaic/dwloop"] += 1
    return out


def mlps(e, w1, b1, w2, b2):
    """probe_mlps: the P4 kernel (counted in probes.mlp.launches)."""
    return P4.mlp(e, w1, b1, w2, b2)


def abt(a, b):
    """a @ b^T by the split-K contraction that B4's parameter gradients run
    (csrc/abt_gemm.cuh): K cut into chunks whose partial sums (a slab
    allocated here) are added in order."""
    if not a.is_cuda:
        return abt_plain(a, b)
    (m, k), n = a.shape, b.shape[0]
    a, b = _cuda.check("a", a, (m, k)), _cuda.check("b", b, (n, k))
    splits = contraction.max_splits(contraction.tiles(m, n), k, contraction.sm_count(str(a.device)))
    part = _new((splits, m * n), a)
    out = _new((m, n), a)
    _cuda.launch("dbfr_probe_abt", (a, b, part, out), (m, n, k, splits))
    launches["probe_mosaic/abt"] += 1
    return out


FUNCS = {"3d": (accum3d, accum3d_plain, "3d_accum"), "onehot": (onehot, onehot_plain, "onehot_matmul"),
         "tile": (tile_lanes, tile_lanes_plain, "tile_lanes"),
         "bcast": (bcast2d, bcast2d_plain, "bcast2d"), "4d": (block4d, block4d_plain, "4d_block"),
         "msel": (msel, msel_plain, "msel"), "prec": (precision, onehot_plain, "precision_onehot"),
         "dw": (dwloop, dwloop_plain, "dwloop"), "mlp": (mlps, P4.mlp_plain, "mlps"),
         "abt": (abt, abt_plain, "abt")}


def measure(words=WORDS, device="cuda") -> dict:
    """Per probe, as the TPU probe runs it: the first call's host seconds
    (the kernel library's build and load included on a fresh process), the
    mean ms of RUNS more calls (CUDA events), and max|err| and max|err| /
    max|ref| against the tool's own numpy expectation (None where it states
    none). CUDA only."""
    dev = _cuda.require_cuda(device)
    res = {}
    for word in words:
        fn, _, name = FUNCS[word]
        args = inputs(word, dev)
        t0 = time.time()
        got = fn(*args)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        ms = _cuda.time_ms(lambda: fn(*args), RUNS, warmup=0)
        exp = want(word, args)
        err = rel = None
        if exp is not None:
            err = float(np.abs(got.cpu().numpy() - exp).max())
            rel = err / max(float(np.abs(exp).max()), 1e-30)
        res[word] = dict(name=name, first_s=first_s, ms=ms, maxerr=err, rel=rel)
    return res


def main(argv=()) -> int:
    words = list(argv) or list(WORDS)
    bad = [w for w in words if w not in WORDS]
    if bad:
        raise SystemExit(f"unknown probes {bad}: choose from {' '.join(WORDS)}")
    fails = 0
    for word, r in measure(words).items():
        label = f"{r['name']} ({DW_REPS} blocks)" if word == "dw" else r["name"]
        line = f"{label}: first call {r['first_s']:.1f}s run {r['ms']:.4f}ms"
        if r["maxerr"] is not None:  # the tool's 1e-4, relative to max|ref| here
            ok = r["rel"] <= max(TOL[word], 1e-6)
            fails += not ok
            line += f" maxerr {r['maxerr']:.2e} ({r['rel']:.1e} of max|ref|) " \
                    f"{'OK' if ok else 'FAIL'}"
        print(line, flush=True)
    print(f"on {torch.cuda.get_device_name(0)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
