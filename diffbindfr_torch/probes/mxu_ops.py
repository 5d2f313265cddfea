"""P2: the depthwise chain on CUDA cores against tensor cores, on the card.

Counterpart of tools/probe_mxu_ops.py (legality, the pallas_call at :80;
make_chain_kernels' run_vpu :194 and run_mxu :207), which rated on the TPU
the cmT kernels' bf16 depthwise chain as vector arithmetic and as one
matrix-unit contraction per path, at the flagship ladder
48x0e+12x1o+12x1e+12x0o x sh (18 paths; cmT row plan: wn_p 384, din_p 160,
dout_p 1216, kdim 138). Here (csrc/probe_mxu_ops.cu):

  * legality  a [128, 8] -> [128, 16]: the l <= 2 monomials 1, x, y, z,
              xy, yz, zz, xz, xx - yy of columns 0-2, the row's sum of
              squares, then zeros;
  * chain_vpu grid step i reads input block i % nblk; per path
              bs = src * w, t = bs * cb, z_k = sum over i2 of t, each bf16
              operation rounded (CUDA cores, bf16x2), then the f32 sum over
              each 32-lane group -> [reps, dout_p, 8] (columns 4-7 zero),
              a warp's rows summed by reduce-scatter in the order of
              `_cuda.butterfly_sum`;
  * chain_mxu per path lhs [mp, d1*128] = bf16(src * w) @ rhs [d1*128, d3*8]
              (the one-hot-expanded cb rows) in bf16 with an f32 sum on the
              tensor cores (mma.sync m16n8k16), rows w_row.. of
              [reps, wn_p, 40]; paths with d3 < 5 are rounded to bf16, as the
              TPU kernel's one-hot pad product rounds them.

Each wrapper runs its kernel for CUDA tensors (counted in `launches`) and
its plain version for CPU tensors. `measure` times both chain forms at the
tool's REPS = 4096 steps over NBLK = 64 input blocks. Run on the card:

    python -m diffbindfr_torch.probes.mxu_ops [legality|chain|both]
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from . import _cuda, cm_layout

REPS, NBLK = 4096, 64
LANES, TPLP, GROUP = 128, 8, 32
launches = {"probe_mxu_ops/legality": 0, "probe_mxu_ops/chain_vpu": 0,
            "probe_mxu_ops/chain_mxu": 0}
# timed calls per chain form in `main`, after a first call (the tool's n=3)
RUNS = 3


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def spec():
    """The score net's depthwise TP at flagship widths (ns 48, nv 12)."""
    from ..nn.irreps import compile_dw_tensor_product

    return compile_dw_tensor_product("48x0e+12x1o+12x1e+12x0o", "1x0e+1x1o+1x2e", 2)


@functools.lru_cache(maxsize=None)
def plan():
    """(path metas, wn_p, din_p, dout_p, kdim, d3max) of `spec()`, built once
    (a wrapper call would otherwise spend longer on it than chain_vpu runs)."""
    metas, ck, wn_p, din_p, dout_p = cm_layout.tmetas(spec())
    return metas, wn_p, din_p, dout_p, ck.shape[1], max(m["d3"] for m in metas)


def legality_inputs(device="cpu"):
    a = np.random.default_rng(0).normal(size=(128, 8))
    return torch.tensor(a, dtype=torch.float32, device=device)


def chain_inputs(nblk: int = NBLK, device="cpu"):
    """(src [nblk, din_p, 128], w [nblk, wn_p, 128], cb [nblk, kdim, 128]) as
    the tool draws them (default_rng(0), in that order); cbT is cb with its
    last two axes swapped, contiguous."""
    _, wn_p, din_p, _, kdim, _ = plan()
    rng = np.random.default_rng(0)
    return tuple(torch.tensor(rng.normal(size=(nblk, n, LANES)), dtype=torch.float32,
                              device=device) for n in (din_p, wn_p, kdim))


def transpose_cb(cb):
    return cb.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def legality_plain(a):
    x, y, z = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    sh = torch.cat([torch.ones_like(x), x, y, z, x * y, y * z, z * z, x * z, x * x - y * y], 1)
    s = (a * a).sum(1, keepdim=True)
    return torch.cat([sh, s, torch.zeros_like(a[:, 0:6])], 1)


def chain_vpu_plain(src, w, cb, reps: int = REPS):
    """Every chain operation in bf16, rounded as the kernel rounds it; the
    32-lane group sums in f32 in the order of the kernel's warp butterfly.
    Computed once per input block, then repeated over the grid steps."""
    metas, _, _, dout_p, _, _ = plan()
    nblk = src.shape[0]
    s16, w16, c16 = (t.to(torch.bfloat16) for t in (src, w, cb))
    out = torch.zeros(nblk, dout_p, TPLP, dtype=torch.float32, device=src.device)
    for m in metas:
        mp, d1, d3 = m["mul_p"], m["d1"], m["d3"]
        wp = w16[:, m["w_row"] : m["w_row"] + mp]
        bs = [s16[:, r0 : r0 + mp] * wp for r0 in m["src_rows"]]
        for k in range(d3):
            z = None
            for i2 in range(d1):
                row = m["cb_off"] + i2 * d3 + k
                t = bs[i2] * c16[:, row : row + 1]
                z = t if z is None else z + t
            g = _cuda.butterfly_sum(z.float().reshape(nblk, mp, LANES // GROUP, GROUP))
            o = m["out_row"] + k * mp
            out[:, o : o + mp, : LANES // GROUP] += g
    return out[torch.arange(reps, device=src.device) % nblk]


def chain_mxu_plain(src, w, cbT, reps: int = REPS):
    """The TPU kernel's contraction: lhs and the one-hot-expanded rhs in bf16,
    their product as an f32 matmul (exact products; TF32 off), bf16-rounded
    for paths with d3 < d3max; rows w_row.., columns past d3 * 8 zero."""
    metas, wn_p, _, _, _, d3max = plan()
    nblk, dev = src.shape[0], src.device
    s16, w16, c16 = (t.to(torch.bfloat16) for t in (src, w, cbT))
    m8 = torch.zeros(LANES, TPLP, dtype=torch.bfloat16, device=dev)
    m8[torch.arange(LANES), torch.arange(LANES) * 4 // LANES] = 1.0
    out = torch.zeros(nblk, wn_p, d3max * TPLP, dtype=torch.float32, device=dev)
    for m in metas:
        mp, d1, d3 = m["mul_p"], m["d1"], m["d3"]
        wp = w16[:, m["w_row"] : m["w_row"] + mp]
        lhs = torch.cat([s16[:, r0 : r0 + mp] * wp for r0 in m["src_rows"]], dim=2)
        rows = []
        for i2 in range(d1):
            c0 = m["cb_off"] + i2 * d3
            cols = c16[:, :, c0 : c0 + d3]  # [nblk, 128, d3]
            rows.append((cols[:, :, :, None] * m8[None, :, None, :]).reshape(nblk, LANES, -1))
        rhs = torch.cat(rows, dim=1)  # [nblk, d1 * 128, d3 * 8]
        mk = torch.matmul(lhs.float(), rhs.float())
        if d3 < d3max:
            mk = mk.to(torch.bfloat16).float()
        out[:, m["w_row"] : m["w_row"] + mp, : d3 * TPLP] = mk
    return out[torch.arange(reps, device=dev) % nblk]


def _rows(metas, d3_five: bool):
    d3max = max(m["d3"] for m in metas)
    return [r for m in metas if (m["d3"] == d3max) == d3_five
            for r in range(m["w_row"], m["w_row"] + m["mul_p"])]


def mxu_errors(got, ref):
    """chain_mxu against a reference, by the gate's two measures: max|err| /
    max|ref| over the rows of d3 = d3max paths (f32 sums in another order:
    gate 1e-5), and over the rows of the other paths, which are bf16-rounded
    f32 sums, the largest |err| / (one bf16 unit of the reference element +
    1e-5 max|ref|) (gate 1: the two sums may lie on either side of a bf16
    rounding boundary)."""
    metas = plan()[0]
    five, rest = _rows(metas, True), _rows(metas, False)
    g5, r5 = got[:, five].double(), ref[:, five].double()
    e5 = float((g5 - r5).abs().max() / r5.abs().max().clamp_min(1e-30))
    g, r = got[:, rest].double(), ref[:, rest].double()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(torch.finfo(torch.float32).tiny)))
                     - 7)
    return e5, float(((g - r).abs() / (ulp + 1e-5 * r.abs().max())).max())


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _path_table(device):
    metas = plan()[0]
    for m in metas:
        if m["d1"] not in (1, 3, 5) or m["d3"] not in (1, 3, 5) or m["mul_p"] % 16 \
                or m["mul_p"] > 48:
            raise ValueError(f"path {m}: the kernels take d1, d3 in (1, 3, 5) and mul_p "
                             "a multiple of 16 up to 48")
    # chain_vpu writes each output row once (the plain version adds paths' rows)
    spans = sorted((m["out_row"], m["out_row"] + m["mul_p"] * m["d3"]) for m in metas)
    if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError("the paths' output rows overlap")
    return cm_layout.device_table(metas, device)


def legality(a):
    if not a.is_cuda:
        return legality_plain(a)
    a = _cuda.check("a", a, (128, 8))
    out = torch.empty(128, 16, dtype=torch.float32, device=a.device)
    _cuda.launch("dbfr_probe_legality", (a, out))
    launches["probe_mxu_ops/legality"] += 1
    return out


def _chain_args(src, w, cb_or_t, transposed):
    _, wn_p, din_p, _, kdim, _ = plan()
    nblk = src.shape[0]
    src = _cuda.check("src", src, (nblk, din_p, LANES))
    w = _cuda.check("w", w, (nblk, wn_p, LANES))
    shape = (nblk, LANES, kdim) if transposed else (nblk, kdim, LANES)
    return src, w, _cuda.check("cbT" if transposed else "cb", cb_or_t, shape), nblk


def chain_vpu(src, w, cb, reps: int = REPS):
    """[reps, dout_p, 8]: the kernel for CUDA tensors, else chain_vpu_plain."""
    if not src.is_cuda:
        return chain_vpu_plain(src, w, cb, reps)
    _, wn_p, din_p, dout_p, kdim, _ = plan()
    src, w, cb, nblk = _chain_args(src, w, cb, False)
    paths = _path_table(src.device)
    out = torch.empty(reps, dout_p, TPLP, dtype=torch.float32, device=src.device)
    _cuda.launch("dbfr_probe_chain_vpu", (src, w, cb, paths, out),
                 (paths.shape[0], reps, nblk, din_p, wn_p, kdim, dout_p))
    launches["probe_mxu_ops/chain_vpu"] += 1
    return out


def chain_mxu(src, w, cbT, reps: int = REPS):
    """[reps, wn_p, 40]: the kernel for CUDA tensors, else chain_mxu_plain."""
    if not src.is_cuda:
        return chain_mxu_plain(src, w, cbT, reps)
    _, wn_p, din_p, _, kdim, d3max = plan()
    src, w, cbT, nblk = _chain_args(src, w, cbT, True)
    paths = _path_table(src.device)
    out = torch.empty(reps, wn_p, d3max * TPLP, dtype=torch.float32, device=src.device)
    _cuda.launch("dbfr_probe_chain_mxu", (src, w, cbT, paths, out),
                 (paths.shape[0], reps, nblk, din_p, wn_p, kdim, d3max))
    launches["probe_mxu_ops/chain_mxu"] += 1
    return out


def counts():
    """Per grid step: the tool's madd count of the chain (Σ mul_p · 128 ·
    d1 · (1 + 2 d3)) and its MXU FLOP count (Σ 2 mul_p · d1 · 128 · d3 · 8)."""
    metas = plan()[0]
    madds = sum(m["mul_p"] * LANES * m["d1"] * (1 + 2 * m["d3"]) for m in metas)
    flops = sum(2 * m["mul_p"] * m["d1"] * LANES * m["d3"] * TPLP for m in metas)
    return madds, flops


def measure(reps: int = REPS, nblk: int = NBLK, device="cuda") -> dict:
    """Both chain forms at `reps` steps over `nblk` input blocks: ms per call
    (CUDA events, after a first call, RUNS calls), the tool's rates (Tmadd/s
    of the VPU form, effective TF/s of the MXU form) and their speedup. CUDA
    only: a measurement without a card fails."""
    dev = _cuda.require_cuda(device)
    src, w, cb = chain_inputs(nblk, dev)
    cbT = transpose_cb(cb)
    ta = _cuda.time_ms(lambda: chain_vpu(src, w, cb, reps), RUNS)
    tb = _cuda.time_ms(lambda: chain_mxu(src, w, cbT, reps), RUNS)
    madds, flops = counts()
    return dict(paths=len(plan()[0]), reps=reps, nblk=nblk, vpu_ms=ta, mxu_ms=tb,
                tmadd_s=madds * reps / (ta * 1e-3) / 1e12,
                tflops_eff=flops * reps / (tb * 1e-3) / 1e12, speedup=ta / tb)


def main(argv=()) -> int:
    what = argv[0] if argv else "both"
    if what not in ("legality", "chain", "both"):
        raise SystemExit(f"unknown probe {what!r}: legality, chain or both")
    dev = _cuda.require_cuda("cuda")
    rc = 0
    if what in ("legality", "both"):
        a = legality_inputs(dev)
        got = legality(a).cpu().numpy()
        an = a.cpu().numpy()
        x, y, z = an[:, 0], an[:, 1], an[:, 2]
        exp = np.stack([np.ones_like(x), x, y, z, x * y, y * z, z * z, x * z, x * x - y * y], 1)
        err = np.abs(got[:, 0:9] - exp).max()
        err2 = np.abs(got[:, 9] - (an * an).sum(1)).max()
        rc |= not (err < 1e-6 and err2 < 1e-5 and not got[:, 10:].any())
        print(f"[legality] {'OK' if not rc else 'FAIL'} — sh err {err:.2e}, "
              f"lane-reduce err {err2:.2e}", flush=True)
    if what in ("chain", "both"):
        r = measure(device=dev)
        print(f"[chain] paths={r['paths']} REPS={r['reps']}")
        print(f"[chain] VPU-form {r['vpu_ms']:.2f} ms ({r['tmadd_s']:.2f} Tmadd/s)", flush=True)
        print(f"[chain] MXU-form {r['mxu_ms']:.2f} ms ({r['tflops_eff']:.2f} TF/s eff) "
              f"-> speedup x{r['speedup']:.2f} on {torch.cuda.get_device_name(0)}", flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
