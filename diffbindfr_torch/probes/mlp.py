"""P4: the fused two-layer MLP of one cmT block, on the card.

Counterpart of tools/probe_timing.py (fn, the pallas_call at :22), which
timed the cmT kernels' TP-weight MLP on one 1024-pair block of the TPU;
tools/probe_mosaic.py's probe_mlps (:291) has the same body and shapes and
is served by the same kernel (probes/mosaic.py `mlps`).

    out[480, R] = w2 @ relu(w1 @ e + b1),  e [144, R], w1 [144, 144],
                  b1 [144, 1], w2 [480, 144], b2 [480, 1]

b2 is passed in and never added, as in the TPU kernel. `mlp` is the
wrapper: the CUDA kernel (csrc/probe_mlp.cu) for CUDA tensors, counted in
`launches`, else `mlp_plain`. `measure` times the kernel at R = 1024 (the
TPU probe's block) and R = 32 (B1's chunk width). Run on the card:

    python -m diffbindfr_torch.probes.mlp
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import _cuda

H, WN_P = 144, 480
R_BLOCK, R_CHUNK = 1024, 32
MEASURE_ITERS = 50
launches = {"probe_mlp": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def inputs(R: int = R_BLOCK, device="cpu"):
    """(e, w1, b1, w2, b2) as the TPU probe draws them: standard normal from
    numpy's default_rng(0), in that order, cast to f32."""
    rng = np.random.default_rng(0)
    return tuple(torch.tensor(rng.normal(size=s), dtype=torch.float32, device=device)
                 for s in [(H, R), (H, H), (H, 1), (WN_P, H), (WN_P, 1)])


def mlp_plain(e, w1, b1, w2, b2):
    return w2 @ torch.relu(w1 @ e + b1)


def mlp(e, w1, b1, w2, b2):
    """out [480, R]: the CUDA kernel for CUDA tensors, else mlp_plain."""
    if not e.is_cuda:
        return mlp_plain(e, w1, b1, w2, b2)
    R = e.shape[-1]
    e = _cuda.check("e", e, (H, R))
    w1, b1 = _cuda.check("w1", w1, (H, H)), _cuda.check("b1", b1, (H, 1))
    w2 = _cuda.check("w2", w2, (WN_P, H))
    _cuda.check("b2", b2, (WN_P, 1))
    out = torch.empty(WN_P, R, dtype=torch.float32, device=e.device)
    _cuda.launch("dbfr_probe_mlp", (e, w1, b1, w2, out), (R,))
    launches["probe_mlp"] += 1
    return out


def work(R: int):
    """(fp32 operations, bytes) of one call: both products, the bias add and
    the ReLU; each input it reads read once (e, w1, b1, w2: b2 is never
    read), the output written once."""
    ops = 2.0 * H * H * R + 2.0 * WN_P * H * R + 2.0 * H * R
    byts = 4.0 * (H * R + H * H + H + WN_P * H + WN_P * R)
    return ops, byts


def measure(device="cuda", iters: int = MEASURE_ITERS) -> dict:
    """Per R in (1024, 32): the kernel's ms per call (CUDA events) and its
    GFLOP/s. CUDA only: a measurement without a card fails."""
    dev = _cuda.require_cuda(device)
    out = {}
    for R in (R_BLOCK, R_CHUNK):
        args = inputs(R, dev)
        ms = _cuda.time_ms(lambda: mlp(*args), iters)
        out[R] = dict(ms=ms, gflops=work(R)[0] / (ms * 1e-3) / 1e9)
    return out


def main(argv=()) -> int:
    """The TPU probe's run: 8 timed calls at R = 1024, each ended by a host
    read of out[0, 0]; then the kernel's rate at R = 1024 and 32."""
    dev = _cuda.require_cuda("cuda")
    args = inputs(R_BLOCK, dev)
    for it in range(8):
        t0 = time.time()
        out = mlp(*args)
        s = float(out[0, 0])
        print(f"iter {it}: {time.time() - t0:.3f}s (s={s:.3f})", flush=True)
    for R, r in measure(dev).items():
        print(f"R={R}: {r['ms'] * 1e3:.2f} us per call, {r['gflops']:.0f} GFLOP/s "
              f"on {torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
