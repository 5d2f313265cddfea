"""P1: does packed bf16 arithmetic pay on the card's CUDA cores?

Counterpart of tools/probe_bf16.py (make_probe, the pallas_call at :48),
which measured packed bf16 against f32 on the TPU's vector unit before the
cmT kernels' depthwise chain went bf16. Here the chain
acc = acc * w + x + pert (pert = step * 1e-6, so that no step folds into
another) runs over a [rows, lanes] block for `reps` steps in three
arithmetics (csrc/probe_bf16.cu):
  * f32_fma:        f32, an fma and an add per step;
  * bf16x2_mul_add: packed bf16x2, every product and sum rounded to bf16
                    (the rounding of the B11 chain and of the JAX reference);
  * bf16x2_fma:     packed bf16x2 with a fused multiply-add (one rounding
                    fewer than the reference's order).
`measure` times R and 2R steps with CUDA events and takes the per-step
("sweep") time from the difference, as the TPU probe does; its GFLOP/s
count 2 operations per element and step (a multiply-add), the TPU probe's
convention, and `gops` counts every rounded operation (3 per element and
step). `chain` is the wrapper: the kernel for CUDA tensors (counted in
`launches`), the plain version `chain_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

VARIANTS = ("f32_fma", "bf16x2_mul_add", "bf16x2_fma")
launches = {f"probe_bf16/{v}": 0 for v in VARIANTS}

# elements per thread of the kernel: one 16-byte vector
_VEC = {"f32_fma": 4, "bf16x2_mul_add": 8, "bf16x2_fma": 8}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def dtype_of(variant: str) -> torch.dtype:
    return torch.float32 if variant == "f32_fma" else torch.bfloat16


def inputs(rows: int, lanes: int, variant: str, device="cpu"):
    """(x, w) as the TPU probe draws them: x uniform in [0, 1), w in
    [1, 1.001), in the variant's dtype."""
    x = np.random.RandomState(0).rand(rows, lanes)
    w = 1.0 + np.random.RandomState(1).rand(rows, lanes) * 1e-3
    dt = dtype_of(variant)
    return (torch.tensor(x, dtype=torch.float32, device=device).to(dt),
            torch.tensor(w, dtype=torch.float32, device=device).to(dt))


def _pert(step: int, dt: torch.dtype, device):
    p = torch.tensor(float(step), dtype=torch.float32, device=device) * torch.tensor(
        1e-6, dtype=torch.float32, device=device)
    return p.to(dt)


def chain_plain(x, w, reps: int, variant: str):
    """The chain in PyTorch. f32_fma: multiply and add rounded separately
    (the kernel's fma rounds once: they differ by f32 rounding);
    bf16x2_mul_add: every bf16 operation rounded, as the kernel;
    bf16x2_fma: the product and sum exact in f64, then rounded."""
    acc = torch.zeros_like(x)
    for r in range(reps):
        pert = _pert(r, x.dtype, x.device)
        if variant == "bf16x2_fma":
            t = (acc.double() * w.double() + x.double()).to(torch.bfloat16)
            acc = t + pert
        else:
            acc = acc * w + x + pert
    return acc


def _library():
    from ..utils import cuda_build

    lib = cuda_build.load()
    fn = lib.dbfr_probe_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def chain(x, w, reps: int, variant: str):
    """The chain on x, w [rows, lanes] (the variant's dtype; rows * lanes a
    multiple of 8): the CUDA kernel for CUDA tensors, else chain_plain."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if not x.is_cuda:
        return chain_plain(x, w, reps, variant)
    dt = dtype_of(variant)
    if (x.dtype != dt or w.dtype != dt or x.shape != w.shape or w.device != x.device
            or x.numel() % _VEC[variant]):
        raise ValueError(f"{variant}: x and w of one shape and device, dtype {dt}, "
                         f"a multiple of {_VEC[variant]} elements")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    rc = _library().dbfr_probe_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    x.numel() // _VEC[variant], reps, VARIANTS.index(variant),
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_bf16 {variant}: CUDA error {rc} at launch")
    launches[f"probe_bf16/{variant}"] += 1
    return out


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(rows: int = 256, lanes: int = 1024, reps: int = 2000, iters: int = 20,
            device="cuda") -> dict:
    """Per variant: ms per launch at `reps` and 2 x `reps` steps, the
    per-sweep time (us) from their difference, GFLOP/s (2 per element and
    step) and gops (3 rounded operations per element and step). CUDA only:
    a measurement without a card fails."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card: pass a CUDA device")
    out = {}
    elems = rows * lanes
    for v in VARIANTS:
        x, w = inputs(rows, lanes, v, dev)
        t1 = _time_ms(lambda: chain(x, w, reps, v), iters)
        t2 = _time_ms(lambda: chain(x, w, 2 * reps, v), iters)
        sweep_s = (t2 - t1) * 1e-3 / reps
        out[v] = dict(rows=rows, lanes=lanes, reps=reps, ms_r=t1, ms_2r=t2,
                      us_per_sweep=sweep_s * 1e6,
                      gflops=elems * 2 / sweep_s / 1e9 if sweep_s > 0 else float("inf"),
                      gops=elems * 3 / sweep_s / 1e9 if sweep_s > 0 else float("inf"))
    return out
