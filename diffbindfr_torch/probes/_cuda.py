"""Plumbing shared by the probe wrappers (P1-P4): the kernel library's C
entry points with their ctypes signatures, a launch that raises on a CUDA
error, the checks of a wrapper's tensors and of a measurement's device,
CUDA-event timing, and the summation order of a warp's butterfly for the
plain versions. Nothing here builds or touches the card at import time."""
from __future__ import annotations

import ctypes

import torch

P, I = ctypes.c_void_p, ctypes.c_int


def entry(name: str, n_ptr: int, n_int: int):
    """The library's function `name`, taking n_ptr pointers, then n_int
    ints, then the stream; returns a cudaError_t as int."""
    from ..utils import cuda_build

    fn = getattr(cuda_build.load(), name)
    if fn.argtypes is None:
        fn.argtypes = [P] * n_ptr + [I] * n_int + [P]
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, ptrs, ints=()) -> None:
    """Launch on the current stream: `ptrs` are tensors (or None), `ints`
    Python ints. Raises if the launch is refused."""
    args = [t.data_ptr() if t is not None else None for t in ptrs] + [int(i) for i in ints]
    rc = entry(name, len(ptrs), len(ints))(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check(name: str, t, shape, dtype=torch.float32):
    """A CUDA tensor of `shape` and `dtype`, made contiguous; raises on
    anything else."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want a CUDA {dtype} tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def require_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: pass a CUDA device (none here)")
    return dev


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call of `fn` over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def butterfly_sum(x):
    """Sum over the last axis (a power of 2) by halving: x[:h] + x[h:] until
    one is left, the order in which a warp's xor-shuffle butterfly leaves
    the sum in lane 0 (f32 additions are commutative, so it is bit-equal)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
