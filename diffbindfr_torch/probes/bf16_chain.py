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
`launches`), the plain version `chain_plain` for CPU tensors. The kernel's
bound is its instruction rate (2, 1.5 and 1 instructions per element and step);
`sass_steps` reads from the compiled kernel (`cuobjdump -sass`) how many
instructions its step loop runs per step.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from . import _cuda

VARIANTS = ("f32_fma", "bf16x2_mul_add", "bf16x2_fma")
launches = {f"probe_bf16/{v}": 0 for v in VARIANTS}

# elements per 16-byte vector of the kernel (a thread runs up to 4 vectors)
_VEC = {"f32_fma": 4, "bf16x2_mul_add": 8, "bf16x2_fma": 8}
# each variant's kernel symbol, as the mangled name in the SASS listing holds it
SASS_KERNELS = {"f32_fma": "probe_f32_kernel", "bf16x2_mul_add": "probe_bf16_kernelILb0E",
                "bf16x2_fma": "probe_bf16_kernelILb1E"}
# the kernel counts steps in a float (no integer-to-float conversion a
# step), exact up to 2**24
_MAX_REPS = 2**24


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


def chain(x, w, reps: int, variant: str):
    """The chain on x, w [rows, lanes] (the variant's dtype; rows * lanes a
    multiple of 8): the CUDA kernel for CUDA tensors, else chain_plain."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if reps > _MAX_REPS:
        raise ValueError(f"reps {reps}: at most 2**24, where the kernel's float step counter "
                         "stops counting exactly")
    if not x.is_cuda:
        return chain_plain(x, w, reps, variant)
    dt = dtype_of(variant)
    if (x.dtype != dt or w.dtype != dt or x.shape != w.shape or w.device != x.device
            or x.numel() % _VEC[variant]):
        raise ValueError(f"{variant}: x and w of one shape and device, dtype {dt}, "
                         f"a multiple of {_VEC[variant]} elements")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    _cuda.launch("dbfr_probe_bf16", (x, w, out),
                 (x.numel() // _VEC[variant], reps, VARIANTS.index(variant)))
    launches[f"probe_bf16/{variant}"] += 1
    return out


def measure(rows: int = 256, lanes: int = 1024, reps: int = 2000, iters: int = 20,
            device="cuda") -> dict:
    """Per variant: ms per launch at `reps` and 2 x `reps` steps, the
    per-sweep time (us) from their difference, GFLOP/s (2 per element and
    step) and gops (3 rounded operations per element and step). CUDA only:
    a measurement without a card fails."""
    dev = _cuda.require_cuda(device)
    out = {}
    elems = rows * lanes
    for v in VARIANTS:
        x, w = inputs(rows, lanes, v, dev)
        t1 = _cuda.time_ms(lambda: chain(x, w, reps, v), iters)
        t2 = _cuda.time_ms(lambda: chain(x, w, 2 * reps, v), iters)
        sweep_s = (t2 - t1) * 1e-3 / reps
        out[v] = dict(rows=rows, lanes=lanes, reps=reps, ms_r=t1, ms_2r=t2,
                      us_per_sweep=sweep_s * 1e6,
                      gflops=elems * 2 / sweep_s / 1e9 if sweep_s > 0 else float("inf"),
                      gops=elems * 3 / sweep_s / 1e9 if sweep_s > 0 else float("inf"))
    return out


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _sass_functions(sass: str) -> dict:
    """`cuobjdump -sass` text -> {function name: [(address, opcode, operands)]}."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = funcs.setdefault(line.split("Function : ", 1)[1].strip(), [])
        elif cur is not None:
            m = _SASS_INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return funcs


def _loops(insns):
    """[(first, last)] instruction indices of each loop body of one
    function: the branches (`BRA 0x<address>`) to an instruction at or
    before their own."""
    at = {addr: i for i, (addr, _, _) in enumerate(insns)}
    out = []
    for i, (_, op, args) in enumerate(insns):
        m = re.fullmatch(r"0x([0-9a-f]+)", args)
        j = at.get(int(m.group(1), 16)) if op.split(".")[0] == "BRA" and m else None
        if j is not None and j <= i:
            out.append((j, i))
    return out


def sass_steps(sass: str) -> dict:
    """Per variant, from the kernel's SASS: its widest step loop (the one
    that runs a thread's four vectors, unrolled) as instructions per step,
    per element and step, and by opcode per step. A step runs one pert
    multiply (FMUL), so the loop's FMULs count its steps."""
    funcs = _sass_functions(sass)
    out = {}
    for v, key in SASS_KERNELS.items():
        names = [n for n in funcs if key in n]
        if len(names) != 1:
            raise ValueError(f"{v}: {len(names)} functions named like {key} in the SASS")
        insns = funcs[names[0]]
        loops = _loops(insns)
        if not loops:
            raise ValueError(f"{v}: no loop in the SASS of {names[0]}")
        first, last = max(loops, key=lambda fl: fl[1] - fl[0])
        body = [op for _, op, _ in insns[first : last + 1]]
        steps = sum(op.split(".")[0] == "FMUL" for op in body)
        if steps == 0:
            raise ValueError(f"{v}: no FMUL (the step's pert) in the loop of {names[0]}")
        ops = {}
        for op in body:
            ops[op] = ops.get(op, 0) + 1
        elems = 4 * _VEC[v]  # four vectors a thread
        out[v] = dict(loop_instructions=len(body), steps=steps,
                      per_step=len(body) / steps, per_element_step=len(body) / steps / elems,
                      opcodes_per_step={op: n / steps for op, n in sorted(ops.items())})
    return out
