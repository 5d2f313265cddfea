"""The cmT row plan of a depthwise tensor product, in numpy.

The port's own copy of `_pad8`, `cm_row_plan` and `_tmetas` of the JAX
package's cmT kernels (diffbindfr_tpu/nn/pallas_conv_t.py:78-145), on top of
the port's `_path_constants` (nn/trunk_convs.py). The cmT layout stores
features transposed, [rows, pairs], with every (irreps slot, component)
block padded to a multiple of 8 rows. The probes P2 and P3 run their
depthwise chains over that layout, so their kernels and plain versions take
the path table from here (`path_table`, and `device_table` for the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..nn.irreps import Irreps, TensorProductSpec
from ..nn.trunk_convs import _path_constants

# columns of `path_table`
PATH_COLS = ("mul_p", "d1", "d3", "w_row", "out_row", "cb_off", "src0", "src1", "src2",
             "src3", "src4")
MAX_D1 = 5


def pad8(n: int) -> int:
    return -(-n // 8) * 8


@functools.lru_cache(maxsize=None)
def cm_row_plan(irreps: Irreps):
    """[(cm_offset, mul, padded_row_offset)] per (slot, component) block,
    plus the total padded row count."""
    blocks, r = [], 0
    for off, mul, ir in irreps.slices():
        for k in range(ir.dim):
            blocks.append((off + k * mul, mul, r))
            r += pad8(mul)
    return tuple(blocks), r


def tmetas(spec: TensorProductSpec):
    """(path metas, ck [9, kdim], wn_p, din_p, dout_p): per path its padded
    row count mul_p, d1, d3, the rows of its d1 source components in the
    input, its first row in the padded weight rows (w_row) and in the
    output (out_row), and its first column of ck (cb_off)."""
    metas, ck = _path_constants(spec)
    in_map = {cm: ro for cm, _, ro in cm_row_plan(spec.in1)[0]}
    out_map = {cm: ro for cm, _, ro in cm_row_plan(spec.out)[0]}
    w_row = 0
    out = []
    for m in metas:
        mul, d1, d3 = m["mul"], m["d1"], m["d3"]
        mp = pad8(mul)
        out.append(dict(
            mul=mul, mul_p=mp, d1=d1, d3=d3,
            src_rows=tuple(in_map[m["s1"] + i * mul] for i in range(d1)),
            out_row=out_map[m["s3"]],
            w_row=w_row, w_off=m["w_off"], cb_off=m["cb_off"],
        ))
        w_row += mp
    return out, ck, w_row, cm_row_plan(spec.in1)[1], cm_row_plan(spec.out)[1]


def path_table(metas) -> np.ndarray:
    """The kernels' view of the paths: int32 [n_paths, 16], columns
    PATH_COLS (unused source rows -1)."""
    t = np.zeros((len(metas), 16), np.int32)
    for i, m in enumerate(metas):
        if m["d1"] > MAX_D1:
            raise ValueError(f"path {i}: d1 {m['d1']} > {MAX_D1}")
        src = list(m["src_rows"]) + [-1] * (MAX_D1 - m["d1"])
        t[i, :len(PATH_COLS)] = (m["mul_p"], m["d1"], m["d3"], m["w_row"], m["out_row"],
                                 m["cb_off"], *src)
    return t


_DEVICE_TABLES: dict = {}


def device_table(metas, device) -> torch.Tensor:
    """path_table(metas) as an int32 tensor on `device`, copied there once
    per table and device."""
    t = path_table(metas)
    key = (t.tobytes(), str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = torch.tensor(t, device=device)
    return _DEVICE_TABLES[key]
