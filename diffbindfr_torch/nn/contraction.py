"""The split-K fp32 contraction out = a @ b^T of csrc/abt_gemm.cuh.

Two callers launch it: P3-abt (probes/mosaic.py) and B4's parameter
gradients (trunk_convs.cross_bwd), which contract feature-major per-pair rows
over every pair of a batch. This module holds what the host decides for a
launch (how many K chunks, hence the size of the partial-sum slab) and the
plain version of a contraction whose A operand carries generated indicator
rows: row r is 1 on the K columns of segment r, so a bias gradient, a sum
over K per segment, comes out as extra output rows.
"""
from __future__ import annotations

import functools
import math

import torch

TILE = 64  # kAbtTile: output rows and columns per block
BK = 32  # kAbtBK: K columns per staged slice; a chunk is whole slices
BLOCKS_PER_SM = 2  # abt_kernel's __launch_bounds__(256, 2)


def tiles(rows: int, cols: int) -> int:
    """Output tiles of one [rows, cols] result."""
    return math.ceil(rows / TILE) * math.ceil(cols / TILE)


def max_splits(n_tiles: int, k: int, sms: int) -> int:
    """K chunks for a launch of `n_tiles` output tiles: as many as fill the
    card's resident block slots (BLOCKS_PER_SM per SM) once, since a second,
    partial wave of blocks would double the time; at least 1, at most one
    chunk per K slice. The kernel may use fewer (no empty chunk); the
    partial-sum slab is sized for this many."""
    if n_tiles <= 0:
        return 1
    return max(1, min(math.ceil(k / BK), (BLOCKS_PER_SM * sms) // n_tiles))


@functools.lru_cache(maxsize=None)
def sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def indicator_rows(k: int, seg=None, dtype=torch.float32, device="cpu"):
    """[n_seg, k]: row r is 1 on columns seg[r] .. seg[r + 1] - 1; with seg
    None, one row of ones."""
    if seg is None:
        return torch.ones(1, k, dtype=dtype, device=device)
    col = torch.arange(k, device=device)
    seg = seg.to(device=device, dtype=torch.long)
    return ((col >= seg[:-1, None]) & (col < seg[1:, None])).to(dtype)


def contract_plain(a, b, seg=None):
    """Plain version: [a; indicator_rows(K, seg)] @ b^T, [M + n_seg, N]."""
    ind = indicator_rows(a.shape[1], seg, a.dtype, a.device)
    return torch.cat([a, ind], dim=0) @ b.t()
