"""Load the JAX package's flat-npz checkpoints into torch tensors.

Key scheme (diffbindfr_tpu/utils/checkpoint.py): every leaf is stored under
its pytree path; raw weights under ``params/``, EMA weights under ``ema/``,
list items as ``#i`` path components, metadata under ``meta/``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
                idx = sorted(int(k[1:]) for k in keys)
                if idx == list(range(len(idx))):
                    return [fix(node[f"#{i}"]) for i in idx]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of arrays -> the same structure of torch tensors on
    `device` (the card unless the caller asks for the CPU).

    Floating arrays become float32 (the checkpoints are f32); integer arrays
    keep an integer dtype.
    """
    return _to_tensors(tree, resolve_device(device))


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, copy=True))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def load_checkpoint(path: str, use_ema: bool = True, device="cuda"):
    """Returns (params tree of tensors on `device`, step or None).

    `use_ema` loads the ``ema/`` tree when the file has one, else ``params/``.
    """
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        files = data.files
        prefix = ("ema/" if use_ema and any(k.startswith("ema/") for k in files)
                  else "params/")
        flat = {k[len(prefix):]: data[k] for k in files if k.startswith(prefix)}
        step = int(data["meta/step"]) if "meta/step" in files else None
    if not flat:
        raise ValueError(f"no parameters under prefix {prefix!r} in {path}")
    return _to_tensors(_unflatten(flat), dev), step
