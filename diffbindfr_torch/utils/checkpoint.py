"""Checkpoints in the JAX package's flat-npz format, and training state.

Key scheme (diffbindfr_tpu/utils/checkpoint.py): every leaf is stored under
its pytree path; raw weights under ``params/``, EMA weights under ``ema/``,
list items as ``#i`` path components, metadata under ``meta/``. Files
written by `save_checkpoint` load with diffbindfr_tpu.utils.load_checkpoint
and vice versa. The full training state (parameters, EMA, Adam moments,
update count and step) is the port's own format (`save_train_state`), in the
same key scheme with ``mu/`` and ``nu/`` trees added.
"""
from __future__ import annotations

import glob
import os

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


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
    return out


def _save_npz(path: str, flat: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"  # atomic: readers never see a partial file
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_checkpoint(path: str, params, ema_params=None, step: int | None = None) -> None:
    """params (and EMA) trees of tensors -> the JAX package's checkpoint file."""
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    if ema_params is not None:
        flat.update({f"ema/{k}": v for k, v in _flatten(ema_params).items()})
    if step is not None:
        flat["meta/step"] = np.asarray(step)
    _save_npz(path, flat)


def save_train_state(path: str, state) -> None:
    """A train.TrainState (params, EMA, Adam moments, count, step) -> npz."""
    from ..train import tree_unflatten

    flat = {}
    for name, tree in (("params", state.params), ("ema", state.ema_params),
                       ("mu", tree_unflatten(state.params, state.opt_state["mu"])),
                       ("nu", tree_unflatten(state.params, state.opt_state["nu"]))):
        flat.update({f"{name}/{k}": v for k, v in _flatten(tree).items()})
    flat["meta/count"] = np.asarray(state.opt_state["count"])
    flat["meta/step"] = np.asarray(state.step)
    _save_npz(path, flat)


def load_train_state(path: str, device="cuda"):
    """npz written by save_train_state -> train.TrainState on `device`."""
    from ..train import TrainState, tree_leaves

    dev = resolve_device(device)
    trees = {}
    with np.load(path, allow_pickle=False) as data:
        for name in ("params", "ema", "mu", "nu"):
            flat = {k[len(name) + 1:]: data[k] for k in data.files if k.startswith(name + "/")}
            trees[name] = _to_tensors(_unflatten(flat), dev)
        count, step = int(data["meta/count"]), int(data["meta/step"])
    return TrainState(params=trees["params"], ema_params=trees["ema"],
                      opt_state={"mu": tree_leaves(trees["mu"]), "nu": tree_leaves(trees["nu"]),
                                 "count": count},
                      step=step)


def resolve_checkpoint(path: str) -> str:
    """A file path is used as-is; a training run directory resolves to its
    validation-best checkpoint (ckpt_best.npz) when present, else to the
    highest-step ckpt_*.npz / mdn_ckpt_*.npz (the JAX package's policy)."""
    if not os.path.isdir(path):
        return path
    best = os.path.join(path, "ckpt_best.npz")
    if os.path.exists(best):
        print(f"[model] checkpoint policy: best-val ({best})")
        return best
    cands = sorted(glob.glob(os.path.join(path, "ckpt_*.npz"))
                   or glob.glob(os.path.join(path, "*ckpt_*.npz")))
    if not cands:
        raise FileNotFoundError(f"no ckpt_*.npz under {path}")
    print(f"[model] checkpoint policy: no ckpt_best.npz in {path}; "
          f"falling back to latest ({cands[-1]})")
    return cands[-1]
