"""Python-file configs: the port's copy of diffbindfr_tpu/utils/config.py.

A config file is evaluated into a dict; `_base_` inherits with a deep merge,
`${var}` strings are interpolated once on the merged dict, and dotted
command-line overrides (`--cfg-options a.b=1`) apply last. Values stay plain
dicts: the port's config dataclasses are built from them.
"""
from __future__ import annotations

import ast
import copy
import os
import re
import types


def _exec_config(path: str) -> dict:
    with open(path) as fh:
        src = fh.read()
    mod = types.ModuleType("cfg")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return {
        k: v
        for k, v in vars(mod).items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, types.ModuleType)
    }


def deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_VAR = re.compile(r"\$\{(\w+)\}")


def _interpolate(obj, root: dict):
    if isinstance(obj, str):
        def sub(m):
            return str(root.get(m.group(1), m.group(0)))

        return _VAR.sub(sub, obj)
    if isinstance(obj, dict):
        return {k: _interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_interpolate(v, root) for v in obj)
    return obj


def _load_raw(path: str) -> dict:
    cfg = _exec_config(path)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        bpath = b if os.path.isabs(b) else os.path.join(os.path.dirname(path), b)
        merged = deep_merge(merged, _load_raw(bpath))
    return deep_merge(merged, cfg)


def load_config(path: str) -> dict:
    """Load a python config file, resolving `_base_` and `${var}`.

    Interpolation runs once on the fully merged dict, so a child config's
    override of `tag` is seen by a base config's `'${tag}'` reference."""
    merged = _load_raw(path)
    return _interpolate(merged, merged)


def apply_overrides(cfg: dict, options: list) -> dict:
    """Apply ['a.b=2', 'name=foo'] style overrides (values parsed as
    python literals when possible)."""
    out = copy.deepcopy(cfg)
    for opt in options or []:
        key, _, raw = opt.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out
