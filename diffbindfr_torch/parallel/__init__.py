"""Replica scale-out over devices: the port's counterpart of
diffbindfr_tpu/parallel/__init__.py.

Graphs are small (<= ~1k nodes), so the one useful parallel axis is the
replica batch. The JAX package shards it over a `Mesh` ('dp',) and lets
pjit place the work; here a mesh is a list of torch devices, a batch is
split into one chunk of rows per device (`shard_batch`) and the parameters
are copied once to each device (`replicate`). Each device's chunk runs its
own launches; app/pipeline.py's DockEngine gathers the results. Processes
on several hosts join through parallel/dist.py.
"""
from __future__ import annotations

import torch


def make_mesh(devices=None) -> list:
    """The mesh's devices as torch.device; by default every visible CUDA
    device. A device may appear twice (two shards on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass the devices (e.g. ['cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(v, fn) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh: list, batch) -> list:
    """[chunk on mesh[d]] of a batch tree (dicts, lists, NamedTuples of
    tensors or numpy arrays): its leading (replica) axis split into
    len(mesh) equal chunks, chunk d moved to mesh[d]."""
    nd = len(mesh)

    def rows(d):
        def take(x):
            n = x.shape[0]
            if n % nd:
                raise ValueError(f"shard_batch: {n} rows do not split over {nd} devices")
            part = x[d * (n // nd) : (d + 1) * (n // nd)]
            return torch.as_tensor(part).to(mesh[d])

        return take

    return [_map(batch, rows(d)) for d in range(nd)]


def replicate(mesh: list, tree) -> list:
    """[the tree on mesh[d]]: one copy per distinct device, shared by the
    mesh entries that name the same device (the copies are read only)."""
    copies: dict = {}
    out = []
    for dev in mesh:
        if dev not in copies:
            copies[dev] = _map(tree, lambda x, dev=dev: x.to(dev))
        out.append(copies[dev])
    return out
