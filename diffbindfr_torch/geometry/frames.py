"""Rigid-frame algebra on (rot [..., 3, 3], trans [..., 3]) pairs
(counterpart of diffbindfr_tpu/geometry/frames.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rigid(NamedTuple):
    rot: torch.Tensor
    trans: torch.Tensor


def identity(shape=(), dtype=torch.float32, device="cpu") -> Rigid:
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(shape) + (3, 3))
    return Rigid(R, torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))


def compose(a: Rigid, b: Rigid) -> Rigid:
    """(a o b)(x) = a(b(x))."""
    return Rigid(a.rot @ b.rot, torch.einsum("...ij,...j->...i", a.rot, b.trans) + a.trans)


def invert(a: Rigid) -> Rigid:
    rot_t = a.rot.transpose(-1, -2)
    return Rigid(rot_t, -torch.einsum("...ij,...j->...i", rot_t, a.trans))


def apply(a: Rigid, x):
    return torch.einsum("...ij,...j->...i", a.rot, x) + a.trans


def apply_inverse(a: Rigid, x):
    return torch.einsum("...ji,...j->...i", a.rot, x - a.trans)


def from_4x4(m) -> Rigid:
    return Rigid(m[..., :3, :3], m[..., :3, 3])


def from_3_points(origin, x_axis_point, xy_plane_point, eps: float = 1e-20) -> Rigid:
    """Gram-Schmidt frame: x along origin -> x_axis_point, xy-plane through
    xy_plane_point."""
    e0 = x_axis_point - origin
    e1 = xy_plane_point - origin
    e0 = e0 / torch.sqrt((e0**2).sum(dim=-1, keepdim=True) + eps)
    e1 = e1 - e0 * (e0 * e1).sum(dim=-1, keepdim=True)
    e1 = e1 / torch.sqrt((e1**2).sum(dim=-1, keepdim=True) + eps)
    e2 = torch.cross(e0, e1, dim=-1)
    return Rigid(torch.stack([e0, e1, e2], dim=-1), origin)
