"""Rotation utilities (batched, static-shape), PyTorch counterpart of
diffbindfr_tpu/geometry/rotations.py."""
from __future__ import annotations

import math

import torch


def axis_angle_to_matrix(rotvec):
    """Rodrigues formula; rotvec [..., 3] -> [..., 3, 3], finite at zero angle."""
    theta2 = (rotvec**2).sum(dim=-1)
    theta = torch.sqrt(theta2 + 1e-24)
    small = theta < 1e-4
    theta_s = torch.where(small, torch.ones_like(theta), theta)
    f1 = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_s) / theta_s)
    f2 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_s)) / theta_s**2)
    vx, vy, vz = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(vx)
    K = torch.stack(
        [
            torch.stack([zero, -vz, vy], dim=-1),
            torch.stack([vz, zero, -vx], dim=-1),
            torch.stack([-vy, vx, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(K.shape)
    return eye + f1[..., None, None] * K + f2[..., None, None] * (K @ K)


def matrix_to_quaternion(R):
    """R [..., 3, 3] -> quaternion [..., 4] (w, x, y, z), w >= 0 (branchless
    Shepperd: the candidate with the largest pivot)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + r00 + r11 + r22
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    q0 = torch.stack([t0, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    q1 = torch.stack([r21 - r12, t1, r01 + r10, r02 + r20], dim=-1)
    q2 = torch.stack([r02 - r20, r01 + r10, t2, r12 + r21], dim=-1)
    q3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, t3], dim=-1)
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    best = torch.argmax(ts, dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_to_axis_angle(R):
    """Inverse of axis_angle_to_matrix, angle in [0, pi]."""
    q = matrix_to_quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    nv = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(nv, w)
    small = nv < 1e-6
    factor = torch.where(small, torch.full_like(nv, 2.0),
                         theta / torch.where(small, torch.ones_like(nv), nv))
    return v * factor[..., None]


def quaternion_to_matrix(q):
    """q [..., 4] (w, x, y, z), normalised -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], dim=-1),
        ],
        dim=-2,
    )


def random_rotation(shape=(), generator=None, device="cpu"):
    """Uniform random rotation matrices via normalised Gaussian quaternions."""
    q = torch.randn(tuple(shape) + (4,), generator=generator, device=device)
    return quaternion_to_matrix(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def wrap_angle(x):
    """Wrap angles to [-pi, pi) (rotations.py:wrap_angle)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi
