"""Masked batched Kabsch superposition (counterpart of
diffbindfr_tpu/geometry/kabsch.py)."""
from __future__ import annotations

import torch


def kabsch_align(mobile, target, mask=None, eps: float = 1e-8):
    """Optimal rigid (R [..., 3, 3], t [..., 3]) with R @ mobile + t ~ target
    over the masked points; mobile/target [..., N, 3], mask [..., N]."""
    if mask is None:
        mask = torch.ones(mobile.shape[:-1], dtype=mobile.dtype, device=mobile.device)
    w = mask[..., None].to(mobile.dtype)
    n = torch.clamp(w.sum(dim=-2, keepdim=True), min=eps)
    mu_m = (mobile * w).sum(dim=-2, keepdim=True) / n
    mu_t = (target * w).sum(dim=-2, keepdim=True) / n
    xm = (mobile - mu_m) * w
    xt = (target - mu_t) * w
    H = torch.einsum("...ni,...nj->...ij", xm, xt)
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("...ij,...kj->...ik", V, U))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)
    t = mu_t[..., 0, :] - torch.einsum("...ij,...j->...i", R, mu_m[..., 0, :])
    return R, t


def kabsch_apply(R, t, x):
    return torch.einsum("...ij,...nj->...ni", R, x) + t[..., None, :]


def masked_rmsd(a, b, mask=None, eps: float = 1e-8):
    if mask is None:
        mask = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    d2 = ((a - b) ** 2).sum(dim=-1) * mask
    n = torch.clamp(mask.sum(dim=-1), min=eps)
    return torch.sqrt(d2.sum(dim=-1) / n)
