"""Wrapped-normal score norms on the torus (ligand torsions, chi angles).

Counterpart of diffbindfr_tpu/geometry/torus.py. The score net reads only
`score_norm` at the sigma grid point nearest each sigma; this module
computes those rows on demand with torch float64 on the caller's device
(201 wraps x 2001 |x| points per row) and keeps the values.
"""
from __future__ import annotations

import numpy as np
import torch

X_MIN, X_N = 1e-5, 2000
SIGMA_MIN, SIGMA_MAX, SIGMA_N = 3e-3, 2.0, 2000
_N_WRAP = 100

_score_norms: dict = {}


def x_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(X_MIN), 0, X_N + 1) * np.pi


def sigma_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(SIGMA_MIN), np.log10(SIGMA_MAX), SIGMA_N + 1) * np.pi


def score_norm_row(i: int, device="cpu") -> float:
    """E[score^2] of the wrapped normal at sigma_grid()[i], by trapezoid
    integration over the |x| grid (torus.py:_compute_tables)."""
    x_np = x_grid()
    x = torch.from_numpy(x_np).to(device)
    s2 = float(sigma_grid()[i]) ** 2
    k = torch.arange(-_N_WRAP, _N_WRAP + 1, dtype=torch.float64, device=device)[:, None]
    xk = x[None] + 2 * np.pi * k
    e = torch.exp(-(xk**2) / (2 * s2))
    p = e.sum(dim=0)
    grad = (-xk / s2 * e).sum(dim=0)
    score = torch.where(p > 0, grad / torch.where(p > 0, p, torch.ones_like(p)), -x / s2)
    w = torch.from_numpy(np.gradient(x_np)).to(device)
    val = (p * score**2 * w).sum() / (p * w).sum()
    return float(np.float32(val.item()))


def _sigma_index(sigma):
    ls = torch.log(sigma / np.pi)
    idx = (ls - np.log(SIGMA_MIN)) / (np.log(SIGMA_MAX) - np.log(SIGMA_MIN)) * SIGMA_N
    return torch.clamp(torch.round(idx), 0, SIGMA_N).to(torch.int32)


def score_norm(sigma):
    """score_norm at the grid point nearest each sigma (f32 tensor). Like
    so3.score_norm, it reads the grid indices on the host."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    idx = _sigma_index(sigma)
    keys = idx.reshape(-1).tolist()
    for i in set(keys):
        if i not in _score_norms:
            _score_norms[i] = score_norm_row(i, sigma.device)
    vals = torch.tensor([_score_norms[i] for i in keys], dtype=torch.float32,
                        device=sigma.device)
    return vals.reshape(idx.shape)
