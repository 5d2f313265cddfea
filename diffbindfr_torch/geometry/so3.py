"""IGSO(3) score norms for the score network's sigma scaling.

Counterpart of diffbindfr_tpu/geometry/so3.py. The JAX package precomputes
whole tables (1000 eps x 2000 omega x 2000 series terms) in numpy float64
and caches them on disk; the score net only reads `exp_score_norms` at the
eps grid point nearest each sigma. This module computes exactly those grid
rows, on demand, with torch float64 on the caller's device, and keeps the
values; nothing is written to disk.

Where the density underflows (omega near pi at small eps) the series sums
to rounding noise, whose value depends on the summation order: a CUDA
reduction turned it into 0/0 = NaN. A row therefore keeps only the omegas
where the sum exceeds its rounding-error bound. On every one of the 1000
grid rows this gives the reference's f32 value exactly (the dropped points
carry no weight at f32 precision), and it does not depend on the order.
"""
from __future__ import annotations

import numpy as np
import torch

MIN_EPS, MAX_EPS, N_EPS = 0.01, 2.0, 1000
X_N = 2000
_L_TRUNC = 2000

# grid index -> exp_score_norms value (float64 -> float32 like the JAX tables)
_exp_score_norms: dict = {}


def eps_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(MIN_EPS), np.log10(MAX_EPS), N_EPS)


def exp_score_norm_row(i: int, device="cpu") -> float:
    """sqrt(E ||score||^2) of IGSO(3) at eps_grid()[i] (so3.py:_compute_tables)."""
    f64 = torch.float64
    eps = float(eps_grid()[i])
    omegas = torch.from_numpy(np.linspace(0, np.pi, X_N + 1)[1:]).to(device)
    ls = torch.arange(_L_TRUNC, dtype=f64, device=device)[:, None]
    coef = (2 * ls + 1) * torch.exp(-ls * (ls + 1) * eps**2)
    hi = torch.sin(omegas[None] * (ls + 0.5))
    lo = torch.sin(omegas[None] / 2)
    terms = coef * hi / lo
    exp_vals = terms.sum(dim=0)
    keep = exp_vals > _L_TRUNC * torch.finfo(f64).eps * terms.abs().sum(dim=0)
    dhi = (ls + 0.5) * torch.cos(omegas[None] * (ls + 0.5))
    dlo = 0.5 * torch.cos(omegas[None] / 2)
    dsig = (coef * (lo * dhi - hi * dlo) / lo**2).sum(dim=0)
    score = torch.where(keep, dsig / torch.where(keep, exp_vals, 1.0), 0.0)
    pdf = torch.where(keep, exp_vals * (1 - torch.cos(omegas)) / np.pi, 0.0)
    val = torch.sqrt((score**2 * pdf).sum() / pdf.sum() / np.pi)
    return float(np.float32(val.item()))


def _eps_index(eps):
    idx = ((torch.log10(eps) - np.log10(MIN_EPS))
           / (np.log10(MAX_EPS) - np.log10(MIN_EPS)) * N_EPS)
    return torch.clamp(torch.round(idx).to(torch.int32), 0, N_EPS - 1)


def score_norm(eps):
    """exp_score_norms at the grid point nearest each eps (f32 tensor).

    Reads the grid indices on the host, which waits for the device when eps
    is on the card: callers in a loop look up all their sigmas once, before
    it (sampler.sample)."""
    eps = torch.as_tensor(eps, dtype=torch.float32)
    idx = _eps_index(eps)
    keys = idx.reshape(-1).tolist()
    for i in set(keys):
        if i not in _exp_score_norms:
            _exp_score_norms[i] = exp_score_norm_row(i, eps.device)
    vals = torch.tensor([_exp_score_norms[i] for i in keys], dtype=torch.float32,
                        device=eps.device)
    return vals.reshape(idx.shape)
