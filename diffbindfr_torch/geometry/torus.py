"""Wrapped-normal diffusion tables on the torus (ligand torsions, chi angles).

Counterpart of diffbindfr_tpu/geometry/torus.py: on log-spaced |x| and sigma
grids (2001 x 2001, relative to pi) the unnormalised density
p(x, sigma) = sum_k exp(-(x + 2 pi k)^2 / (2 sigma^2)) over 201 wraps, its
score d/dx log p, and score_norm(sigma) = E[score^2] by trapezoid
integration. The tables are computed in float64 on the caller's device,
kept as float32 tensors there, and cached on disk under the checkout's
gitignored build/ directory; the lookups (`score`, `score_norm`) index the
device tables and never read the host.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

X_MIN, X_N = 1e-5, 2000
SIGMA_MIN, SIGMA_MAX, SIGMA_N = 3e-3, 2.0, 2000
_N_WRAP = 100
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "build", "torus_tables.npz")
_ROW_CHUNK = 128  # sigma rows per pass of the table build


class TorusTables(NamedTuple):
    score: torch.Tensor  # [SIGMA_N + 1, X_N + 1] score at +|x| (negative there)
    score_norm: torch.Tensor  # [SIGMA_N + 1]

    @classmethod
    def from_numpy(cls, device, **arrays) -> "TorusTables":
        return cls(**{k: torch.as_tensor(np.asarray(arrays[k], np.float32)).to(device)
                      for k in cls._fields})


# device string -> TorusTables
_tables: dict = {}


def x_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(X_MIN), 0, X_N + 1) * np.pi


def sigma_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(SIGMA_MIN), np.log10(SIGMA_MAX), SIGMA_N + 1) * np.pi


def compute_rows(rows, device="cpu") -> dict:
    """float64 tensors of the sigma rows `rows` (torus.py:_compute_tables):
    score [n, X_N + 1] and score_norm [n]."""
    x_np = x_grid()
    x = torch.from_numpy(x_np).to(device)
    s2 = torch.as_tensor(sigma_grid()[np.asarray(rows)], dtype=torch.float64,
                         device=device)[:, None] ** 2
    p = torch.zeros(s2.shape[0], x.shape[0], dtype=torch.float64, device=device)
    grad = torch.zeros_like(p)
    for k in range(-_N_WRAP, _N_WRAP + 1):
        xk = x[None] + 2 * np.pi * k
        e = torch.exp(-(xk**2) / (2 * s2))
        p += e
        grad += -xk / s2 * e
    # where the density underflows the k = 0 wrap dominates: score -x/sigma^2
    score = torch.where(p > 0, grad / torch.where(p > 0, p, torch.ones_like(p)), -x[None] / s2)
    w = torch.from_numpy(np.gradient(x_np)).to(device)
    return dict(score=score,
                score_norm=(p * score**2 * w).sum(-1) / (p * w).sum(-1))


def score_norm_row(i: int, device="cpu") -> float:
    """E[score^2] of the wrapped normal at sigma_grid()[i], as float32."""
    return float(np.float32(compute_rows([i], device)["score_norm"][0].item()))


def compute_tables(device="cpu") -> dict:
    """The whole table set as float32 numpy arrays, computed on `device`."""
    parts = [compute_rows(np.arange(r, min(r + _ROW_CHUNK, SIGMA_N + 1)), device)
             for r in range(0, SIGMA_N + 1, _ROW_CHUNK)]
    return {k: torch.cat([q[k] for q in parts]).to(torch.float32).cpu().numpy()
            for k in TorusTables._fields}


def tables(device) -> TorusTables:
    """The tables on `device`: kept per device, read from the disk cache,
    else computed on that device (and cached)."""
    key = str(torch.device(device))
    if key not in _tables:
        if os.path.exists(CACHE):
            with np.load(CACHE) as data:
                arrays = {k: data[k] for k in TorusTables._fields}
        else:
            arrays = compute_tables(device)
            os.makedirs(os.path.dirname(CACHE), exist_ok=True)
            tmp = CACHE + f".{os.getpid()}.tmp.npz"  # atomic: readers never see a partial file
            np.savez(tmp, **arrays)
            os.replace(tmp, CACHE)
        _tables[key] = TorusTables.from_numpy(device, **arrays)
    return _tables[key]


def set_tables(t: TorusTables) -> None:
    """Use `t` for lookups on its device (tests hand in reference tables)."""
    _tables[str(t.score.device)] = t


def _sigma_index(sigma):
    ls = torch.log(sigma / np.pi)
    idx = (ls - np.log(SIGMA_MIN)) / (np.log(SIGMA_MAX) - np.log(SIGMA_MIN)) * SIGMA_N
    return torch.clamp(torch.round(idx), 0, SIGMA_N).to(torch.int32)


def score_norm(sigma):
    """score_norm at the grid point nearest each sigma (f32, sigma's device)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return tables(sigma.device).score_norm[_sigma_index(sigma).long()]


def score(x, sigma):
    """Score of the wrapped normal at x (broadcasting sigma)."""
    t = tables(x.device)
    xw = torch.remainder(x + math.pi, 2 * math.pi) - math.pi
    lx = torch.log(torch.clamp(xw.abs(), min=1e-30) / math.pi)
    xi = (lx - np.log(X_MIN)) / (0 - np.log(X_MIN)) * X_N
    xi = torch.clamp(torch.round(xi), 0, X_N).long()
    si = _sigma_index(torch.as_tensor(sigma, dtype=torch.float32, device=x.device)).long()
    # table rows are the score at +|x| (negative there); odd in x
    return torch.sign(xw) * t.score[si.expand(xi.shape), xi]


def sample(sigma, normal=None, generator=None):
    """Wrapped-normal draws sigma * normal mod 2 pi into [-pi, pi); `normal`
    (sigma's shape) is drawn from `generator` when not given."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    if normal is None:
        normal = torch.randn(sigma.shape, generator=generator, device=sigma.device)
    return torch.remainder(sigma * normal + math.pi, 2 * math.pi) - math.pi
