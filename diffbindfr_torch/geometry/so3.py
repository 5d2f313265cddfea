"""IGSO(3) diffusion tables and lookups on the device.

Counterpart of diffbindfr_tpu/geometry/so3.py: the isotropic Gaussian on
SO(3) with concentration eps has angle-marginal density
  f(w) = [sum_l (2l+1) exp(-l(l+1) eps^2) sin((l+1/2) w) / sin(w/2)]
         * (1 - cos w) / pi
over a log-spaced eps grid (1000 rows) and a uniform omega grid (2000
points), truncated at l < 2000. The whole table set -- the CDF and the score
magnitude per (eps, omega), and sqrt(E ||score||^2) per eps -- is computed in
float64 on the caller's device, kept as float32 tensors there, and cached on
disk under the checkout's gitignored build/ directory. The series over l is
a matrix product (coefficients [eps, l] @ basis [l, omega]), so the whole
set takes seconds even on a CPU. Lookups (`score_norm`, `score_vec`,
`sample_vec`) index the device tables and never read the host.

Where the density underflows (omega near pi at small eps) the series sums
to rounding noise, whose value depends on the summation order: a CUDA
reduction turned it into 0/0 = NaN. The port keeps only the omegas where the
sum exceeds its rounding-error bound (density 0 and score 0 elsewhere). On
every one of the 1000 grid rows this gives the JAX table's f32
exp_score_norms exactly (the dropped points carry no weight at f32
precision), and it does not depend on the order.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

MIN_EPS, MAX_EPS, N_EPS = 0.01, 2.0, 1000
X_N = 2000
_L_TRUNC = 2000
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "build", "so3_tables.npz")


class SO3Tables(NamedTuple):
    omegas: torch.Tensor  # [X_N]
    cdf_vals: torch.Tensor  # [N_EPS, X_N]
    score_norms: torch.Tensor  # [N_EPS, X_N]
    exp_score_norms: torch.Tensor  # [N_EPS]

    @classmethod
    def from_numpy(cls, device, **arrays) -> "SO3Tables":
        """float32 tables on `device` from numpy arrays (the fields' names)."""
        return cls(**{k: torch.as_tensor(np.asarray(arrays[k], np.float32)).to(device)
                      for k in cls._fields})


# device string -> SO3Tables
_tables: dict = {}


def eps_grid() -> np.ndarray:
    return 10 ** np.linspace(np.log10(MIN_EPS), np.log10(MAX_EPS), N_EPS)


def compute_rows(rows, device="cpu") -> dict:
    """float64 tensors of the grid rows `rows` (so3.py:_compute_tables):
    cdf_vals and score_norms [n, X_N], exp_score_norms [n]."""
    f64 = torch.float64
    eps = torch.as_tensor(eps_grid()[np.asarray(rows)], dtype=f64, device=device)
    omegas = torch.from_numpy(np.linspace(0, np.pi, X_N + 1)[1:]).to(device)
    ls = torch.arange(_L_TRUNC, dtype=f64, device=device)[:, None]
    coef = (2 * ls.T + 1) * torch.exp(-ls.T * (ls.T + 1) * eps[:, None] ** 2)  # [n, L]
    hi = torch.sin(omegas[None] * (ls + 0.5))
    lo = torch.sin(omegas[None] / 2)
    basis = hi / lo  # [L, X]
    exp_vals = coef @ basis
    keep = exp_vals > _L_TRUNC * torch.finfo(f64).eps * (coef @ basis.abs())
    dhi = (ls + 0.5) * torch.cos(omegas[None] * (ls + 0.5))
    dlo = 0.5 * torch.cos(omegas[None] / 2)
    dsig = coef @ ((lo * dhi - hi * dlo) / lo**2)
    score = torch.where(keep, dsig / torch.where(keep, exp_vals, 1.0), 0.0)
    pdf = torch.where(keep, exp_vals * (1 - torch.cos(omegas)) / np.pi, 0.0)
    return dict(
        cdf_vals=pdf.cumsum(dim=-1) / X_N * np.pi,
        score_norms=score,
        exp_score_norms=torch.sqrt((score**2 * pdf).sum(-1) / pdf.sum(-1) / np.pi),
    )


def exp_score_norm_row(i: int, device="cpu") -> float:
    """sqrt(E ||score||^2) of IGSO(3) at eps_grid()[i], as float32."""
    val = compute_rows([i], device)["exp_score_norms"][0]
    return float(np.float32(val.item()))


def compute_tables(device="cpu") -> dict:
    """The whole table set as float32 numpy arrays, computed on `device`."""
    out = compute_rows(np.arange(N_EPS), device)
    out["omegas"] = torch.from_numpy(np.linspace(0, np.pi, X_N + 1)[1:])
    return {k: v.to(torch.float32).cpu().numpy() for k, v in out.items()}


def tables(device) -> SO3Tables:
    """The tables on `device`: kept per device, read from the disk cache,
    else computed on that device (and cached)."""
    key = str(torch.device(device))
    if key not in _tables:
        if os.path.exists(CACHE):
            with np.load(CACHE) as data:
                arrays = {k: data[k] for k in SO3Tables._fields}
        else:
            arrays = compute_tables(device)
            os.makedirs(os.path.dirname(CACHE), exist_ok=True)
            tmp = CACHE + f".{os.getpid()}.tmp.npz"  # atomic: readers never see a partial file
            np.savez(tmp, **arrays)
            os.replace(tmp, CACHE)
        _tables[key] = SO3Tables.from_numpy(device, **arrays)
    return _tables[key]


def set_tables(t: SO3Tables) -> None:
    """Use `t` for lookups on its device (tests hand in reference tables)."""
    _tables[str(t.omegas.device)] = t


def _eps_index(eps):
    idx = ((torch.log10(eps) - np.log10(MIN_EPS))
           / (np.log10(MAX_EPS) - np.log10(MIN_EPS)) * N_EPS)
    return torch.clamp(torch.round(idx).to(torch.int32), 0, N_EPS - 1)


def interp(x, xp, fp):
    """jnp.interp per element: x [N], xp and fp [N, X] rows or one [X] row
    (searchsorted on the right, constant beyond the ends, flat segments take
    their left value)."""
    n = x.shape[0]
    xp = (xp.expand(n, -1) if xp.dim() == 1 else xp).contiguous()
    fp = fp.expand(n, -1) if fp.dim() == 1 else fp
    i = torch.searchsorted(xp, x[:, None].contiguous(), right=True).clamp(1, xp.shape[1] - 1)
    xp0, xp1 = xp.gather(1, i - 1)[:, 0], xp.gather(1, i)[:, 0]
    fp0, fp1 = fp.gather(1, i - 1)[:, 0], fp.gather(1, i)[:, 0]
    dx = xp1 - xp0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp0, fp0 + ((x - xp0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (fp1 - fp0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def score_norm(eps):
    """exp_score_norms at the grid point nearest each eps (f32, eps's device)."""
    eps = torch.as_tensor(eps, dtype=torch.float32)
    return tables(eps.device).exp_score_norms[_eps_index(eps).long()]


def score_vec(eps, vec):
    """IGSO(3) score at rotation vectors; eps [...], vec [..., 3]."""
    t = tables(vec.device)
    om = torch.linalg.norm(vec, dim=-1)
    idx = _eps_index(torch.as_tensor(eps, dtype=torch.float32, device=vec.device)).long()
    idx = idx.expand(om.shape).reshape(-1)
    mag = interp(om.reshape(-1), t.omegas, t.score_norms[idx]).reshape(om.shape)
    return mag[..., None] * vec / torch.clamp(om[..., None], min=1e-12)


def sample_vec(eps, normal=None, uniform=None, generator=None):
    """Rotation vectors ~ IGSO(3)(eps), one per element of eps: a uniform
    axis from `normal` [..., 3] and the angle by inverse CDF from `uniform`
    [...]; either is drawn from `generator` when not given."""
    eps = torch.as_tensor(eps, dtype=torch.float32)
    dev, shape = eps.device, eps.shape
    if normal is None:
        normal = torch.randn(shape + (3,), generator=generator, device=dev)
    if uniform is None:
        uniform = torch.rand(shape, generator=generator, device=dev)
    t = tables(dev)
    x = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    idx = _eps_index(eps).long().reshape(-1)
    omega = interp(uniform.reshape(-1), t.cdf_vals[idx], t.omegas).reshape(shape)
    return x * omega[..., None]
