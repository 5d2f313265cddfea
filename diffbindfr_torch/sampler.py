"""Reverse-diffusion sampler (the SDE and the probability-flow ODE), PyTorch
counterpart of diffbindfr_tpu/sampler.py:99-248.

The JAX package runs the steps as one jitted lax.scan with jax.random keys;
here the steps are a Python loop and every random draw is a tensor in a
`SamplerNoise`, drawn up front from a torch.Generator on the device
(`draw_noise`) or handed in by the caller: the two frameworks' random
streams differ, so parity tests build the noise on the JAX side and pass it
in. Per pose, the noise of a batch is independent of the other poses, so
slicing a `SamplerNoise` along the batch reruns a subset of poses. The ODE
(`kind='ode'`) draws only the prior: its steps are deterministic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .geometry.chi import build_atom14
from .geometry.rotations import matrix_to_axis_angle, random_rotation
from .geometry.torsion import modify_conformer
from .models import score_net as sn


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "sde"  # 'sde' | 'ode'
    inference_steps: int = 22
    actual_steps: int = 20
    eps: float = 1e-5
    no_random: bool = False
    no_final_step_noise: bool = True
    tr_sigma_min: float = 0.1
    tr_sigma_max: float = 6.0
    rot_sigma_min: float = 0.03
    rot_sigma_max: float = 1.55
    tor_sigma_min: float = 0.0314
    tor_sigma_max: float = 3.14
    sc_tor_sigma_min: float = 0.0314
    sc_tor_sigma_max: float = 3.14
    tr_sigma_max_init: float = 10.0

    @property
    def schedule(self) -> dict:
        return {k: getattr(self, k) for k in (
            "tr_sigma_min", "tr_sigma_max", "rot_sigma_min", "rot_sigma_max",
            "tor_sigma_min", "tor_sigma_max", "sc_tor_sigma_min", "sc_tor_sigma_max")}


class SamplerNoise(NamedTuple):
    """Every random draw of one sampler run; batch axis B after the step axis S."""

    prior_tor: torch.Tensor  # [B, T] uniform torsions in [-pi, pi)
    prior_rot: torch.Tensor  # [B, 3] uniform rotation (axis-angle)
    prior_tr: torch.Tensor  # [B, 3] centroid offset ~ N(0, tr_sigma_max_init)
    prior_chi: torch.Tensor  # [B, R, 4] uniform chi in [-pi, pi)
    z_tr: torch.Tensor  # [S, B, 3]
    z_rot: torch.Tensor  # [S, B, 3]
    z_tor: torch.Tensor  # [S, B, T]
    z_sc: torch.Tensor  # [S, B, R, 4]

    def select(self, idx) -> "SamplerNoise":
        """The noise of the poses `idx` (a list or index tensor)."""
        return SamplerNoise(*[v[idx] for v in self[:4]], *[v[:, idx] for v in self[4:]])


class SampleResult(NamedTuple):
    lig_pos: torch.Tensor  # [B, NL, 3] final pose (pocket frame)
    atom14_pos: torch.Tensor  # [B, R, 14, 3]
    chi: torch.Tensor  # [B, R, 4]
    lig_traj: torch.Tensor | None = None  # [S, B, NL, 3] after each step
    atom14_traj: torch.Tensor | None = None  # [S, B, R, 14, 3]


def draw_noise(batch, cfg: SamplerConfig, generator: torch.Generator) -> SamplerNoise:
    """Draw the prior and per-step noise for `batch` from `generator` (its
    device is the tensors' device). Pose b's draws do not depend on B. The
    ODE draws no per-step noise: its z fields have 0 steps."""
    dev = generator.device
    bsz, nt = batch.tor_mask.shape
    nres = batch.chi_mask.shape[1]
    steps = cfg.actual_steps if _kind(cfg) == "sde" else 0

    def uni(*shape):
        return (torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0) * math.pi

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    per_pose = []
    for _ in range(bsz):
        rot = matrix_to_axis_angle(random_rotation((), generator, dev))
        per_pose.append((uni(nt), rot, nrm(3) * cfg.tr_sigma_max_init, uni(nres, 4),
                         nrm(steps, 3), nrm(steps, 3), nrm(steps, nt), nrm(steps, nres, 4)))
    cols = [torch.stack(c) for c in zip(*per_pose)]
    return SamplerNoise(*cols[:4], *[c.transpose(0, 1).contiguous() for c in cols[4:]])


def _kind(cfg: SamplerConfig) -> str:
    if cfg.kind not in ("sde", "ode"):
        raise ValueError(f"sampler kind {cfg.kind!r}: 'sde' or 'ode'")
    return cfg.kind


def _rebuild_atom14(s, chi):
    """chi [B, R, 4] -> atom14 positions [B, R, 14, 3]."""
    tors = torch.cat([s.torsion_angle[..., :1], chi], dim=-1)
    sincos = torch.stack([torch.sin(tors), torch.cos(tors)], dim=-1)
    return build_atom14(sincos, s.backbone_rots, s.backbone_transl, s.default_frame,
                        s.template_pos, s.group_idx, s.atom14_mask)


def _pack_atoms(s, atom14):
    """atom14 [B, R, 14, 3] -> packed pocket atom cloud [B, NA, 3]."""
    flat = atom14.reshape(atom14.shape[0], -1, 3)
    bidx = torch.arange(flat.shape[0], device=flat.device)[:, None]
    return flat[bidx, s.pack_flat] * s.atm_mask[..., None]


def _tor_bonds(s):
    return torch.stack([s.tor_src, s.tor_dst], dim=-1)


def init_pose(s, cfg: SamplerConfig, noise: SamplerNoise):
    """Prior pose: randomise torsions and rotation about the reference
    conformer, recentre, offset the centroid; uniform chi where diffused.
    Returns (lig_pos [B, NL, 3], chi [B, R, 4], atm_pos [B, NA, 3])."""
    zeros = torch.zeros_like(noise.prior_tr)
    pos = modify_conformer(s.lig_ref_pos, s.lig_mask > 0, zeros, noise.prior_rot,
                           _tor_bonds(s), s.rot_node_mask > 0, noise.prior_tor,
                           s.tor_mask > 0)
    w = s.lig_mask[..., None]
    n = torch.clamp(w.sum(1, keepdim=True), min=1.0)
    centroid = (pos * w).sum(1, keepdim=True) / n
    pos = (pos - centroid + noise.prior_tr[:, None, :]) * w
    chi = torch.where(s.chi_mask > 0, noise.prior_chi, s.torsion_angle[..., 1:])
    return pos, chi, _pack_atoms(s, _rebuild_atom14(s, chi))


def t_schedule(cfg: SamplerConfig, device="cpu"):
    """Linear 1 -> eps grid of inference_steps + 1 points (f32)."""
    return torch.linspace(1.0, cfg.eps, cfg.inference_steps + 1, dtype=torch.float32,
                          device=device)


def _schedule(cfg: SamplerConfig, device):
    """(time grid, each step's Sigmas, their score-norm SigmaScales): every
    step's lookups made once, before the loop."""
    ts = t_schedule(cfg, device)
    sigs = [sn.sigmas_from_t(ts[i], cfg.schedule) for i in range(cfg.actual_steps)]
    return ts, sigs, sn.sigma_scales(sn.Sigmas(*[torch.stack(v) for v in zip(*sigs)]))


def _step(params, net_cfg: sn.ScoreNetConfig, cfg: SamplerConfig, batch, sched,
          noise: SamplerNoise, i: int, lig_pos, chi, atm_pos, use_kernels: bool = True):
    """Step i of the schedule `sched` (= _schedule(cfg, ...)) from the state
    (lig_pos, chi, atm_pos) -> (lig_pos, chi, atom14, atm_pos) after it."""
    ts, sigs, scales = sched
    bsz = batch.lig_pos.shape[0]
    sig, t, dt = sigs[i], ts[i], ts[i] - ts[i + 1]
    sig_b = sn.Sigmas(*[v.expand(bsz) for v in sig])
    scales_b = sn.SigmaScales(*[v[i].expand(bsz) for v in scales])
    data = batch._replace(lig_pos=lig_pos, atm_pos=atm_pos)
    out = sn.apply(params, net_cfg, data, t.expand(bsz), sig_b, use_kernels=use_kernels,
                   scales=scales_b)
    tr_g = sig.tr * math.sqrt(2.0 * math.log(cfg.tr_sigma_max / cfg.tr_sigma_min))
    rot_g = sig.rot * (2.0 * math.sqrt(math.log(cfg.rot_sigma_max / cfg.rot_sigma_min)))
    tor_g = sig.tor * math.sqrt(2.0 * math.log(cfg.tor_sigma_max / cfg.tor_sigma_min))
    sc_g = sig.sc_tor * math.sqrt(2.0 * math.log(cfg.sc_tor_sigma_max / cfg.sc_tor_sigma_min))
    if _kind(cfg) == "ode":  # probability flow: half the drift, no noise
        tr_p = 0.5 * tr_g**2 * out.tr * dt
        rot_p = 0.5 * rot_g**2 * out.rot * dt
        tor_p = 0.5 * tor_g**2 * out.tor * dt
        sc_p = 0.5 * sc_g**2 * out.sc_tor * dt
    else:
        last = i == cfg.actual_steps - 1
        nz = 0.0 if (cfg.no_random or (cfg.no_final_step_noise and last)) else 1.0
        sdt = torch.sqrt(dt)
        tr_p = tr_g**2 * out.tr * dt + tr_g * sdt * (noise.z_tr[i] * nz)
        rot_p = rot_g**2 * out.rot * dt + rot_g * sdt * (noise.z_rot[i] * nz)
        tor_p = tor_g**2 * out.tor * dt + tor_g * sdt * (noise.z_tor[i] * nz)
        sc_p = sc_g**2 * out.sc_tor * dt + sc_g * sdt * (noise.z_sc[i] * nz)
    lig_pos = modify_conformer(lig_pos, batch.lig_mask > 0, tr_p, rot_p, _tor_bonds(batch),
                               batch.rot_node_mask > 0, tor_p, batch.tor_mask > 0)
    chi = chi + sc_p * batch.chi_mask
    atom14 = _rebuild_atom14(batch, chi)
    return lig_pos, chi, atom14, _pack_atoms(batch, atom14)


def sample(params, net_cfg: sn.ScoreNetConfig, cfg: SamplerConfig, batch,
           noise: SamplerNoise, use_kernels: bool = True,
           keep_trajectory: bool = False) -> SampleResult:
    """Run the reverse SDE (or, with cfg.kind 'ode', the probability-flow
    ODE) for a batch of tensors [B, ...] on their device. `keep_trajectory`
    also returns the ligand and atom14 positions after every step."""
    lig_pos, chi, atm_pos = init_pose(batch, cfg, noise)
    sched = _schedule(cfg, batch.lig_pos.device)
    lig_traj, a14_traj = [], []
    for i in range(cfg.actual_steps):
        lig_pos, chi, atom14, atm_pos = _step(params, net_cfg, cfg, batch, sched, noise, i,
                                              lig_pos, chi, atm_pos, use_kernels=use_kernels)
        if keep_trajectory:
            lig_traj.append(lig_pos)
            a14_traj.append(atom14)
    traj = (torch.stack(lig_traj), torch.stack(a14_traj)) if keep_trajectory else (None, None)
    return SampleResult(lig_pos, _rebuild_atom14(batch, chi), chi, *traj)
