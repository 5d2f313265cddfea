"""Denoising score-matching training of the score network, in PyTorch.

Counterpart of diffbindfr_tpu/train.py: per sample, t ~ U(t_min, 1),
sigmas from the geometric schedule, and the clean pose perturbed on the four
manifolds (translation ~ N(0, sigma_tr^2), rotation ~ IGSO(3)(sigma_rot),
torsions and chis ~ wrapped N(0, sigma)); each manifold's squared error
against the perturbation kernel's score is normalised by the expected score
magnitude (see the JAX module's docstring for the terms).

The JAX step draws its noise with jax.random keys inside the jitted step;
here every draw is a tensor in a `TrainNoise`, drawn from a torch.Generator
on the device (`draw_noise`) or handed in by the caller, as the sampler's
`SamplerNoise` is: parity tests build the draws on the JAX side.

Under `compute_dtype='bfloat16'` (train_cli's default, as in the JAX
package) the master parameters, the Adam moments, the EMA and the
checkpoints stay f32: `score_net.apply` casts the tree to bf16 for the
forward, so each weight gradient comes back through that cast rounded to
bf16, as JAX's `castp` rounds it; the heads return f32 before the sigma
scaling, so the loss terms are f32. The kernel path keeps the trunk f32 on
the bf16-rounded weights; a training config pins `pallas_dw_dtype=
'float32'`, so its convs run B1-B3 forward and B4-B6 backward (never B11).

The optimizer is written out to match optax's chain(clip_by_global_norm,
adam(warmup_cosine_decay_schedule)) step for step: the schedule reads the
update count before incrementing it (the first update has lr = 0), and the
clip scales by max_norm / norm with no epsilon (torch's clip_grad_norm_ adds
1e-6). State is a plain tree of tensors, updated functionally.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import so3, torus
from .geometry.rotations import wrap_angle
from .geometry.torsion import modify_conformer
from .models import score_net as sn
from .sampler import SamplerConfig, _pack_atoms, _rebuild_atom14
from .utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 300_000
    grad_clip: float = 1.0
    ema_decay: float = 0.999
    weight_tr: float = 1.0
    weight_rot: float = 1.0
    weight_tor: float = 1.0
    weight_sc: float = 1.0
    t_min: float = 0.0  # sample t in [t_min, 1]


class TrainState(NamedTuple):
    params: dict
    ema_params: dict
    opt_state: dict  # {"mu": tree, "nu": tree, "count": int}
    step: int


class Perturbation(NamedTuple):
    tr: torch.Tensor  # [B, 3]
    rot: torch.Tensor  # [B, 3] rotation vector
    tor: torch.Tensor  # [B, T]
    sc: torch.Tensor  # [B, R, 4]


class TrainNoise(NamedTuple):
    """Every random draw of one training step (batch axis B first)."""

    t: torch.Tensor  # [B] diffusion time in [t_min, 1]
    tr: torch.Tensor  # [B, 3] standard normal
    rot_axis: torch.Tensor  # [B, 3] standard normal (rotation axis)
    rot_u: torch.Tensor  # [B] uniform in [0, 1) (rotation angle, inverse CDF)
    tor: torch.Tensor  # [B, T] standard normal
    sc: torch.Tensor  # [B, R, 4] standard normal


def draw_noise(batch, tcfg: TrainConfig, generator: torch.Generator) -> TrainNoise:
    """The draws of one step for `batch`, from `generator` (its device is
    the tensors' device)."""
    dev = generator.device
    bsz, nt = batch.tor_mask.shape
    nres = batch.chi_mask.shape[1]

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    t = torch.rand(bsz, generator=generator, device=dev) * (1.0 - tcfg.t_min) + tcfg.t_min
    return TrainNoise(t=t, tr=nrm(bsz, 3), rot_axis=nrm(bsz, 3),
                      rot_u=torch.rand(bsz, generator=generator, device=dev),
                      tor=nrm(bsz, nt), sc=nrm(bsz, nres, 4))


def perturb_sample(s, sig: sn.Sigmas, noise: TrainNoise):
    """Forward noise at levels `sig` [B] applied to the clean poses in `s`."""
    delta = Perturbation(
        tr=noise.tr * sig.tr[:, None],
        rot=so3.sample_vec(sig.rot, normal=noise.rot_axis, uniform=noise.rot_u),
        tor=torus.sample(sig.tor[:, None].expand_as(noise.tor), normal=noise.tor) * s.tor_mask,
        sc=torus.sample(sig.sc_tor[:, None, None].expand_as(noise.sc), normal=noise.sc)
        * s.chi_mask,
    )
    lig_pos = modify_conformer(s.lig_pos, s.lig_mask > 0, delta.tr, delta.rot,
                               torch.stack([s.tor_src, s.tor_dst], dim=-1),
                               s.rot_node_mask > 0, delta.tor, s.tor_mask > 0)
    chi = wrap_angle(s.torsion_angle[..., 1:] + delta.sc)
    atm_pos = _pack_atoms(s, _rebuild_atom14(s, chi))
    noisy = s._replace(lig_pos=lig_pos, atm_pos=atm_pos,
                       torsion_angle=torch.cat([s.torsion_angle[..., :1], chi], dim=-1))
    return noisy, delta


def score_targets(delta: Perturbation, sig: sn.Sigmas) -> Perturbation:
    """Perturbation-kernel scores on each manifold."""
    return Perturbation(
        tr=-delta.tr / sig.tr[:, None] ** 2,
        rot=so3.score_vec(sig.rot, delta.rot),
        tor=torus.score(delta.tor, sig.tor[:, None]),
        sc=torus.score(delta.sc, sig.sc_tor[:, None, None]),
    )


def loss_fn(params, net_cfg: sn.ScoreNetConfig, scfg: SamplerConfig, tcfg: TrainConfig,
            batch, noise: TrainNoise, use_kernels: bool = True):
    """(loss, metrics) of one batch; differentiable in `params`."""
    sig = sn.sigmas_from_t(noise.t, scfg.schedule)
    noisy, delta = perturb_sample(batch, sig, noise)
    target = score_targets(delta, sig)
    pred = sn.apply(params, net_cfg, noisy, noise.t, sig, use_kernels=use_kernels)

    rot_norm = so3.score_norm(sig.rot)
    tor_norm = torch.sqrt(torus.score_norm(sig.tor))
    sc_norm = torch.sqrt(torus.score_norm(sig.sc_tor))

    tr_loss = ((pred.tr - target.tr) ** 2 * sig.tr[:, None] ** 2).sum(-1).mean()
    rot_loss = (((pred.rot - target.rot) / rot_norm[:, None]) ** 2).sum(-1).mean()
    tmask = batch.tor_mask
    tor_se = ((pred.tor - target.tor) / tor_norm[:, None]) ** 2 * tmask
    tor_loss = tor_se.sum() / torch.clamp(tmask.sum(), min=1.0)
    cmask = batch.chi_mask
    sc_se = ((pred.sc_tor - target.sc) / sc_norm[:, None, None]) ** 2 * cmask
    sc_loss = sc_se.sum() / torch.clamp(cmask.sum(), min=1.0)
    loss = (tcfg.weight_tr * tr_loss + tcfg.weight_rot * rot_loss
            + tcfg.weight_tor * tor_loss + tcfg.weight_sc * sc_loss)
    metrics = {"loss": loss, "tr_loss": tr_loss, "rot_loss": rot_loss,
               "tor_loss": tor_loss, "sc_loss": sc_loss}
    return loss, metrics


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like `template` with `leaves` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)


# ---------------------------------------------------------------------------
# optimizer / step
# ---------------------------------------------------------------------------


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adam(warmup-cosine lr)):
    b1 0.9, b2 0.999, eps 1e-8."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg
        self.warmup = min(tcfg.warmup_steps, max(tcfg.total_steps // 2, 1))
        self.decay_steps = max(tcfg.total_steps, self.warmup + 1)

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps) at
        update `count` (0 for the first update)."""
        lr = self.tcfg.lr
        if count < self.warmup:
            return lr * count / self.warmup
        span = self.decay_steps - self.warmup
        c = min(count - self.warmup, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / span))

    def init(self, params) -> dict:
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        return {"mu": zeros, "nu": [z.clone() for z in zeros], "count": 0}

    def apply(self, params, grads: list, opt_state: dict):
        """One update of the tree `params` by its leaf gradients: (new
        tree, new state, grad_norm)."""
        grad_norm = global_norm(grads)
        updates, opt_state = self.update(grads, opt_state, grad_norm)
        new = torch._foreach_add(tree_leaves(params), updates)
        return tree_unflatten(params, new), opt_state, grad_norm

    def update(self, grads: list, opt_state: dict, grad_norm):
        """(updates, new state) for the flat gradient list; moments update in
        place."""
        clip = self.tcfg.grad_clip
        # optax divides by the norm, then multiplies by max_norm
        g = [torch.where(grad_norm < clip, gi, gi / grad_norm * clip) for gi in grads]
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        count = opt_state["count"] + 1
        # bias corrections in float32, as optax computes them
        mu_hat = torch._foreach_div(mu, float(1 - np.float32(self.b1) ** np.float32(count)))
        nu_hat = torch._foreach_div(nu, float(1 - np.float32(self.b2) ** np.float32(count)))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                     -self.learning_rate(opt_state["count"]))
        return updates, {"mu": mu, "nu": nu, "count": count}


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return Optimizer(tcfg)


def init_state(generator: torch.Generator, net_cfg: sn.ScoreNetConfig, tcfg: TrainConfig,
               device="cuda", params=None) -> TrainState:
    """Fresh state: `params` (a tree on the device), else init_params from
    the CPU `generator`; EMA starts equal to the parameters."""
    dev = resolve_device(device)
    if params is None:
        params = sn.init_params(generator, net_cfg, dev)
    params = tree_unflatten(params, [p.detach().to(dev, torch.float32).clone()
                                     for p in tree_leaves(params)])
    ema = tree_unflatten(params, [p.clone() for p in tree_leaves(params)])
    return TrainState(params=params, ema_params=ema,
                      opt_state=make_optimizer(tcfg).init(params), step=0)


def _check_device(state: TrainState, device):
    dev = resolve_device(device)
    p0 = tree_leaves(state.params)[0]
    if p0.device.type != dev.type:
        raise ValueError(f"train state on {p0.device}, step asked for {dev}")


def loss_of_leaves(params, batch, noise: TrainNoise, net_cfg: sn.ScoreNetConfig,
                   scfg: SamplerConfig, tcfg: TrainConfig, use_kernels: bool = True):
    """(leaves, f): the leaves of `params` in tree_leaves order as fresh
    autograd leaves, and f(*leaves) -> (loss, detached metrics), the
    function of them that loss_and_grads differentiates."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]

    def f(*ls):
        loss, metrics = loss_fn(tree_unflatten(params, list(ls)), net_cfg, scfg, tcfg, batch,
                                noise, use_kernels=use_kernels)
        return loss, {k: v.detach() for k, v in metrics.items()}

    return leaves, f


def loss_and_grads(params, batch, noise: TrainNoise, net_cfg: sn.ScoreNetConfig,
                   scfg: SamplerConfig, tcfg: TrainConfig, use_kernels: bool = True):
    """(detached metrics, gradient of the loss for every leaf of `params`
    in tree_leaves order; zeros for leaves the loss does not read)."""
    leaves, f = loss_of_leaves(params, batch, noise, net_cfg, scfg, tcfg, use_kernels)
    loss, metrics = f(*leaves)
    return metrics, leaf_grads(loss, leaves)


def leaf_grads(loss, leaves: list) -> list:
    """Gradient of `loss` for every leaf (zeros where the loss does not
    read it)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def global_norm(grads):
    """optax.global_norm: sqrt of the sum of squares of every leaf."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


def train_step(state: TrainState, batch, noise: TrainNoise, net_cfg: sn.ScoreNetConfig,
               scfg: SamplerConfig, tcfg: TrainConfig, use_kernels: bool = True,
               device="cuda", optimizer: Optimizer | None = None):
    """One update: (new state, metrics incl. grad_norm). Runs on `device`
    (the card unless the caller asks for the CPU), where state, batch and
    noise must lie."""
    _check_device(state, device)
    opt = optimizer or make_optimizer(tcfg)
    metrics, grads = loss_and_grads(state.params, batch, noise, net_cfg, scfg, tcfg,
                                    use_kernels)
    params, opt_state, grad_norm = opt.apply(state.params, grads, state.opt_state)
    d = tcfg.ema_decay
    ema = torch._foreach_add(torch._foreach_mul(tree_leaves(state.ema_params), d),
                             torch._foreach_mul(tree_leaves(params), 1.0 - d))
    metrics["grad_norm"] = grad_norm
    return TrainState(params=params, ema_params=tree_unflatten(state.params, ema),
                      opt_state=opt_state, step=state.step + 1), metrics


def eval_step(params, batch, noise: TrainNoise, net_cfg: sn.ScoreNetConfig,
              scfg: SamplerConfig, tcfg: TrainConfig, use_kernels: bool = True):
    """Held-out DSM loss terms (no update); call with fixed noise across
    evaluations so the curve is comparable step to step."""
    with torch.no_grad():
        _, metrics = loss_fn(params, net_cfg, scfg, tcfg, batch, noise, use_kernels)
    return metrics
