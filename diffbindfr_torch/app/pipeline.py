"""Dock stage of `predict`: PyTorch counterpart of the docking half of
diffbindfr_tpu/app/pipeline.py (PreparedPair, DockEngine, dock, save_poses).

Pairs come from prep-cache npz files (the JAX package's `prep` writes them);
prep from raw PDB/SDF, error correction, MDN scoring and export are later
slices. Replicas (pair x pose) are grouped by bucket and run in batches of
`batch_size`; a final partial batch is padded by repeating its first
replica and the padding results are dropped.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import sampler as sp
from ..data.sample import Buckets, DockingSample, _load_sample_npz, bucket_of, stack_samples, to_device
from ..utils.device import resolve_device


@dataclasses.dataclass
class PreparedPair:
    """One featurised (pocket, ligand) pair, read from a prep-cache npz."""

    name: str
    sample: DockingSample  # numpy fields, one padded sample
    bucket: Buckets

    @classmethod
    def from_prep_cache(cls, path: str, name: str | None = None) -> "PreparedPair":
        s = _load_sample_npz(path)
        stem = os.path.basename(path)
        if name is None:
            name = stem[: -len(".npz")] if stem.endswith(".npz") else stem
        return cls(name=name, sample=s, bucket=bucket_of(s))


@dataclasses.dataclass
class PoseResult:
    pair_idx: int
    pose_idx: int
    lig_pos: np.ndarray  # [NL_pad, 3] pocket frame
    atom14_pos: np.ndarray  # [R_pad, 14, 3] pocket frame
    chi: np.ndarray  # [R_pad, 4]


class DockEngine:
    """Docking engine: parameters (a tree of tensors, e.g. from
    load_checkpoint or params_from_numpy) pinned on the device once, batches
    of one bucket run through `sampler.sample`.

    Noise: `run(..., seed)` makes one torch.Generator on the device seeded
    with `seed` and, batch by batch in order, draws each batch's noise with
    `sampler.draw_noise` (padding replicas included), so a run is
    reproducible and a caller can rebuild any batch's noise.
    """

    def __init__(self, params, net_cfg, sampler_cfg, batch_size: int = 16,
                 device="cuda", verbose: bool = True):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.net_cfg = net_cfg
        self.sampler_cfg = sampler_cfg
        self.batch_size = batch_size
        self.verbose = verbose

    def batches(self, prepared: list, num_poses=40):
        """[(bucket, [(pair_idx, pose_idx), ...] of one padded batch)] in run order."""
        counts = [num_poses] * len(prepared) if isinstance(num_poses, int) else list(num_poses)
        groups: dict = {}
        for i in range(len(prepared)):
            for p in range(counts[i]):
                groups.setdefault(prepared[i].bucket, []).append((i, p))
        out = []
        for bucket, ents in groups.items():
            for lo in range(0, len(ents), self.batch_size):
                out.append((bucket, ents[lo : lo + self.batch_size]))
        return out

    @torch.no_grad()
    def run(self, prepared: list, num_poses=40, seed: int = 0) -> list:
        """Dock every (pair, pose) replica; PoseResult.pair_idx indexes `prepared`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        results: list = []
        plan = self.batches(prepared, num_poses)
        total = sum(len(c) for _, c in plan)
        t0 = time.time()
        for _, chunk in plan:
            reps = chunk + [chunk[0]] * (self.batch_size - len(chunk))
            batch = to_device(stack_samples([prepared[i].sample for i, _ in reps]), self.device)
            noise = sp.draw_noise(batch, self.sampler_cfg, gen)
            res = sp.sample(self.params, self.net_cfg, self.sampler_cfg, batch, noise)
            lig_pos, a14, chi = (res.lig_pos.cpu().numpy(), res.atom14_pos.cpu().numpy(),
                                 res.chi.cpu().numpy())
            for j, (pi, po) in enumerate(chunk):
                results.append(PoseResult(pi, po, lig_pos[j], a14[j], chi[j]))
            if self.verbose:
                rate = len(results) / max(time.time() - t0, 1e-9)
                print(f"[dock] {len(results)}/{total} poses ({rate:.2f}/s)", flush=True)
        return results


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def dock(prepared: list, params, net_cfg, scfg, num_poses: int = 40, batch_size: int = 16,
         seed: int = 0, device="cuda", verbose: bool = True) -> list:
    """Run the reverse diffusion for every (pair, pose) replica (one-shot
    wrapper around DockEngine)."""
    eng = DockEngine(params, net_cfg, scfg, batch_size=batch_size, device=device,
                     verbose=verbose)
    return eng.run(prepared, num_poses=num_poses, seed=seed)


def save_poses(outdir: str, prepared: list, results: list, name: str = "poses.npz") -> str:
    """Write `<outdir>/<name>` in the JAX package's layout: per complex
    `{name}|lig_pos` [P, NL_pad, 3], `{name}|atom14_pos` [P, R_pad, 14, 3],
    `{name}|pose_idx` [P] and `{name}|vina` [P] (nan: no EC stage yet).
    Atomic write; returns the path."""
    by_pair: dict = {}
    for r in results:
        by_pair.setdefault(r.pair_idx, []).append(r)
    arrs = {}
    for pi, rs in by_pair.items():
        nm = prepared[pi].name
        arrs[nm + "|lig_pos"] = np.stack([r.lig_pos for r in rs])
        arrs[nm + "|atom14_pos"] = np.stack([r.atom14_pos for r in rs])
        arrs[nm + "|pose_idx"] = np.asarray([r.pose_idx for r in rs], np.int32)
        arrs[nm + "|vina"] = np.full(len(rs), np.nan, np.float32)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    tmp = path + f".{os.getpid()}.tmp"
    np.savez(tmp, **arrs)
    os.replace(tmp + ".npz", path)
    return path
