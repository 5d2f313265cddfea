"""Dock, error correction and MDN scoring, the stages of `predict` after
prep: PyTorch counterpart of diffbindfr_tpu/app/pipeline.py (PreparedPair,
DockEngine / dock, ECEngine / error_correct, MDNEngine / score_mdn,
save_poses).

Pairs come from prep-cache npz files and the `<stem>.rec.pkl` records beside
them (the JAX package's `prep` writes both); prep from raw PDB/SDF and
export are later slices. Each stage groups its replicas (pair x pose) by
bucket and runs them in batches of `batch_size`; a final partial batch is
padded by repeating its first replica and the padding results are dropped.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import sampler as sp
from ..chem.records import LigandRecord, PocketRecord, load_prep_record
from ..data.sample import Buckets, DockingSample, _load_sample_npz, bucket_of, stack_samples, to_device
from ..models import mdn_scorer as mdn
from ..ops import vina
from ..utils.device import resolve_device


@dataclasses.dataclass
class PreparedPair:
    """One featurised (pocket, ligand) pair, read from a prep-cache npz and,
    where it exists, the `<stem>.rec.pkl` record beside it (the ligand and
    pocket records that error correction types atoms from)."""

    name: str
    sample: DockingSample  # numpy fields, one padded sample
    bucket: Buckets
    lig: LigandRecord | None = None
    pocket: PocketRecord | None = None
    crystal_pos: np.ndarray | None = None  # [A, 3] input ligand pose, pocket frame

    @classmethod
    def from_prep_cache(cls, path: str, name: str | None = None) -> "PreparedPair":
        s = _load_sample_npz(path)
        stem = path[: -len(".npz")] if path.endswith(".npz") else path
        if name is None:
            name = os.path.basename(stem)
        rec = {}
        if os.path.exists(stem + ".rec.pkl"):
            rec = load_prep_record(stem + ".rec.pkl")
        return cls(name=name, sample=s, bucket=rec.get("bucket", bucket_of(s)),
                   lig=rec.get("lig"), pocket=rec.get("pocket"),
                   crystal_pos=rec.get("crystal_pos"))


@dataclasses.dataclass
class PoseResult:
    pair_idx: int
    pose_idx: int
    lig_pos: np.ndarray  # [NL_pad, 3] pocket frame
    atom14_pos: np.ndarray  # [R_pad, 14, 3] pocket frame
    chi: np.ndarray  # [R_pad, 4]
    mdn_score: float | None = None  # summed mixture probability (higher = better)
    mdn_nll: float | None = None  # mean per-contact NLL (lower = better)
    vina_score: float | None = None  # affinity after error correction (lower = better)


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


def _batches(prepared: list, results: list, batch_size: int):
    """[(chunk, padded chunk)] of result indices, grouped by the pair's
    bucket; the padding repeats the chunk's first replica."""
    groups: dict = {}
    for k, r in enumerate(results):
        groups.setdefault(prepared[r.pair_idx].bucket, []).append(k)
    out = []
    for ridxs in groups.values():
        for lo in range(0, len(ridxs), batch_size):
            chunk = ridxs[lo : lo + batch_size]
            out.append((chunk, chunk + [chunk[0]] * (batch_size - len(chunk))))
    return out


class ECEngine:
    """Vina error correction: each pose re-minimized in (translation,
    rotation, torsion) space against the rigid pocket (`vina.minimize_batch`,
    `steps` Adam steps at learning rate `lr`). The typed ligand and receptor
    of a pair are built on the host once and kept on the device."""

    def __init__(self, steps: int = 150, lr: float = 0.05, batch_size: int = 16,
                 device="cuda", verbose: bool = True):
        self.device = resolve_device(device)
        self.steps = steps
        self.lr = lr
        self.batch_size = batch_size
        self.verbose = verbose
        self._systems: dict = {}  # id(pair) -> (pair, VinaLigand, VinaReceptor) on the device

    def _system(self, pair):
        key = id(pair)
        if key not in self._systems:
            if pair.lig is None or pair.pocket is None:
                raise ValueError(f"{pair.name}: no ligand/pocket record (rec.pkl) for EC")
            b = pair.bucket
            lig = vina.stack_to_device([vina.build_ligand(pair.lig, b.n_lig, b.n_tor)],
                                       self.device)
            rec = vina.stack_to_device([vina.build_receptor(pair.pocket, b.n_atm)],
                                       self.device)
            self._systems[key] = (pair, lig, rec)
        return self._systems[key]

    def run(self, prepared: list, results: list) -> None:
        """Minimize every result's pose in place: sets lig_pos and
        vina_score."""
        t0 = time.time()
        done = 0
        for chunk, idxs in _batches(prepared, results, self.batch_size):
            pairs = [prepared[results[k].pair_idx] for k in idxs]
            systems = [self._system(p) for p in pairs]
            ligs = vina.VinaLigand(*[torch.cat(f) for f in zip(*[s[1] for s in systems])])
            recs = vina.VinaReceptor(*[torch.cat(f) for f in zip(*[s[2] for s in systems])])
            lp = torch.from_numpy(np.stack([results[k].lig_pos for k in idxs])).to(
                self.device, torch.float32)
            # the torsion loop stops after the batch's last real torsion
            n_tor = max(p.lig.num_torsions for p in pairs)
            pos, aff = vina.minimize_batch(lp, ligs, recs, steps=self.steps, lr=self.lr,
                                           n_tor=n_tor)
            pos, aff = pos.cpu().numpy(), aff.cpu().numpy()
            for j, k in enumerate(chunk):
                results[k].lig_pos = pos[j]
                results[k].vina_score = float(aff[j])
            done += len(chunk)
            if self.verbose:
                print(f"[ec] {done}/{len(results)} poses ({time.time() - t0:.1f} s)", flush=True)


def error_correct(prepared: list, results: list, steps: int = 150, lr: float = 0.05,
                  batch_size: int = 16, device="cuda", verbose: bool = True) -> None:
    """Vina re-minimization of every pose ("error correction"); updates
    lig_pos in place and attaches vina_score. One-shot wrapper around
    ECEngine."""
    ECEngine(steps=steps, lr=lr, batch_size=batch_size, device=device,
             verbose=verbose).run(prepared, results)


class MDNEngine:
    """MDN scoring: parameters (a tree of tensors, e.g. from load_checkpoint)
    pinned on the device once; batches of one bucket run through
    `mdn_scorer.score_batch_both`."""

    def __init__(self, mdn_params, mdn_cfg, batch_size: int = 16, device="cuda",
                 verbose: bool = True):
        self.device = resolve_device(device)
        self.mdn_params = _to_device(mdn_params, self.device)
        self.mdn_cfg = mdn_cfg
        self.batch_size = batch_size
        self.verbose = verbose

    @torch.no_grad()
    def run(self, prepared: list, results: list) -> None:
        """Score every result in place: sets mdn_score and mdn_nll."""
        t0 = time.time()
        done = 0
        for chunk, idxs in _batches(prepared, results, self.batch_size):
            batch = to_device(stack_samples([prepared[results[k].pair_idx].sample
                                             for k in idxs]), self.device)
            lp = torch.from_numpy(np.stack([results[k].lig_pos for k in idxs])).to(
                self.device, torch.float32)
            a14 = torch.from_numpy(np.stack([results[k].atom14_pos for k in idxs])).to(
                self.device, torch.float32)
            sp_, nll = mdn.score_batch_both(self.mdn_params, self.mdn_cfg, batch, lp, a14)
            sp_, nll = sp_.cpu().numpy(), nll.cpu().numpy()
            for j, k in enumerate(chunk):
                results[k].mdn_score = float(sp_[j])
                results[k].mdn_nll = float(nll[j])
            done += len(chunk)
            if self.verbose:
                print(f"[score] {done}/{len(results)} poses ({time.time() - t0:.1f} s)",
                      flush=True)


def score_mdn(prepared: list, results: list, mdn_params, mdn_cfg, batch_size: int = 16,
              device="cuda", verbose: bool = True) -> None:
    """Attach MDN scores to PoseResults in place. One-shot wrapper around
    MDNEngine."""
    MDNEngine(mdn_params, mdn_cfg, batch_size=batch_size, device=device,
              verbose=verbose).run(prepared, results)


def save_poses(outdir: str, prepared: list, results: list, name: str = "poses.npz") -> str:
    """Write `<outdir>/<name>` in the JAX package's layout: per complex
    `{name}|lig_pos` [P, NL_pad, 3], `{name}|atom14_pos` [P, R_pad, 14, 3],
    `{name}|pose_idx` [P] and `{name}|vina` [P] (nan where a pose has no
    vina_score). Atomic write; returns the path."""
    by_pair: dict = {}
    for r in results:
        by_pair.setdefault(r.pair_idx, []).append(r)
    arrs = {}
    for pi, rs in by_pair.items():
        nm = prepared[pi].name
        arrs[nm + "|lig_pos"] = np.stack([r.lig_pos for r in rs])
        arrs[nm + "|atom14_pos"] = np.stack([r.atom14_pos for r in rs])
        arrs[nm + "|pose_idx"] = np.asarray([r.pose_idx for r in rs], np.int32)
        arrs[nm + "|vina"] = np.asarray(
            [np.nan if r.vina_score is None else r.vina_score for r in rs], np.float32)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    tmp = path + f".{os.getpid()}.tmp"
    np.savez(tmp, **arrs)
    os.replace(tmp + ".npz", path)
    return path
