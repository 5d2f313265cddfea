"""Pose-discrimination training of the MDN scorer, in PyTorch.

Counterpart of diffbindfr_tpu/mdn_train.py (`train_cli --model mdn
--pose-dir`): the scorer learns to rank pose quality on a set of generated
poses (the npz files of tools/make_scorer_poses.py), not only the crystal
contact statistics. Per training entry (one pocket/ligand pair and its
poses):
  * crystal NLL: models/mdn_scorer.mdn_loss on the crystal complex (7 A
    training cutoff)                                   [self-dock entries]
  * pair hinge: relu(PAIR_MARGIN + nll(good) - nll(bad)) on the 5 A scoring
    mean NLL, good a pose of L-RMSD <= GOOD_RMSD (or the crystal), bad one
    of >= BAD_RMSD                                     [self-dock entries]
  * decoy floor: relu(ref + ABS_MARGIN - nll(decoy)), ref the batch's
    stop-gradient mean crystal scoring NLL, or the host EMA `ref_ema` when
    the batch holds no self-dock entry                [cross-dock entries]
  * graded ranking: relu(RANK_K * gap + nll(a) - nll(b)) on a random pose
    pair of the same complex whose RMSD gap is >= RANK_MIN_GAP, a the
    better                                             [self-dock entries]

`make_pose_batch` makes the JAX function's numpy draws in the same order,
so one generator state gives the JAX package's batch.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .data.sample import Buckets, DockingSample, bucket_of, stack_samples, to_device
from .models import mdn_scorer as mdn

GOOD_RMSD = 2.5
BAD_RMSD = 4.0
PAIR_MARGIN = 0.3
ABS_MARGIN = 1.0
W_PAIR = 1.0
W_ABS = 0.5
W_RANK = 1.0
RANK_K = 0.15  # margin per Angstrom of RMSD gap
RANK_MIN_GAP = 0.5


@dataclasses.dataclass
class PoseEntry:
    name: str
    sample: DockingSample
    crystal_a14: np.ndarray  # [R, 14, 3] rebuilt from the native chis
    lig_pos: np.ndarray  # [K, NL, 3]
    a14: np.ndarray  # [K, R, 14, 3]
    rmsd: np.ndarray  # [K] (NaN for cross-dock)
    is_self: bool
    bucket: Buckets

    @property
    def good_idx(self) -> np.ndarray:
        return np.nonzero(self.rmsd <= GOOD_RMSD)[0]

    @property
    def bad_idx(self) -> np.ndarray:
        if self.is_self:
            return np.nonzero(self.rmsd >= BAD_RMSD)[0]
        return np.arange(self.lig_pos.shape[0])


def crystal_atom14(sample: DockingSample) -> np.ndarray:
    """[R, 14, 3] pocket atoms rebuilt from the sample's native chis (on the
    CPU, f32)."""
    from .sampler import _rebuild_atom14

    s = to_device(stack_samples([sample]), "cpu")
    with torch.no_grad():
        return _rebuild_atom14(s, s.torsion_angle[..., 1:])[0].numpy()


def load_pose_entries(pose_dir: str) -> list:
    """The pose set's entries, one per npz in name order; the crystal atom14
    is rebuilt once per entry."""
    entries = []
    for fn in sorted(os.listdir(pose_dir)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(pose_dir, fn)) as d:
            sample = DockingSample(**{k: d[f"s_{k}"] for k in DockingSample._fields})
            entries.append(PoseEntry(
                name=fn[:-4], sample=sample, crystal_a14=crystal_atom14(sample),
                lig_pos=d["lig_pos"], a14=d["atom14_pos"], rmsd=d["l_rmsd"],
                is_self=bool(d["is_self"]), bucket=bucket_of(sample)))
    return entries


def make_pose_batch(entries: list, idxs, rng, ref_ema: float = 2.0) -> tuple:
    """Stack B entries of one bucket into (samples, good_lig, good_a14,
    bad_lig, bad_a14, crystal_a14, rank_a_lig, rank_a_a14, rank_b_lig,
    rank_b_a14, rank_gap, w_crystal, w_pair, w_abs, w_rank, ref_ema), numpy;
    per entry one good pose (the crystal with p = 0.5, else a pose within
    GOOD_RMSD), one bad pose and one graded pose pair, drawn from `rng` in
    the JAX function's order."""
    samples, gl, ga, bl, ba, ca = [], [], [], [], [], []
    ral, raa, rbl, rba, rgap = [], [], [], [], []
    w_cr, w_pair, w_abs, w_rank = [], [], [], []
    for i in idxs:
        e = entries[i]
        s = e.sample
        samples.append(s)
        ca.append(e.crystal_a14)
        good, bad = e.good_idx, e.bad_idx
        if e.is_self and len(good) and rng.random() < 0.5:
            gi = int(rng.choice(good))
            gl.append(e.lig_pos[gi])
            ga.append(e.a14[gi])
        else:
            gl.append(np.asarray(s.lig_pos))  # crystal pose
            ga.append(e.crystal_a14)
        if len(bad):
            bi = int(rng.choice(bad))
            bl.append(e.lig_pos[bi])
            ba.append(e.a14[bi])
            pair_ok = 1.0 if e.is_self else 0.0
            abs_ok = 0.0 if e.is_self else 1.0
        else:  # no decoy: hinges off
            bl.append(np.asarray(s.lig_pos))
            ba.append(e.crystal_a14)
            pair_ok = abs_ok = 0.0
        rank_ok = 0.0
        if e.is_self and e.lig_pos.shape[0] >= 2:
            ii, jj = rng.choice(e.lig_pos.shape[0], size=2, replace=False)
            if e.rmsd[ii] > e.rmsd[jj]:
                ii, jj = jj, ii  # ii = the better pose
            gap = float(e.rmsd[jj] - e.rmsd[ii])
            if gap >= RANK_MIN_GAP:
                rank_ok = 1.0
                ral.append(e.lig_pos[ii])
                raa.append(e.a14[ii])
                rbl.append(e.lig_pos[jj])
                rba.append(e.a14[jj])
                rgap.append(gap)
        if not rank_ok:
            ral.append(np.asarray(s.lig_pos))
            raa.append(e.crystal_a14)
            rbl.append(np.asarray(s.lig_pos))
            rba.append(e.crystal_a14)
            rgap.append(0.0)
        w_cr.append(1.0 if e.is_self else 0.0)
        w_pair.append(pair_ok)
        w_abs.append(abs_ok)
        w_rank.append(rank_ok)
    return (stack_samples(samples),
            np.stack(gl), np.stack(ga), np.stack(bl), np.stack(ba), np.stack(ca),
            np.stack(ral), np.stack(raa), np.stack(rbl), np.stack(rba),
            np.asarray(rgap, np.float32),
            np.asarray(w_cr, np.float32), np.asarray(w_pair, np.float32),
            np.asarray(w_abs, np.float32), np.asarray(w_rank, np.float32),
            np.float32(ref_ema))


def pose_batch_to_device(batch: tuple, device) -> tuple:
    """make_pose_batch's tuple as float32 tensors on `device`."""
    return (to_device(batch[0], device),
            *[torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
              for a in batch[1:]])


def _repeat(s: DockingSample, k: int) -> DockingSample:
    return DockingSample(*[v.repeat(k, *([1] * (v.dim() - 1))) for v in s])


def make_pose_loss(cfg: mdn.MDNConfig):
    """loss_fn(params, device batch) -> (loss, metrics): the batched
    pose-discrimination loss, differentiable in the parameters. The five
    scoring passes of the JAX function (good, bad, rank a, rank b, crystal)
    run as one batch of 5B poses."""

    def loss_fn(p, batch: tuple):
        (s, gl, ga, bl, ba, ca, ral, raa, rbl, rba, rgap,
         w_cr, w_pair, w_abs, w_rank, ref_ema) = batch
        bsz = gl.shape[0]
        nll_cr_train = mdn.mdn_loss(p, cfg, s, s.lig_pos, ca)
        _, nll = mdn.score_batch_both(p, cfg, _repeat(s, 5),
                                      torch.cat([gl, bl, ral, rbl, s.lig_pos]),
                                      torch.cat([ga, ba, raa, rba, ca]))
        nll_good, nll_bad, nll_ra, nll_rb, nll_cr_score = nll.reshape(5, bsz)
        n_self = w_cr.sum()
        batch_ref = (w_cr * nll_cr_score).sum() / torch.clamp(n_self, min=1.0)
        ref = torch.where(n_self > 0, batch_ref, ref_ema).detach()
        pair_hinge = torch.clamp(PAIR_MARGIN + nll_good - nll_bad, min=0.0)
        abs_hinge = torch.clamp(ref + ABS_MARGIN - nll_bad, min=0.0)
        rank_hinge = torch.clamp(RANK_K * rgap + nll_ra - nll_rb, min=0.0)
        per = (w_cr * nll_cr_train + W_PAIR * w_pair * pair_hinge
               + W_ABS * w_abs * abs_hinge + W_RANK * w_rank * rank_hinge)
        denom = torch.clamp((w_cr + w_pair + w_abs + w_rank).sum(), min=1.0)

        def wmean(w, v):
            return (w * v).sum() / torch.clamp(w.sum(), min=1.0)

        metrics = {"loss": per.sum() / denom, "nll_crystal": wmean(w_cr, nll_cr_train),
                   "pair_hinge": wmean(w_pair, pair_hinge),
                   "abs_hinge": wmean(w_abs, abs_hinge),
                   "rank_hinge": wmean(w_rank, rank_hinge),
                   "ref_native": batch_ref, "n_self": n_self}
        return metrics["loss"], metrics

    return loss_fn
