"""The stages of `predict`: PyTorch counterpart of
diffbindfr_tpu/app/pipeline.py (PreparedPair, prep, DockEngine / dock,
ECEngine / error_correct, CartesianRelaxEngine / cartesian_relax,
MDNEngine / score_mdn, export_and_rank, save_poses / load_poses,
write_failures).

Host prep (PreparedPair, prep, write_failures) lives in app/prepare.py,
which imports no torch, and is re-exported here. Pairs, poses and exports
are keyed by the complex name, as in the JAX package. Each stage after prep
groups its replicas (pair x pose) by bucket and runs them in batches of
`batch_size`; a final partial batch is padded by repeating its first
replica and the padding results are dropped.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import sampler as sp
from ..data.sample import stack_samples, to_device
from ..models import mdn_scorer as mdn
from ..ops import cartesian, vina
from ..utils.device import resolve_device
from .export import PoseStructWriter, export_pose, export_trajectory, pose_metrics
from .prepare import Failure, PreparedPair, prep, write_failures  # noqa: F401 (re-exported)


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
    lig_traj: np.ndarray | None = None  # [S, NL_pad, 3]
    atom14_traj: np.ndarray | None = None  # [S, R_pad, 14, 3]


class DockEngine:
    """Docking engine: parameters (a tree of tensors, e.g. from
    load_checkpoint or params_from_numpy) pinned on the device once, batches
    of one bucket run through `sampler.sample`.

    Noise: `run(..., seed)` makes one torch.Generator on the device seeded
    with `seed` and, batch by batch in order, draws each batch's noise with
    `sampler.draw_noise` (padding replicas included), so a run is
    reproducible and a caller can rebuild any batch's noise.
    `keep_trajectory` attaches each pose's positions after every step.
    Replica po of a pair with conformers starts from conformer po % C
    (`start_refs`). `use_kernels` picks the score net's path (the plain
    path for conv_mode 'fc', which has no kernels).
    """

    def __init__(self, params, net_cfg, sampler_cfg, batch_size: int = 16,
                 device="cuda", verbose: bool = True, keep_trajectory: bool = False,
                 use_kernels: bool = True):
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.params = _to_device(params, self.device)
        self.net_cfg = net_cfg
        self.sampler_cfg = sampler_cfg
        self.batch_size = batch_size
        self.verbose = verbose
        self.keep_trajectory = keep_trajectory

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
            host = start_refs(_stack(prepared, [i for i, _ in reps]), prepared, reps)
            batch = to_device(host, self.device)
            noise = sp.draw_noise(batch, self.sampler_cfg, gen)
            res = sp.sample(self.params, self.net_cfg, self.sampler_cfg, batch, noise,
                            use_kernels=self.use_kernels,
                            keep_trajectory=self.keep_trajectory)
            lig_pos, a14, chi = (res.lig_pos.cpu().numpy(), res.atom14_pos.cpu().numpy(),
                                 res.chi.cpu().numpy())
            lt = at = None
            if self.keep_trajectory:
                lt, at = res.lig_traj.cpu().numpy(), res.atom14_traj.cpu().numpy()
            for j, (pi, po) in enumerate(chunk):
                results.append(PoseResult(pi, po, lig_pos[j], a14[j], chi[j],
                                          lig_traj=None if lt is None else lt[:, j],
                                          atom14_traj=None if at is None else at[:, j]))
            if self.verbose:
                rate = len(results) / max(time.time() - t0, 1e-9)
                print(f"[dock] {len(results)}/{total} poses ({rate:.2f}/s)", flush=True)
        return results


def _stack(prepared: list, pair_idxs: list):
    """The batch of the pairs `pair_idxs` (repeats allowed): each pair's
    sample read once, from memory or its npz."""
    samples = {i: prepared[i].sample for i in dict.fromkeys(pair_idxs)}
    return stack_samples([samples[i] for i in pair_idxs])


def start_refs(batch, prepared: list, reps: list):
    """The host batch of the replicas `reps` [(pair_idx, pose_idx)] with
    each replica's lig_ref_pos set to its pair's conformer pose_idx % C,
    zero-padded to the bucket, where the pair has conformers (JAX
    pipeline.py:710-720): the sampler randomises torsions, rotation and
    translation about lig_ref_pos, so only the conformer's internal
    geometry matters."""
    if all(prepared[pi].conformers is None for pi, _ in reps):
        return batch
    ref = np.array(batch.lig_ref_pos, copy=True)
    for j, (pi, po) in enumerate(reps):
        confs = prepared[pi].conformers
        if confs is not None:
            c = confs[po % confs.shape[0]]
            ref[j] = 0.0
            ref[j, : c.shape[0]] = c
    return batch._replace(lig_ref_pos=ref)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def dock(prepared: list, params, net_cfg, scfg, num_poses: int = 40, batch_size: int = 16,
         seed: int = 0, device="cuda", verbose: bool = True,
         keep_trajectory: bool = False, use_kernels: bool = True) -> list:
    """Run the reverse diffusion for every (pair, pose) replica (one-shot
    wrapper around DockEngine)."""
    eng = DockEngine(params, net_cfg, scfg, batch_size=batch_size, device=device,
                     verbose=verbose, keep_trajectory=keep_trajectory,
                     use_kernels=use_kernels)
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


class _PairSystemEngine:
    """A pose stage over per-pair systems built on the host and kept on the
    device, for at most `max(2 * batch_size, 32)` pairs (the JAX engines'
    stager capacity): past that the least recently used pair outside the
    running batch is dropped, so a long-lived server does not grow with
    every pair it has seen. Subclasses name their stage and build a pair's
    system (`_build`: a tuple of NamedTuples with batch axis 1)."""

    stage = ""

    def __init__(self, batch_size: int, device, verbose: bool):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.verbose = verbose
        self.capacity = max(2 * batch_size, 32)
        # id(pair) -> (pair, *system) on the device, least recently used
        # first; the entry holds the pair, so its id is not reused
        self._systems: OrderedDict = OrderedDict()

    def _system(self, pair, keep: set):
        """The pair's system on the device; `keep` holds the ids of the
        running batch's pairs, which are never evicted."""
        key = id(pair)
        if key in self._systems:
            self._systems.move_to_end(key)
            return self._systems[key]
        if pair.lig is None or pair.pocket is None:
            raise ValueError(f"{pair.name}: no ligand/pocket record (rec.pkl) for {self.stage}")
        self._systems[key] = (pair, *self._build(pair))
        while len(self._systems) > self.capacity:
            old = next(k for k in self._systems if k not in keep)
            del self._systems[old]
        return self._systems[key]

    def close(self) -> None:
        """Drop every pair's system from the device."""
        self._systems.clear()

    def _batches(self, prepared: list, results: list):
        """[(chunk, padded result indices, the batch's pairs, its systems
        concatenated field by field)] in run order."""
        for chunk, idxs in _batches(prepared, results, self.batch_size):
            pairs = [prepared[results[k].pair_idx] for k in idxs]
            keep = {id(p) for p in pairs}
            systems = [self._system(p, keep)[1:] for p in pairs]
            cat = tuple(type(parts[0])(*[torch.cat(f) for f in zip(*parts)])
                        for parts in zip(*systems))
            yield chunk, idxs, pairs, cat

    def _tensor(self, arrays: list):
        return torch.from_numpy(np.stack(arrays)).to(self.device, torch.float32)


class ECEngine(_PairSystemEngine):
    """Vina error correction: each pose re-minimized in (translation,
    rotation, torsion) space against the rigid pocket (`vina.minimize_batch`,
    `steps` Adam steps at learning rate `lr`)."""

    stage = "EC"

    def __init__(self, steps: int = 150, lr: float = 0.05, batch_size: int = 16,
                 device="cuda", verbose: bool = True):
        super().__init__(batch_size, device, verbose)
        self.steps = steps
        self.lr = lr

    def _build(self, pair):
        b = pair.bucket
        return (vina.stack_to_device([vina.build_ligand(pair.lig, b.n_lig, b.n_tor)], self.device),
                vina.stack_to_device([vina.build_receptor(pair.pocket, b.n_atm)], self.device))

    def run(self, prepared: list, results: list) -> None:
        """Minimize every result's pose in place: sets lig_pos and
        vina_score."""
        t0 = time.time()
        done = 0
        for chunk, idxs, pairs, (ligs, recs) in self._batches(prepared, results):
            lp = self._tensor([results[k].lig_pos for k in idxs])
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


class CartesianRelaxEngine(_PairSystemEngine):
    """All-atom Cartesian fine-relax (`cartesian.cartesian_minimize_batch`,
    `steps` Adam steps at learning rate `lr`, the default RelaxWeights): the
    ligand's Cartesian coordinates and the pose's receptor heavy atoms,
    restrained, move together."""

    stage = "Cartesian relax"

    def __init__(self, steps: int = 300, lr: float = 0.02, batch_size: int = 16,
                 device="cuda", verbose: bool = True):
        super().__init__(batch_size, device, verbose)
        self.steps = steps
        self.lr = lr

    def _build(self, pair):
        b = pair.bucket
        host = (cartesian.build_cartesian_ligand(pair.lig, b.n_lig),
                vina.build_ligand(pair.lig, b.n_lig, b.n_tor),
                cartesian.build_cartesian_receptor(pair.pocket, b.n_atm))
        return tuple(vina.stack_to_device([t], self.device) for t in host)

    def run(self, prepared: list, results: list) -> None:
        """Relax every result's pose in place: sets lig_pos and atom14_pos
        (the scores are left as they are)."""
        t0 = time.time()
        done = 0
        for chunk, idxs, _, (cls, vls, crs) in self._batches(prepared, results):
            lp = self._tensor([results[k].lig_pos for k in idxs])
            a14 = self._tensor([results[k].atom14_pos for k in idxs])
            pos, a14 = cartesian.cartesian_minimize_batch(lp, a14, cls, vls, crs,
                                                          steps=self.steps, lr=self.lr)
            pos, a14 = pos.cpu().numpy(), a14.cpu().numpy()
            for j, k in enumerate(chunk):
                results[k].lig_pos = pos[j]
                results[k].atom14_pos = a14[j]
            done += len(chunk)
            if self.verbose:
                print(f"[relax] {done}/{len(results)} poses ({time.time() - t0:.1f} s)",
                      flush=True)


def cartesian_relax(prepared: list, results: list, steps: int = 300, lr: float = 0.02,
                    batch_size: int = 16, device="cuda", verbose: bool = True) -> None:
    """All-atom Cartesian fine-relax of every pose (the reference's OpenMM
    relax role): repairs the strain and clashes that EC's pose-space moves
    cannot reach; updates lig_pos and atom14_pos in place, the vina and MDN
    scores are not touched. One-shot wrapper around CartesianRelaxEngine."""
    t0 = time.time()
    CartesianRelaxEngine(steps=steps, lr=lr, batch_size=batch_size, device=device,
                         verbose=verbose).run(prepared, results)
    if verbose:
        print(f"[relax] Cartesian fine-relax of {len(results)} poses in "
              f"{time.time() - t0:.1f}s")


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
            batch = to_device(_stack(prepared, [results[k].pair_idx for k in idxs]),
                              self.device)
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


def load_poses(path: str, prepared: list) -> list:
    """Rebuild the PoseResult list from a `save_poses` file (either
    package's) for the pairs in `prepared`, matched by complex name; pairs
    without saved poses are skipped with a warning."""
    data = np.load(path)
    names = {k.split("|")[0] for k in data.files}
    results = []
    for pi, pair in enumerate(prepared):
        nm = pair.name
        if nm not in names:
            print(f"[poses] WARNING: no saved poses for {nm}")
            continue
        lp = data[nm + "|lig_pos"]
        a14 = data[nm + "|atom14_pos"]
        pidx = data[nm + "|pose_idx"]
        vina_ = data[nm + "|vina"]
        for j in range(lp.shape[0]):
            results.append(PoseResult(
                pair_idx=pi, pose_idx=int(pidx[j]), lig_pos=lp[j], atom14_pos=a14[j],
                chi=np.zeros(0, np.float32),
                vina_score=None if np.isnan(vina_[j]) else float(vina_[j])))
    return results


def _top_results(results, k: int) -> set:
    """Indices of the k best poses per pair (mdn desc, else vina asc, else
    pose order): the structure-export budget of a screen."""
    by_pair: dict = {}
    for i, r in enumerate(results):
        by_pair.setdefault(r.pair_idx, []).append(i)
    keep: set = set()
    for idxs in by_pair.values():
        def key(i):
            r = results[i]
            if r.mdn_score is not None:
                return (-r.mdn_score,)
            if r.vina_score is not None:
                return (r.vina_score,)
            return (r.pose_idx,)
        keep.update(sorted(idxs, key=key)[:k])
    return keep


def _num(v, default: float) -> float:
    """Score-or-default without truthiness: a score of 0.0 is a score."""
    return default if v is None else v


def _write_table(path: str, fields: list, rows) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _best_per_complex(rows: list, col: str, lower: bool) -> dict:
    """complex -> its first row with the strictly best `col` (missing
    scores rank last), in row order."""
    best: dict = {}
    for row in rows:
        c = row["complex_name"]
        if lower:
            better = c not in best or _num(row[col], 1e30) < _num(best[c][col], 1e30)
        else:
            better = c not in best or _num(row[col], -1e30) > _num(best[c][col], -1e30)
        if better:
            best[c] = row
    return best


def export_and_rank(prepared: list, results: list, outdir: str, export_structures: bool = True,
                    export_pocket: bool = False, export_top: int = -1, verbose: bool = True,
                    cluster_rank: float = 0.0, cluster_mode: str = "mean") -> str:
    """Write per-pose structures, results.csv and the top-1 tables; returns
    the results.csv path. The JAX package's `export_and_rank`, file for
    file, with one addition: results_cluster_top1.csv has a `rank_score`
    column naming the score that ranked the clusters (mdn_nll, else
    vina_score).

    Per pose `<outdir>/<complex>/pose_<i>/lig_final.sdf` and
    `prot_final.pdb` (`pocket_final.pdb` too with `export_pocket`, the
    trajectory files when the pose carries one); `export_top >= 0` writes
    structures only for the top-k poses per complex (`_top_results`), the
    other rows keep their scores and metrics with empty file columns, and
    `export_structures=False` writes none (the tables only, as a rescore
    does). The
    metrics grade each pose against the crystal pose (l_rmsd, centroid)
    and its side chains against `pair.holo_ref`, else the input pocket
    (chi1_rate, sc_rmsd). Top-1 tables: results_mdn_top1.csv (highest
    mdn_score), results_mdn_nll_top1.csv (lowest mdn_nll),
    results_vina_top1.csv (lowest vina_score), and with `cluster_rank > 0`
    results_cluster_top1.csv (app/cluster.py: single linkage at
    `cluster_rank` A, clusters ordered by `cluster_mode`)."""
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    keep = None if export_top < 0 else _top_results(results, export_top)
    struct_writer = PoseStructWriter()
    rows = []
    for ri, r in enumerate(results):
        pair = prepared[r.pair_idx]
        pose_dir = os.path.join(outdir, pair.name, f"pose_{r.pose_idx}")
        props = {}
        if r.mdn_score is not None:
            props["mdn_score"] = f"{r.mdn_score:.6f}"
        write_structs = export_structures and (keep is None or ri in keep)
        if write_structs:
            export_pose(pose_dir, pair.lig, pair.pocket, pair.protein, r.lig_pos,
                        r.atom14_pos, export_pocket=export_pocket, props=props,
                        struct_writer=struct_writer)
            if r.lig_traj is not None:
                export_trajectory(pose_dir, pair.lig, pair.pocket, r.lig_traj, r.atom14_traj)
        row = {
            "complex_name": pair.name,
            "pose": r.pose_idx,
            "lig_sdf": os.path.join(pose_dir, "lig_final.sdf") if write_structs else "",
            "prot_pdb": os.path.join(pose_dir, "prot_final.pdb") if write_structs else "",
            "mdn_score": r.mdn_score,
            "mdn_nll": r.mdn_nll,
            "vina_score": r.vina_score,
        }
        holo = pair.holo_ref if pair.holo_ref is not None else pair.pocket
        row.update(pose_metrics(pair.lig, pair.pocket, r.lig_pos, r.atom14_pos,
                                crystal_lig_pos=pair.crystal_pos,
                                holo_pocket=holo).as_dict())
        rows.append(row)

    fields = sorted({k for row in rows for k in row})
    res_csv = os.path.join(outdir, "results.csv")
    _write_table(res_csv, fields, rows)
    if any(row["mdn_score"] is not None for row in rows):
        _write_table(os.path.join(outdir, "results_mdn_top1.csv"), fields,
                     _best_per_complex(rows, "mdn_score", lower=False).values())
    if any(row["mdn_nll"] is not None for row in rows):
        _write_table(os.path.join(outdir, "results_mdn_nll_top1.csv"), fields,
                     _best_per_complex(rows, "mdn_nll", lower=True).values())

    score_col = None
    if cluster_rank > 0:
        if any(row["mdn_nll"] is not None for row in rows):
            score_col = "mdn_nll"
        elif any(row["vina_score"] is not None for row in rows):
            score_col = "vina_score"
            print("[cluster] no mdn_nll scores (no -mdn checkpoint); "
                  "cluster-ranking by vina_score instead")
        else:
            print("[cluster] --cluster-rank requested but no pose has an mdn_nll or "
                  "vina_score (no -mdn and no EC stage?); results_cluster_top1.csv NOT written")
    if score_col is not None:
        from . import cluster as CL

        by_pair_rows: dict = {}
        for ri, r in enumerate(results):
            by_pair_rows.setdefault(r.pair_idx, []).append(ri)
        best = {}
        for pi, ris in by_pair_rows.items():
            pair = prepared[pi]
            scores = np.asarray([_num(rows[ri][score_col], 1e30) for ri in ris])
            na = pair.lig.num_atoms
            lp = np.stack([np.asarray(results[ri].lig_pos)[:na] for ri in ris])
            dmat = CL.pose_rmsd_matrix(lp, pair.lig.bonds, pair.lig.elements)
            labels = CL.single_linkage(dmat, cluster_rank)
            order = CL.cluster_rank(labels, scores, cluster_mode)
            best[pair.name] = {**rows[ris[order[0]]], "rank_score": score_col}
        _write_table(os.path.join(outdir, "results_cluster_top1.csv"),
                     sorted(fields + ["rank_score"]), best.values())

    if any(row["vina_score"] is not None for row in rows):
        _write_table(os.path.join(outdir, "results_vina_top1.csv"), fields,
                     _best_per_complex(rows, "vina_score", lower=True).values())
    if verbose:
        print(f"[export] {len(rows)} rows -> {res_csv} in {time.time() - t0:.1f}s")
    return res_csv
