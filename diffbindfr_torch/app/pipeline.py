"""The stages of `predict`: PyTorch counterpart of
diffbindfr_tpu/app/pipeline.py (PreparedPair, prep from a prep cache,
DockEngine / dock, ECEngine / error_correct, MDNEngine / score_mdn,
export_and_rank, save_poses / load_poses, write_failures).

Pairs come from prep-cache npz files and the `<stem>.rec.pkl` records beside
them, as the JAX package's `prep` writes both; `prep` here reads the cache
only (host prep from raw PDB/SDF files is a later slice), and a pair without
a usable cache entry is a Failure. Pairs, poses and exports are keyed by the
complex name, as in the JAX package. Each stage groups its replicas (pair x
pose) by bucket and runs them in batches of `batch_size`; a final partial
batch is padded by repeating its first replica and the padding results are
dropped.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import time

import numpy as np
import torch

from .. import sampler as sp
from ..chem.records import HoloRef, LigandRecord, PocketRecord, load_prep_record
from ..data.sample import Buckets, DockingSample, _load_sample_npz, bucket_of, stack_samples, to_device
from ..io.pdb import Protein, parse_pdb
from ..models import mdn_scorer as mdn
from ..ops import vina
from ..utils.device import resolve_device
from .export import PoseStructWriter, export_pose, export_trajectory, pose_metrics
from .jobs import Job


@dataclasses.dataclass
class PreparedPair:
    """One featurised (pocket, ligand) pair, read from a prep-cache npz and,
    where it exists, the `<stem>.rec.pkl` record beside it (the ligand and
    pocket records that error correction, export and the metrics read)."""

    name: str  # the complex name (the JAX pair's job.complex_name)
    sample: DockingSample  # numpy fields, one padded sample
    bucket: Buckets
    lig: LigandRecord | None = None
    pocket: PocketRecord | None = None
    crystal_pos: np.ndarray | None = None  # [A, 3] input ligand pose, world frame
    job: Job | None = None  # the job the pair was prepared for (its protein path)
    # side-chain reference of an apo->holo job; None grades against the input pocket
    holo_ref: HoloRef | None = None
    # receptor path -> parsed Protein, shared by the pairs of one `prep` call
    protein_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_prep_cache(cls, path: str, job: Job | None = None, rec: dict | None = None,
                        protein_cache: dict | None = None) -> "PreparedPair":
        """The pair of the cache entry `path` (`<stem>.npz`). `rec` is its
        record when the caller has read it already, else `<stem>.rec.pkl`
        is read where it exists. With a job the pair takes the job's complex
        name, its protein and, when the job names a holo structure, the
        record's holo_ref (a redock job grades against the input pocket).
        Without one the name is the stem less the `_r<radius>` suffix that
        the JAX package's `_cache_paths` adds (`3dbs_r12.npz` -> `3dbs`),
        and the pair has no protein."""
        stem = path[: -len(".npz")] if path.endswith(".npz") else path
        if rec is None:
            rec = load_prep_record(stem + ".rec.pkl") if os.path.exists(stem + ".rec.pkl") else {}
        if job is not None:
            name = job.complex_name
        else:
            name = os.path.basename(stem)
            head, sep, tail = name.rpartition("_r")
            if sep and head and tail.replace(".", "", 1).isdigit():
                name = head
        s = _load_sample_npz(path)
        return cls(name=name, sample=s, bucket=rec.get("bucket", bucket_of(s)),
                   lig=rec.get("lig"), pocket=rec.get("pocket"),
                   crystal_pos=rec.get("crystal_pos"), job=job,
                   holo_ref=rec.get("holo_ref") if job is not None and job.holo_protein else None,
                   protein_cache={} if protein_cache is None else protein_cache)

    @property
    def protein(self) -> Protein:
        """The full input protein, parsed from job.protein on first use (once
        per path among the pairs sharing `protein_cache`)."""
        if self.job is None:
            raise RuntimeError(f"{self.name}: no job, so no protein to export into")
        if self.job.protein not in self.protein_cache:
            self.protein_cache[self.job.protein] = parse_pdb(self.job.protein)
        return self.protein_cache[self.job.protein]


@dataclasses.dataclass
class Failure:
    complex_name: str
    stage: str
    error: str


def _cache_paths(cache_dir: str, job: Job, pocket_radius: float):
    stem = os.path.join(cache_dir, f"{job.complex_name}_r{pocket_radius:g}")
    return stem + ".npz", stem + ".rec.pkl"


def _cache_hit(rec: dict, job: Job):
    """Why a prep record does not serve `job`, or None when it does: the JAX
    package's `_cache_hit` checks for a run without conformers (-nc 0). A
    record with conformers is refused too: the port's dock starts every
    replica from the input conformer (conformer starts are ROADMAP A14)."""
    if rec.get("conformers") is not None:
        return ("the record carries DG-embedded conformers (-nc), which the port cannot "
                "dock yet (ROADMAP A14)")
    if job.holo_protein and (rec.get("holo_src") != job.holo_protein
                             or rec.get("holo_ref") is None):
        return f"the record's holo reference is not built from {job.holo_protein}"
    return None


def prep(jobs: list, pocket_radius: float = 12.0, cache_dir: str | None = None,
         verbose: bool = True):
    """The pairs of `jobs` from the prep cache in `cache_dir`, as the JAX
    package's `prep` serves a cache hit (`<complex>_r<radius:g>.npz` and its
    `.rec.pkl`). Returns (prepared list, failures list); a job whose entry is
    missing or does not serve it is a Failure at stage 'prep': host prep
    from raw files is ROADMAP A9b."""
    prepared, failures, proteins = [], [], {}
    for job in jobs:
        spath, rpath = _cache_paths(cache_dir or "", job, pocket_radius)
        if not (os.path.exists(spath) and os.path.exists(rpath)):
            why = f"no prep-cache entry {spath} (+ .rec.pkl)"
        else:
            try:
                rec = load_prep_record(rpath)
                why = _cache_hit(rec, job)
                if why is None:
                    prepared.append(PreparedPair.from_prep_cache(
                        spath, job=job, rec=rec, protein_cache=proteins))
                    continue
            except Exception as e:  # an entry the port cannot read: the job fails, not the run
                why = f"unreadable prep-cache entry {spath}: {e!r}"
        failures.append(Failure(job.complex_name, "prep",
                                why + "; host prep from raw files is ROADMAP A9b"))
    if verbose:
        print(f"[prep] {len(prepared)} pairs from the prep cache, {len(failures)} failed")
    return prepared, failures


def write_failures(outdir: str, failures: list) -> None:
    if not failures:
        return
    with open(os.path.join(outdir, "failed.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["complex_name", "stage", "error"])
        for f in failures:
            w.writerow([f.complex_name, f.stage, f.error])


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
    """

    def __init__(self, params, net_cfg, sampler_cfg, batch_size: int = 16,
                 device="cuda", verbose: bool = True, keep_trajectory: bool = False):
        self.device = resolve_device(device)
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
            batch = to_device(stack_samples([prepared[i].sample for i, _ in reps]), self.device)
            noise = sp.draw_noise(batch, self.sampler_cfg, gen)
            res = sp.sample(self.params, self.net_cfg, self.sampler_cfg, batch, noise,
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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def dock(prepared: list, params, net_cfg, scfg, num_poses: int = 40, batch_size: int = 16,
         seed: int = 0, device="cuda", verbose: bool = True,
         keep_trajectory: bool = False) -> list:
    """Run the reverse diffusion for every (pair, pose) replica (one-shot
    wrapper around DockEngine)."""
    eng = DockEngine(params, net_cfg, scfg, batch_size=batch_size, device=device,
                     verbose=verbose, keep_trajectory=keep_trajectory)
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


def export_and_rank(prepared: list, results: list, outdir: str, export_pocket: bool = False,
                    export_top: int = -1, verbose: bool = True, cluster_rank: float = 0.0,
                    cluster_mode: str = "mean") -> str:
    """Write per-pose structures, results.csv and the top-1 tables; returns
    the results.csv path. The JAX package's `export_and_rank`, file for
    file, with one addition: results_cluster_top1.csv has a `rank_score`
    column naming the score that ranked the clusters (mdn_nll, else
    vina_score).

    Per pose `<outdir>/<complex>/pose_<i>/lig_final.sdf` and
    `prot_final.pdb` (`pocket_final.pdb` too with `export_pocket`, the
    trajectory files when the pose carries one); `export_top >= 0` writes
    structures only for the top-k poses per complex (`_top_results`), the
    other rows keep their scores and metrics with empty file columns. The
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
        write_structs = keep is None or ri in keep
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
