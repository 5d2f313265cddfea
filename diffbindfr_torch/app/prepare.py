"""Host prep of `predict`: the PreparedPair, prep and write_failures of
diffbindfr_tpu/app/pipeline.py. app/pipeline.py re-exports them beside the
stages that run on the device.

`prep` featurises each (receptor, ligand) pair from its raw PDB/SDF files on
the host (numpy, chem/), or serves it from the prep cache: the npz of its
padded sample and the `<stem>.rec.pkl` record beside it, written by the
port's prep or by the JAX package's. A pair that fails is a Failure at the
stage that failed, and the run goes on.

With `n_conformers > 0` each ligand is also embedded into that many fresh
conformers (chem/embed.py, once per ligand and process), which the dock
starts its replicas from. This module and everything it imports stay
without torch, so that a spawn worker of `prep` starts in the time numpy
takes to load: the embedding imports torch when it runs, in the main process
on the caller's device, in a worker on the CPU, never the card.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import pickle

import numpy as np

from ..chem.ligand_feats import featurize_ligand
from ..chem.mol import perceive
from ..chem.protein_feats import build_pocket_record
from ..chem.records import (HoloRef, LigandRecord, PocketRecord, ligand_source,
                            load_prep_record, pocket_source)
from ..data.sample import Buckets, DockingSample, _load_sample_npz, bucket_of, make_sample
from ..io.pdb import Protein, parse_pdb
from ..io.sdf import parse_ligand_file, read_record
from .analysis import build_holo_ref
from .jobs import Job

# job lists of more pairs than this keep no padded sample in host RAM: each
# pair reads its npz when a stage asks for it (a 10k-pair screen would hold
# ~100 KB or more a pair)
RETAIN_PAIRS = 1024


@dataclasses.dataclass
class PreparedPair:
    """One featurised (pocket, ligand) pair: prep's output, or read from a
    prep-cache npz and, where it exists, the `<stem>.rec.pkl` record beside
    it (the ligand and pocket records that error correction, export and the
    metrics read).

    `sample` is read from `sample_path` on first use; `retain` keeps it in
    memory after that, else every use reads the npz again (prep of more
    than RETAIN_PAIRS pairs)."""

    name: str  # the complex name (the JAX pair's job.complex_name)
    bucket: Buckets
    lig: LigandRecord | None = None
    pocket: PocketRecord | None = None
    crystal_pos: np.ndarray | None = None  # [A, 3] input ligand pose, world frame
    job: Job | None = None  # the job the pair was prepared for (its protein path)
    # side-chain reference of an apo->holo job; None grades against the input pocket
    holo_ref: HoloRef | None = None
    # [C, A, 3] embedded start conformers (centred); the dock's replica po
    # starts from conformer po % C. None: every replica starts from the input pose
    conformers: np.ndarray | None = None
    # receptor path -> parsed Protein, shared by the pairs of one `prep` call
    protein_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    sample_path: str | None = None  # the prep-cache npz of the padded sample
    retain: bool = True
    _sample: DockingSample | None = dataclasses.field(default=None, repr=False)

    @property
    def sample(self) -> DockingSample:
        """The padded sample (numpy fields)."""
        if self._sample is not None:
            return self._sample
        if self.sample_path is None:
            raise RuntimeError(f"{self.name}: no sample in memory or on disk")
        s = _load_sample_npz(self.sample_path)
        if self.retain:
            self._sample = s
        return s

    @classmethod
    def from_prep_cache(cls, path: str, job: Job | None = None, rec: dict | None = None,
                        protein_cache: dict | None = None, retain: bool = True):
        """The pair of the cache entry `path` (`<stem>.npz`). `rec` is its
        record when the caller has read it already, else `<stem>.rec.pkl`
        is read where it exists. With a job the pair takes the job's complex
        name, its protein and, when the job names a holo structure, the
        record's holo_ref (a redock job grades against the input pocket).
        Without one the name is the stem less the `_r<radius>` suffix that
        the JAX package's `_cache_paths` adds (`3dbs_r12.npz` -> `3dbs`),
        and the pair has no protein. The npz is read here only where the
        record names no bucket."""
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
        pair = cls(name=name, bucket=rec.get("bucket"), lig=rec.get("lig"),
                   pocket=rec.get("pocket"), crystal_pos=rec.get("crystal_pos"), job=job,
                   holo_ref=rec.get("holo_ref") if job is not None and job.holo_protein else None,
                   protein_cache={} if protein_cache is None else protein_cache,
                   sample_path=path, retain=retain)
        if pair.bucket is None:
            pair.bucket = bucket_of(pair.sample)
        return pair

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


def _cache_hit(rec: dict, job: Job, n_conformers: int = 0) -> bool:
    """Whether a prep record serves `job`, as the JAX package's `_cache_hit`
    (diffbindfr_tpu/app/pipeline.py:105-133) decides: with `n_conformers >
    0` the record needs at least that many conformers (one with more serves,
    sliced by `cached_conformers`), and an apo->holo job needs the record's
    holo reference to come from its holo structure. Two checks more: a
    record with `lig_src` and `pocket_src` (one the port wrote) serves only
    the ligand record, receptor and pocket reference it was built from
    (chem/records.ligand_source, pocket_source); one without them, as the
    JAX package writes them, is served without those checks."""
    confs = rec.get("conformers")
    if n_conformers and (confs is None or confs.shape[0] < n_conformers):
        return False
    if job.holo_protein and (rec.get("holo_src") != job.holo_protein
                             or rec.get("holo_ref") is None):
        return False
    if "pocket_src" in rec and rec["pocket_src"] != pocket_source(job):
        return False
    return "lig_src" not in rec or rec["lig_src"] == ligand_source(job.ligand)


def cached_conformers(rec: dict, n_conformers: int):
    """The conformers a record that serves a job hands its pair: the first
    `n_conformers`, so replica-to-conformer assignment matches a fresh run,
    and none at -nc 0. The JAX package attaches a record's conformers at
    -nc 0 as well, so its cached -nc 0 run docks from conformers where a
    fresh one does not; the port does not copy that."""
    confs = rec.get("conformers")
    return confs[:n_conformers] if n_conformers and confs is not None else None


def _read_hit(spath: str, rpath: str, job: Job, n_conformers: int = 0):
    """The record of the cache entry (spath, rpath) if it serves `job`, else
    None: the pair is then prepared again and the entry replaced."""
    if not (os.path.exists(spath) and os.path.exists(rpath)):
        return None
    try:
        rec = load_prep_record(rpath)
        return rec if _cache_hit(rec, job, n_conformers) else None
    except Exception:  # stale, corrupt or foreign entry, unreadable ligand: recompute
        return None


def _prep_one(job: Job, pocket_radius: float, cache_dir: str | None, lig_cache: dict,
              prot_cache: dict, pocket_cache: dict, n_conformers: int = 0,
              conf_cache: dict | None = None, device="cuda"):
    """Featurise one pair, as the JAX package's `_prep_one`
    (diffbindfr_tpu/app/pipeline.py:136-241). Returns ('ok', (record dict,
    sample path or None, DockingSample or None: None on a cache hit, which
    is read from the npz)) or ('fail', Failure) at the stage that failed:
    'ligand', 'pocket', 'holo', 'embed' or 'sample'. The dicts dedup
    ligand, protein, pocket and (`conf_cache`, keyed by ligand path and
    seed) conformer work within a process; with `n_conformers > 0` the
    ligand is embedded on `device`."""
    spath = rpath = None
    if cache_dir:
        spath, rpath = _cache_paths(cache_dir, job, pocket_radius)
        rec = _read_hit(spath, rpath, job, n_conformers)
        if rec is not None:
            return "ok", (rec, spath, None)

    try:
        if job.ligand not in lig_cache:
            raw, digest = read_record(job.ligand)
            lig_cache[job.ligand] = (featurize_ligand(perceive(raw), job.ligand_name),
                                     (job.ligand, digest))
        lig0, lig_src = lig_cache[job.ligand]
    except Exception as e:  # quarantine, don't kill the run
        return "fail", Failure(job.complex_name, "ligand", repr(e))

    try:
        if job.protein not in prot_cache:
            prot_cache[job.protein] = parse_pdb(job.protein)
        prot = prot_cache[job.protein]
        kind, ref = job.pocket_ref()
        if kind == "center":
            ref_points = np.asarray(ref, dtype=np.float32).reshape(1, 3)
        else:
            ref_points = parse_ligand_file(ref)[0].coords
        pkey = (job.protein, kind, tuple(np.round(ref_points.mean(0), 3)))
        if pkey not in pocket_cache:
            pocket_cache[pkey] = build_pocket_record(prot, ref_points, cutoff=pocket_radius)
        pocket = pocket_cache[pkey]
        pocket_src = pocket_source(job)
    except Exception as e:
        return "fail", Failure(job.complex_name, "pocket", repr(e))

    holo_ref = None
    if job.holo_protein:
        try:
            if job.holo_protein not in prot_cache:
                prot_cache[job.holo_protein] = parse_pdb(job.holo_protein)
            holo_ref = build_holo_ref(pocket, prot_cache[job.holo_protein])
        except Exception as e:
            return "fail", Failure(job.complex_name, "holo", repr(e))

    confs = None
    if n_conformers > 0:
        try:
            conf_cache = {} if conf_cache is None else conf_cache
            key = (job.ligand, 0)
            if key not in conf_cache:
                from ..chem.embed import embed_conformers

                conf_cache[key] = embed_conformers(lig0, n_conformers, seed=0, device=device)
            confs = conf_cache[key]
        except Exception as e:
            return "fail", Failure(job.complex_name, "embed", repr(e))

    try:
        lig = dataclasses.replace(lig0)
        crystal_pos = lig0.pos.copy()
        lig.pos = lig0.pos - pocket.center
        sample = make_sample(lig, pocket)
        rec = {"lig": lig, "pocket": pocket, "bucket": bucket_of(sample),
               "crystal_pos": crystal_pos, "conformers": confs, "holo_ref": holo_ref,
               "holo_src": job.holo_protein or None, "lig_src": lig_src,
               "pocket_src": pocket_src}
        if spath:  # atomic: a reader never sees a half-written file
            tmp = f"{spath}.{os.getpid()}.tmp"
            np.savez(tmp, **sample._asdict())  # writes tmp + ".npz"
            os.replace(tmp + ".npz", spath)
            tmp = f"{rpath}.{os.getpid()}.tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(rec, fh)
            os.replace(tmp, rpath)
        return "ok", (rec, spath, sample)
    except Exception as e:
        return "fail", Failure(job.complex_name, "sample", repr(e))


def _worker_init():
    # a prep worker must never initialise CUDA (the parent may hold the
    # card): with no visible device, torch cannot create a context here
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _worker_prep(args):
    """One chunk of (job index, job) in a pool worker. IPC stays light: the
    padded sample goes back through the npz cache, not the pipe. A worker
    embeds conformers on the CPU (the JAX package's workers are forced onto
    the CPU backend)."""
    chunk, pocket_radius, cache_dir, n_conformers = args
    lig_cache, prot_cache, pocket_cache, conf_cache = {}, {}, {}, {}
    out = []
    for i, job in chunk:
        status, payload = _prep_one(job, pocket_radius, cache_dir, lig_cache, prot_cache,
                                    pocket_cache, n_conformers, conf_cache, device="cpu")
        if status == "ok":
            payload = payload[:2] + (None,)
        out.append((i, status, payload))
    return out


def prep(jobs: list, pocket_radius: float = 12.0, verbose: bool = True,
         cache_dir: str | None = None, num_workers: int = 0, chunk_size: int = 32,
         n_conformers: int = 0, device="cuda"):
    """Featurise all pairs on the host; returns (prepared list in job
    order, failures list). The JAX package's `prep`.

    Ligands, proteins and pockets are deduplicated within a process. With
    `cache_dir`, each pair persists its DockingSample npz and record pkl
    keyed by (complex, radius), `<complex>_r<radius:g>.npz` + `.rec.pkl`: a
    killed run resumes pair by pair, and `predict -j prep` hands its pairs
    to a later dock. An entry serves a job as `_cache_hit` decides, else the
    pair is prepared again and the entry replaced.

    `num_workers > 1` sends the misses to a spawn-based process pool, in
    chunks of jobs grouped by protein (so a receptor parses once per chunk)
    and at most `chunk_size` long, but short enough that every worker gets
    one; cache hits are served in the parent. Results come back through the
    cache, so a temporary `cache_dir` is made when none is given. Samples
    are read from the cache when first used; of more than RETAIN_PAIRS
    pairs none is kept in memory. Prep is host numpy and touches no device,
    except that with `n_conformers > 0` each ligand (once per process) is
    embedded into that many conformers (chem/embed.embed_conformers, seed
    0): on `device` in this process, on the CPU in a worker. Every pair gets
    `conformers` as `cached_conformers` gives them."""
    retain = len(jobs) <= RETAIN_PAIRS
    proteins: dict = {}
    results = []  # (job index, status, payload) in any order
    if num_workers and num_workers > 1 and len(jobs) > 1:
        import multiprocessing as mp
        import tempfile

        if cache_dir is None:
            cache_dir = tempfile.mkdtemp(prefix="diffbindfr_prep_")
        os.makedirs(cache_dir, exist_ok=True)
        todo = []
        for i, job in enumerate(jobs):
            spath, rpath = _cache_paths(cache_dir, job, pocket_radius)
            rec = _read_hit(spath, rpath, job, n_conformers)
            if rec is not None:
                results.append((i, "ok", (rec, spath, None)))
            else:
                todo.append((i, job))
        if verbose and results:
            print(f"[prep] {len(results)}/{len(jobs)} pairs from cache")
        if todo:
            grouped = sorted(todo, key=lambda t: (t[1].protein, t[1].ligand))
            # at most chunk_size jobs a chunk, and a chunk for every worker
            size = max(1, min(chunk_size, -(-len(grouped) // num_workers)))
            chunks = [grouped[k : k + size] for k in range(0, len(grouped), size)]
            # the native parser's library is built here, once, before the
            # workers load it
            from ..io import native

            native.build()
            ctx = mp.get_context("spawn")
            with ctx.Pool(num_workers, initializer=_worker_init) as pool:
                for out in pool.imap_unordered(
                        _worker_prep,
                        [(c, pocket_radius, cache_dir, n_conformers) for c in chunks]):
                    results.extend(out)
                    if verbose:
                        print(f"[prep] {len(results)}/{len(jobs)} pairs featurized", flush=True)
    else:
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        lig_cache, pocket_cache, conf_cache = {}, {}, {}
        for i, job in enumerate(jobs):
            results.append((i, *_prep_one(job, pocket_radius, cache_dir, lig_cache, proteins,
                                          pocket_cache, n_conformers, conf_cache, device)))

    prepared, failures = [], []
    for i, status, payload in sorted(results, key=lambda r: r[0]):
        if status != "ok":
            failures.append(payload)
            continue
        job, (rec, spath, sample) = jobs[i], payload
        if spath:
            pair = PreparedPair.from_prep_cache(spath, job=job, rec=rec, protein_cache=proteins,
                                                retain=retain)
            if retain:  # a fresh sample is the npz's: no need to read it back
                pair._sample = sample
        else:  # no cache: the fresh sample is the only copy
            pair = PreparedPair(name=job.complex_name, bucket=rec["bucket"], lig=rec["lig"],
                                pocket=rec["pocket"], crystal_pos=rec["crystal_pos"], job=job,
                                holo_ref=rec["holo_ref"], protein_cache=proteins,
                                _sample=sample)
        pair.conformers = cached_conformers(rec, n_conformers)
        prepared.append(pair)
    if verbose:
        print(f"[prep] {len(prepared)} pairs prepared, {len(failures)} failed")
    return prepared, failures


def write_failures(outdir: str, failures: list) -> None:
    if not failures:
        return
    with open(os.path.join(outdir, "failed.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["complex_name", "stage", "error"])
        for f in failures:
            w.writerow([f.complex_name, f.stage, f.error])
