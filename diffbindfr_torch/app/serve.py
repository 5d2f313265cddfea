"""Persistent docking service of the port: the counterpart of
diffbindfr_tpu/app/serve.py, with the same HTTP protocol, flags and
defaults.

The daemon keeps its state across requests:

  * checkpoints load once; DockEngine / ECEngine / MDNEngine keep their
    parameters and each pair's EC system on the device
  * requests batch dynamically: the single device worker drains the queue
    and packs the (pair x pose) replicas of CONCURRENT requests into shared
    bucket batches, so light requests share device time as the batch CLI's
    replicas do. A round docks with the seed of its first request, so a
    request's poses depend on which requests share its round (as in the
    JAX package)
  * prep runs in the HTTP handler threads, off the device thread, with the
    same per-pair npz cache the CLI uses, and a pair cache in memory that
    keeps the max(2 * batch_size, 32) pairs used last (as ECEngine bounds
    its device cache), keyed by the files' paths, modification times and
    sizes, so a file rewritten in place is prepared again
  * `n_conformers > 0` embeds that many start conformers per ligand at prep
    (chem/embed.py, on the service's device, in the handler thread); pose i
    starts from conformer i % n. Embeddings and the worker's rounds take
    turns on the card under embed.CARD_LOCK: work on the card's default
    stream beside an embedding's CUDA-graph capture would invalidate it

Protocol: JSON over HTTP (stdlib only).

  GET  /health -> {"status": "ok", "device": "cuda" | "cpu",
                   "warm_buckets": N (buckets docked so far),
                   "requests_served": N}
  POST /dock   {"protein": "/abs/prot.pdb",
                "ligand": "/abs/lig.sdf",
                "center": [x, y, z]          # or "crystal_ligand": path
                "num_poses": 8,              # default 8
                "n_conformers": 0,           # DG-embed fresh starts
                "ec": true, "score": true,   # stage toggles
                "seed": 0,
                "outdir": "/abs/dir"}        # optional file export
       -> {"complex_name": ..., "poses": [{"pose": i, "sdf": "...",
           "mdn_score": ..., "mdn_nll": ..., "vina_score": ...}, ...]}
           sorted best-first (mdn when scored, else vina, else pose id)
  POST /shutdown -> {"status": "bye"}  (every request queued before it is
                   served first)

A bad request (missing file, failed prep, a field the port lacks) gets 400,
a timed-out one 503, any other failure 500 with the error's type and text.

Start: python -m diffbindfr_torch.app.serve -ckt runs/diff_r2 -mdn runs/mdn_r4b --port 8765
"""
from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from collections import OrderedDict

import numpy as np

from ..chem.embed import CARD_LOCK
from .jobs import Job


class DockRequest:
    """One /dock request riding through the batching queue."""

    def __init__(self, pair, num_poses: int, do_ec: bool, do_score: bool, seed: int):
        self.pair = pair
        self.num_poses = num_poses
        self.do_ec = do_ec
        self.do_score = do_score
        self.seed = seed
        self.done = threading.Event()
        self.results = None  # list[PoseResult]
        self.error: str | None = None


class DockService:
    """Engine owner + dynamic batcher. One instance per process and card."""

    def __init__(self, params, net_cfg, sampler_cfg, mdn_params=None, mdn_cfg=None,
                 batch_size: int = 16, ec_steps: int = 150, pocket_radius: float = 12.0,
                 cache_dir: str | None = None, max_wait_s: float = 0.2,
                 request_timeout_s: float = 1800.0, device="cuda", verbose: bool = True):
        from . import pipeline as P

        self.pocket_radius = pocket_radius
        self.cache_dir = cache_dir or tempfile.mkdtemp(prefix="diffbindfr_serve_")
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.request_timeout_s = request_timeout_s
        self.verbose = verbose
        self.requests_served = 0

        self.dock_engine = P.DockEngine(params, net_cfg, sampler_cfg, batch_size=batch_size,
                                        device=device, verbose=verbose)
        self.device = self.dock_engine.device
        self.ec_engine = P.ECEngine(steps=ec_steps, batch_size=batch_size, device=self.device,
                                    verbose=verbose)
        self.mdn_engine = (P.MDNEngine(mdn_params, mdn_cfg, batch_size=batch_size,
                                       device=self.device, verbose=verbose)
                           if mdn_params is not None else None)
        self._buckets: set = set()  # buckets docked so far

        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._work_loop, name="dock-worker",
                                        daemon=True)
        self._worker.start()
        # prep dedup: (protein, ligand, center/crystal, nc) -> PreparedPair,
        # least recently used first, at most pair_capacity of them
        self.pair_capacity = max(2 * batch_size, 32)
        self._pair_cache: OrderedDict = OrderedDict()
        self._pair_lock = threading.Lock()
        # complex name -> lock, for concurrent same-pair requests; bounded alike
        self._key_locks: OrderedDict = OrderedDict()

    # ---- host side (handler threads) ----------------------------------

    def prepare(self, req: dict):
        """Featurize the request's (protein, ligand) pair; cached. Raises
        ValueError (HTTP 400) for a request the port cannot serve."""
        from . import pipeline as P

        protein = req["protein"]
        ligand = req["ligand"]
        center = req.get("center")
        crystal = req.get("crystal_ligand")
        nc = int(req.get("n_conformers", 0))
        if center is None and not crystal:
            # auto-discovery convention (<stem>_crystal.sdf / _box.csv next
            # to the receptor), else self-dock on the input ligand
            from .jobs import discover_pocket_ref

            kind, ref = discover_pocket_ref(protein)
            if kind == "crystal":
                crystal = ref
            elif kind == "center":
                center = ref
            else:
                crystal = ligand
        key = (_file_key(protein), _file_key(ligand),
               tuple(center) if center else _file_key(crystal), nc)
        name = (os.path.splitext(os.path.basename(protein))[0] + "_"
                + os.path.splitext(os.path.basename(ligand))[0])
        with self._pair_lock:
            hit = self._cached(key)
            if hit is not None:
                return hit
            # concurrent requests hitting the same prep-cache stem (complex
            # name) must not prep in parallel
            key_lock = self._key_locks.setdefault(name, threading.Lock())
            self._key_locks.move_to_end(name)
            _bound(self._key_locks, self.pair_capacity, keep=lambda lk: lk.locked())
        with key_lock:
            with self._pair_lock:
                hit = self._cached(key)
            if hit is not None:
                return hit
            job = Job(protein=protein, protein_name=name, ligand=ligand, ligand_name=name,
                      complex_name=name, crystal_ligand=crystal,
                      center=tuple(center) if center else None)
            prepared, failures = P.prep([job], pocket_radius=self.pocket_radius,
                                        cache_dir=self.cache_dir, verbose=False,
                                        n_conformers=nc, device=self.device)
            if failures:
                raise ValueError(f"prep failed: {failures[0].stage}: {failures[0].error}")
            with self._pair_lock:
                self._pair_cache[key] = prepared[0]
                _bound(self._pair_cache, self.pair_capacity)
            return prepared[0]

    def _cached(self, key):
        """The cached pair of `key` (marked as used last), or None; under
        _pair_lock."""
        hit = self._pair_cache.get(key)
        if hit is not None:
            self._pair_cache.move_to_end(key)
        return hit

    def warmup(self, protein: str, ligand: str, **req) -> int:
        """Run the full request path (prep, dock, EC, MDN) once on an
        example pair so the first real request finds the libraries loaded
        and the allocator warm. Returns the number of poses produced."""
        pair = self.prepare({"protein": protein, "ligand": ligand, **req})
        results = self.submit(pair, num_poses=1, do_ec=True,
                              do_score=self.mdn_engine is not None)
        return len(results)

    def submit(self, pair, num_poses: int, do_ec: bool, do_score: bool, seed: int = 0,
               timeout: float | None = None) -> list:
        """Enqueue a docking job; blocks until its poses are ready."""
        r = DockRequest(pair, num_poses, do_ec, do_score, seed)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("the service is shutting down")
            self._queue.put(r)
        if not r.done.wait(timeout or self.request_timeout_s):
            raise TimeoutError("dock request timed out")
        if r.error:
            raise RuntimeError(r.error)
        self.requests_served += 1
        return r.results

    # ---- device side (single worker thread) ---------------------------

    def _drain(self):
        """Collect queued requests up to one device round's worth."""
        reqs = [self._queue.get()]
        deadline = time.time() + self.max_wait_s
        total = reqs[0].num_poses if reqs[0] is not None else self.batch_size
        while total < self.batch_size and time.time() < deadline:
            try:
                r = self._queue.get(timeout=max(deadline - time.time(), 1e-3))
            except queue.Empty:
                break
            reqs.append(r)
            if r is None:  # shutdown sentinel: nothing queued behind it
                break
            total += r.num_poses
        return reqs

    def _work_loop(self):
        while True:
            reqs = self._drain()
            try:
                with CARD_LOCK:
                    self._run_round(reqs)
            except Exception as e:  # noqa: BLE001 — reported to the callers
                for r in reqs:
                    if r is not None and not r.done.is_set():
                        r.error = f"{type(e).__name__}: {e}"
                        r.done.set()
            if reqs[-1] is None:  # shutdown after the requests queued before it
                break

    def _run_round(self, reqs):
        reqs = [r for r in reqs if r is not None]
        if not reqs:
            return
        pairs = [r.pair for r in reqs]
        counts = [r.num_poses for r in reqs]
        seed = reqs[0].seed
        results = self.dock_engine.run(pairs, num_poses=counts, seed=seed)
        self._buckets.update(p.bucket for p in pairs)
        if any(r.do_ec for r in reqs):
            ec_idx = {i for i, r in enumerate(reqs) if r.do_ec}
            self.ec_engine.run(pairs, [x for x in results if x.pair_idx in ec_idx])
        if self.mdn_engine is not None and any(r.do_score for r in reqs):
            sc_idx = {i for i, r in enumerate(reqs) if r.do_score}
            self.mdn_engine.run(pairs, [x for x in results if x.pair_idx in sc_idx])
        by_req: dict = {i: [] for i in range(len(reqs))}
        for x in results:
            by_req[x.pair_idx].append(x)
        for i, r in enumerate(reqs):
            r.results = by_req[i]
            r.done.set()

    def close(self):
        """Serve every request queued so far, then stop the worker and drop
        the EC systems from the device."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=self.request_timeout_s)
        self.ec_engine.close()

    @property
    def warm_buckets(self) -> int:
        return len(self._buckets)


def _file_key(path: str):
    """(absolute path, modification time in ns, size) of a request's file;
    a file that cannot be read keys by its path alone and fails in prep."""
    try:
        st = os.stat(path)
    except OSError:
        return (os.path.abspath(path), None, None)
    return (os.path.abspath(path), st.st_mtime_ns, st.st_size)


def _bound(cache: OrderedDict, capacity: int, keep=lambda v: False) -> None:
    """Drop the least recently used entries of `cache` past `capacity`,
    skipping those `keep` holds on to."""
    over = len(cache) - capacity
    for k in [k for k, v in cache.items() if not keep(v)][:max(over, 0)]:
        del cache[k]


def _pose_payload(pair, res, outdir: str | None):
    """PoseResult -> JSON-safe dict with an inline SDF block."""
    from ..io.sdf import to_sdf_block
    from .export import ligand_to_rawmol

    props = {}
    if res.mdn_score is not None:
        props["mdn_score"] = f"{res.mdn_score:.6f}"
    if res.vina_score is not None:
        props["vina_score"] = f"{res.vina_score:.4f}"
    world = np.asarray(res.lig_pos)[: pair.lig.num_atoms]
    world = world + pair.pocket.center[None, :]
    sdf = to_sdf_block(ligand_to_rawmol(pair.lig, world, props))
    row = {
        "pose": int(res.pose_idx),
        "sdf": sdf,
        "mdn_score": res.mdn_score,
        "mdn_nll": res.mdn_nll,
        "vina_score": res.vina_score,
    }
    if outdir:
        pose_dir = os.path.join(outdir, pair.name)
        os.makedirs(pose_dir, exist_ok=True)
        path = os.path.join(pose_dir, f"pose_{res.pose_idx}.sdf")
        with open(path, "w") as fh:
            fh.write(sdf)
        row["lig_sdf"] = path
    return row


def _sort_key(row):
    if row["mdn_score"] is not None:
        return (-row["mdn_score"],)
    if row["vina_score"] is not None:
        return (row["vina_score"],)
    return (row["pose"],)


class DockServer:
    """HTTP front end over a DockService (stdlib http.server)."""

    def __init__(self, service: DockService, host: str = "127.0.0.1", port: int = 0):
        import http.server

        svc = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                if service.verbose:
                    super().log_message(fmt, *args)

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    return self._reply(404, {"error": "unknown path"})
                self._reply(200, {
                    "status": "ok",
                    "device": service.device.type,
                    "warm_buckets": service.warm_buckets,
                    "requests_served": service.requests_served,
                })

            def do_POST(self):
                if self.path == "/shutdown":
                    self._reply(200, {"status": "bye"})
                    threading.Thread(target=svc.stop, daemon=True).start()
                    return
                if self.path != "/dock":
                    return self._reply(404, {"error": "unknown path"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    pair = service.prepare(req)
                    results = service.submit(
                        pair,
                        num_poses=int(req.get("num_poses", 8)),
                        do_ec=bool(req.get("ec", True)),
                        do_score=bool(req.get("score", True)),
                        seed=int(req.get("seed", 0)),
                    )
                    outdir = req.get("outdir")
                    rows = sorted((_pose_payload(pair, r, outdir) for r in results),
                                  key=_sort_key)
                    self._reply(200, {"complex_name": pair.name, "poses": rows})
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                except TimeoutError as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self.service = service
        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http",
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.service.close()
        self.httpd.server_close()

    def serve_forever(self):
        self._thread.start()
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(prog="diffbindfr_torch.serve",
                                 description="persistent docking service (JSON over HTTP), "
                                             "PyTorch/CUDA port")
    ap.add_argument("-ckt", "--checkpoint", help="diffusion checkpoint (.npz or run dir)")
    ap.add_argument("-mdn", "--mdn-checkpoint", help="MDN scorer checkpoint (.npz or run dir)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("-bs", "--batch-size", type=int, default=16)
    ap.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    ap.add_argument("--ec-steps", type=int, default=150)
    ap.add_argument("-st", "--steps", type=int, default=20)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted and ignored: the device picks the path (the card runs the "
                         "hand-written CUDA kernels, --cpu their plain versions)")
    ap.add_argument("--cache-dir", help="prep cache directory")
    ap.add_argument("--warmup", nargs=2, metavar=("PROT", "LIG"),
                    help="run the request path once on this example (protein.pdb "
                         "ligand.sdf) before listening")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def make_service(args, verbose: bool = True) -> DockService:
    """The DockService of parsed command-line `args` (build_parser): the
    checkpoints loaded onto the card, or the CPU with --cpu."""
    import torch

    from .. import sampler as sp
    from ..models import mdn_scorer as mdn
    from ..models import score_net as sn
    from ..utils.checkpoint import load_checkpoint, resolve_checkpoint
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    net_cfg = sn.ScoreNetConfig(compute_dtype=args.dtype)
    scfg = sp.SamplerConfig(inference_steps=args.steps + 2, actual_steps=args.steps)
    if args.checkpoint:
        ckpt = resolve_checkpoint(args.checkpoint)
        params, step = load_checkpoint(ckpt, use_ema=True, device=dev)
        print(f"[serve] diffusion model {ckpt} (step {step})")
    else:
        print("[serve] WARNING: random diffusion weights")
        params = sn.init_params(torch.Generator().manual_seed(0), net_cfg, device=dev)
    mdn_params = mdn_cfg = None
    if args.mdn_checkpoint:
        mdn_cfg = mdn.MDNConfig()
        mdn_params, _ = load_checkpoint(resolve_checkpoint(args.mdn_checkpoint), use_ema=True,
                                        device=dev)
        print(f"[serve] MDN scorer {args.mdn_checkpoint}")
    return DockService(params, net_cfg, scfg, mdn_params=mdn_params, mdn_cfg=mdn_cfg,
                       batch_size=args.batch_size, ec_steps=args.ec_steps,
                       pocket_radius=args.pocket_radius, cache_dir=args.cache_dir, device=dev,
                       verbose=verbose)


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = make_service(args)
    if args.warmup:
        t0 = time.time()
        print(f"[serve] warming up on {args.warmup[1]} ...", flush=True)
        service.warmup(args.warmup[0], args.warmup[1])
        print(f"[serve] warm in {time.time() - t0:.0f}s")
    server = DockServer(service, host=args.host, port=args.port)
    print(f"[serve] listening on http://{args.host}:{server.port} ({service.device})")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
