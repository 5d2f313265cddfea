"""Streaming training data layer: shuffle-buffer + grouped dynamic batching
over the per-pair npz prep cache.

A copy of diffbindfr_tpu/data/stream.py (plain numpy and the standard
library; the port imports nothing of the JAX package): ``manifest.jsonl``
indexes the cache directory once, `ShuffleStream` draws epoch-shuffled,
host-sharded samples through a bounded shuffle buffer, `GroupedBatcher`
emits a stacked batch whenever a bucket class reaches its token-budget batch
size (bs * 64*512 / (n_lig*n_atm)), and `Prefetcher` decodes and stacks the
next batches on a daemon thread. With the same entries and seed it yields
the JAX package's batches. Batches are numpy; the training loop moves them
to the device (data.sample.to_device).

Note: `build_manifest` writes ``manifest.jsonl`` into the cache directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np

from .sample import Buckets, DockingSample, _load_sample_npz, stack_samples

MANIFEST_NAME = "manifest.jsonl"

# DockingSample 1-D mask fields whose PADDED lengths are the bucket dims —
# the npz arrays are stored padded, so the bucket is recoverable from
# shapes alone without unpickling the .rec.pkl sidecar.
_BUCKET_FIELDS = {
    "n_lig": "lig_mask",
    "n_lig_edges": "lig_e_mask",
    "n_tor": "tor_mask",
    "n_res": "res_mask",
    "n_atm": "atm_mask",
}


@dataclasses.dataclass(frozen=True)
class StreamEntry:
    """One manifest row: enough to schedule a pair without decoding it."""

    name: str
    path: str
    bucket: Buckets


def _bucket_from_npz(path: str) -> Buckets:
    """Recover the Buckets class from the padded array shapes (lazy zip
    member reads — only the five small mask vectors are decompressed)."""
    with np.load(path) as data:
        dims = {k: int(data[f].shape[0]) for k, f in _BUCKET_FIELDS.items()}
    return Buckets(**dims)


def load_sample(path: str) -> DockingSample:
    return _load_sample_npz(path)


def build_manifest(cache_dir: str, refresh: bool = False) -> list[StreamEntry]:
    """Index every per-pair sample npz under `cache_dir` into
    ``manifest.jsonl`` (incremental: known rows are kept, new npz files are
    inspected and appended; `refresh` rebuilds from scratch). Returns the
    entries sorted by name so the per-epoch permutation is reproducible
    across processes that share a seed."""
    mpath = os.path.join(cache_dir, MANIFEST_NAME)
    known: dict[str, StreamEntry] = {}
    if not refresh and os.path.exists(mpath):
        with open(mpath) as fh:
            for line in fh:
                row = json.loads(line)
                path = os.path.join(cache_dir, row["file"])
                if not os.path.exists(path):
                    continue  # npz deleted since last index: drop the row
                known[row["file"]] = StreamEntry(
                    name=row["name"],
                    path=path,
                    bucket=Buckets(**row["bucket"]),
                )
    new_rows = []
    for fn in sorted(os.listdir(cache_dir)):
        if not fn.endswith(".npz") or ".tmp" in fn or fn in known:
            continue
        path = os.path.join(cache_dir, fn)
        try:
            bucket = _bucket_from_npz(path)
        except Exception:
            continue  # partial write / foreign npz: skip, don't poison
        entry = StreamEntry(name=fn[: -len(".npz")], path=path, bucket=bucket)
        known[fn] = entry
        new_rows.append((fn, entry))
    if new_rows or refresh:
        tmp = mpath + f".{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            for fn, e in sorted(known.items()):
                fh.write(json.dumps({
                    "file": fn, "name": e.name,
                    "bucket": dataclasses.asdict(e.bucket),
                }) + "\n")
        os.replace(tmp, mpath)
    return [known[fn] for fn in sorted(known)]


class ShuffleStream:
    """Infinite epoch-shuffled, host-sharded, shuffle-buffered sample stream.

    Per epoch e: permutation(seed + e) over ALL entries, then this host
    takes ``perm[host_id::num_hosts]`` (shard-after-shuffle, the
    DistributedSampler contract: disjoint per-host subsets that change
    every epoch). Decoded samples fill a capacity-K buffer; `draw` pops a
    uniform element and refills from the stream, so at most K decoded
    samples are resident.
    """

    def __init__(
        self,
        entries: list[StreamEntry],
        buffer_size: int = 256,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        loader: Callable[[str], DockingSample] = load_sample,
    ):
        if not entries:
            raise ValueError("empty manifest")
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.entries = entries
        self.buffer_size = max(1, min(buffer_size, len(entries)))
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._loader = loader
        self._rng = np.random.default_rng(seed + 104729 * (host_id + 1))
        self._paths = self._path_iter()
        self._buf: list[tuple[StreamEntry, DockingSample]] = []
        self.epoch = 0
        self.samples_drawn = 0

    def _path_iter(self) -> Iterator[StreamEntry]:
        epoch = 0
        n = len(self.entries)
        while True:
            self.epoch = epoch
            order = np.random.default_rng(self.seed + epoch).permutation(n)
            for i in order[self.host_id :: self.num_hosts]:
                yield self.entries[int(i)]
            epoch += 1

    def _fill(self):
        while len(self._buf) < self.buffer_size:
            e = next(self._paths)
            self._buf.append((e, self._loader(e.path)))

    def draw(self) -> tuple[StreamEntry, DockingSample]:
        self._fill()
        i = int(self._rng.integers(len(self._buf)))
        item = self._buf[i]
        self._buf[i] = self._buf[-1]
        self._buf.pop()
        self.samples_drawn += 1
        return item

    def resident_samples(self) -> int:
        return len(self._buf)


def bucket_batch_size(bucket: Buckets, base_bs: int,
                      base_area: int = 64 * 512) -> int:
    """Constant-token-budget batch size (the train_cli rule): the pair work
    of a step scales with n_lig*n_atm, so larger buckets get proportionally
    smaller batches."""
    return max(1, (base_bs * base_area) // max(bucket.n_lig * bucket.n_atm, 1))


class GroupedBatcher:
    """Route streamed samples into their bucket class and emit a stacked
    fixed-shape batch whenever a class fills to its token-budget size.

    Resident memory is bounded by ``stream.buffer_size`` + at most
    (bs_bucket - 1) pending samples per bucket class. Iterating yields
    ``(Buckets, DockingSample-batch, names)`` forever; the train loop
    stops at its step target.
    """

    def __init__(self, stream: ShuffleStream, base_bs: int = 8,
                 base_area: int = 64 * 512):
        self.stream = stream
        self.base_bs = base_bs
        self.base_area = base_area
        self._pending: dict[Buckets, list] = {}
        # per-bucket emission stats (batches, samples) for the train log
        self.stats: dict[Buckets, dict] = {}

    def batch_size(self, bucket: Buckets) -> int:
        return bucket_batch_size(bucket, self.base_bs, self.base_area)

    def pending_samples(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def __iter__(self):
        while True:
            yield self.next_batch()

    def next_batch(self):
        while True:
            entry, sample = self.stream.draw()
            group = self._pending.setdefault(entry.bucket, [])
            group.append((entry.name, sample))
            bs = self.batch_size(entry.bucket)
            if len(group) >= bs:
                names = [n for n, _ in group]
                batch = stack_samples([s for _, s in group])
                group.clear()
                st = self.stats.setdefault(
                    entry.bucket, {"batches": 0, "samples": 0, "bs": bs})
                st["batches"] += 1
                st["samples"] += len(names)
                return entry.bucket, batch, names

    def format_stats(self) -> str:
        parts = []
        for b, st in sorted(self.stats.items(),
                            key=lambda kv: kv[0].n_lig * kv[0].n_atm):
            parts.append(
                f"{b.n_lig}/{b.n_atm}:bs{st['bs']}x{st['batches']}"
            )
        return " ".join(parts) if parts else "-"


class Prefetcher:
    """Decode-and-stack next batches on a daemon thread into a bounded
    queue so disk IO + numpy stacking overlap the device step (the
    reference's DataLoader worker role)."""

    _SENTINEL = object()

    def __init__(self, batcher: GroupedBatcher, depth: int = 2):
        self.batcher = batcher
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                item = self.batcher.next_batch()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e
            try:
                self._q.put(self._SENTINEL, timeout=0.1)
            except queue.Full:
                pass

    def next_batch(self):
        item = self._q.get()
        if item is self._SENTINEL or self._exc is not None:
            raise RuntimeError("prefetch thread failed") from self._exc
        return item

    def close(self):
        self._stop.set()
        try:  # unblock a waiting producer
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
