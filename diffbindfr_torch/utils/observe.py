"""Observability: loggers, timers and the profiler harness of the port
(counterpart of diffbindfr_tpu/utils/observe.py).

  * get_logger     named stream (and file) loggers
  * MetricsLogger  append-only JSONL metrics stream, the JAX package's lines
  * Timer / timed  wall-clock times that wait for the card's queued work
  * trace          torch.profiler around a block (CPU and CUDA activity),
                   written as a Chrome trace (.json) into `logdir`
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time

_LOGGERS: dict = {}


def get_logger(name: str = "diffbindfr", log_file: str | None = None, level=logging.INFO):
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream with simple windowed averaging."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a")
        self._window: dict = {}

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            rec[k] = v
            self._window.setdefault(k, []).append(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def average(self, key: str, last: int = 50) -> float:
        vals = self._window.get(key, [])[-last:]
        return sum(vals) / len(vals) if vals else float("nan")

    def close(self):
        self._fh.close()


def _sync():
    """Wait for the card's queued work (when torch has a card in use), so a
    time includes the work its result came from."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer that waits for the card's work to finish."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self, result=None) -> float:
        if result is not None:
            _sync()
        return time.perf_counter() - self._t0


def timed(fn, *args, warmup: int = 1, iters: int = 3):
    """(min_seconds, result) of fn(*args) over `iters` calls after `warmup`
    calls (first-call costs: kernel builds, allocator), each call timed to
    the end of its work on the card."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args)
        _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best, result


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU activity, and CUDA activity
    when a card is present), exported as a Chrome trace into `logdir`
    (trace_<pid>_<n>.json: chrome://tracing or Perfetto). Yields the
    profiler; the trace's path is its `trace_path` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(prof.trace_path)
