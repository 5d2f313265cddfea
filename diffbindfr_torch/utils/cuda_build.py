"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in `diffbindfr_torch/csrc/*.cu` have a plain C interface and
never include PyTorch's headers, so a build takes seconds. Each source is
compiled to an object by its own nvcc process (all started together), and
the objects are linked into one shared library under `build/torch_kernels/`
in the checkout, named by a hash of the sources and flags: a library is
rebuilt only when a source changes. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libdbfr_kernels.so"

_lock = threading.Lock()
_loaded: dict = {}
build_log: list = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's machine")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build(timeout: float = 600.0) -> str:
    """Compile every source in parallel and link one .so; returns its path."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(prefix="obj.", dir=out_dir)
    try:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs = []
        failed = []
        for src, obj, proc in procs:
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failed.append(src)
            build_log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(sorted(set(failed)))
                               + "\n" + "\n".join(build_log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=timeout)
        build_log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_lib, lib_path)  # atomic: readers never see a partial file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            lib = ctypes.CDLL(build())
            _loaded["lib"] = lib
        return lib
