"""ctypes binding of the port's native prep library (csrc/fastio.cpp, the
port's copy of native/fastio.cpp): the counterpart of
diffbindfr_tpu/io/native.py.

`build()` compiles the source with g++ into the checkout's git-ignored
build/fastio/<source hash>/ at first use (once per source: a later call, in
this process or another, loads what is there), through a temporary file
renamed into place, so processes that build at once do not clash. A failed
build raises with the compiler's message. Nothing here imports torch: the
prep workers use it.

  * parse_pdb_native   atom37 arrays of a PDB file (io/pdb.parse_pdb's
                       fast path), or None where the file holds more
                       residues than max_res or cannot be opened (the line
                       parser then reads it, or raises its IO error)
  * pocket_hits_native per residue, any atom within the cutoff of the
                       reference points (a cell grid; chem/protein_feats)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..constants import residues as rc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "fastio.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "fastio")
FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libfastio.so")


def build() -> str:
    """Compile csrc/fastio.cpp unless its library is built; returns the
    library's path. Raises RuntimeError with the compiler's output when g++
    fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SRC} failed (g++ exit {proc.returncode}):\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def get_lib():
    """The loaded library (built first if need be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            u8p, cp = ctypes.POINTER(ctypes.c_ubyte), ctypes.c_char_p
            lib.fp_parse_pdb.restype = ctypes.c_int
            lib.fp_parse_pdb.argtypes = [cp, cp, ctypes.c_int, f32p, f32p, f32p, i32p, cp, cp,
                                         cp]
            lib.fp_pocket_hits.restype = None
            lib.fp_pocket_hits.argtypes = [f32p, i32p, ctypes.c_int, f32p, ctypes.c_int,
                                           ctypes.c_float, u8p]
            _lib = lib
    return _lib


_A37_NAMES = "".join(f"{n:<4}" for n in rc.atom37_names).encode()


def parse_pdb_native(path: str, max_res: int = 20000):
    """Protein (atom37 arrays parsed in C++) or None (module docstring)."""
    lib = get_lib()
    pos = np.zeros((max_res, 37, 3), np.float32)
    mask = np.zeros((max_res, 37), np.float32)
    bfac = np.zeros((max_res, 37), np.float32)
    resnum = np.zeros(max_res, np.int32)
    chains = ctypes.create_string_buffer(max_res)
    icodes = ctypes.create_string_buffer(max_res)
    resnames = ctypes.create_string_buffer(max_res * 3)
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    n = lib.fp_parse_pdb(path.encode(), _A37_NAMES, max_res, pos.ctypes.data_as(f32p),
                         mask.ctypes.data_as(f32p), bfac.ctypes.data_as(f32p),
                         resnum.ctypes.data_as(i32p), chains, icodes, resnames)
    if n < 0:
        return None
    from .pdb import Protein

    rn = [resnames.raw[3 * i : 3 * i + 3].decode().strip() for i in range(n)]
    ch = [chains.raw[i : i + 1].decode() for i in range(n)]
    ic = [icodes.raw[i : i + 1].decode() or " " for i in range(n)]
    chain_ids: list = []
    chain_idx = np.zeros(n, np.int64)
    for i, c in enumerate(ch):
        if c not in chain_ids:
            chain_ids.append(c)
        chain_idx[i] = chain_ids.index(c)
    aatype = np.array([rc.aatype_from_resname(r) for r in rn], np.int64)
    return Protein(atom_positions=pos[:n], atom_mask=mask[:n], aatype=aatype,
                   residue_index=resnum[:n].astype(np.int64), chain_index=chain_idx,
                   b_factors=bfac[:n], chain_ids=chain_ids, resnames=rn, insertion_codes=ic)


def pocket_hits_native(atom_xyz, atom_res, n_res, ref_xyz, cutoff) -> np.ndarray:
    """[n_res] bool: the residue has an atom within `cutoff` of a reference
    point (squared f32 distance < cutoff^2)."""
    lib = get_lib()
    atom_xyz = np.ascontiguousarray(atom_xyz, np.float32)
    atom_res = np.ascontiguousarray(atom_res, np.int32)
    ref_xyz = np.ascontiguousarray(ref_xyz, np.float32)
    hit = np.zeros(n_res, np.uint8)
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.fp_pocket_hits(atom_xyz.ctypes.data_as(f32p), atom_res.ctypes.data_as(i32p),
                       int(atom_xyz.shape[0]), ref_xyz.ctypes.data_as(f32p), int(ref_xyz.shape[0]),
                       float(cutoff), hit.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return hit.astype(bool)
