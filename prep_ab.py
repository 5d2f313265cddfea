#!/usr/bin/env python3
"""Host prep with and without the native C++ parser (io/native.py), in
turns in one process (A B B A).

    python3 prep_ab.py [--cpu] [--repeats N]

The jobs are chip_smoke.py's phase-27 table widened to the five complexes of
runs/pb_bench (each protein with its crystal ligand) plus the 16 ligands of
runs/screen_demo/mols on 3dbs's pocket: 21 pairs. A turn is `predict -j
prep -nw 0` of them into a fresh output directory, so no pair comes from a
cache; a first turn warms the process and is not compared. In the `native`
turns prep runs as shipped: io/pdb.parse_pdb reads each receptor with the
C++ parser, chem/protein_feats.select_pocket finds the pocket's residues
with its C++ cell grid. In the `line` turns the C++
parser declines every file (parse_pdb then takes its line parser) and the
pocket hits come from numpy (the squared float32 distances of every pocket
atom to every reference point against the same bound). Both kinds of turn
must write the same cache entries, array for array. Also timed, --repeats
times each: parse_pdb alone on each of the five receptor files, both ways.

Prints the card's nvidia-smi line (the host is the one that serves the
card), one line per turn and per file, and, last, every number as one JSON
object. Imports nothing of JAX.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


def numpy_hits(atom_xyz, atom_res, n_res, ref_xyz, cutoff):
    """pocket_hits_native's function in numpy."""
    d2 = ((atom_xyz[:, None, :] - ref_xyz[None]) ** 2).sum(-1).min(axis=1)
    hits = np.zeros(n_res, dtype=bool)
    np.logical_or.at(hits, atom_res, d2 < cutoff * cutoff)
    return hits


class Line:
    """Within: the prep path without the native library."""

    def __enter__(self):
        from diffbindfr_torch.io import native

        self.native, self.saved = native, (native.parse_pdb_native, native.pocket_hits_native)
        native.parse_pdb_native = lambda path, max_res=20000: None
        native.pocket_hits_native = numpy_hits

    def __exit__(self, *exc):
        self.native.parse_pdb_native, self.native.pocket_hits_native = self.saved


def smi_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def same_cache(a: str, b: str) -> bool:
    """The two prep caches hold the same files with equal arrays and records."""
    import pickle

    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        return False
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                if za.files != zb.files or not all(np.array_equal(za[k], zb[k])
                                                   for k in za.files):
                    return False
        elif f.endswith(".pkl"):
            with open(pa, "rb") as ha, open(pb, "rb") as hb:
                if not same_tree(pickle.load(ha), pickle.load(hb)):
                    return False
    return True


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and same_tree(vars(a), vars(b))
    return a == b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="pass --cpu to predict")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import chip_smoke
    from diffbindfr_torch.app import cli
    from diffbindfr_torch.io import native
    from diffbindfr_torch.io.pdb import parse_pdb

    native.build()
    smi = smi_line()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(prefix="prep_ab_")
    out = {"smi": smi, "turns": [], "parse_ms": {}}
    try:
        jobs = chip_smoke.predict_inputs(os.path.join(tmp, "jobs"), NAMES, copy_cache=False,
                                         screen=True)
        n_pairs = len(NAMES) + len(os.listdir(chip_smoke.SCREEN_MOLS))
        caches = {}
        # turn 0 warms the process (imports, first reads of the files) and is
        # left out of the comparison
        for i, kind in enumerate(("warm", "native", "line", "line", "native")):
            d = os.path.join(tmp, f"turn{i}")
            argv = ["predict", "-j", "prep", "-nw", "0", "-i", jobs, "-o", d]
            argv += ["--cpu"] if args.cpu else []
            t0 = time.perf_counter()
            if kind == "line":
                with Line():
                    rc = cli.main(argv)
            else:
                rc = cli.main(argv)
            sec = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"turn {i} ({kind}): predict exited with {rc}")
            caches.setdefault(kind, os.path.join(d, "prep_cache"))
            if kind == "warm":
                print(f"turn 0 (warm-up, native): {sec:.4f} s", flush=True)
                continue
            out["turns"].append({"kind": kind, "s": sec, "s_per_pair": sec / n_pairs})
            print(f"turn {i} {kind}: {sec:.4f} s for {n_pairs} pairs "
                  f"({sec / n_pairs:.5f} s per pair)", flush=True)
        if not same_cache(caches["native"], caches["line"]):
            raise SystemExit("the native and line turns wrote different cache entries")
        print("native and line turns wrote the same cache entries", flush=True)
        for n in NAMES:
            f = f"{n}_protein_contact_chains.pdb"
            path, row = os.path.join(chip_smoke.PB_BENCH, n, f), {}
            for kind in ("native", "line", "line", "native"):
                t0 = time.perf_counter()
                for _ in range(args.repeats):
                    if kind == "line":
                        with Line():
                            parse_pdb(path)
                    else:
                        parse_pdb(path)
                row.setdefault(kind, []).append(1e3 * (time.perf_counter() - t0) / args.repeats)
            out["parse_ms"][f] = row
            print(f"parse_pdb {f}: native {row['native']} ms, line {row['line']} ms",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
