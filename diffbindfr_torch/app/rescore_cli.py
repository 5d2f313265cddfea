"""Standalone pose scoring of the port: `python -m
diffbindfr_torch.app.rescore_cli ...`, the counterpart of
diffbindfr_tpu/app/rescore_cli.py with the same flags and files.

Given poses from any source, attach MDN scores and NLL and re-rank them
without running the sampler again. Two input modes:

* ``--poses <eval-outdir>`` (fast path): reuse a previous eval/predict
  run's `prep_cache/` + `poses.npz` (written by eval_cli, or predict
  --save-poses). Needs the same dataset args so the job list (and hence the
  prep cache keys) comes out the same.
* ``-i results.csv`` (generic path): parse the exported pose structures
  (lig_final.sdf + prot_final.pdb per row) and score them standalone, so
  poses docked by any program can be ranked by the MDN.

Writes `results.csv` (+ the top-1 tables) and `metrics_report.txt` into
`-o OUTDIR`, never touching the source run's files. The MDN runs on the
card unless `--cpu` is given; parsing and prep are host numpy.

    python -m diffbindfr_torch.app.rescore_cli --poses EVAL_OUT --lib pb -d DATA -mdn MDN -o OUT
    python -m diffbindfr_torch.app.rescore_cli -i results.csv -mdn MDN -o OUT
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(
        prog="diffbindfr_torch-rescore",
        description="score/re-rank existing poses with an MDN checkpoint (PyTorch/CUDA port)")
    ap.add_argument("-mdn", "--mdn-checkpoint", required=True)
    ap.add_argument("-o", "--outdir", required=True, help="output dir for the rescored tables")
    # fast path (saved pose arrays from a previous run)
    ap.add_argument("--poses",
                    help="previous eval/predict outdir holding poses.npz + prep_cache (fast "
                         "path; needs the dataset args below to rebuild the same job list)")
    ap.add_argument("--lib", default="pb",
                    help="pdbbind_ts | pb | <crossdock subset> (with --poses)")
    ap.add_argument("-d", "--data-dir", help="dataset root (with --poses)")
    ap.add_argument("-s", "--start", type=int, default=0)
    ap.add_argument("-e", "--end", type=int, default=None)
    ap.add_argument("-int", "--interval", type=int, default=1)
    # generic path (exported structures)
    ap.add_argument("-i", "--results-csv",
                    help="results.csv with lig_sdf/prot_pdb columns (generic path; poses from "
                         "any program)")
    ap.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    ap.add_argument("--score-bs", type=int, default=32)
    ap.add_argument("--cluster-rank", type=float, default=0.0,
                    help="also write results_cluster_top1.csv: single-linkage pose clustering "
                         "at this cutoff (A) over symmetric pose RMSDs, cluster "
                         "representatives ranked by --cluster-mode over mdn_nll (as eval_cli "
                         "--cluster-rank)")
    ap.add_argument("--cluster-mode", default="mean", choices=["best", "mean", "size"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the MDN on the CPU")
    return ap


def _pairs_from_csv(csv_path: str, pocket_radius: float):
    """Generic path: rebuild (PreparedPair, PoseResult) lists from exported
    structures. Ligand topology and features come from the first pose's
    SDF; the pocket is defined once per complex from that pose (the same
    residues for every pose, so the fixed-shape batch is well formed); each
    pose contributes its own ligand coordinates and its own receptor atom14
    coordinates at those pocket residues."""
    from ..chem.ligand_feats import featurize_ligand
    from ..chem.mol import perceive
    from ..chem.protein_feats import atom37_to_atom14, build_pocket_record
    from ..data.sample import choose_bucket, make_sample
    from ..io.pdb import parse_pdb
    from ..io.sdf import parse_ligand_file
    from .jobs import Job
    from .pipeline import PoseResult, PreparedPair

    with open(csv_path, newline="") as fh:
        rows = [r for r in csv.DictReader(fh) if r.get("lig_sdf") and r.get("prot_pdb")]
    if not rows:
        sys.exit(f"no rows with structure files in {csv_path}")
    by_complex: dict = {}
    for r in rows:
        by_complex.setdefault(r["complex_name"], []).append(r)

    prepared, results, prot_cache = [], [], {}
    for name, crows in by_complex.items():
        first = crows[0]
        raw = parse_ligand_file(first["lig_sdf"])[0]
        lig = featurize_ligand(perceive(raw), name)
        if first["prot_pdb"] not in prot_cache:
            prot_cache[first["prot_pdb"]] = parse_pdb(first["prot_pdb"])
        prot = prot_cache[first["prot_pdb"]]
        # poses from arbitrary sources can sit away from the receptor
        # surface; grow the cutoff until the selection is non-empty so the
        # scoring surface never hard-fails on a bad pose
        cutoff = pocket_radius
        while True:
            try:
                pocket = build_pocket_record(prot, lig.pos, cutoff=cutoff)
                break
            except ValueError:
                if cutoff > 64.0:
                    raise
                cutoff *= 1.5
        if cutoff != pocket_radius:
            print(f"[rescore] WARNING: {name}: pocket cutoff grown to {cutoff:.1f} A "
                  "(pose far from receptor)")
        lig = dataclasses.replace(lig)
        lig.pos = lig.pos - pocket.center
        sample = make_sample(lig, pocket)
        bucket = choose_bucket(lig.num_atoms, lig.edge_index.shape[1], lig.num_torsions,
                               pocket.num_res, int(pocket.atom14_mask.sum()))
        pair = PreparedPair(
            name=name, bucket=bucket, lig=lig, pocket=pocket,
            job=Job(protein=first["prot_pdb"], protein_name=name, ligand=first["lig_sdf"],
                    ligand_name=name, complex_name=name),
            _sample=sample)
        pi = len(prepared)
        prepared.append(pair)
        na, nr = lig.num_atoms, pocket.num_res
        for r in crows:
            pose_raw = parse_ligand_file(r["lig_sdf"])[0]
            lp = np.zeros((bucket.n_lig, 3), np.float32)
            lp[:na] = pose_raw.coords - pocket.center
            if r["prot_pdb"] not in prot_cache:
                prot_cache[r["prot_pdb"]] = parse_pdb(r["prot_pdb"])
            p14, _ = atom37_to_atom14(prot_cache[r["prot_pdb"]])
            a14 = np.zeros((bucket.n_res, 14, 3), np.float32)
            a14[:nr] = (p14[pocket.pocket_res_indices]
                        - pocket.center[None, None, :]) * pocket.atom14_mask[..., None]
            vina = r.get("vina_score")
            results.append(PoseResult(
                pair_idx=pi, pose_idx=int(r["pose"]) if r.get("pose") else len(results),
                lig_pos=lp, atom14_pos=a14, chi=np.zeros(0, np.float32),
                vina_score=float(vina) if vina else None))
    return prepared, results


def _pairs_from_poses(args, P):
    """Fast path: the job list of the dataset args, served from the source
    run's prep cache, and its poses.npz."""
    from . import jobs as J
    from .eval_cli import make_jobs

    jobs = make_jobs(args.lib, args.data_dir,
                     cache_dir=os.path.join(args.poses, "contact_chains"))
    jobs = J.job_slice(jobs, args.start, args.end, args.interval)
    prepared, failures = P.prep(jobs, pocket_radius=args.pocket_radius,
                                cache_dir=os.path.join(args.poses, "prep_cache"))
    if failures:
        print(f"[rescore] WARNING: {len(failures)} pairs failed prep")
    return prepared, P.load_poses(os.path.join(args.poses, "poses.npz"), prepared)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if bool(args.poses) == bool(args.results_csv):
        sys.exit("need exactly one of --poses <outdir> or -i results.csv")
    if args.poses and not args.data_dir:
        sys.exit("--poses needs -d/--data-dir (to rebuild the job list)")

    from ..models import mdn_scorer as mdn
    from ..utils.checkpoint import load_checkpoint, resolve_checkpoint
    from ..utils.device import resolve_device
    from . import pipeline as P
    from . import reporter as R

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.poses:
        prepared, results = _pairs_from_poses(args, P)
    else:
        prepared, results = _pairs_from_csv(args.results_csv, args.pocket_radius)
    print(f"[rescore] {len(results)} poses over {len(prepared)} complexes on {dev}")

    mdn_params, step = load_checkpoint(resolve_checkpoint(args.mdn_checkpoint), use_ema=True,
                                       device=dev)
    print(f"[rescore] MDN checkpoint step {step}")
    P.score_mdn(prepared, results, mdn_params, mdn.MDNConfig(), batch_size=args.score_bs,
                device=dev)

    os.makedirs(args.outdir, exist_ok=True)
    res_csv = P.export_and_rank(prepared, results, args.outdir, export_structures=False,
                                cluster_rank=args.cluster_rank, cluster_mode=args.cluster_mode)
    report = R.format_report(R.load_results(res_csv))
    with open(os.path.join(args.outdir, "metrics_report.txt"), "w") as fh:
        fh.write(report)
    print(report)
    print(f"[rescore] done: {res_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
