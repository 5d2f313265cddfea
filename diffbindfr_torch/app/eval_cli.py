"""Benchmark evaluation command of the port: `python -m
diffbindfr_torch.app.eval_cli ...`, the counterpart of
diffbindfr_tpu/app/eval_cli.py with the same flags, defaults and files.

Dataset job makers (PDBbind time-split, PoseBusters, CrossDock layouts)
drive the redocking protocol: prep -> dock (-np poses) -> error correction
-> (`--cart-relax`: Cartesian fine-relax) -> `poses.npz` -> MDN scoring ->
structure export with the redock metrics (symmetric L-RMSD, centroid, chi1,
sc-RMSD against the crystal complex) -> `metrics_report.txt`
(app/reporter.py) -> `validity.csv` (app/validity.py, the PoseBusters-style
suite). With `--cart-relax` the poses before the relax are graded too:
`validity_prerelax.csv`, and `relax_ab.json` with the validity pass share
and the oracle (best-pose) L-RMSD per complex before and after.

Dataset layouts:
  * pdbbind_ts:  <root>/timesplit_test (one pdbid per line) +
                 <root>/<pdbid>/{<pdbid>_ligand.sdf, <pdbid>_fix.pdb}
  * pb:          <root>/<id>/{<id>_ligand.sdf, <id>_protein.pdb}; chains
                 within 10 A of the ligand are extracted to
                 <id>_protein_contact_chains.pdb (into the dataset directory
                 when it is writable, else into <outdir>/contact_chains)
  * crossdock-*: <root>/<lib>/<cid>/{ligand.sdf, protein.pdb}

In every layout the ligand file doubles as the crystal reference pose.

The dock, error correction, relax and MDN run on the card unless `--cpu` is given
(then on the CPU, through the kernels' plain versions); prep, the report
and validity are host numpy. `-nc N` embeds N start conformers per ligand
at prep (on the same device); `--conv-mode fc` docks with the
reference-exact tensor product on the plain path (as app/cli.py predict).

    python -m diffbindfr_torch.app.eval_cli --lib pb -d DATA -o OUT -ckt CKPT -mdn MDN
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

from ..io.pdb import parse_pdb
from ..io.sdf import parse_sdf
from .cli import dock_path
from .jobs import Job

# ---------------------------------------------------------------------------
# dataset job makers
# ---------------------------------------------------------------------------


def _job(protein, name, ligand, crystal):
    return Job(protein=protein, protein_name=name, ligand=ligand, ligand_name=name,
               complex_name=name, crystal_ligand=crystal)


def make_jobs_tstest(data_root: str, test_file_name: str = "timesplit_test"):
    """PDBbind v2020 time-split test layout."""
    listing = os.path.join(data_root, test_file_name)
    if not os.path.exists(listing):
        raise FileNotFoundError(listing)
    jobs = []
    with open(listing) as fh:
        for line in fh:
            pdbid = line.strip()
            if not pdbid:
                continue
            lig = os.path.join(data_root, pdbid, f"{pdbid}_ligand.sdf")
            prot = os.path.join(data_root, pdbid, f"{pdbid}_fix.pdb")
            jobs.append(_job(prot, pdbid, lig, lig))
    return jobs


def extract_contact_chains(protein_file: str, ligand_file: str, out_file: str,
                           cutoff: float = 10.0) -> str:
    """Write a PDB keeping only chains with any atom within `cutoff` of the
    ligand. Line-level filtering preserves the original records."""
    lig = parse_sdf(ligand_file)[0]
    ligpos = np.asarray(lig.coords, np.float64)
    prot = parse_pdb(protein_file)
    pos = prot.atom_positions[prot.atom_mask > 0]
    # chain of each existing atom
    ridx, _ = np.nonzero(prot.atom_mask)
    d2 = ((pos[:, None, :] - ligpos[None, :, :]) ** 2).sum(-1)
    near = d2.min(axis=1) <= cutoff * cutoff
    keep = {prot.chain_ids[prot.chain_index[r]] for r in ridx[near]}
    with open(protein_file) as fh, open(out_file, "w") as out:
        for line in fh:
            if line[:6] in ("ATOM  ", "HETATM", "TER   ", "ANISOU") or line.startswith("TER"):
                if len(line) > 21 and line[21] not in keep:
                    continue
            out.write(line)
    return out_file


def make_jobs_pbtest(data_root: str, cache_dir: str | None = None):
    """PoseBusters benchmark layout."""
    if not os.path.isdir(data_root):
        raise FileNotFoundError(data_root)
    jobs = []
    for pb_id in sorted(os.listdir(data_root)):
        d = os.path.join(data_root, pb_id)
        if not os.path.isdir(d):
            continue
        lig = os.path.join(d, f"{pb_id}_ligand.sdf")
        prot = os.path.join(d, f"{pb_id}_protein.pdb")
        cc = os.path.join(d, f"{pb_id}_protein_contact_chains.pdb")
        if not os.path.exists(cc):
            target = cc
            if not os.access(d, os.W_OK):
                # dataset dir read-only: cache the extraction elsewhere
                target = os.path.join(cache_dir or ".", f"{pb_id}_protein_contact_chains.pdb")
                os.makedirs(os.path.dirname(target), exist_ok=True)
            if not os.path.exists(target):
                extract_contact_chains(prot, lig, target)
            cc = target
        jobs.append(_job(cc, pb_id, lig, lig))
    return jobs


def make_jobs_cdtest(data_root: str, lib: str):
    """CrossDock subset layout."""
    root = os.path.join(data_root, lib)
    if not os.path.isdir(root):
        raise FileNotFoundError(root)
    jobs = []
    for cid in sorted(os.listdir(root)):
        d = os.path.join(root, cid)
        if not os.path.isdir(d):
            continue
        lig = os.path.join(d, "ligand.sdf")
        jobs.append(_job(os.path.join(d, "protein.pdb"), cid, lig, lig))
    return jobs


def make_jobs(lib: str, data_dir: str, cache_dir: str | None = None):
    if lib == "pdbbind_ts":
        return make_jobs_tstest(data_dir)
    if lib == "pb":
        return make_jobs_pbtest(data_dir, cache_dir=cache_dir)
    return make_jobs_cdtest(data_dir, lib)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def build_parser():
    ap = argparse.ArgumentParser(
        prog="diffbindfr_torch-eval",
        description="benchmark evaluation (PDBbind-TS / PoseBusters / CrossDock), PyTorch/CUDA "
                    "port")
    ap.add_argument("--lib", default="pb", help="pdbbind_ts | pb | <crossdock subset name>")
    ap.add_argument("-d", "--data-dir", required=True)
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("-ckt", "--checkpoint", required=True)
    ap.add_argument("-mdn", "--mdn-checkpoint")
    ap.add_argument("-np", "--num-poses", type=int, default=40)
    ap.add_argument("-bs", "--batch-size", type=int, default=16)
    ap.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    ap.add_argument("-st", "--steps", type=int, default=20)
    ap.add_argument("-nw", "--num-workers", type=int, default=0)
    ap.add_argument("-nc", "--num-conformers", type=int, default=0,
                    help="DG-embedded starting conformers per ligand (0 = the input conformer)")
    ap.add_argument("-s", "--start", type=int, default=0)
    ap.add_argument("-e", "--end", type=int, default=None)
    ap.add_argument("-int", "--interval", type=int, default=1)
    ap.add_argument("-sd", "--seed", type=int, default=0)
    ap.add_argument("-no_ec", "--no-ec", action="store_true")
    ap.add_argument("-no_score", "--no-score", action="store_true")
    ap.add_argument("--ec-steps", type=int, default=150)
    ap.add_argument("--cart-relax", action="store_true",
                    help="all-atom Cartesian fine-relax after EC (ops/cartesian.py); also writes "
                         "validity_prerelax.csv and relax_ab.json")
    ap.add_argument("--cart-steps", type=int, default=300)
    ap.add_argument("--no-validity", action="store_true",
                    help="skip PoseBusters-style pose validity checks")
    ap.add_argument("--cluster-rank", type=float, default=0.0,
                    help="write results_cluster_top1.csv: single-linkage pose clustering at "
                         "this RMSD cutoff (A), clusters ranked by mdn_nll; 0 = off")
    ap.add_argument("--cluster-mode", choices=["best", "mean", "size"], default="mean")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted and ignored: the device picks the path (the card runs the "
                         "hand-written CUDA kernels, --cpu their plain versions)")
    ap.add_argument("--conv-mode", choices=["sep", "fc"], default="sep",
                    help="'fc': the reference-exact tensor product of converted reference "
                         "checkpoints (plain PyTorch, no kernels)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    ap.add_argument("--ns", type=int, default=48)
    ap.add_argument("--nv", type=int, default=12)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def validity_rows(prepared: list, results: list, poses: list | None = None) -> list:
    """The validity suite on every pose, judged against the pose's own
    receptor (its atom14_pos, the structure the exporter writes); `poses`
    [(lig_pos, atom14_pos)] in the results' order replaces their own."""
    from . import validity as V

    if poses is None:
        poses = [(r.lig_pos, r.atom14_pos) for r in results]
    rows = []
    for r, (lp, a14) in zip(results, poses):
        pr = prepared[r.pair_idx]
        checks = V.check_pose(pr.lig, pr.pocket, lp, atom14_pos=a14)
        rows.append({"complex_name": pr.name, "pose": r.pose_idx,
                     **{k: int(bool(v)) for k, v in checks.items()}})
    return rows


def relax_ab(prepared: list, results: list, pre: list, frac_pre: float,
             frac_post: float) -> dict:
    """relax_ab.json's content: the validity pass share before and after the
    relax, and per complex with a crystal pose the oracle (lowest) L-RMSD
    over its poses before (`pre`, [(lig_pos, atom14_pos)]) and after, with
    their means."""
    from .export import pose_metrics

    oracle: dict = {}
    for r, (lp, a14) in zip(results, pre):
        pr = prepared[r.pair_idx]
        if pr.crystal_pos is None:
            continue
        m_pre = pose_metrics(pr.lig, pr.pocket, lp, a14, crystal_lig_pos=pr.crystal_pos)
        m_post = pose_metrics(pr.lig, pr.pocket, r.lig_pos, r.atom14_pos,
                              crystal_lig_pos=pr.crystal_pos)
        o = oracle.setdefault(pr.name, {"pre": 1e30, "post": 1e30})
        o["pre"] = min(o["pre"], m_pre.l_rmsd)
        o["post"] = min(o["post"], m_post.l_rmsd)
    ab = {
        "validity_pass_pre": round(frac_pre, 4),
        "validity_pass_post": round(frac_post, 4),
        "oracle_l_rmsd_pre": {k: round(v["pre"], 3) for k, v in oracle.items()},
        "oracle_l_rmsd_post": {k: round(v["post"], 3) for k, v in oracle.items()},
    }
    if oracle:
        ab["oracle_mean_pre"] = round(sum(v["pre"] for v in oracle.values()) / len(oracle), 3)
        ab["oracle_mean_post"] = round(sum(v["post"] for v in oracle.values()) / len(oracle), 3)
    return ab


def write_validity(outdir: str, vrows: list, name: str = "validity.csv") -> float:
    """Write <outdir>/<name>; returns the share of poses passing all."""
    vpath = os.path.join(outdir, name)
    with open(vpath, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(vrows[0]))
        w.writeheader()
        w.writerows(vrows)
    frac = sum(v["pass"] for v in vrows) / len(vrows)
    print(f"[validity] {frac:.1%} of poses pass all checks -> {vpath}")
    return frac


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from .. import sampler as sp
    from ..models import mdn_scorer as mdn
    from ..models import score_net as sn
    from ..utils.checkpoint import load_checkpoint, resolve_checkpoint
    from ..utils.device import resolve_device
    from . import jobs as J
    from . import pipeline as P
    from . import reporter as R

    dev = resolve_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.outdir, exist_ok=True)
    jobs = make_jobs(args.lib, args.data_dir,
                     cache_dir=os.path.join(args.outdir, "contact_chains"))
    jobs = J.job_slice(jobs, args.start, args.end, args.interval)
    print(f"[eval] {args.lib}: {len(jobs)} complexes on {dev}")

    prepared, failures = P.prep(jobs, pocket_radius=args.pocket_radius,
                                cache_dir=os.path.join(args.outdir, "prep_cache"),
                                num_workers=args.num_workers,
                                n_conformers=args.num_conformers, device=dev)
    P.write_failures(args.outdir, failures)
    if not prepared:
        sys.exit("no pairs prepared")

    net_cfg = sn.ScoreNetConfig(ns=args.ns, nv=args.nv, num_conv_layers=args.layers,
                                conv_mode=args.conv_mode, compute_dtype=args.dtype)
    scfg = sp.SamplerConfig(inference_steps=args.steps + 2, actual_steps=args.steps)
    ckpt_path = resolve_checkpoint(args.checkpoint)
    params, step = load_checkpoint(ckpt_path, use_ema=True, device=dev)
    print(f"[model] loaded {ckpt_path} (step {step})")

    results = P.dock(prepared, params, net_cfg, scfg, num_poses=args.num_poses,
                     batch_size=args.batch_size, seed=args.seed, device=dev,
                     use_kernels=dock_path(net_cfg))
    if not args.no_ec:
        P.error_correct(prepared, results, steps=args.ec_steps, batch_size=args.batch_size,
                        device=dev)
    pre = None
    if args.cart_relax:
        pre = [(r.lig_pos.copy(), r.atom14_pos.copy()) for r in results]
        P.cartesian_relax(prepared, results, steps=args.cart_steps, batch_size=args.batch_size,
                          device=dev)
    # final pose geometry persisted so scorers can be re-run on these exact
    # poses without re-docking (app/rescore_cli.py)
    P.save_poses(args.outdir, prepared, results)

    if not args.no_score:
        mdn_cfg = mdn.MDNConfig()
        if args.mdn_checkpoint:
            mdn_params, _ = load_checkpoint(resolve_checkpoint(args.mdn_checkpoint),
                                            use_ema=True, device=dev)
        else:
            print("[score] WARNING: random MDN weights (ranking untrained)")
            mdn_params = mdn.init_params(torch.Generator().manual_seed(1), mdn_cfg, device=dev)
        P.score_mdn(prepared, results, mdn_params, mdn_cfg, batch_size=args.batch_size,
                    device=dev)

    res_csv = P.export_and_rank(prepared, results, args.outdir, cluster_rank=args.cluster_rank,
                                cluster_mode=args.cluster_mode)

    report = R.format_report(R.load_results(res_csv))
    with open(os.path.join(args.outdir, "metrics_report.txt"), "w") as fh:
        fh.write(report)
    print(report)

    if not args.no_validity:
        frac_post = write_validity(args.outdir, validity_rows(prepared, results))
        if pre is not None:
            frac_pre = write_validity(args.outdir, validity_rows(prepared, results, pre),
                                      "validity_prerelax.csv")
            ab = relax_ab(prepared, results, pre, frac_pre, frac_post)
            abpath = os.path.join(args.outdir, "relax_ab.json")
            with open(abpath, "w") as fh:
                json.dump(ab, fh, indent=1)
            print(f"[relax A/B] validity {frac_pre:.1%} -> {frac_post:.1%}"
                  + (f", oracle L-RMSD {ab['oracle_mean_pre']} -> {ab['oracle_mean_post']} A"
                     if "oracle_mean_pre" in ab else "") + f" -> {abpath}")
    print(f"[eval] done: {res_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
