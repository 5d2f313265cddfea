"""Command-line entry point of the port: `python -m diffbindfr_torch.app.cli
predict ...`, the counterpart of diffbindfr_tpu/app/cli.py's `predict`.

Same flag names and defaults. Jobs come from a CSV (-i) or receptor/ligand
lists (-p / -l); their pairs are read from `<outdir>/prep_cache`, where the
JAX package's `predict` writes them (`<complex>_r<radius>.npz` + `.rec.pkl`).
Then dock -> error correction -> MDN scoring -> export and rank.

The device picks the path (as app/train_cli.py): the card by default, where
the score net's trunk runs the hand-written CUDA kernels; `--cpu` runs their
plain PyTorch versions on the CPU. Flags of stages the port does not have
yet exit with an error naming their ROADMAP item; none falls back silently.

    python -m diffbindfr_torch.app.cli predict -i jobs.csv -o OUT -ckt CKPT -mdn MDN
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# flags of stages not ported yet: (flag, is set, ROADMAP item and what it ports)
_NOT_PORTED = (
    ("-j prep", lambda a: a.job == "prep", "A9b (host prep from raw files)"),
    ("-nw > 0", lambda a: a.num_workers > 0, "A9b (host prep from raw files)"),
    ("-nc > 0", lambda a: a.num_conformers > 0, "A14 (chem/embed.py conformers)"),
    ("--cart-relax", lambda a: a.cart_relax, "A10 (ops/cartesian.py relax)"),
    ("--conv-mode fc", lambda a: a.conv_mode == "fc", "A3 (the 'fc' tensor product)"),
)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="diffbindfr_torch",
        description="flexible protein-ligand diffusion docking (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="end-to-end docking from a prep cache")
    p.add_argument("-i", "--input-csv", help="job table csv")
    p.add_argument("-l", "--ligands", nargs="+", help="ligand files/dirs")
    p.add_argument("-p", "--receptors", nargs="+", help="receptor files/dirs")
    p.add_argument("-o", "--outdir", required=True,
                   help="output dir; pairs are read from <outdir>/prep_cache")
    p.add_argument("-np", "--num-poses", type=int, default=40)
    p.add_argument("-bs", "--batch-size", type=int, default=16)
    p.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    p.add_argument("-j", "--job", choices=["prep", "dock"], default="dock",
                   help="'prep' waits for ROADMAP A9b")
    p.add_argument("-ckt", "--checkpoint", help="diffusion model checkpoint (.npz)")
    p.add_argument("-mdn", "--mdn-checkpoint", help="MDN scorer checkpoint (.npz)")
    p.add_argument("-sd", "--seed", type=int, default=0)
    p.add_argument("-nw", "--num-workers", type=int, default=0,
                   help="parallel featurization workers (> 0 waits for ROADMAP A9b)")
    p.add_argument("-nc", "--num-conformers", type=int, default=0,
                   help="DG-embedded starting conformers (> 0 waits for ROADMAP A14)")
    p.add_argument("-s", "--start", type=int, default=0, help="job slice start")
    p.add_argument("-e", "--end", type=int, default=None, help="job slice end")
    p.add_argument("-int", "--interval", type=int, default=1)
    p.add_argument("-es", "--export-pocket", action="store_true")
    p.add_argument("-et", "--export-top", type=int, default=-1,
                   help="write structure files only for the K best poses per complex "
                        "(mdn rank, else vina); other rows keep scores/metrics in "
                        "results.csv with empty file columns. -1 = all (default)")
    p.add_argument("-no_score", "--no-score", action="store_true", help="skip MDN scoring")
    p.add_argument("--save-poses", action="store_true",
                   help="persist final pose arrays to <outdir>/poses.npz")
    p.add_argument("-no_ec", "--no-ec", action="store_true",
                   help="skip vina-style pose re-minimization")
    p.add_argument("--ec-steps", type=int, default=150)
    p.add_argument("--cart-relax", action="store_true",
                   help="all-atom Cartesian fine-relax after EC (waits for ROADMAP A10)")
    p.add_argument("--ec-bs", type=int, default=0,
                   help="EC minimization batch size (0 = same as -bs)")
    p.add_argument("--score-bs", type=int, default=0,
                   help="MDN scoring batch size (0 = same as -bs)")
    p.add_argument("-st", "--steps", type=int, default=20, help="actual diffusion steps")
    p.add_argument("--cluster-rank", type=float, default=0.0,
                   help="cluster poses (symmetric-RMSD single linkage at this cutoff, A) "
                        "and write results_cluster_top1.csv ranking cluster "
                        "representatives by mdn_nll; 0 = off")
    p.add_argument("--cluster-mode", choices=["best", "mean", "size"], default="mean")
    p.add_argument("--expand-sdf", action="store_true",
                   help="expand multi-molecule ligand SDFs into one job per record "
                        "(path#<i> addressing)")
    p.add_argument("-traj", "--trajectory", action="store_true",
                   help="export per-step denoising trajectories")
    p.add_argument("--pallas", action="store_true",
                   help="accepted and ignored: the device picks the path (the card runs "
                        "the hand-written CUDA kernels, --cpu their plain versions)")
    p.add_argument("--conv-mode", choices=["sep", "fc"], default="sep",
                   help="'fc' waits for ROADMAP A3")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("-cfg", "--config", help="python config file (utils/config.py: _base_ "
                   "inheritance, ${var} interpolation)")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="dotted overrides, e.g. score_net.ns=96 sampler.kind=ode")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return ap


def _config(cls, kw: dict, what: str):
    """cls(**kw), refusing keys the port's config does not have."""
    names = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(kw) - names)
    if bad:
        sys.exit(f"{what} options not in the port's {cls.__name__}: {', '.join(bad)}")
    return cls(**kw)


def cmd_predict(args):
    for flag, is_set, item in _NOT_PORTED:
        if is_set(args):
            sys.exit(f"{flag}: not ported yet (ROADMAP {item})")

    import torch

    from .. import sampler as sp
    from ..models import mdn_scorer as mdn
    from ..models import score_net as sn
    from ..utils.checkpoint import load_checkpoint, resolve_checkpoint
    from ..utils.device import resolve_device
    from . import jobs as J
    from . import pipeline as P

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.input_csv:
        jobs = J.load_jobs_csv(args.input_csv)
    elif args.ligands and args.receptors:
        jobs = J.make_jobs(args.ligands, args.receptors)
    else:
        sys.exit("need -i CSV or both -l and -p")
    if args.expand_sdf:
        n0 = len(jobs)
        jobs = J.expand_ligand_library(jobs)
        if len(jobs) != n0:
            print(f"[jobs] library expansion: {n0} -> {len(jobs)}")
    jobs = J.job_slice(jobs, args.start, args.end, args.interval)
    print(f"[jobs] {len(jobs)} pairs on {dev}")

    os.makedirs(args.outdir, exist_ok=True)
    prepared, failures = P.prep(jobs, pocket_radius=args.pocket_radius,
                                cache_dir=os.path.join(args.outdir, "prep_cache"))
    P.write_failures(args.outdir, failures)
    if not prepared:
        sys.exit("no pairs prepared")

    net_kw = dict(compute_dtype=args.dtype)
    samp_kw = dict(inference_steps=args.steps + 2, actual_steps=args.steps)
    if args.config or args.cfg_options:
        from ..utils.config import apply_overrides, load_config

        cfg_d = load_config(args.config) if args.config else {}
        cfg_d = apply_overrides(cfg_d, args.cfg_options)
        net_kw.update(cfg_d.get("score_net", {}))
        samp_kw.update(cfg_d.get("sampler", {}))
    net_cfg = _config(sn.ScoreNetConfig, net_kw, "score_net")
    scfg = _config(sp.SamplerConfig, samp_kw, "sampler")
    if args.checkpoint:
        ckpt = resolve_checkpoint(args.checkpoint)
        params, step = load_checkpoint(ckpt, use_ema=True, device=dev)
        print(f"[model] loaded {ckpt} (step {step})")
    else:
        print("[model] WARNING: no checkpoint given — using random weights "
              "(poses will not be meaningful; train with diffbindfr_torch.app.train_cli)")
        params = sn.init_params(torch.Generator().manual_seed(0), net_cfg, device=dev)

    results = P.dock(prepared, params, net_cfg, scfg, num_poses=args.num_poses,
                     batch_size=args.batch_size, seed=args.seed, device=dev,
                     keep_trajectory=args.trajectory)
    if not args.no_ec:
        P.error_correct(prepared, results, steps=args.ec_steps,
                        batch_size=args.ec_bs or args.batch_size, device=dev)
    if args.save_poses:
        P.save_poses(args.outdir, prepared, results)
    if not args.no_score:
        mdn_cfg = mdn.MDNConfig()
        if args.mdn_checkpoint:
            mdn_params, _ = load_checkpoint(resolve_checkpoint(args.mdn_checkpoint),
                                            use_ema=True, device=dev)
        else:
            print("[score] WARNING: random MDN weights (ranking untrained)")
            mdn_params = mdn.init_params(torch.Generator().manual_seed(1), mdn_cfg, device=dev)
        P.score_mdn(prepared, results, mdn_params, mdn_cfg,
                    batch_size=args.score_bs or args.batch_size, device=dev)

    res_csv = P.export_and_rank(prepared, results, args.outdir,
                                export_pocket=args.export_pocket, export_top=args.export_top,
                                cluster_rank=args.cluster_rank, cluster_mode=args.cluster_mode)
    print(f"[done] results at {res_csv}")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "predict":
        return cmd_predict(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
