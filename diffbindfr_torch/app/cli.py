"""Command-line entry point of the port: `python -m diffbindfr_torch.app.cli
predict|relax ...`, the counterpart of diffbindfr_tpu/app/cli.py.

Same flag names and defaults. Jobs come from a CSV (-i) or receptor/ligand
lists (-p / -l, with a `<stem>_crystal.sdf` or `<stem>_box.csv` beside each
receptor defining its pocket). Prep featurises each pair from its raw files
on the host, in `-nw` spawn workers when asked, into `<outdir>/prep_cache`
(`<complex>_r<radius>.npz` + `.rec.pkl`; an entry there that serves the job,
written by the port or by the JAX package's `predict`, is used as it is).
`-j prep` stops after prep; it touches no device. Then dock -> error
correction -> (`--cart-relax`: Cartesian fine-relax) -> MDN scoring ->
export and rank. `relax -i results.csv` re-minimizes exported poses in
place: rigid-receptor Vina (with `--angular-hb`, `--explicit-h`), joint
ligand + side chains (`--flex`) or all-atom Cartesian (`--cartesian`).

The device picks the path of the stages after prep (as app/train_cli.py):
the card by default, where the score net's trunk runs the hand-written CUDA
kernels; `--cpu` runs their plain PyTorch versions on the CPU. `-nc N`
embeds N fresh start conformers per ligand at prep (chem/embed.py, on the
same device), and pose replica i starts from conformer i % N.
`--conv-mode fc` runs the reference-exact fully connected tensor product
that a checkpoint converted from the reference needs
(utils/torch_import.py); it has no kernels, so the dock takes the plain
path, on the card as on the CPU.

    python -m diffbindfr_torch.app.cli predict -i jobs.csv -o OUT -j prep -nw 4
    python -m diffbindfr_torch.app.cli predict -i jobs.csv -o OUT -ckt CKPT -mdn MDN
    python -m diffbindfr_torch.app.cli relax -i OUT/results.csv --cartesian
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

def dock_path(net_cfg) -> bool:
    """use_kernels for the dock of `net_cfg`: the kernels, except under
    conv_mode 'fc', which has none (said on stdout)."""
    if net_cfg.conv_mode != "fc":
        return True
    from ..nn.layers import FC_CHUNK_PAIRS

    print(f"[model] conv_mode 'fc': the plain PyTorch path (no kernel for 'fc'), "
          f"per-pair weights in chunks of {FC_CHUNK_PAIRS} pairs")
    return False


def build_parser():
    ap = argparse.ArgumentParser(
        prog="diffbindfr_torch",
        description="flexible protein-ligand diffusion docking (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="end-to-end docking")
    p.add_argument("-i", "--input-csv", help="job table csv")
    p.add_argument("-l", "--ligands", nargs="+", help="ligand files/dirs")
    p.add_argument("-p", "--receptors", nargs="+", help="receptor files/dirs")
    p.add_argument("-o", "--outdir", required=True,
                   help="output dir; pairs are prepared into <outdir>/prep_cache")
    p.add_argument("-np", "--num-poses", type=int, default=40)
    p.add_argument("-bs", "--batch-size", type=int, default=16)
    p.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    p.add_argument("-j", "--job", choices=["prep", "dock"], default="dock",
                   help="'prep' stops after prep (host only, no device)")
    p.add_argument("-ckt", "--checkpoint", help="diffusion model checkpoint (.npz)")
    p.add_argument("-mdn", "--mdn-checkpoint", help="MDN scorer checkpoint (.npz)")
    p.add_argument("-sd", "--seed", type=int, default=0)
    p.add_argument("-nw", "--num-workers", type=int, default=0,
                   help="parallel featurization workers (0 = serial)")
    p.add_argument("-nc", "--num-conformers", type=int, default=0,
                   help="DG-embedded starting conformers per ligand (0 = start from the "
                        "input conformer)")
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
                   help="all-atom Cartesian fine-relax of every pose after EC (the reference's "
                        "OpenMM relax role; repairs clashes and planarity that EC's pose-space "
                        "moves cannot reach, ops/cartesian.py)")
    p.add_argument("--cart-steps", type=int, default=300)
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
                   help="'fc': the reference-exact tensor product of converted reference "
                        "checkpoints (plain PyTorch, no kernels)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("-cfg", "--config", help="python config file (utils/config.py: _base_ "
                   "inheritance, ${var} interpolation)")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="dotted overrides, e.g. score_net.ns=96 sampler.kind=ode")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")

    r = sub.add_parser("relax", help="re-minimize exported poses in place (the reference relaxes "
                                     "with OpenMM, DiffBindFR/relax/pl.py)")
    r.add_argument("-i", "--results-csv", required=True,
                   help="a results.csv of predict (its lig_sdf and prot_pdb columns)")
    r.add_argument("--steps", type=int, default=300)
    r.add_argument("-dr", "--pocket-radius", type=float, default=8.0)
    r.add_argument("--flex", action="store_true",
                   help="joint ligand + side-chain relax (restrained chi DOFs, receptor clash "
                        "term); writes <pose>_relaxed.pdb with the re-packed side chains")
    r.add_argument("--cartesian", action="store_true",
                   help="all-atom Cartesian fine-relax (ligand coordinates + restrained "
                        "receptor heavy atoms, ops/cartesian.py); writes the relaxed receptor "
                        "as <pose>_relaxed.pdb")
    r.add_argument("--angular-hb", action="store_true",
                   help="angular H-bond term: the hbond pair term scaled by donor/acceptor "
                        "cones from heavy-atom geometry (implicit hydrogens)")
    r.add_argument("--w-chi", type=float, default=1.0, help="chi restraint weight (--flex)")
    r.add_argument("--explicit-h", action="store_true",
                   help="explicit polar hydrogens on the receptor (chem/protonate.py), their "
                        "directions in the angular H-bond term (implies --angular-hb; rigid "
                        "receptor only)")
    r.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def _config(cls, kw: dict, what: str):
    """cls(**kw), refusing keys the port's config does not have."""
    names = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(kw) - names)
    if bad:
        sys.exit(f"{what} options not in the port's {cls.__name__}: {', '.join(bad)}")
    return cls(**kw)


def cmd_predict(args):
    import torch

    from .. import sampler as sp
    from ..models import mdn_scorer as mdn
    from ..models import score_net as sn
    from ..utils.checkpoint import load_checkpoint, resolve_checkpoint
    from ..utils.device import resolve_device
    from . import jobs as J
    from . import pipeline as P

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
    print(f"[jobs] {len(jobs)} pairs")

    os.makedirs(args.outdir, exist_ok=True)
    prepared, failures = P.prep(jobs, pocket_radius=args.pocket_radius,
                                cache_dir=os.path.join(args.outdir, "prep_cache"),
                                num_workers=args.num_workers,
                                n_conformers=args.num_conformers,
                                device="cpu" if args.cpu else "cuda")
    P.write_failures(args.outdir, failures)
    if args.job == "prep":
        print("[prep] done (job=prep, stopping before dock)")
        return 0
    if not prepared:
        sys.exit("no pairs prepared")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"[device] {dev}")

    net_kw = dict(conv_mode=args.conv_mode, compute_dtype=args.dtype)
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
                     keep_trajectory=args.trajectory, use_kernels=dock_path(net_cfg))
    if not args.no_ec:
        P.error_correct(prepared, results, steps=args.ec_steps,
                        batch_size=args.ec_bs or args.batch_size, device=dev)
    if args.cart_relax:
        P.cartesian_relax(prepared, results, steps=args.cart_steps, batch_size=args.batch_size,
                          device=dev)
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


def _relaxed_protein(prot, pocket, atom14_pos):
    """The input protein with the pocket's relaxed atom14 swapped in."""
    from ..io.pdb import Protein
    from .export import full_protein_with_pocket

    pos37, mask37 = full_protein_with_pocket(prot, pocket, atom14_pos[: pocket.num_res])
    return Protein(atom_positions=pos37, atom_mask=mask37, aatype=prot.aatype,
                   residue_index=prot.residue_index, chain_index=prot.chain_index,
                   b_factors=prot.b_factors, chain_ids=prot.chain_ids, resnames=prot.resnames,
                   insertion_codes=prot.insertion_codes)


def cmd_relax(args):
    """Re-minimize each row's exported pose (`lig_sdf` against `prot_pdb`,
    the pocket within `-dr` of the ligand) in place, one pose at a time:
    the ligand SDF is rewritten (with its vina_score in the pose-space
    modes), and `--flex` / `--cartesian` write the relaxed receptor as
    `<lig_sdf stem>_relaxed.pdb`."""
    import csv

    import numpy as np
    import torch

    from ..chem.ligand_feats import featurize_ligand
    from ..chem.mol import perceive
    from ..chem.protein_feats import build_pocket_record
    from ..io.pdb import parse_pdb, to_pdb_string
    from ..io.sdf import parse_ligand_file, to_sdf_block
    from ..ops import cartesian as C
    from ..ops import vina
    from ..utils.device import resolve_device
    from .export import ligand_to_rawmol

    with open(args.results_csv, newline="") as fh:
        rows = list(csv.DictReader(fh))
    if args.explicit_h and not args.angular_hb:
        print("[relax] --explicit-h implies --angular-hb")
        args.angular_hb = True
    if args.explicit_h and args.flex:
        sys.exit("--explicit-h is rigid-receptor only (the flex path recomputes the axes from "
                 "the rebuilt atom14)")
    if args.cartesian and (args.flex or args.explicit_h or args.angular_hb):
        sys.exit("--cartesian is its own mode (Cartesian DOFs; the angular/explicit-H terms "
                 "belong to the pose-space minimizers)")
    dev = resolve_device("cpu" if args.cpu else "cuda")

    def on_dev(*trees):
        return [vina.stack_to_device([t], dev) for t in trees]

    for row in rows:
        lig_raw = parse_ligand_file(row["lig_sdf"])[0]
        lig = featurize_ligand(perceive(lig_raw), lig_raw.name)
        prot = parse_pdb(row["prot_pdb"])
        pocket = build_pocket_record(prot, lig.pos, cutoff=args.pocket_radius)
        na = lig.num_atoms
        pad_n = -(-na // 8) * 8
        pad_a = -(-int(pocket.atom14_mask.sum()) // 8) * 8
        vl = vina.build_ligand(lig, pad_n, max(lig.num_torsions, 1))
        pos0 = np.pad(lig.pos - pocket.center, ((0, pad_n - na), (0, 0))).astype(np.float32)
        lp = torch.from_numpy(pos0[None]).to(dev)
        a14 = aff = None
        if args.cartesian:
            cl, vl_, cr = on_dev(C.build_cartesian_ligand(lig, pad_n), vl,
                                 C.build_cartesian_receptor(pocket, pad_a))
            a14_0 = torch.from_numpy(pocket.atom14_pos[None].astype(np.float32)).to(dev)
            pos, a14 = C.cartesian_minimize_batch(lp, a14_0, cl, vl_, cr, steps=args.steps)
        elif args.flex:
            vl_, frec = on_dev(vl, vina.build_flex_receptor(pocket, -(-pocket.num_res // 8) * 8))
            pos, a14, aff = vina.joint_minimize_batch(lp, vl_, frec, steps=args.steps,
                                                      w_chi=args.w_chi,
                                                      angular_hb=args.angular_hb)
        else:
            opt_acc = pos0[:na][np.asarray(vl.acceptor)[:na] > 0] if args.explicit_h else None
            vrec = vina.build_receptor(pocket, pad_a, explicit_polar_h=args.explicit_h,
                                       opt_acceptors=opt_acc)
            vl_, vrec = on_dev(vl, vrec)
            pos, aff = vina.minimize_batch(lp, vl_, vrec, steps=args.steps,
                                           angular_hb=args.angular_hb)
        world = pos[0].cpu().numpy()[:na] + pocket.center[None, :]
        props = {} if aff is None else {"vina_score": f"{float(aff[0]):.4f}"}
        with open(row["lig_sdf"], "w") as fh:
            fh.write(to_sdf_block(ligand_to_rawmol(lig, world, props)))
        if a14 is not None:
            stem = os.path.splitext(row["lig_sdf"])[0]
            with open(stem + "_relaxed.pdb", "w") as fh:
                fh.write(to_pdb_string(_relaxed_protein(prot, pocket, a14[0].cpu().numpy())))
    mode = " (Cartesian)" if args.cartesian else " (flex)" if args.flex else ""
    print(f"[relax] re-minimized {len(rows)} poses in place{mode}")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "predict":
        return cmd_predict(args)
    if args.cmd == "relax":
        return cmd_relax(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
