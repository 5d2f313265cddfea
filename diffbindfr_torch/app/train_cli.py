"""Training entry point of the port: `python -m diffbindfr_torch.app.train_cli`.

Counterpart of diffbindfr_tpu/app/train_cli.py, with its flags, defaults,
files and log lines. It trains either model from crystal-complex job
tables (`-i` CSV or `-l`/`-p`, prepared by app/prepare.py), from a
prep-cache directory (`--stream-cache`, data/stream.py) or, for the MDN,
from a generated pose set (`--pose-dir`, mdn_train.py):
  * diffusion: denoising score matching (train.py) at `--dtype bfloat16`
    by default: f32 master weights, Adam moments, EMA and checkpoints, the
    trunk on bf16-rounded weights and the heads in bf16, as in the JAX
    package. The depthwise chain of the trunk kernels is pinned to f32
    (`pallas_dw_dtype='float32'`), so on the card the trunk runs B1-B3
    forward and B4-B6 backward, never B11, in training and in the
    validation dock;
  * mdn: the scorer's mixture NLL on crystal contacts, or with `--pose-dir`
    the pose-discrimination loss (crystal NLL + ranking hinges).
Each step draws a batch of one bucket class, the pairs from a numpy
default_rng(seed) as the JAX trainer draws them (with replacement, the
token-budget batch size of data/stream.bucket_batch_size), so one seed
gives the JAX run's pairs. The diffusion noise comes from a torch.Generator
on the device (the JAX run draws its own from keys). `--holdout` /
`--val-csv` add fixed validation batches (pairs from default_rng(seed +
7919), noise drawn once from a generator seeded seed + 4242); with
`--val-poses` the EMA model also docks the held-out pairs, and the best
validation model goes to ckpt_best.npz, which `predict -ckt <run dir>`
picks.

The card runs everything unless `--cpu` (or `--device cpu`) is given: the
trunk convs through their hand-written CUDA kernels there (so `--pallas`
and `--pallas-bwd` change nothing), their plain PyTorch versions on the
CPU. `--conv-mode fc` trains the reference-exact fully connected tensor
product on the plain PyTorch path (it has no kernel), each conv's per-pair
weights in chunks whose backward recomputes them (nn/layers.fc_conv_mean);
`--resume` takes a checkpoint converted by utils/torch_import.py. Writes train_log.jsonl,
ckpt_XXXXXXX.npz / mdn_ckpt_XXXXXXX.npz and ckpt_best.npz (the JAX
package's checkpoint format) and train_state.npz (the port's own format,
for --resume) into the output directory.

    python -m diffbindfr_torch.app.train_cli -p REC.pdb -l LIG.sdf -o OUT --steps N
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(prog="diffbindfr_torch-train")
    ap.add_argument("-i", "--input-csv", help="crystal complex job table")
    ap.add_argument("-l", "--ligands", nargs="+")
    ap.add_argument("-p", "--receptors", nargs="+")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--model", choices=["diffusion", "mdn"], default="diffusion")
    ap.add_argument("--pose-dir",
                    help="mdn only: pose-discrimination training from a generated pose set "
                         "(tools/make_scorer_poses.py npz dir). Replaces -i/-l for the "
                         "train set.")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("-bs", "--batch-size", type=int, default=8,
                    help="batch size of the 64/512 bucket; larger buckets get the same "
                         "token budget (data/stream.py:bucket_batch_size)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("-dr", "--pocket-radius", type=float, default=12.0)
    ap.add_argument("-nw", "--num-workers", type=int, default=0)
    ap.add_argument("--stream-cache",
                    help="stream training batches from a prep-cache dir of per-pair npz "
                         "files (a manifest.jsonl is written there). Replaces -i/-l for "
                         "the train set; validation comes from --val-csv.")
    ap.add_argument("--stream-buffer", type=int, default=256,
                    help="shuffle-buffer capacity (decoded samples resident)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="stream mode: batches decoded ahead on the IO thread")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume", help="train_state.npz (full state) or a checkpoint (params)")
    ap.add_argument("--val-csv", help="held-out validation job table")
    ap.add_argument("--holdout", nargs="+",
                    help="complex_name substrings moved from the train table to the "
                         "validation set (alternative to --val-csv)")
    ap.add_argument("--val-every", type=int, default=0,
                    help="validation interval in steps (0 = ckpt_every)")
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--val-poses", type=int, default=0,
                    help="diffusion only: also dock N poses per validation pair with the "
                         "EMA model and log best/mean L-RMSD")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conv-mode", choices=["sep", "fc"], default="sep",
                    help="the convs' tensor product: 'sep' (kernels on the card) or the "
                         "reference's fully connected 'fc' (plain PyTorch path)")
    ap.add_argument("--ns", type=int, default=48, help="scalar channels")
    ap.add_argument("--nv", type=int, default=12, help="vector channels")
    ap.add_argument("--layers", type=int, default=6, help="conv layers")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX command line; the device picks the path")
    ap.add_argument("--pallas-bwd", action="store_true",
                    help="accepted for the JAX command line; the device picks the path")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-layer recomputation in the backward")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class _Inputs:
    """What both trainers read besides the flags."""

    draw_batch: object  # () -> a host batch of one bucket; None under --pose-dir
    stream_stats: object  # () -> the stream's batch counts for the log line
    val_batches: list  # fixed validation batches on the device
    val_prepared: list  # the held-out pairs
    val_every: int
    rng: np.random.Generator  # the batch draws' generator
    bucket_bs: object  # bucket -> batch size
    log: object  # (step, metrics, extra=None) -> a train_log.jsonl line


def _bucket_groups(items) -> dict:
    """bucket -> indices of `items` (objects with .bucket), in first-seen order."""
    out: dict = {}
    for i, it in enumerate(items):
        out.setdefault(it.bucket, []).append(i)
    return out


class _Clock:
    """The loop's time without checkpoints and validation, in total and
    after the first step (which waits for the first batch)."""

    def __init__(self, dev):
        import torch

        self.sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (
            lambda: None)
        self.t0 = time.time()
        self.aside = 0.0
        self.first = None  # (time, samples, aside) after step one

    def pause(self):
        self.sync()
        return time.time()

    def resume(self, t):
        self.aside += time.time() - t

    def stepped(self, n_samp):
        if self.first is None:
            self.sync()
            self.first = (time.time(), n_samp, self.aside)

    def result(self, steps, n_samp, losses) -> dict:
        import torch

        self.sync()
        end = time.time()
        res = {"steps": steps, "samples": n_samp, "seconds": end - self.t0 - self.aside,
               "losses": torch.stack(losses).tolist() if losses else []}
        if self.first is not None:
            res.update(steady_steps=steps - 1, steady_samples=n_samp - self.first[1],
                       steady_seconds=end - self.first[0] - (self.aside - self.first[2]))
        return res


def main(argv=None) -> dict:
    """Runs the loop; returns {steps, samples, seconds} of the steps it ran
    (loop time without checkpoint writes and validation, the device
    synchronised at its end), the same for the steps after the first as
    {steady_steps, steady_samples, steady_seconds} (the first step waits for
    the first batch), and every step's loss, read once after the loop."""
    args = build_parser().parse_args(argv)
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)

    from ..data.sample import stack_samples, to_device
    from ..data.stream import bucket_batch_size
    from . import jobs as J
    from . import prepare as P

    if args.stream_cache or args.pose_dir:
        jobs = []
        if args.holdout:
            sys.exit("--holdout needs a job table; use --val-csv with "
                     "--stream-cache/--pose-dir")
    elif args.input_csv:
        jobs = J.load_jobs_csv(args.input_csv)
    elif args.ligands and args.receptors:
        jobs = J.make_jobs(args.ligands, args.receptors)
    else:
        sys.exit("need -i CSV, both -l and -p, --stream-cache, or --pose-dir")
    if args.pose_dir and args.model != "mdn":
        sys.exit("--pose-dir requires --model mdn")

    os.makedirs(args.outdir, exist_ok=True)
    if args.holdout:
        val_jobs = [j for j in jobs if any(h in j.complex_name for h in args.holdout)]
        jobs = [j for j in jobs if j not in val_jobs]
        if not val_jobs:
            sys.exit(f"--holdout {args.holdout} matched no complex_name")
    elif args.val_csv:
        val_jobs = J.load_jobs_csv(args.val_csv)
    else:
        val_jobs = []

    prepared = []
    if jobs:
        prepared, failures = P.prep(jobs, pocket_radius=args.pocket_radius,
                                    num_workers=args.num_workers)
        P.write_failures(args.outdir, failures)
    if not prepared and not (args.stream_cache or args.pose_dir):
        sys.exit("no training pairs prepared")
    val_prepared = []
    if val_jobs:
        val_prepared, val_fail = P.prep(val_jobs, pocket_radius=args.pocket_radius)
        if val_fail:
            print(f"[val] {len(val_fail)} validation pairs failed prep")
        print(f"[val] {len(val_prepared)} held-out pairs "
              f"({', '.join(p.name for p in val_prepared)})")

    def bucket_bs(b):
        return bucket_batch_size(b, args.batch_size)

    rng = np.random.default_rng(args.seed)
    logf = open(os.path.join(args.outdir, "train_log.jsonl"), "a")

    def log(step, metrics, extra=None):
        rec = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        if extra:
            rec.update(extra)
        logf.write(json.dumps(rec) + "\n")
        logf.flush()

    prefetcher = None
    try:
        if args.stream_cache:
            from ..data import stream as DS

            entries = DS.build_manifest(args.stream_cache)
            if not entries:
                sys.exit(f"no sample npz files under {args.stream_cache}")
            sstream = DS.ShuffleStream(entries, buffer_size=args.stream_buffer, seed=args.seed)
            batcher = DS.GroupedBatcher(sstream, base_bs=args.batch_size)
            prefetcher = DS.Prefetcher(batcher, depth=args.prefetch)
            print(f"[train] streaming {len(entries)} pairs from {args.stream_cache} "
                  f"(buffer {sstream.buffer_size}) on {dev}", flush=True)

            def draw_batch():
                return prefetcher.next_batch()[1]

            def stream_stats():
                return " | " + batcher.format_stats()
        elif prepared:
            by_bucket = _bucket_groups(prepared)
            buckets = list(by_bucket)
            weights = np.array([len(by_bucket[b]) for b in buckets], np.float64)
            weights /= weights.sum()
            print(f"[train] {len(prepared)} pairs in {len(buckets)} buckets on {dev}", flush=True)

            def draw_batch():
                b = buckets[rng.choice(len(buckets), p=weights)]
                idxs = rng.choice(by_bucket[b], size=bucket_bs(b), replace=True)
                return stack_samples([prepared[i].sample for i in idxs])

            def stream_stats():
                return ""
        else:  # --pose-dir: mdn_train batches below
            draw_batch = None

            def stream_stats():
                return ""

        # fixed validation batches: the same pairs (and noise) at every evaluation
        val_every = args.val_every or args.ckpt_every
        val_batches = []
        if val_prepared:
            vrng = np.random.default_rng(args.seed + 7919)
            vb_by_bucket = _bucket_groups(val_prepared)
            vbuckets = list(vb_by_bucket)
            for bi in range(args.val_batches):
                b = vbuckets[bi % len(vbuckets)]
                idxs = vrng.choice(vb_by_bucket[b], size=bucket_bs(b), replace=True)
                val_batches.append(to_device(stack_samples([val_prepared[i].sample for i in idxs]),
                                             dev))

        inputs = _Inputs(draw_batch, stream_stats, val_batches, val_prepared, val_every, rng,
                         bucket_bs, log)
        return (_train_diffusion if args.model == "diffusion" else _train_mdn)(args, dev, inputs)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        logf.close()


def _train_diffusion(args, dev, inputs: _Inputs) -> dict:
    import torch

    from .. import train
    from ..data.sample import to_device
    from ..models import score_net as sn
    from ..sampler import SamplerConfig
    from ..utils.checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                                    save_train_state)
    from .cli import dock_path

    val_batches, val_prepared, log = inputs.val_batches, inputs.val_prepared, inputs.log

    net_cfg = sn.ScoreNetConfig(ns=args.ns, nv=args.nv, num_conv_layers=args.layers,
                                conv_mode=args.conv_mode,
                                compute_dtype=args.dtype, remat=not args.no_remat,
                                # both backward paths are f32: a bf16 chain would pair
                                # a bf16 forward with an f32 backward (the JAX pin)
                                pallas_dw_dtype="float32")
    tcfg = train.TrainConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                             ema_decay=args.ema)
    scfg = SamplerConfig()
    uk = dock_path(net_cfg)
    opt = train.make_optimizer(tcfg)
    start_step = 0
    if args.resume and args.resume.endswith("state.npz"):
        state = load_train_state(args.resume, dev)
        start_step = state.step
        print(f"[train] resumed full state from {args.resume} (step {start_step})")
    elif args.resume:
        params, step0 = load_checkpoint(args.resume, use_ema=False, device=dev)
        state = train.init_state(None, net_cfg, tcfg, dev, params=params)
        # continue the global step count, as the JAX trainer does
        start_step = int(step0 or 0)
        state = state._replace(step=start_step)
        print(f"[train] resumed params from {args.resume} (step {start_step}; "
              f"optimizer state fresh)")
    else:
        state = train.init_state(torch.Generator().manual_seed(args.seed), net_cfg, tcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vgen = torch.Generator(device=dev).manual_seed(args.seed + 4242)
    val_noise = [train.draw_noise(b, tcfg, vgen) for b in val_batches]
    best_val = [float("inf")]

    def run_validation(step):
        from . import pipeline as PL
        from .export import pose_metrics

        rec = {}
        for tag, p in (("val", state.params), ("val_ema", state.ema_params)):
            ms = [train.eval_step(p, b, n, net_cfg, scfg, tcfg, use_kernels=uk)
                  for b, n in zip(val_batches, val_noise)]
            for name in ms[0]:
                rec[f"{tag}_{name}"] = float(np.mean([float(m[name]) for m in ms]))
        if args.val_poses:
            res = PL.dock(val_prepared, state.ema_params, net_cfg, scfg,
                          num_poses=args.val_poses, batch_size=args.batch_size,
                          seed=args.seed + step, device=dev, verbose=False,
                          use_kernels=uk)
            best: dict = {}
            for r in res:
                pr = val_prepared[r.pair_idx]
                if pr.crystal_pos is None:
                    continue
                m = pose_metrics(pr.lig, pr.pocket, r.lig_pos, r.atom14_pos,
                                 crystal_lig_pos=pr.crystal_pos)
                best.setdefault(r.pair_idx, []).append(m.l_rmsd)
            if best:
                bests = [min(v) for v in best.values()]
                rec["val_best_lrmsd_mean"] = float(np.mean(bests))
                rec["val_best_lrmsd_lt2"] = float(np.mean([b < 2.0 for b in bests]))
        print(f"[val {step}] " + " ".join(f"{k}={v:.4f}" for k, v in rec.items()), flush=True)
        # selection: the sampling eval when --val-poses is on, else val EMA-DSM
        key = "val_best_lrmsd_mean" if "val_best_lrmsd_mean" in rec else "val_ema_loss"
        v = rec.get(key)
        if v is not None and v < best_val[0]:
            best_val[0] = v
            bpath = os.path.join(args.outdir, "ckpt_best.npz")
            save_checkpoint(bpath, state.params, state.ema_params, step)
            print(f"[ckpt] new best {key}={v:.4f} (step {step}) -> {bpath}", flush=True)
            rec["best_val"] = 1.0
        log(step, {}, extra=rec)

    clock = _Clock(dev)
    n_samp, last_t, last_n, losses = 0, clock.t0, 0, []
    # resumed runs continue the global step count: checkpoint names, logs
    # and the --steps target all count total steps trained
    for step in range(start_step + 1, args.steps + 1):
        batch = to_device(inputs.draw_batch(), dev)
        noise = train.draw_noise(batch, tcfg, gen)
        state, metrics = train.train_step(state, batch, noise, net_cfg, scfg, tcfg,
                                          use_kernels=uk, device=dev, optimizer=opt)
        n_samp += int(batch.lig_mask.shape[0])
        losses.append(metrics["loss"].detach())
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            rate = n_samp / (now - clock.t0)
            marg = (n_samp - last_n) / max(now - last_t, 1e-9)
            last_t, last_n = now, n_samp
            print(f"[{step}] loss={m['loss']:.4f} (tr {m['tr_loss']:.3f} rot "
                  f"{m['rot_loss']:.3f} tor {m['tor_loss']:.3f} sc {m['sc_loss']:.3f}) "
                  f"{rate:.1f} samp/s (marginal {marg:.1f})" + inputs.stream_stats(), flush=True)
            log(step, m)
        if val_batches and (step % inputs.val_every == 0 or step == args.steps):
            t = clock.pause()
            run_validation(step)
            clock.resume(t)
        if step % args.ckpt_every == 0 or step == args.steps:
            t = clock.pause()
            path = os.path.join(args.outdir, f"ckpt_{step:07d}.npz")
            save_checkpoint(path, state.params, state.ema_params, step)
            save_train_state(os.path.join(args.outdir, "train_state.npz"), state)
            print(f"[ckpt] {path}", flush=True)
            clock.resume(t)
        clock.stepped(n_samp)
    return clock.result(args.steps - start_step, n_samp, losses)


def _train_mdn(args, dev, inputs: _Inputs) -> dict:
    import torch

    from .. import mdn_train as MT
    from .. import train
    from ..data.sample import to_device
    from ..models import mdn_scorer as mdn
    from ..sampler import _rebuild_atom14
    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    rng, log, val_batches = inputs.rng, inputs.log, inputs.val_batches

    mcfg = mdn.MDNConfig()
    if args.resume:
        params, _ = load_checkpoint(args.resume, use_ema=False, device=dev)
    else:
        params = mdn.init_params(torch.Generator().manual_seed(args.seed), mcfg, dev)
    # clip_by_global_norm(1.0) + Adam on warmup-cosine, warmup capped at steps // 2
    opt = train.make_optimizer(train.TrainConfig(lr=args.lr, warmup_steps=args.warmup,
                                                 total_steps=args.steps, grad_clip=1.0))
    opt_state = opt.init(params)

    def crystal_loss(p, batch):
        pos14 = _rebuild_atom14(batch, batch.torsion_angle[..., 1:])
        loss = mdn.mdn_loss(p, mcfg, batch, batch.lig_pos, pos14).mean()
        return loss, {"loss": loss}

    if args.pose_dir:
        entries = MT.load_pose_entries(args.pose_dir)
        if not entries:
            sys.exit(f"no pose npz files under {args.pose_dir}")
        e_by_bucket = _bucket_groups(entries)
        ebuckets = list(e_by_bucket)
        eweights = np.array([len(e_by_bucket[b]) for b in ebuckets], np.float64)
        eweights /= eweights.sum()
        n_self = sum(e.is_self for e in entries)
        print(f"[mdn] pose-aug training: {len(entries)} pairs ({n_self} self-dock, "
              f"{len(entries) - n_self} cross-dock) in {len(ebuckets)} buckets", flush=True)
        pose_loss = MT.make_pose_loss(mcfg)
        # stratified draw: half of every batch from self-dock entries when the
        # bucket has both kinds (uniform draws made most batches cross-only)
        e_self = {b: [i for i in ix if entries[i].is_self] for b, ix in e_by_bucket.items()}
        e_cross = {b: [i for i in ix if not entries[i].is_self] for b, ix in e_by_bucket.items()}
        ref_ema = [2.0]  # host-side decoy-floor fallback (EMA)

        def draw_pose_batch():
            b = ebuckets[rng.choice(len(ebuckets), p=eweights)]
            bs_ = inputs.bucket_bs(b)
            if e_self[b] and e_cross[b]:
                n_s = max(bs_ // 2, 1)
                idxs = np.concatenate([rng.choice(e_self[b], size=n_s, replace=True),
                                       rng.choice(e_cross[b], size=bs_ - n_s, replace=True)])
            else:
                idxs = rng.choice(e_by_bucket[b], size=bs_, replace=True)
            return MT.pose_batch_to_device(
                MT.make_pose_batch(entries, idxs, rng, ref_ema=ref_ema[0]), dev)

    def update(loss_of, batch):
        nonlocal params, opt_state
        leaves = [p.detach().requires_grad_(True) for p in train.tree_leaves(params)]
        loss, metrics = loss_of(train.tree_unflatten(params, leaves), batch)
        grads = train.leaf_grads(loss, leaves)
        params, opt_state, _ = opt.apply(params, grads, opt_state)
        return {k: v.detach() for k, v in metrics.items()}

    clock = _Clock(dev)
    n_samp, losses = 0, []
    for step in range(1, args.steps + 1):
        if args.pose_dir:
            batch = draw_pose_batch()
            metrics = update(pose_loss, batch)
            if float(metrics["n_self"]) > 0:  # decoy-floor EMA
                ref_ema[0] = 0.95 * ref_ema[0] + 0.05 * float(metrics["ref_native"])
            n_samp += int(batch[1].shape[0])
        else:
            batch = to_device(inputs.draw_batch(), dev)
            metrics = update(crystal_loss, batch)
            n_samp += int(batch.lig_mask.shape[0])
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            rate = n_samp / (time.time() - clock.t0)
            if args.pose_dir:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"[{step}] loss={m['loss']:.4f} (cr {m['nll_crystal']:.3f} pair "
                      f"{m['pair_hinge']:.3f} abs {m['abs_hinge']:.3f} rank "
                      f"{m['rank_hinge']:.3f}) {rate:.1f} samp/s", flush=True)
                log(step, m)
            else:
                print(f"[{step}] mdn_nll={float(metrics['loss']):.4f} {rate:.1f} samp/s"
                      + inputs.stream_stats(), flush=True)
                log(step, {"mdn_nll": metrics["loss"]})
        if val_batches and (step % inputs.val_every == 0 or step == args.steps):
            t = clock.pause()
            with torch.no_grad():
                v = float(np.mean([float(crystal_loss(params, b)[0]) for b in val_batches]))
            print(f"[val {step}] val_mdn_nll={v:.4f}", flush=True)
            log(step, {}, extra={"val_mdn_nll": v})
            clock.resume(t)
        if step % args.ckpt_every == 0 or step == args.steps:
            t = clock.pause()
            path = os.path.join(args.outdir, f"mdn_ckpt_{step:07d}.npz")
            save_checkpoint(path, params, step=step)
            print(f"[ckpt] {path}", flush=True)
            clock.resume(t)
        clock.stepped(n_samp)
    return clock.result(args.steps, n_samp, losses)


if __name__ == "__main__":
    main()
