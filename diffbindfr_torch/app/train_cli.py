"""Training entry point of the port: `python -m diffbindfr_torch.app.train_cli`.

Counterpart of diffbindfr_tpu/app/train_cli.py for the diffusion model fed
from a prep-cache directory (`--stream-cache`): denoising score matching
(train.py) on batches from the streaming data layer (data/stream.py), with
the JAX trainer's flag names and defaults. On the card the trunk convs run
forward and backward through the hand-written CUDA kernels (the device picks
the path, so there is no --pallas flag); `--device cpu` runs the plain
PyTorch versions. Writes train_log.jsonl, ckpt_XXXXXXX.npz (the JAX
package's checkpoint format) and train_state.npz (the port's own format,
for --resume) into the output directory.

    python -m diffbindfr_torch.app.train_cli --stream-cache DIR -o OUT --steps N -bs 16
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser(prog="diffbindfr_torch-train")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--stream-cache", required=True,
                    help="prep-cache dir of per-pair sample npz files (a manifest.jsonl "
                         "is written there)")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("-bs", "--batch-size", type=int, default=8,
                    help="batch size of the 64/512 bucket; larger buckets get the same "
                         "token budget (data/stream.py:bucket_batch_size)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume", help="train_state.npz (full state) or a checkpoint (params)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ns", type=int, default=48, help="scalar channels")
    ap.add_argument("--nv", type=int, default=12, help="vector channels")
    ap.add_argument("--layers", type=int, default=6, help="conv layers")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-layer recomputation in the backward")
    ap.add_argument("--stream-buffer", type=int, default=256,
                    help="shuffle-buffer capacity (decoded samples resident)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches decoded ahead on the IO thread")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Runs the loop; returns {steps, samples, seconds} of the steps it ran
    (loop time without checkpoint writes, the device synchronised at its
    end), the same for the steps after the first as {steady_steps,
    steady_samples, steady_seconds} (the first step waits for the first
    batch's decode), and every step's loss, read once after the loop."""
    args = build_parser().parse_args(argv)
    import torch

    from .. import train
    from ..data import stream as DS
    from ..data.sample import to_device
    from ..models import score_net as sn
    from ..sampler import SamplerConfig
    from ..utils.checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                                    save_train_state)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    entries = DS.build_manifest(args.stream_cache)
    if not entries:
        sys.exit(f"no sample npz files under {args.stream_cache}")
    sstream = DS.ShuffleStream(entries, buffer_size=args.stream_buffer, seed=args.seed)
    batcher = DS.GroupedBatcher(sstream, base_bs=args.batch_size)
    prefetcher = DS.Prefetcher(batcher, depth=args.prefetch)
    print(f"[train] streaming {len(entries)} pairs from {args.stream_cache} "
          f"(buffer {sstream.buffer_size}) on {dev}", flush=True)

    net_cfg = sn.ScoreNetConfig(ns=args.ns, nv=args.nv, num_conv_layers=args.layers,
                                remat=not args.no_remat)
    tcfg = train.TrainConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                             ema_decay=args.ema)
    scfg = SamplerConfig()
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

    logf = open(os.path.join(args.outdir, "train_log.jsonl"), "a")
    t0 = time.time()
    n_samp, last_t, last_n, ckpt_s = 0, t0, 0, 0.0
    losses, first = [], None  # first: (time, samples, checkpoint time) after step one
    try:
        for step in range(start_step + 1, args.steps + 1):
            _, batch_np, _ = prefetcher.next_batch()
            batch = to_device(batch_np, dev)
            noise = train.draw_noise(batch, tcfg, gen)
            state, metrics = train.train_step(state, batch, noise, net_cfg, scfg, tcfg,
                                              device=dev, optimizer=opt)
            n_samp += int(batch.lig_mask.shape[0])
            losses.append(metrics["loss"].detach())
            if step % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                rate = n_samp / (now - t0)
                marg = (n_samp - last_n) / max(now - last_t, 1e-9)
                last_t, last_n = now, n_samp
                print(f"[{step}] loss={m['loss']:.4f} (tr {m['tr_loss']:.3f} rot "
                      f"{m['rot_loss']:.3f} tor {m['tor_loss']:.3f} sc {m['sc_loss']:.3f}) "
                      f"{rate:.2f} samp/s (marginal {marg:.2f}) | {batcher.format_stats()}",
                      flush=True)
                logf.write(json.dumps({"step": step, **m}) + "\n")
                logf.flush()
            if step % args.ckpt_every == 0 or step == args.steps:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                c0 = time.time()
                path = os.path.join(args.outdir, f"ckpt_{step:07d}.npz")
                save_checkpoint(path, state.params, state.ema_params, step)
                save_train_state(os.path.join(args.outdir, "train_state.npz"), state)
                print(f"[ckpt] {path}", flush=True)
                ckpt_s += time.time() - c0
            if first is None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                first = (time.time(), n_samp, ckpt_s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        prefetcher.close()
        logf.close()
    end = time.time()
    res = {"steps": args.steps - start_step, "samples": n_samp,
           "seconds": end - t0 - ckpt_s,
           "losses": torch.stack(losses).tolist() if losses else []}
    if first is not None:
        res.update(steady_steps=res["steps"] - 1, steady_samples=n_samp - first[1],
                   steady_seconds=end - first[0] - (ckpt_s - first[2]))
    return res


if __name__ == "__main__":
    main()
