#!/usr/bin/env python3
"""Device times of the cross conv kernels B1 and B7, the knn conv kernels B3
and B9, the bf16-chain kernels B11-cross, B11-knn and B11-pair, and the
pair conv's kernels B2 (its sums), B8 (its sums finalized) and B5 (its
backward) in two checkouts of this repository, in turns on one card
(A B B A).

    python3 kernel_ab.py <checkout A> <checkout B> [--knn-rows G,G,...]
                         [--pair-rows G,G,...]
    python3 kernel_ab.py <checkout A> <checkout B> --probes

A checkout is a directory that holds a `diffbindfr_torch` package (for
example the parent commit's, unpacked with `git archive <commit>
diffbindfr_torch | tar -x -C <dir>`). Each turn is a child process that
imports the package from its checkout (building its kernels there at first
use) and this checkout's chip_smoke.py, makes chip_smoke's phase-5 and
phase-12 inputs (kernel_inputs / rm_inputs: 3dbs bucket shapes, diff_r2
weights, seeded features), and times each kernel through its wrapper:
B1 (`cross_conv`) and B3 (`knn_conv`) at (layer 0, B = 4), (5, 4) and
(5, 16), B7 (`cross_conv_fin`) and B9 (`knn_conv_fin`) at (0, 16) and
(5, 16), B11-cross and B11-knn
(`cross_conv` and `knn_conv` with `bf16_chain=True`, on the bf16-rounded
weights of chip_smoke's phase 18) at (0, 16) and (5, 16), B5 (`pair_bwd`,
the backward alone on phase 9's seeded cotangent, chip_smoke.bwd_launcher)
at (0, 4), (5, 4) and (5, 16), B8 (`pair_conv_fin`) at (0, 16) and (5, 16),
B2 (`pair_conv`) at (0, 4), (5, 4), (0, 16) and (5, 16) (training's forward
runs at B = 4) and B11-pair (`pair_conv` with `bf16_chain=True`, on phase
18's weights) at (0, 16) and (5, 16). `graph_ms` is the device time per call
from CUDA events around replays of a CUDA graph of 20 calls (no host work
between the launches; either version's kernels, whatever their symbols),
`ms` CUDA events around 10 wrapper calls. A call that reads to the host
(B5 where the checkout reads its pair count to size its scratch) cannot be
captured: its line has no graph_ms, only `ms`, and names the method. Prints
the card's nvidia-smi line, one line per kernel and shape with every turn's
numbers, and, last, every turn's numbers as one JSON object. With
--knn-rows, each turn also times each knn kernel that runs on the
checkout's knn grid (B3, B9, B11-knn: the kernels whose call records
trunk_convs.knn_conv_stats) at its shapes with the atoms per block forced
to each G (the host's rule, knn_row_groups, replaced for the call), beside
the G the rule picks; with --pair-rows, each kernel that runs on the
checkout's grid of ligand rows (B2, B11-pair, B8: the kernels whose call
records trunk_convs.pair_conv_stats) at its shapes with each forced g_p
(pair_row_groups replaced). With --probes, each turn times the probe
kernels instead: P1 (`bf16_chain.chain`, its three arithmetics at 8192 x
1024 elements and 2000 steps) and P2-vpu (`mxu_ops.chain_vpu`, the tool's
4096 grid steps over 64 input blocks), on the probes' own seeded inputs.
Imports nothing of JAX.
"""
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"cross_conv": ((0, 4), (5, 4), (5, 16)), "cross_conv_fin": ((0, 16), (5, 16)),
          "cross_conv_bf16": ((0, 16), (5, 16)), "knn_conv_bf16": ((0, 16), (5, 16)),
          "knn_conv": ((0, 4), (5, 4), (5, 16)), "knn_conv_fin": ((0, 16), (5, 16)),
          "pair_bwd": ((0, 4), (5, 4), (5, 16)), "pair_conv_fin": ((0, 16), (5, 16)),
          "pair_conv": ((0, 4), (5, 4), (0, 16), (5, 16)), "pair_conv_bf16": ((0, 16), (5, 16))}
KNN_GRID = ("knn_conv_bf16", "knn_conv", "knn_conv_fin")
PAIR_GRID = ("pair_conv", "pair_conv_bf16", "pair_conv_fin")


def _timed(cs, torch, fn, reads_host=False):
    """One row of a turn: graph replay and wrapper times of `fn`."""
    with torch.no_grad():
        fn()
        ms = cs.time_ms(fn, 3, 10)
        graph = None if reads_host else cs.graph_ms(torch, fn)
    return {"graph_ms": graph, "ms": ms,
            "method": ("events around 10 calls: the call reads its pair count to the host, no "
                       "CUDA graph captures it") if reads_host else "graph replay"}


def probe_times(cs, torch):
    """The probe kernels P1 and P2-vpu of the imported checkout at their
    tools' shapes."""
    from diffbindfr_torch.probes import bf16_chain, mxu_ops

    out = {}
    for v in bf16_chain.VARIANTS:
        x, w = bf16_chain.inputs(8192, 1024, v, cs.DEV)
        fn = functools.partial(bf16_chain.chain, x, w, 2000, v)
        out[f"probe_bf16/{v} 8192x1024 2000"] = _timed(cs, torch, fn)
        del x, w, fn
    src, w, cb = mxu_ops.chain_inputs(mxu_ops.NBLK, cs.DEV)
    fn = functools.partial(mxu_ops.chain_vpu, src, w, cb, mxu_ops.REPS)
    out[f"probe_mxu_ops/chain_vpu {mxu_ops.REPS} {mxu_ops.NBLK}"] = _timed(cs, torch, fn)
    return out


def child(checkout, knn_rows=(), pair_rows=(), probes=False):
    """One turn: the kernels of `checkout` at every shape (and its knn-grid
    kernels at each forced g_k of knn_rows, its kernels on the grid of
    ligand rows at each forced g_p of pair_rows), or with `probes` the
    probe kernels; one JSON line."""
    import importlib.util

    sys.path.insert(0, os.path.abspath(checkout))
    path = os.path.join(ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab.py needs a CUDA device")
    if probes:
        from diffbindfr_torch.probes import bf16_chain

        if not bf16_chain.__file__.startswith(os.path.abspath(checkout)):
            raise RuntimeError(f"imported {bf16_chain.__file__}, not the package of {checkout}")
        print(json.dumps({"checkout": checkout, "times": probe_times(cs, torch), "rows": {}}),
              flush=True)
        return

    from diffbindfr_torch.data.sample import _load_sample_npz
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import trunk_convs as TC
    from diffbindfr_torch.utils.checkpoint import load_checkpoint

    if not TC.__file__.startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {TC.__file__}, not the package of {checkout}")
    params, _ = load_checkpoint(cs.CKPT, use_ema=True, device=cs.DEV)
    s_np = _load_sample_npz(cs.SAMPLE)
    p16 = sn._cast_f32_leaves(params, torch.bfloat16)
    wrapper = {"cross_conv": TC.cross_conv, "cross_conv_fin": TC.cross_conv_fin,
               "cross_conv_bf16": functools.partial(TC.cross_conv, bf16_chain=True),
               "knn_conv_bf16": functools.partial(TC.knn_conv, bf16_chain=True),
               "pair_conv_bf16": functools.partial(TC.pair_conv, bf16_chain=True),
               "knn_conv": TC.knn_conv, "knn_conv_fin": TC.knn_conv_fin,
               "pair_conv_fin": TC.pair_conv_fin, "pair_conv": TC.pair_conv}

    def inputs(name, layer, bsz):
        seed = layer * 100 + bsz
        if name.endswith("_bf16"):
            return cs.kernel_inputs(torch, p16, s_np, layer, bsz, seed)[name[:-len("_bf16")]]
        rm, args = cs.rm_inputs(torch, params, s_np, layer, bsz, seed)
        return args[name] if name in args else rm[name]

    def call(name, layer, bsz):
        """A call of the kernel alone at the shape, and whether it reads to
        the host (then no CUDA graph captures it)."""
        if name != "pair_bwd":
            a = inputs(name, layer, bsz)
            return lambda: wrapper[name](*a), False
        a = inputs("pair_conv", layer, bsz)
        gen = torch.Generator(device=cs.DEV).manual_seed(layer * 10 + bsz)
        g = torch.randn(a[3].shape[0], a[3].shape[1], a[0].dout, generator=gen, device=cs.DEV)
        return cs.bwd_launcher(torch, TC, "pair_conv", a, [g]), hasattr(TC, "_pair_pairs")

    out = {}
    for name, shapes in SHAPES.items():
        for layer, bsz in shapes:
            fn, reads_host = call(name, layer, bsz)
            out[f"{name} {layer} {bsz}"] = _timed(cs, torch, fn, reads_host)
    sweep = {}
    for grid, stats, rule_name, word, rows in (
            (KNN_GRID, "knn_conv_stats", "knn_row_groups", "atom_rows", knn_rows),
            (PAIR_GRID, "pair_conv_stats", "pair_row_groups", "lig_rows", pair_rows)):
        rule = getattr(TC, rule_name, None)
        tag = "g_k" if grid is KNN_GRID else "g_p"
        for name in grid if rows and rule is not None else ():
            for layer, bsz in SHAPES[name]:
                a = inputs(name, layer, bsz)
                with torch.no_grad():
                    getattr(TC, stats).pop(name, None)
                    wrapper[name](*a)
                    if name not in getattr(TC, stats):  # not on the checkout's grid
                        break
                    picked = getattr(TC, stats)[name][word]
                    for g in rows:
                        setattr(TC, rule_name, lambda ints, sms, g=g: g)
                        graph = cs.graph_ms(torch, lambda: wrapper[name](*a))
                        sweep[f"{name} {layer} {bsz} {tag}={g}"] = {"graph_ms": graph,
                                                                    "rule_picks": picked}
                    setattr(TC, rule_name, rule)
    print(json.dumps({"checkout": checkout, "times": out, "rows": sweep}), flush=True)


def main(a, b, knn_rows="", pair_rows="", probes=False):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    turns = []
    for checkout in (a, b, b, a):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", checkout,
                              knn_rows, pair_rows, "probes" if probes else ""],
                             capture_output=True, text=True, timeout=900, cwd=ROOT)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
            raise RuntimeError(f"turn on {checkout} failed")
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for key in turns[0]["times"]:
        cells = "  ".join(
            f"{t['checkout']}: "
            + ("no graph" if t['times'][key]['graph_ms'] is None
               else f"{t['times'][key]['graph_ms']:.4f}")
            + f" ({t['times'][key]['ms']:.4f})" for t in turns)
        how = sorted({t["times"][key]["method"] for t in turns})
        print(f"{key}: graph_ms (wrapper ms) {cells}; {' / '.join(how)}", flush=True)
    for t in turns:
        for key, v in t.get("rows", {}).items():
            print(f"{t['checkout']} {key}: graph_ms {v['graph_ms']:.4f} (the rule picks "
                  f"{v['rule_picks']})", flush=True)
    print(json.dumps({"nvidia_smi": smi, "turns": turns}), flush=True)
    return 0


def _rows(word):
    return [int(g) for g in word.split(",") if g]


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--child":
        child(sys.argv[2], _rows(sys.argv[3]), _rows(sys.argv[4]), sys.argv[5] == "probes")
    elif len(sys.argv) == 4 and sys.argv[3] == "--probes":
        sys.exit(main(sys.argv[1], sys.argv[2], probes=True))
    elif len(sys.argv) >= 3 and len(sys.argv) % 2 == 1 and all(
            k in ("--knn-rows", "--pair-rows") for k in sys.argv[3::2]):
        opts = dict(zip(sys.argv[3::2], sys.argv[4::2]))
        sys.exit(main(sys.argv[1], sys.argv[2], opts.get("--knn-rows", ""),
                      opts.get("--pair-rows", "")))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
