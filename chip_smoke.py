#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffbindfr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each with its own deadline (a phase that overruns ends the run with
a non-zero exit code):
  1. device   require CUDA; print the card's name and power limit (nvidia-smi)
  2. build    nvcc-build the trunk-conv kernels (csrc/*.cu) into one .so
  3. load     read the diff_r2 checkpoint and the 3dbs prep cache
  4. tables   the SO(3) and torus tables built on the card, against the
              score-norm rows of the 20 sampler steps computed on the CPU
              (<= 1e-6)
  5. kernels  B1 cross, B2 pair, B3 knn at the 3dbs bucket shapes (nl 128,
              na 1024, k 16) with diff_r2 weights, layers 0 and 5, B = 4 and
              the dock batch B = 16: each kernel against its plain PyTorch
              version (max|err| <= 1e-4 max|ref|), CUDA-event times; B1
              (one wide-tile grid, csrc/cross_conv.cu): two more calls give
              the same bits, and its two kinds of block (al: g_l ligand
              rows; la: g_a atoms): blocks, working blocks, 64-pair tiles
              and their fill, each kind's share of the blocks' cycles, the
              longest block against the working mean; g_l, g_a and the
              block's shared memory; B3 (a knn grid of g_k atoms per block,
              csrc/knn_conv.cu) and B2 (a grid of g_p ligand rows per block,
              csrc/pair_conv.cu): a CUDA graph captures the call and its
              replay gives the same bits, two more calls give the same bits,
              and its blocks as phase 18 reports B11-knn's
  6. forward  full-width score net with the kernels on 3dbs, against the JAX
              package's numbers (tests/fixtures/torch_port_ref.npz, <= 1e-3)
              and against the port's plain path on the card
  7. dock     the dock stage of predict (app.pipeline.dock) on 3dbs: 16 poses
              in one batch, 20 SDE steps, kernels on; a first (cold) call,
              then the measured call, in which each kernel's launch
              counter must read 6 x 20 = 120; poses finite; poses/s, RMSD to
              the prep-cache pose; 4 poses rerun through the plain path with
              the same noise
  8. profile  torch.profiler over 2 sampler steps of the same batch: device
              time of the three kernels vs all other device work, the
              device-busy share of the steps' wall time, kernel launches per step
  9. bwd_kernels  B4 cross, B5 pair, B6 knn backward at layers 0 and 5,
              B = 4 (the 128/1024 training batch) and B = 16, and at layer 1
              B = 4 and layer 5 B = 1, on the kernel inputs of phase 5 with a
              seeded cotangent: every feature and parameter gradient against
              autograd through the plain version on the card, CUDA-event
              times. Gate per tensor: max|err| <= 5e-4 max|ref|, where the
              plain version may take the kernel's decision at a ReLU
              pre-activation within f32 rounding of 0 and nowhere else
              (nn/relu_ties.py); each such tie is printed with |z| and its
              rounding bound. B4, B5 and B6 also: two more calls give the
              same bits; the pair list holds the pairs the mask keeps; the
              device time by part (pair list, pair passes, contractions, node
              sums), the pair count (B6: of its neighbour slots; B5: the
              pass's tiles, the SMs they fill, its time per tile and SM) and
              the scratch bytes of a call
  10. train_parity  one full-width train step (diff_r2 params, a fixed 3dbs
              batch of 4, fixed TrainNoise) on the kernel path and on the
              plain path: loss terms within 1e-5, grad_norm within 1e-4
              (relative), every parameter gradient within 1e-3 max|ref|
  11. train   the port's train_cli at --dtype float32 on a copy of the five
              prep caches from diff_r2's params at -bs 16: 3 warm-up steps, then 20 steps
              resumed from the saved state, counted: per step each backward
              kernel launches 6 times and each forward kernel 12 (remat
              reruns the forward); then 5 steps with --no-remat (6 each);
              every step's loss finite, the checkpoint reloads; then 10 steps
              at --dtype bfloat16 (train_cli's default), the same counts per
              step, B11 never; samples/s and step ms after each run's first
              step, peak memory, and the profiler's device time over 2 steps
              of f32 and of bf16
  12. rm_kernels  the row-major kernel configurations' kernels: B7 cross,
              B8 pair, B9 knn with the finalize in the kernel, and B10 (the
              whole layer), at the 3dbs bucket shapes, layers 0 and 5, B = 16,
              on diff_r2 weights and phase 5's kernel inputs, against their
              plain versions (max|err| <= 1e-4 max|ref|); CUDA-event times,
              bounds and plain times; B10's two kinds of block (ligand rows,
              atoms): blocks, 64-pair tiles and their fill, each kind's share
              of the blocks' cycles; B7 as phase 5's B1 (same bits, its al
              and la blocks, g_l, g_a, shared memory); B9 as phase 5's B3
              (graph replay, same bits, its blocks, g_k, shared memory); B8
              likewise on its grid of g_p ligand rows per block
              (csrc/pair_conv.cu)
  13. rm_forward  the full-width score net in the row-major configurations
              (rowmajor, +fused_epilogue, +fused_layer) against the JAX fixture
              (<= 1e-3, as phase 6)
  14. rm_dock  16 poses x 20 steps of 3dbs after a warm-up, the default (cmt),
              fused_epilogue and fused_layer configurations in turns
              (A B C C B A): every pose finite, exact launch counts (cmt: B1-B3
              120 each; fused_epilogue: B7-B9 120 each; fused_layer: B10 120;
              every other kernel 0), poses/s of each
  15. rm_profile  phase 8's profile for fused_epilogue and fused_layer; for
              the three configurations: device ms, busy share, the trunk
              kernels' share and kernel launches per step
  16. rm_grad  one full-width train-loss gradient (B = 1, fixed noise) in the
              fused_layer configuration, kernel path vs plain path: every
              parameter gradient within 1e-3 max|ref| (B10's backward
              recomputes through its plain version)
  17. probe_bf16  P1 (probes/bf16_chain.py): the madd chain in f32, bf16x2
              mul/add and bf16x2 fma, each kernel against its plain version
              at 8 steps (f32 1e-5 relative, mul/add exact, fma 2^-8), then
              the time per sweep from R = 2000 and 2R steps at the TPU
              probe's 256 x 1024 and at 8192 x 1024 (which fills the card),
              GFLOP/s
  18. bf16_kernels  B11 cross, pair, knn (the bf16 chain) at the 3dbs bucket
              shapes, layers 0 and 5, B = 16, on the bf16-rounded diff_r2
              weights: each against its plain bf16 version (max|err| <=
              BF16_GATE max|ref|, dead rows exactly 0), CUDA-event times;
              the bound takes the chain's bf16 operations at the card's
              peak for separately rounded bf16x2 operations (67e12/s; phase
              17's measured rate printed beside it) and the fp32 operations
              at 67 TFLOP/s. B11-cross (csrc/cross_conv.cu, the wide-tile
              grid of phase 5's B1), B11-pair (csrc/pair_conv.cu, the grid
              of ligand rows of phase 5's B2) and B11-knn (csrc/knn_conv.cu,
              a knn grid of g_k atoms per block) also: a CUDA graph captures
              the call and its replay gives the same bits; two more calls
              give the same bits; their blocks (B11-cross: al and la blocks
              as phase 5 reports B1's; B11-pair and B11-knn: blocks, working
              blocks and their share of the block cycles, 64-pair tiles and
              their fill, the longest block against the working mean), rows
              per block and the block's shared memory
  19. bf16_forward  the full-width score net with compute_dtype='bfloat16',
              kernels on, against the JAX package's bf16 forward
              (tests/fixtures/torch_bf16_ref.npz; per field, tests/
              test_torch_bf16.py FULL_WIDTH_TOL), one launch of each B11
              kernel per layer and none of B1-B3; the control: the f32
              forward's distance to the same fixture, which must exceed the
              bound on tr, rot and tor; the distance to the f32 fixture
              printed
  20. bf16_dock  16 poses x 20 steps of 3dbs after a warm-up, the f32 cmt
              dock and the bf16 dock in turns (A B B A): every pose finite,
              exact launch counts (bf16: B11 120 each, every other kernel 0),
              poses/s of each, RMSD to the prep-cache pose; then phase 8's
              profile of the bf16 dock beside phase 8's f32 numbers
  21. ec_mdn_ref  error correction (ops/vina.py minimize_batch through
              app.pipeline.error_correct, 150 steps) and MDN scoring
              (models/mdn_scorer.py through score_mdn, runs/mdn_r4b weights)
              on the card against the JAX package's numbers
              (tests/fixtures/torch_ec_ref.npz, torch_mdn_ref.npz: 3dbs and
              3mhw, 4 perturbed crystal poses each): EC positions <= 1e-2 A
              over real atoms, affinity <= 1e-3 relative, MDN on the poses
              before and after EC <= 1e-3 relative; the control printed
              beside each: how far EC moved the atoms, how far the other
              stage's scores are
  22. score_chain  phase 7's 16 docked 3dbs poses -> error_correct (150
              steps) -> score_mdn, after a first (cold) pass: every score
              finite, every pose's Vina energy no higher after EC; ms per EC
              batch and per MDN batch, kernel launches per EC step and the
              card's busy share over 3 EC steps under torch.profiler. These
              stages are plain PyTorch: the JAX package runs them as XLA,
              with no Pallas kernel, so they add no row to the kernels line
  23. probe_mlp  P4 (probes/mlp.py, and P3's mlps): the fused MLP kernel
              against its plain version at R = 1024 and 32 (<= 1e-5), its
              device time beside addmm + relu + mm (a reading); the entry
              point `python -m diffbindfr_torch.probes.mlp` run in process
              with exact launch counts
  24. probe_mxu_ops  P2 (probes/mxu_ops.py): legality (1e-6), the bf16 chain
              on CUDA cores (chain_vpu, 1e-6) and on the tensor cores
              (chain_mxu: d3 = 5 rows 1e-5, the bf16-rounded rows within one
              bf16 unit) at the tool's 4096 grid steps over 64 input
              blocks, the tool's rates; the entry point with exact counts
  25. probe_mosaic  P3 (probes/mosaic.py): the ten probes at the tool's
              shapes (exact for the layout probes, onehot and precision bit
              for bit; mosaic.TOL otherwise), the library call beside each
              that has one (TF32 off, stated; events and graph replay);
              probe_precision's control: the one-hot matmul with TF32 on;
              each probe's entry point with exact counts
  26. predict  the port's `predict` command end to end (app/cli.py main(argv)
              in process) from a prep cache: a jobs CSV of 3dbs and 3mhw
              (runs/pb_bench proteins and ligands) and their tracked caches
              copied into <outdir>/prep_cache. Run 1 at the defaults (bf16,
              EC 150 steps) with diff_r2 and mdn_r4b, -np 40 -bs 16
              --cluster-rank 2.0 --save-poses -traj --export-top 5: each B11
              kernel launched exactly 720 times (2 complexes x 3 batches x 6
              layers x 20 steps) and B1-B3 never; 80 rows with finite scores
              and the four metrics; one row per complex in each top-1 table,
              `rank_score` in the clustered one; 5 structure sets per
              complex, each lig_final.sdf (read back with the port's
              parse_sdf) at its pose's lig_pos + center and each
              prot_final.pdb's pocket atoms (parse_pdb) at atom14_pos +
              center, both within 1e-3 A; poses.npz back through load_poses
              unchanged; a 20-frame lig_traj.xtc per kept pose. Run 2,
              --dtype float32 -np 16 on 3dbs: B1-B3 120 launches each, B11
              none. Prints each stage's wall time (poses/s of the dock, ms
              per batch of EC and MDN, ms per row of export), seconds per
              pose end to end and the top-1 l_rmsd by mdn_nll per complex
  27. prep_predict  host prep from raw files (app/prepare.py prep):
              (a) `predict -j prep` of 18 pairs (3dbs, 3mhw, and the 16
              ligands of runs/screen_demo/mols on 3dbs's pocket) at -nw 0 and
              -nw 4, seconds per pair of each: every pair prepared, the
              workers' entries equal the serial ones, 3dbs's and 3mhw's
              samples equal the tracked caches' real rows bit for bit and
              their records the tracked records apart from the bucket and
              the pocket's chain_ids, at the fresh buckets (n_lig, n_atm)
              (64, 1024) and (32, 768); a second -nw 4 run serves every pair
              from the cache and rewrites nothing. A library screen's prep
              (prep_library: 64 and 640 records of one SDF on 3dbs's
              pocket, -nw 0 and -nw 4): every pair prepared, seconds per
              pair and the pair count from which -nw 4 is the faster. (b)
              `predict` of 3dbs and 3mhw from their raw files at its
              defaults (bf16, EC 150 steps, MDN), 40 poses each, -bs 16:
              each B11 kernel launched exactly 720 times and B1-B10 never,
              phase 26's read-back gates, each stage's wall time, prep
              included. (c) B1-B3 and B11 at the
              fresh buckets, layers 0 and 5, B = 16, diff_r2 weights (B11 on
              their bf16 rounding): each against its plain version at phase
              5's (1e-4) and phase 18's (BF16_GATE) bounds, its CUDA-graph
              replay time, plain time and bound, and the same at the tracked
              3dbs cache's bucket (128, 1024) for comparison; each such row
              goes into its kernel's `buckets` in the kernels line
  28. serve   the serving daemon (app/serve.py: make_service from the command
              line's defaults, bf16, -bs 16, EC 150 steps, diff_r2 + mdn_r4b;
              DockServer on a free localhost port; a drain window of 2 s, which
              a full batch ends at once), requests from the raw files of
              runs/pb_bench, after a warm-up on 3dbs: (a) two concurrent
              requests for 8 poses of 3dbs share one round, each B11 kernel
              launched exactly 120 times (B1-B10 never) and nothing prepared;
              (c) that round run directly on the engines (DockEngine.run,
              ECEngine, MDNEngine): poses within 1e-3 A, scores 1e-3 relative;
              (d) each reply's SDFs (parse_sdf) at its round group's lig_pos +
              center within 1e-3 A, rows best first; (b) concurrent 3dbs and
              3mhw, 8 poses each: one round of two buckets, 240 launches of
              each B11 kernel, one prep (3mhw's); /health, 400 for
              a missing file, 200 with 2 poses for n_conformers 2; (e) an
              n_conformers 2 request for 3mhw whose prep begins (and embeds,
              a CUDA-graph capture in its handler thread) while a 16-pose
              round docks, then 2zec and 3pp0 with n_conformers 2 at once
              (these three without EC and MDN): all 200, every pose finite
              (embed.CARD_LOCK makes them take turns on the card); /shutdown
              with a request in flight serves it. Prints each request's
              latency, the served round's dock poses/s beside the direct run's
  29. eval    eval_cli.main (the pb layout: a copy of runs/pb_bench's five
              complexes) with diff_r2 and mdn_r4b at -np 16 -bs 16 and the
              defaults (bf16, EC 150 steps, validity): five batches (2src +
              2zec, 3dbs + 3pp0, 3mhw), each B11 kernel launched exactly 600
              times and B1-B10 never; 80 rows of finite scores and metrics,
              metrics_report.txt, 80 validity rows, poses.npz; each stage's
              time, validity's included, s per pose, the validity pass share,
              the top-1 l_rmsd by mdn_nll per complex (readings). B11 and
              B1-B3 at the new bucket (n_lig 32, n_atm 1024), layers 0 and 5,
              B = 16, as phase 27 (c), and a CUDA-graph replay gives the same
              bits (rows into `buckets`; no path launches B1-B3 there). rescore_cli --poses on that run: MDN scores
              within 1e-3 relative of eval's; rescore_cli -i results.csv
              scores all 80 poses. The B11 rows of the kernels line carry the
              launches of (a), (b) and eval in `path_launches`
  30. relax   (a) the relax engine (pipeline.cartesian_relax, 300 steps, batches of
              4) on the 3dbs and 3mhw poses of tests/fixtures/torch_relax_ref.npz,
              the flex joint minimizer and the explicit-H angular rigid minimizer
              (300 steps, 2 poses of 3dbs) against the JAX package's results
              there: ligand and receptor atoms within RELAX_GATE (1e-2 A),
              affinities within EC_AFF_GATE; ms per relax step. (b) `predict
              --cart-relax` (bf16, EC 150 steps, relax 300 steps) on 16 poses of
              3dbs from its tracked cache, -bs 16, with phase 26's read-back
              flags and gates: each B11 kernel launched exactly 120 times (as in
              `predict` without the relax) and B1-B10 never; each stage's time,
              the relax's ms per step and share of the run; three relax steps
              under torch.profiler: launches per step, busy share. (c) `relax` in
              its five modes (rigid, --angular-hb, --explicit-h, --flex,
              --cartesian) on one of (b)'s exported poses, RELAX_MODE_STEPS
              steps each, each mode on its own copy: a finite pose, `_relaxed.pdb` where the mode writes one, no
              trunk kernel. (d) `eval_cli --cart-relax` on 2src and 2zec, 8 poses
              each (one batch): 120 launches per B11 kernel, validity_prerelax.csv
              with 16 rows, relax_ab.json with its keys (printed as a reading).
              The B11 rows of the kernels line carry (b)'s and (d)'s launches in
              `path_launches`
  31. train_cli  train_cli at its defaults (bf16, -bs 8, remat, the f32
              depthwise chain) from -p/-l of runs/pb_bench's five complexes
              (receptor x ligand: 25 jobs) with --holdout 2zec --val-poses 4,
              10 steps resumed from diff_r2: every loss finite; exact launch
              counts: per step B1-B3 12 and B4-B6 6, B1-B3 6 per evaluation
              forward, B11 never, the validation dock B1-B3 120 per batch (20
              steps x 6 layers); ckpt_best.npz reloads to the trained EMA;
              samples/s, ms/step and peak memory. One full-width bf16 step
              (diff_r2, a 3dbs batch of 4) on the kernel path against the same
              path with the convs' plain versions on the card: loss terms and
              grad_norm at phase 10's gates; the gradients as
              tests/test_torch_train_bf16.py holds them (relative L2 over all
              below half of the f32 step's distance, each tensor within 0.2).
              Then --model mdn, crystal (-i, 3mhw and 2zec) and
              --pose-dir (scorer_pose_set), 4 steps from runs/mdn_r4b at -bs 2
              on the card and on the CPU: losses within 1e-4 relative; 10
              steps at -bs 8 on the card: samples/s, ms/step, peak memory
  32. conformers  chem/embed.py on the card: for the crystal ligands of the
              five runs/pb_bench complexes, each restraint term and its
              gradient at 4 MDS starts, at both phases' weights, against
              the port's CPU run (EMBED_GATE, relative); embed_conformers(2,
              seed 0), every conformer through ok()'s criteria (bonds
              within 8%, non-bonded pairs above 1.9 A) with its chiral signs
              kept, seconds per ligand; for 3dbs the refinement replayed as
              CUDA graphs (the card's path) against the same updates run
              eagerly, within 1e-4 A, with both times. Then `predict -nc 2 -np 8 -bs 16` of
              3dbs from its raw files at the defaults (bf16, EC, MDN): each
              replica's lig_ref_pos has the internal distances of conformer
              po % 2 (1e-4 A) and zero padding, the exported poses are
              finite, each B11 kernel launched exactly 120 times and B1-B10
              never
  33. fc_import  the full-width synthetic reference state dict
              (fake_reference_sd, seed 0) saved as a .pth and converted by
              `python -m diffbindfr_torch.utils.torch_import --arch
              score_net --unverified-scorenet` in a subprocess; the
              converted 'fc' net's forward (f32, plain path) on the card
              against tests/fixtures/torch_fc_ref.npz at t = 0.9, 0.5, 0.1
              (FC_GATE of max|ref|); the fixture's synthetic MDN head through
              `--arch mdn`, its pi, sigma and mu likewise; `predict
              --conv-mode fc -np 4 -bs 4` with the converted checkpoint on
              the tracked 3dbs cache at (128, 1024) and the default bf16:
              finite poses and scores, zero launches of B1-B11; seconds per
              pose, the 'fc' pairs and flop of the dock (counted through
              tp_conv_messages) and their rate, peak memory, the chunk size
  34. fc_train  `train_cli --conv-mode fc` at full width (bf16, train_cli's
              default; -bs 8, remat) resumed from phase 33's converted
              synthetic reference (fake_reference_sd, seed 0, converted in
              process) on a crystal job table of runs/pb_bench's five
              complexes, 3 steps: finite losses, zero trunk kernel launches,
              the fine-tuned checkpoint moved from the import; ms/step,
              samples/s, peak memory, the chunk runs per step
              (nn/layers.fc_conv_mean: a trunk conv's chunks run 3 times a
              remat step); one bf16 step under torch.profiler (3mhw, B = 8):
              kernel launches per step, device time, busy share; one f32
              step's gradients (3mhw, B = 1, fixed noise) on the card
              against the same step on the CPU, relative L2 over every
              gradient <= FC_GRAD_GATE
  35. split   DockEngine over parallel.make_mesh([cuda:0, cuda:0]) (the
              split's code on one card, two shards of 8: not two cards)
              against the unsplit dock of the same 16 poses of 3dbs (f32,
              diff_r2, 20 steps) at the shards' batch size, 8: poses within
              1e-3 A, B1-B3 launched 240 times by each; the distance to the
              unsplit dock at B = 16 (120 launches) printed beside the
              unsplit docks' own at B = 8 and 16 (the kernels' row groups
              follow the batch); KarmaDock (models/karmadock.py, default width,
              init_params seed 0) on 4 poses of 3dbs on the card against
              its CPU run (1e-4 of max|ref|); utils/observe.trace around
              one bf16 dock step (B = 16): its Chrome trace names every B11
              kernel symbol
Kernel times: `ms` is the wrapper's time by CUDA events around 10 calls
(its host set-up included), `device_ms` the kernel's own device time per
call (phases 5, 9, 12, 17, 18, 23-25): from torch.profiler's
key_averages(), summed over the CUDA kernel symbols the call launches
(SYMBOLS), taken only where the profiler recorded, for every symbol, one
event for each of its grids launched (its counter's launches x GRIDS); else
from CUDA events around replays of a CUDA graph of 20 calls (no host work
between the kernels); each row names its `device_ms_method` (and, for graph
replay, what the profiler missed).
Phase 23 also prints what the profiler records of the P4 kernel's launches
made bare, with 20 ms host pauses at the ends of its window, each in a
record_function span, and beside an aten kernel (PERF.md section 7). The
probes' library calls are timed both ways. The second-to-last lines are
the kernels JSON and the nvidia-smi line; the last line is {"ok": true,
"device": {...}}. Imports nothing of JAX.
"""
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
CKPT = os.path.join(ROOT, "runs/diff_r2/ckpt_best.npz")
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_port_ref.npz")
FIXTURE_BF16 = os.path.join(ROOT, "tests/fixtures/torch_bf16_ref.npz")
FIXTURE_EC = os.path.join(ROOT, "tests/fixtures/torch_ec_ref.npz")
FIXTURE_MDN = os.path.join(ROOT, "tests/fixtures/torch_mdn_ref.npz")
FIXTURE_RELAX = os.path.join(ROOT, "tests/fixtures/torch_relax_ref.npz")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
# phase 33: the JAX package's import and 'fc' forward of the full-width
# synthetic reference state dict (fake_reference_sd) on a data/synthetic.py
# sample, and of a synthetic MDN head (tests/test_torch_fc.py writes it)
FIXTURE_FC = os.path.join(ROOT, "tests/fixtures/torch_fc_ref.npz")
# phase 32: the card against the port's CPU run, per restraint term and its
# gradient (relative to max|ref|); phase 33: the converted model's forward
# on the card against the JAX fixture
EMBED_GATE, FC_GATE = 1e-5, 1e-3
EC_NAMES = ("3dbs", "3mhw")
PB_BENCH = os.path.join(ROOT, "runs/pb_bench")
SCREEN_MOLS = os.path.join(ROOT, "runs/screen_demo/mols")
# phase 27: the buckets (n_lig, n_atm) a fresh prep picks (the tracked caches
# were written before the ligand and pocket ladders were decoupled: 128/1024
# and 96/768)
PREP_BUCKETS = {"3dbs": (64, 1024), "3mhw": (32, 768)}
# phase 26: the complexes of predict's run 1 (3mhw: no torsions, bucket nl 96)
PREDICT_NAMES = ("3dbs", "3mhw")
# the card against the JAX fixtures after 150 EC steps: positions (A over
# real atoms), affinity and MDN scores (relative)
EC_POS_GATE, EC_AFF_GATE, MDN_GATE = 1e-2, 1e-3, 1e-3
DEV = "cuda"
DEADLINES = {"device": 60, "build": 300, "load": 120, "tables": 120, "kernels": 300,
             "forward": 180, "dock": 300, "profile": 120, "bwd_kernels": 480,
             "train_parity": 180, "train": 300, "rm_kernels": 240, "rm_forward": 120,
             "rm_dock": 300, "rm_profile": 120, "rm_grad": 180, "probe_bf16": 120,
             "bf16_kernels": 240, "bf16_forward": 120, "bf16_dock": 300, "ec_mdn_ref": 180,
             "score_chain": 240, "probe_mlp": 120,
             "probe_mxu_ops": 180, "probe_mosaic": 180, "predict": 300, "prep_predict": 480,
             "serve": 300, "eval": 420, "relax": 420, "train_cli": 240, "conformers": 150,
             "fc_import": 180, "fc_train": 240, "split": 180}
# published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, HBM3 bandwidth; bf16 outside the tensor cores (packed
# bf16x2, two per fp32 lane: the H100 white paper's non-tensor BF16 rate,
# an fma counted as 2)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16X2 = 2 * PEAK_FP32
# separately rounded bf16 operations (bf16x2 mul.rn and add.rn, one result
# per lane each, at the fp32 lane rate): half the fma-counted rate
PEAK_BF16X2_ROUNDED = PEAK_BF16X2 / 2
KERNELS = {
    "cross_conv": ("diffbindfr_torch/csrc/cross_conv.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:693"),
    "pair_conv": ("diffbindfr_torch/csrc/pair_conv.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:433"),
    "knn_conv": ("diffbindfr_torch/csrc/knn_conv.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:935"),
}
# backward kernels: launch counter -> (source, replaced TPU kernel, forward wrapper)
BWD_KERNELS = {
    "cross_bwd": ("diffbindfr_torch/csrc/cross_bwd.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:1600",
                  "cross_conv"),
    "pair_bwd": ("diffbindfr_torch/csrc/pair_bwd.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:1258",
                 "pair_conv"),
    "knn_bwd": ("diffbindfr_torch/csrc/knn_bwd.cu", "diffbindfr_tpu/nn/pallas_conv_t.py:1884",
                "knn_conv"),
}
# the row-major configurations' kernels: launch counter -> (source, replaced TPU kernel)
RM_KERNELS = {
    "cross_conv_fin": ("diffbindfr_torch/csrc/cross_conv.cu", "diffbindfr_tpu/nn/pallas_conv.py:1008"),
    "pair_conv_fin": ("diffbindfr_torch/csrc/pair_conv.cu", "diffbindfr_tpu/nn/pallas_conv.py:653"),
    "knn_conv_fin": ("diffbindfr_torch/csrc/knn_conv.cu", "diffbindfr_tpu/nn/pallas_conv.py:1225"),
    "layer_conv": ("diffbindfr_torch/csrc/layer_conv.cu", "diffbindfr_tpu/nn/pallas_layer.py:552"),
}
# kernel configurations of the score net (ScoreNetConfig fields) and the
# kernels each launches in a dock
RM_MODES = {"cmt": ({}, tuple(KERNELS)),
            "fused_epilogue": (dict(pallas_layout="rowmajor", fused_epilogue=True),
                               ("cross_conv_fin", "pair_conv_fin", "knn_conv_fin")),
            "fused_layer": (dict(pallas_layout="rowmajor", fused_layer=True), ("layer_conv",))}
# B11, the bf16-chain kernels: launch counter -> (source, replaced TPU kernel, f32 twin)
BF16_KERNELS = {
    "cross_conv_bf16": ("diffbindfr_torch/csrc/cross_conv.cu",
                        "diffbindfr_tpu/nn/pallas_conv_t.py:693", "cross_conv"),
    "pair_conv_bf16": ("diffbindfr_torch/csrc/pair_conv.cu",
                       "diffbindfr_tpu/nn/pallas_conv_t.py:433", "pair_conv"),
    "knn_conv_bf16": ("diffbindfr_torch/csrc/knn_conv.cu",
                      "diffbindfr_tpu/nn/pallas_conv_t.py:935", "knn_conv"),
}
# B11 against its plain bf16 version, max|err| / max|ref|: a TP weight or cb
# entry that the kernel's and torch's f32 MLP orders put on either side of a
# bf16 rounding boundary moves one term by one bf16 unit (measured <= 1.1e-3
# at layers 0 and 5, B = 16, on the H100). The control, the f32 kernel
# (B1-B3) on the same inputs, must lie beyond the gate.
BF16_GATE = 2.5e-3
# the full-width bf16 forward against the JAX fixture, per field (the bounds
# of tests/test_torch_bf16.py FULL_WIDTH_TOL, which says why); for the
# fields of BF16_SEPARATING the bound must also lie below the control, the
# f32 forward's distance to the same fixture in the same run
BF16_FORWARD_TOL = {"tr": 4e-3, "rot": 3e-3, "tor": 1e-1, "sc_tor": 1e-1}
BF16_SEPARATING = ("tr", "rot", "tor")
PROBE = ("diffbindfr_torch/csrc/probe_bf16.cu", "tools/probe_bf16.py:48")
# the probes P2-P4: row name -> (source, replaced TPU kernel)
PROBE_KERNELS = {
    "probe_mlp": ("diffbindfr_torch/csrc/probe_mlp.cu", "tools/probe_timing.py:22"),
    "probe_mxu_ops/legality": ("diffbindfr_torch/csrc/probe_mxu_ops.cu",
                               "tools/probe_mxu_ops.py:80"),
    "probe_mxu_ops/chain_vpu": ("diffbindfr_torch/csrc/probe_mxu_ops.cu",
                                "tools/probe_mxu_ops.py:194"),
    "probe_mxu_ops/chain_mxu": ("diffbindfr_torch/csrc/probe_mxu_ops.cu",
                                "tools/probe_mxu_ops.py:207"),
}
# P3: argv word -> (row name, line of the replaced TPU kernel in
# tools/probe_mosaic.py); mlps runs the P4 kernel
MOSAIC_SOURCE = "diffbindfr_torch/csrc/probe_mosaic.cu"
MOSAIC_ROWS = {"3d": ("3d_accum", ":40"), "onehot": ("onehot", ":68"),
               "tile": ("tile_lanes", ":91"), "bcast": ("bcast2d", ":109"),
               "4d": ("4d_block", ":129"), "msel": ("msel", ":154"),
               "prec": ("precision", ":199"), "dw": ("dwloop", ":243"), "mlp": ("mlps", ":291"),
               "abt": ("abt", ":343")}
# CUDA kernel symbols of each launch counter, for the profiler's device time;
# the first is the kernel that the counter counts
SYMBOLS = {
    "cross_conv": ("cross_conv_wide_kernel(",), "pair_conv": ("pair_conv_wide_kernel(",),
    "knn_conv": ("knn_conv_wide_kernel(",),
    "cross_bwd": ("cross_wide_kernel(", "pairs_count_kernel(", "exclusive_scan_kernel(",
                  "src_count_kernel(", "pairs_fill_kernel(", "abt_kernel<",
                  "abt_reduce_kernel(", "segment_sum_kernel<8>(", "segment_sum_kernel<2>("),
    "pair_bwd": ("pair_wide_kernel(", "pairs_count_kernel(", "exclusive_scan_kernel(",
                 "src_count_kernel(", "pairs_fill_kernel(", "abt_kernel<", "abt_reduce_kernel(",
                 "segment_sum_kernel<2>("),
    "knn_bwd": ("knn_wide_kernel(", "knn_count_kernel(", "knn_scan_kernel(", "knn_rev_kernel(",
                "abt_kernel<", "abt_reduce_kernel(", "knn_node_sum_kernel("),
    "cross_conv_fin": ("cross_conv_fin_wide_kernel(",),
    "pair_conv_fin": ("pair_conv_fin_wide_kernel(",),
    "knn_conv_fin": ("knn_conv_fin_wide_kernel(",), "layer_conv": ("layer_conv_kernel(",),
    "cross_conv_bf16": ("cross_conv_bf16_wide_kernel(",),
    "pair_conv_bf16": ("pair_conv_bf16_wide_kernel(",),
    "knn_conv_bf16": ("knn_conv_bf16_wide_kernel(",),
    "probe_bf16/f32_fma": ("probe_f32_kernel(",),
    "probe_bf16/bf16x2_mul_add": ("probe_bf16_kernel<false>(",),
    "probe_bf16/bf16x2_fma": ("probe_bf16_kernel<true>(",),
    "probe_mlp": ("probe_mlp_kernel(",), "probe_mxu_ops/legality": ("legality_kernel(",),
    "probe_mxu_ops/chain_vpu": ("chain_vpu_kernel(",),
    "probe_mxu_ops/chain_mxu": ("chain_mxu_kernel(",),
    "probe_mosaic/3d_accum": ("accum3d_kernel(",), "probe_mosaic/onehot": ("gather_kernel(",),
    "probe_mosaic/tile_lanes": ("tile_kernel(",), "probe_mosaic/bcast2d": ("bcast2d_kernel(",),
    "probe_mosaic/4d_block": ("block4d_kernel(",), "probe_mosaic/msel": ("msel_kernel(",),
    "probe_mosaic/dwloop": ("dwloop_kernel(",), "probe_mosaic/abt": ("abt_kernel<", "abt_reduce_kernel("),
}
# grids of each kernel symbol (SYMBOLS[key]) that one counted launch runs,
# where more than one (B1, B7 and B11-cross run both directions in one
# grid): B4 (csrc/cross_bwd.cu) two prefix sums (ligand rows, atoms) and per
# direction a pair pass, a contraction and its reduction; B5
# (csrc/pair_bwd.cu) two prefix sums (target rows, sources) and two node
# sums (targets, sources)
GRIDS = {"cross_bwd": {"cross_wide_kernel(": 2, "exclusive_scan_kernel(": 2, "abt_kernel<": 2,
                       "abt_reduce_kernel(": 2},
         "pair_bwd": {"exclusive_scan_kernel(": 2, "segment_sum_kernel<2>(": 2}}
# calls that read to the host (B4 and B5 read their pair counts to size
# their scratch): no CUDA graph can capture them, so device_ms's fallback for
# them is CUDA events around the calls
NO_GRAPH = ("cross_bwd", "pair_bwd")
# B4's, B5's and B6's kernels by the part of their work they do (phase 9
# prints each part)
BWD_PARTS = {
    "cross_bwd": {"pair list": ("pairs_count_kernel(", "exclusive_scan_kernel(",
                                "src_count_kernel(", "pairs_fill_kernel("),
                  "pair passes": ("cross_wide_kernel(",),
                  "contractions": ("abt_kernel<", "abt_reduce_kernel("),
                  "node sums": ("segment_sum_kernel<8>(", "segment_sum_kernel<2>(")},
    "pair_bwd": {"pair list": ("pairs_count_kernel(", "exclusive_scan_kernel(",
                               "src_count_kernel(", "pairs_fill_kernel("),
                 "pair pass": ("pair_wide_kernel(",),
                 "contractions": ("abt_kernel<", "abt_reduce_kernel("),
                 "node sums": ("segment_sum_kernel<2>(",)},
    "knn_bwd": {"pair list": ("knn_count_kernel(", "knn_scan_kernel(", "knn_rev_kernel("),
                "pair pass": ("knn_wide_kernel(",),
                "contractions": ("abt_kernel<", "abt_reduce_kernel("),
                "node sums": ("knn_node_sum_kernel(",)}}
# bf16 dense rate of the tensor cores (data sheet, 700 W)
PEAK_BF16_TC = 989e12
SCHED = {"tr_sigma_min": 0.1, "tr_sigma_max": 6.0, "rot_sigma_min": 0.03,
         "rot_sigma_max": 1.55, "tor_sigma_min": 0.0314, "tor_sigma_max": 3.14,
         "sc_tor_sigma_min": 0.0314, "sc_tor_sigma_max": 3.14}


class Phase:
    """Prints one flushed line per phase; a watchdog ends the process when
    the phase overruns its deadline (it also fires inside a hung CUDA call)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        self.timer = threading.Timer(DEADLINES[self.name], self._expire)
        self.timer.daemon = True
        self.timer.start()
        print(f"[{self.name}] start", flush=True)
        return self

    def _expire(self):
        print(f"[{self.name}] FAILED: deadline of {DEADLINES[self.name]} s passed", flush=True)
        os._exit(124)

    def __exit__(self, exc_type, exc, tb):
        self.timer.cancel()
        state = "ok" if exc_type is None else f"FAILED: {exc_type.__name__}: {exc}"
        print(f"[{self.name}] {state} ({time.time() - self.t0:.2f} s)", flush=True)
        return False


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_ms(fn, warmup, iters):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_count(key):
    """The launch counter `key` of whichever port module keeps it."""
    from diffbindfr_torch.nn import trunk_convs
    from diffbindfr_torch.probes import bf16_chain, mlp, mosaic, mxu_ops

    for m in (trunk_convs, bf16_chain, mlp, mosaic, mxu_ops):
        if key in m.launches:
            return m.launches[key]
    raise KeyError(key)


def profile_kernel(torch, fn, key, calls, span=False, pause=0.0):
    """Run `fn` under torch.profiler: one warm-up call in the profiler's
    warm-up step (its events are discarded: the profiler drops events at
    the start of a session), then `calls` calls in its active step, each
    inside a record_function span when `span`, with a host pause of `pause`
    s before the first and after the last. Returns, per kernel symbol of
    SYMBOLS[key], (device us, events recorded, grids launched: the launches
    the counter `key` counted in the active step x GRIDS), and the names of
    up to 6 device kernels the profiler saw."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    symbols = SYMBOLS[key]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = launch_count(key)
        time.sleep(pause)
        for _ in range(calls):
            with record_function("probe_call") if span else contextlib.nullcontext():
                fn()
        torch.cuda.synchronize()
        time.sleep(pause)
        launched = launch_count(key) - before
        prof.step()
    per = {sym: [0.0, 0, launched * GRIDS.get(key, {}).get(sym, 1)] for sym in symbols}
    names = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us > 0 and len(names) < 6:
            names.append(e.key[:60])
        for sym in symbols:
            if sym in e.key:
                per[sym][0] += us
                per[sym][1] += e.count
    return {sym: tuple(v) for sym, v in per.items()}, names


def device_ms(torch, fn, key, calls=5, parts=None):
    """A kernel's own device time per call of `fn`, without the host set-up
    that CUDA events around the wrapper include, and how it was measured.
    "profiler": torch.profiler's key_averages() over `calls` calls after a
    warm-up call in the profiler's warm-up step (profile_kernel), the device
    time of the CUDA kernels whose names contain one of SYMBOLS[key], over
    `calls`; `parts`, if given, receives each symbol's ms per call. It is
    taken only where the profiler recorded, for every symbol, one event per
    grid launched in those calls (the counter `key`'s launches x GRIDS).
    Else "graph replay": CUDA events around replays of a CUDA graph of 20
    calls, so no host work separates the launches, or, for calls that read
    to the host (NO_GRAPH), CUDA events around 10 calls; the method then
    says why the profiler's reading was refused. (None, "not measured ...")
    if both fail."""
    fn()
    torch.cuda.synchronize()
    per, names = profile_kernel(torch, fn, key, calls)
    missed = [f"{ev} events of {sym[:-1]} for {grids} grids" for sym, (_, ev, grids) in per.items()
              if not (grids and ev == grids)]
    if not missed:
        if parts is not None:
            parts.update({sym: us / 1e3 / calls for sym, (us, _, _) in per.items()})
        return sum(us for us, _, _ in per.values()) / 1e3 / calls, "profiler"
    why = "the profiler recorded " + "; ".join(missed)
    print(f"  {key}: profiler reading refused, {why}; device kernels it saw: {names}", flush=True)
    if key in NO_GRAPH:
        return time_ms(fn, 1, 10), f"events around 10 calls, host gaps included ({why})"
    ms = graph_ms_or_none(torch, fn)
    return ms, ("not measured" if ms is None else "graph replay") + f" ({why})"


def graph_ms_or_none(torch, fn):
    """graph_ms, or None (printed) where the calls cannot be captured: a
    measurement, not a gate."""
    try:
        return graph_ms(torch, fn)
    except RuntimeError as exc:
        torch.cuda.synchronize()
        print(f"  graph replay not measured: {exc}", flush=True)
        return None


def paired_graph_ms(torch, fns, calls=20, rounds=10):
    """ms per call of each of `fns` in one window: one CUDA graph of `calls`
    calls each, replayed in turns (A B B A ...), the median of `rounds`
    replays per graph."""
    graphs = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        graphs.append(g)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = [[] for _ in fns]
    for r in range(rounds):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start.record()
            graphs[i].replay()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [sorted(t)[len(t) // 2] for t in times]


def graph_ms(torch, fn, calls=20, replays=5):
    """ms per call of `fn` from CUDA events around replays of a CUDA graph
    that holds `calls` calls: the kernels run back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def nbytes(*ts):
    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def kernel_inputs(torch, params, s_np, layer, bsz, seed):
    """Trunk-conv inputs of one layer at the bucket shapes of the sample
    `s_np`: its geometry with the ligand shifted per replica, seeded random
    features."""
    from diffbindfr_torch.data.sample import stack_samples, to_device
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import layers as L
    from diffbindfr_torch.nn import trunk_convs as TC

    g = torch.Generator(device=DEV).manual_seed(seed)
    s = to_device(stack_samples([s_np] * bsz), DEV)
    shift = torch.randn(bsz, 1, 3, generator=g, device=DEV) * 1.5
    lig_pos = (s.lig_pos + shift) * s.lig_mask[..., None]
    cfg = sn.ScoreNetConfig()
    spec = sn._specs(cfg)[0][layer]
    c_lig, c_cross, c_knn = sn._kernel_consts(cfg)[layer]
    din = spec.dw.in1.dim
    lig_x = torch.randn(bsz, lig_pos.shape[1], din, generator=g, device=DEV)
    atm_x = torch.randn(bsz, s.atm_pos.shape[1], din, generator=g, device=DEV)
    t = torch.rand(bsz, generator=g, device=DEV)
    temb = L.sinusoidal_time_emb(t, cfg.sigma_embed_dim, cfg.emb_scale)
    cut = sn.sigmas_from_t(t, SCHED).tr * 0.2 + 5.0
    bidx = torch.arange(bsz, device=DEV)[:, None]
    nl, na = lig_pos.shape[1], s.atm_pos.shape[1]
    bond_feat = torch.zeros(bsz, nl, nl, cfg.lig_edge_dim, device=DEV)
    bond_feat.index_put_((bidx, s.lig_e_src, s.lig_e_dst),
                         s.lig_e_feat * s.lig_e_mask[..., None], accumulate=True)
    bond_mask = torch.zeros(bsz, nl, nl, device=DEV)
    bond_mask.index_put_((bidx, s.lig_e_src, s.lig_e_dst), s.lig_e_mask, accumulate=True)
    cab = torch.zeros(bsz, na, device=DEV)
    cab.index_put_((bidx, s.cab_idx), s.cab_mask, accumulate=True)
    cab = (cab > 0).float()
    idx, valid = L.knn_edges(s.atm_pos, s.atm_pos, s.atm_mask, s.atm_mask, k=cfg.atom_knn,
                             cutoff=cfg.atom_cutoff, exclude_self=True)
    lp = {k: params[f"{k}_convs"][layer] for k in ("lig", "al", "la", "atom")}
    zero = torch.zeros_like(s.lig_mask)
    pair_params = TC.pair_params(params["lig_edge_emb"], lp["lig"]["fc"])
    knn_params = {"emb": params["atom_edge_emb"], "fc": lp["atom"]["fc"]}
    args = {
        "pair_conv": (c_lig, lig_pos, lig_pos, lig_x, lig_x, s.lig_mask, s.lig_mask, zero, zero,
                      temb, cfg.lig_cutoff, pair_params, bond_feat, bond_mask),
        "cross_conv": (c_cross, lig_pos, s.atm_pos, lig_x, atm_x, s.lig_mask, s.atm_mask, cab,
                       temb, cut, params["la_edge_emb"], lp["al"]["fc"], lp["la"]["fc"]),
        "knn_conv": (c_knn, s.atm_pos, atm_x, s.atm_mask, idx, valid.float(), temb, knn_params),
    }
    return args


def work(torch, name, args):
    """(FLOPs, bytes) the function needs on these inputs: MLP and tensor-
    product operations over the pairs its masks keep; each input read once,
    each output written once."""
    from diffbindfr_torch.nn.trunk_convs import _dist

    c = args[0]
    ck, meta = c.tables
    tp_ops = float(sum(2 * int(m[2]) + 2 for m in meta)) + 2 * 9 * ck.shape[1]
    if name == "knn_conv":
        _, pos, x, mask, idx, valid, temb, p = args
        pairs = float(valid.sum())
        emb, fcs = p["emb"], [p["fc"]]
        e_in = emb["l1"]["w"].shape[0] - c.sed
        he = emb["l1"]["w"].shape[1]
        inputs = (pos, x, idx, valid, temb, p)
        n_out = x.shape[0] * x.shape[1]
    elif name == "pair_conv":
        _, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
        vec = sp[:, None, :, :] - tp[:, :, None, :]
        d = _dist(vec)
        eye = torch.eye(tp.shape[1], dtype=torch.bool, device=tp.device)
        mask = (((d <= cut) & ~eye) | (bm > 0)) & (tm[:, :, None] > 0) & (sm[:, None, :] > 0)
        pairs = float(mask.sum())
        fcs = [{"l1": {"w": p["fc_w1"]}, "l2": {"w": p["fc_w2"]}}]
        e_in = p["emb_w1"].shape[0] - c.sed
        he = p["emb_w1"].shape[1]
        inputs = (tp, tx, tm, temb, p, bf, bm)
        n_out = tx.shape[0] * tx.shape[1]
    else:
        _, lp_, ap, lx, ax, lm, am, cab, temb, cut, emb, fal, fla = args
        d = _dist(ap[:, None, :, :] - lp_[:, :, None, :])
        mask = ((cab[:, None, :] > 0) | (d <= cut[:, None, None])) & (lm[:, :, None] > 0) \
            & (am[:, None, :] > 0)
        pairs = float(mask.sum())
        fcs = [fal, fla]
        e_in = emb["l1"]["w"].shape[0] - c.sed
        he = emb["l1"]["w"].shape[1]
        inputs = (lp_, ap, lx, ax, lm, am, cab, temb, cut, emb, fal, fla)
        n_out = lx.shape[0] * (lx.shape[1] + ax.shape[1])
    per_pair = 2.0 * (e_in * he + he * c.ns)
    for fc in fcs:
        w1, w2 = fc["l1"]["w"], fc["l2"]["w"]
        per_pair += 2.0 * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1]) + tp_ops
    return pairs * per_pair, nbytes(*inputs) + 4.0 * n_out * c.dout, pairs


def phase_kernels(torch, params, s_np, results):
    from diffbindfr_torch.nn import trunk_convs as TC

    plain = {"cross_conv": TC.cross_conv_plain, "pair_conv": TC.pair_conv_plain,
             "knn_conv": TC.knn_conv_plain}
    wrapper = {"cross_conv": TC.cross_conv, "pair_conv": TC.pair_conv,
               "knn_conv": TC.knn_conv}
    for layer, bsz in ((0, 4), (5, 4), (5, 16)):
        args = kernel_inputs(torch, params, s_np, layer, bsz, seed=layer * 100 + bsz)
        for name in KERNELS:
            a = args[name]
            with torch.no_grad():
                got = wrapper[name](*a)
                ref = plain[name](*a)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(rel_err(g_, r_) for g_, r_ in zip(got, ref))
                abs_err = max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))
                finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
                ms = time_ms(lambda: wrapper[name](*a), 3, 10)
                dev_ms, dev_how = device_ms(torch, lambda: wrapper[name](*a), name)
                plain_ms = time_ms(lambda: plain[name](*a), 1, 2)
            flops, byts, pairs = work(torch, name, a)
            bound_ms = max(flops / PEAK_FP32, byts / PEAK_BYTES) * 1e3
            row = dict(layer=layer, batch=bsz, max_rel_err=err, max_abs_err=abs_err,
                       ms=ms, device_ms=dev_ms, device_ms_method=dev_how, plain_ms=plain_ms,
                       bound_ms=bound_ms, pairs=pairs, flops=flops, bytes=byts,
                       bound_by="operations" if flops / PEAK_FP32 >= byts / PEAK_BYTES else "bytes")
            results.setdefault(name, []).append(row)
            print(f"  {name} layer {layer} B={bsz}: max|err|/max|ref| {err:.2e} "
                  f"kernel {fmt_ms(dev_ms)} ({dev_how}; wrapper {ms:.3f} ms) "
                  f"plain {plain_ms:.3f} ms "
                  f"bound {bound_ms:.3f} ms ({row['bound_by']}) pairs {pairs:.0f}", flush=True)
            if not finite or err > 1e-4:
                raise AssertionError(f"{name} layer {layer}: kernel disagrees with plain ({err:.3e})")
            if name == "cross_conv":
                row["blocks"] = cross_block_report(torch, TC, name, wrapper[name], a)
            else:
                row.update(grid_report(torch, TC, name, wrapper[name], a))


def grid_report(torch, TC, name, wrapper, a):
    """A kernel on the knn grid (B3 "knn_conv", B9 "knn_conv_fin", B11-knn
    "knn_conv_bf16"), on the grid of ligand rows (B2 "pair_conv", B8
    "pair_conv_fin", B11-pair "pair_conv_bf16") or B11-cross
    ("cross_conv_bf16"), after its timing: a CUDA graph captures the call
    and its replay gives the same bits; then its block report
    (knn_block_report, pair_block_report, cross_block_report). Returns the
    row's graph_same and blocks."""
    if not graph_same(torch, functools.partial(wrapper, *a)):
        raise AssertionError(f"{name}: a CUDA graph's replay differs")
    print("    a CUDA graph captures the call; its replay gives the same bits", flush=True)
    report = {"pair": pair_block_report, "knn": knn_block_report,
              "cross": cross_block_report}[name.split("_")[0]]
    return {"graph_same": True, "blocks": report(torch, TC, name, wrapper, a)}


def cross_block_report(torch, TC, name, wrapper, a):
    """B1 (name "cross_conv"), B7 ("cross_conv_fin") or B11-cross
    ("cross_conv_bf16") after its timing: two more calls must give the same
    bits; then its two kinds of block (al: g_l
    ligand rows; la: g_a atoms): per kind the blocks, those with a pair
    (working), their 64-pair tiles and how full they are (the plan model,
    cross_tile_plan, on these inputs), the share of the blocks' clock64()
    cycles (one launch with `cycles`) and the longest block against the mean
    of the working blocks (each block's cycles are its SM's time on it); the
    rows per block and the block's shared memory."""
    x = (a[0],) + tuple(a[2:]) if name == "cross_conv_fin" else a
    with torch.no_grad():
        one, two = wrapper(*a), wrapper(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"{name}: two calls gave different bits")
        g_l, g_a = TC.cross_conv_stats[name]["groups"]
        plan = TC.cross_tile_plan(x[1], x[2], x[5], x[6], x[7], x[9], g_l, g_a)
        cycles = torch.zeros(len(plan), dtype=torch.int64, device=DEV)
        if name == "cross_conv_fin":
            TC._cross_fin_kernel(*a, cycles=cycles)
        else:
            d = TC._cross_inputs(*a, bf16_chain=name == "cross_conv_bf16")
            TC._cross_conv_kernel(TC._library(), *d[:5], d[5:],
                                  torch.cuda.current_stream().cuda_stream, cycles=cycles)
        torch.cuda.synchronize()
    cyc = cycles.double().cpu()
    out = {"groups": [g_l, g_a], "smem_bytes": TC.cross_conv_stats[name]["smem_bytes"],
           "same_bits": True}
    print(f"    g_l {g_l} ligand rows, g_a {g_a} atoms per block, {out['smem_bytes']} bytes of "
          f"shared memory; two calls bit-identical", flush=True)
    for kind, what in (("al", f"al blocks ({g_l} ligand rows)"),
                       ("la", f"la blocks ({g_a} atoms)")):
        sel = [i for i, blk in enumerate(plan) if blk.kind == kind]
        work = [i for i in sel if plan[i].tiles[kind]]
        tiles = sum(len(plan[i].tiles[kind]) for i in sel)
        pairs = sum(len(t) for i in sel for t in plan[i].tiles[kind])
        c = cyc[work] if work else cyc[sel]
        out[kind] = dict(blocks=len(sel), working=len(work), tiles=tiles, pairs=pairs,
                         tile_fill=pairs / max(1, tiles * TC.WIDE_TILE),
                         cycle_share=float(cyc[sel].sum() / cyc.sum()),
                         longest_over_working_mean=float(c.max() / c.mean()))
        print(f"    {what}: {len(sel)} blocks ({len(work)} working), {tiles} tiles of {pairs} "
              f"pairs ({100 * out[kind]['tile_fill']:.1f}% full), "
              f"{100 * out[kind]['cycle_share']:.1f}% of the block cycles, longest block "
              f"{out[kind]['longest_over_working_mean']:.2f}x the working mean", flush=True)
    return out


def knn_block_report(torch, TC, name, wrapper, a):
    """B3 (name "knn_conv"), B9 ("knn_conv_fin") or B11-knn
    ("knn_conv_bf16") after its timing: two more calls must give the same
    bits; then its blocks (g_k atoms each, the plan model knn_tile_plan on
    these inputs) as block_summary reports them; g_k and the block's shared
    memory."""
    c, pos, x, _, idx, valid, temb, p = (a[0],) + tuple(a[2:]) if name == "knn_conv_fin" else a
    same_bits(torch, name, wrapper, a)
    stats = TC.knn_conv_stats[name]
    g_k = stats["atom_rows"]
    plan = TC.knn_tile_plan(idx, valid, g_k)
    cycles = torch.zeros(len(plan), dtype=torch.int64, device=DEV)
    with torch.no_grad():
        if name == "knn_conv_fin":
            TC._knn_fin_kernel(*a, cycles=cycles)
        else:
            d = TC._knn_inputs(c, pos, x, idx, valid, temb, p, name == "knn_conv_bf16")
            TC._knn_conv_kernel(TC._library(), *d[:4], d[4:],
                                torch.cuda.current_stream().cuda_stream, cycles=cycles)
        torch.cuda.synchronize()
    print(f"    g_k {g_k} atoms per block, {stats['smem_bytes']} bytes of shared memory; two "
          f"calls bit-identical", flush=True)
    return {"atom_rows": g_k, "smem_bytes": stats["smem_bytes"], "same_bits": True,
            **block_summary(TC, plan, "knn", cycles, "knn blocks")}


def pair_block_report(torch, TC, name, wrapper, a):
    """B2 ("pair_conv"), B11-pair ("pair_conv_bf16") or B8
    ("pair_conv_fin") after its timing: two more calls must give the same
    bits; then its blocks (g_p ligand rows each, the plan model
    pair_tile_plan on these inputs) as block_summary reports them; g_p and
    the block's shared memory."""
    fin = name == "pair_conv_fin"
    c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = (a[0], *a[2:15]) if fin else a
    same_bits(torch, name, wrapper, a)
    stats = TC.pair_conv_stats[name]
    g_p = stats["lig_rows"]
    plan = TC.pair_tile_plan(tp, sp, tm, sm, cs, cut, bm, g_p)
    cycles = torch.zeros(len(plan), dtype=torch.int64, device=DEV)
    with torch.no_grad():
        if fin:
            TC._pair_fin_kernel(*a, cycles=cycles)
        else:
            d = TC._pair_inputs(c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p, bf, bm,
                                name == "pair_conv_bf16")
            TC._pair_conv_kernel(TC._library(), *d[:5], d[5:],
                                 torch.cuda.current_stream().cuda_stream, cycles=cycles)
        torch.cuda.synchronize()
    print(f"    g_p {g_p} ligand rows per block, {stats['smem_bytes']} bytes of shared memory; "
          f"two calls bit-identical", flush=True)
    return {"lig_rows": g_p, "smem_bytes": stats["smem_bytes"], "same_bits": True,
            **block_summary(TC, plan, "pair", cycles, "ligand-row blocks")}


def same_bits(torch, name, wrapper, a):
    """Two more calls of `wrapper` must give the same bits."""
    with torch.no_grad():
        one, two = wrapper(*a), wrapper(*a)
        torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"{name}: two calls gave different bits")


def block_summary(TC, plan, kind, cycles, what):
    """A one-kind grid's blocks (`plan`, TileBlocks in grid order) and their
    clock64() cycles from one launch: the blocks, those with a pair
    (working), their 64-pair tiles and how full they are, the share of the
    blocks' cycles that the working blocks take, the longest working block
    against the working mean (each block's cycles are its SM's time on it)
    and the most tiles a block holds."""
    cyc = cycles.double().cpu()
    work = [i for i, blk in enumerate(plan) if blk.tiles[kind]]
    tiles = sum(len(blk.tiles[kind]) for blk in plan)
    pairs = sum(len(t) for blk in plan for t in blk.tiles[kind])
    c = cyc[work] if work else cyc
    out = {"blocks": len(plan), "working": len(work), "tiles": tiles, "pairs": pairs,
           "tile_fill": pairs / max(1, tiles * TC.WIDE_TILE),
           "working_cycle_share": float(c.sum() / cyc.sum()),
           "longest_over_working_mean": float(c.max() / c.mean()),
           "tiles_per_block_max": max(len(blk.tiles[kind]) for blk in plan)}
    print(f"    {what}: {len(plan)} blocks ({len(work)} working, "
          f"{100 * out['working_cycle_share']:.1f}% of the block cycles), {tiles} tiles of {pairs} "
          f"pairs ({100 * out['tile_fill']:.1f}% full, at most {out['tiles_per_block_max']} a "
          f"block), longest block {out['longest_over_working_mean']:.2f}x the working mean",
          flush=True)
    return out


def graph_same(torch, fn):
    """A CUDA graph captures one call of `fn` and replays it: the replay's
    output must equal an eager call's, bit for bit."""
    with torch.no_grad():
        eager = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
    eager, out = ((v if isinstance(v, tuple) else (v,)) for v in (eager, out))
    same = all(torch.equal(p, q) for p, q in zip(eager, out))
    # the side stream and the capture each keep a cuBLAS workspace allocated
    # (32 MiB on the H100): free them, so that a later phase's peak memory
    # does not count them
    torch._C._cuda_clearCublasWorkspaces()
    return same


def grad_inputs(name, args, names=None):
    """args with the node features and every parameter tensor replaced by
    leaf copies that require grad, and those leaves (features first); their
    names are appended to `names` when given."""
    leaves = []
    names = [] if names is None else names

    def leaf(t, n):
        t = t.detach().clone().requires_grad_(True)
        leaves.append(t)
        names.append(n)
        return t

    def tree(x, n):
        if isinstance(x, dict):
            return {k: tree(v, f"{n}/{k}") for k, v in x.items()}
        return leaf(x, n)

    a = list(args)
    if name == "pair_conv":
        a[3] = a[4] = leaf(a[3], "x")
        a[11] = {k: leaf(v, k) for k, v in a[11].items()}
    elif name == "cross_conv":
        a[3], a[4] = leaf(a[3], "lig_x"), leaf(a[4], "atm_x")
        a[10], a[11], a[12] = tree(a[10], "emb"), tree(a[11], "fc_al"), tree(a[12], "fc_la")
    else:
        a[2] = leaf(a[2], "x")
        a[7] = tree(a[7], "p")
    return a, leaves


def bwd_launcher(torch, TC, name, args, gs):
    """A call of the backward kernel alone on these inputs and cotangents."""
    def plain(v):
        return v.detach() if torch.is_tensor(v) else v

    if name == "pair_conv":
        c, tp, sp, tx, sx, tm, sm, ct, cs, temb, cut, p, bf, bm = args
        data, x1, x2, w_in, beff, *w = map(plain, TC._pair_inputs(
            c, tp, sp, tx, sx, tm, sm, cs, temb, cut, p, bf, bm))
        return lambda: TC.pair_bwd(data, x1, x2, w_in, beff, w, gs[0])
    if name == "cross_conv":
        data, lx, ax, w_in, beff, *w = map(plain, TC._cross_inputs(*args))
        return lambda: TC.cross_bwd(data, lx, ax, w_in, beff, w, gs[0], gs[1])
    c, pos, x, mask, idx, valid, temb, p = args
    data, x1, w_in, beff, *w = map(plain, TC._knn_inputs(c, pos, x, idx, valid, temb, p))
    return lambda: TC.knn_bwd(data, x1, w_in, beff, w, gs[0])


# (layer, batch) of the backward-kernel checks: the training batch of 4 and
# the dock batch of 16 at the first and last layer, and two more shapes
BWD_SHAPES = ((0, 4), (5, 4), (0, 16), (5, 16), (1, 4), (5, 1))
# the MLPs of each conv in the order its plain version runs them, and what
# the target and source index of a pair are
MLP_ROLES = {"cross_conv": (("edge", "fc_al", "fc_la"), "ligand", "atom"),
             "pair_conv": (("edge", "fc"), "ligand", "ligand"),
             "knn_conv": (("edge", "fc"), "atom", "neighbour slot")}


def diagnose_f64(torch, name, args, plain_fn, got, ref32, gs):
    """Kernel and plain f32 gradients against autograd through the plain
    version in float64: which side of a tie the exact value falls on."""
    def f64(x):
        if isinstance(x, dict):
            return {k: f64(v) for k, v in x.items()}
        if torch.is_tensor(x) and x.is_floating_point():
            return x.double()
        return x

    diff, leaves = grad_inputs(name, [f64(a) for a in args])
    out = plain_fn(*diff)
    out = out if isinstance(out, tuple) else (out,)
    ref = torch.autograd.grad(out, leaves, [g.double() for g in gs])
    for what, grads in (("kernel", got), ("plain f32", ref32)):
        print(f"    {what} vs plain f64, max|err|/max|ref| per gradient: " + " ".join(
            f"{rel_err(g_.double(), r_):.1e}" for g_, r_ in zip(grads, ref)), flush=True)


def phase_bwd_kernels(torch, params, s_np, results):
    from diffbindfr_torch.nn import trunk_convs as TC
    from diffbindfr_torch.nn.relu_ties import ReluTies

    plain = {"cross_conv": TC.cross_conv_plain, "pair_conv": TC.pair_conv_plain,
             "knn_conv": TC.knn_conv_plain}
    wrapper = {"cross_conv": TC.cross_conv, "pair_conv": TC.pair_conv,
               "knn_conv": TC.knn_conv}
    for layer, bsz in BWD_SHAPES:
        args = kernel_inputs(torch, params, s_np, layer, bsz, seed=layer * 100 + bsz)
        for bname, (_, _, name) in BWD_KERNELS.items():
            names = []
            diff, leaves = grad_inputs(name, args[name], names)
            out_k = wrapper[name](*diff)
            out_k = out_k if isinstance(out_k, tuple) else (out_k,)
            gen = torch.Generator(device=DEV).manual_seed(layer * 10 + bsz)
            gs = [torch.randn(o.shape, generator=gen, device=DEV) for o in out_k]
            got = torch.autograd.grad(out_k, leaves, gs)
            ties = ReluTies(plain[name], diff, leaves, gs)
            raw, final, flips = ties.check(got, 5e-4)
            n_ties, n_values, ref = ties.n_ties, ties.n_values, ties.ref
            explain = ties.explain(got) if max(final) > 5e-4 else []
            del ties
            torch.cuda.synchronize()
            print("    max|err|/max|ref|: " + " ".join(
                f"{n} {a:.1e}" + (f" ({b:.1e} with the ties below)" if b != a else "")
                for n, a, b in zip(names, raw, final)), flush=True)
            roles, tgt, src = MLP_ROLES[name]
            for f in flips:
                print(f"    ReLU tie taken the other way: sample {f['b']} {tgt} {f['target']} "
                      f"{src} {f['source']}, {roles[f['role']]} hidden unit {f['unit']}: "
                      f"z {f['z']:.3e}, |z| <= rounding bound {f['bound']:.3e}", flush=True)
            if flips:
                diagnose_f64(torch, name, args[name], plain[name], got, ref, gs)
            err, tie_err = max(raw), max(final)
            abs_err = max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))
            finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
            launch = bwd_launcher(torch, TC, name, args[name], gs)
            ms = time_ms(launch, 2, 5)
            parts = {}
            dev_ms, dev_how = device_ms(torch, launch, bname, parts=parts)
            wide = {}
            if bname in BWD_PARTS:
                wide = wide_bwd_report(torch, TC, bname, launch, parts, layer, bsz)
            out_p = plain[name](*diff)
            out_p = out_p if isinstance(out_p, tuple) else (out_p,)
            plain_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves, gs, retain_graph=True),
                               0, 1)
            del out_p, ref
            flops, byts, pairs = work(torch, name, args[name])
            # the recompute plus both products of every MLP's backward: 3x the
            # forward's operations; bytes: the forward's, the cotangent, and
            # one gradient per feature and parameter tensor
            flops *= 3.0
            byts += nbytes(*gs) + nbytes(*leaves)
            bound_ms = max(flops / PEAK_FP32, byts / PEAK_BYTES) * 1e3
            row = dict(layer=layer, batch=bsz, max_rel_err=err, tie_rel_err=tie_err,
                       ties_taken=len(flips), max_abs_err=abs_err, ms=ms, device_ms=dev_ms,
                       device_ms_method=dev_how, plain_ms=plain_ms, bound_ms=bound_ms,
                       pairs=pairs, flops=flops,
                       bytes=byts,
                       bound_by="operations" if flops / PEAK_FP32 >= byts / PEAK_BYTES else "bytes",
                       **wide)
            if wide and wide["pairs_listed"] != pairs:
                raise AssertionError(f"{bname} layer {layer} B={bsz}: the pair list holds "
                                     f"{wide['pairs_listed']} pairs, the mask {pairs:.0f}")
            results.setdefault(bname, []).append(row)
            print(f"  {bname} layer {layer} B={bsz}: {len(got)} gradients, max|err|/max|ref| "
                  f"{err:.2e} ({tie_err:.2e} with {len(flips)} of {n_ties} ReLU ties "
                  f"in {n_values} pre-activations taken the other way) kernel {fmt_ms(dev_ms)} "
                  f"({dev_how}; wrapper {ms:.3f} ms) plain {plain_ms:.3f} ms bound "
                  f"{bound_ms:.3f} ms ({row['bound_by']}) pairs {pairs:.0f}", flush=True)
            if not finite or not tie_err <= 5e-4:
                for e in explain:
                    print(f"    closest single flip to the largest bias-gradient difference "
                          f"({e['diff']:.2e}): sample {e['b']} {tgt} {e['target']} {src} "
                          f"{e['source']}, {roles[e['role']]} unit {e['unit']}: flip "
                          f"{e['delta']:.2e}, z {e['z']:.3e}, rounding bound {e['bound']:.3e}",
                          flush=True)
                raise AssertionError(f"{bname} layer {layer} B={bsz}: kernel gradients disagree "
                                     f"with autograd through the plain version ({err:.3e}; "
                                     f"{tie_err:.3e} with {len(flips)} ties flipped)")


def wide_bwd_report(torch, TC, bname, launch, parts, layer, bsz):
    """B4, B5 or B6 after its timing: two more calls must give the same
    bits; prints the device time of each part of its work (BWD_PARTS, from
    the profiler's per-symbol reading), the pair count (B6: and its
    neighbour slots, by which it sizes its scratch and grid; B5: the pass's
    tiles, the SMs they fill and its time per tile and SM) and the scratch
    bytes of a call."""
    first, second = launch(), launch()
    torch.cuda.synchronize()

    def flat(r):
        return [t for x in r for t in (x.values() if isinstance(x, dict) else [x])]

    if not all(torch.equal(a, b) for a, b in zip(flat(first), flat(second))):
        raise AssertionError(f"{bname} layer {layer} B={bsz}: two calls differ")
    if bname == "cross_bwd":
        stats = dict(TC.cross_bwd_stats)
        listed = f"{stats['pairs']} pairs in the list"
    elif bname == "pair_bwd":
        stats = dict(TC.pair_bwd_stats)
        listed = (f"{stats['pairs']} pairs in the list, the pass's {stats['tiles']} tiles on "
                  f"{stats['sms']} SMs")
    else:
        stats = dict(TC.knn_bwd_stats, pairs=int(TC.knn_bwd_stats["count"]))
        listed = (f"{stats['pairs']} pairs of {stats['slots']} neighbour slots "
                  f"({100 * stats['pairs'] / max(stats['slots'], 1):.1f}% valid; the scratch and "
                  f"the pass's grid are sized by the slots, no host read)")
    by_part = ({part: sum(parts[sym] for sym in syms) for part, syms in BWD_PARTS[bname].items()}
               if parts else None)
    print(f"  {bname} layer {layer} B={bsz}: two calls bit-identical; {listed}, "
          f"{stats['splits']} K chunks per contraction, scratch "
          f"{stats['scratch_bytes'] / 2**20:.1f} MiB; device time by part: "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in by_part.items()) if by_part
             else "not measured (the profiler's reading was refused)"), flush=True)
    if parts:
        print("    by kernel: " + ", ".join(f"{k[:-1]} {v:.4f} ms" for k, v in parts.items()),
              flush=True)
    extra = {k: stats[k] for k in ("slots", "tiles", "sms") if k in stats}
    if bname == "pair_bwd" and by_part and stats["tiles"]:
        # the pass's time per tile and SM: its tiles fill stats["sms"] SMs
        extra["pass_us_per_tile"] = 1e3 * by_part["pair pass"] * stats["sms"] / stats["tiles"]
        print(f"    the pass: {stats['tiles']} tiles on {stats['sms']} SMs, "
              f"{extra['pass_us_per_tile']:.1f} us per tile and SM", flush=True)
    return dict(pairs_listed=stats["pairs"], splits=stats["splits"],
                scratch_bytes=stats["scratch_bytes"], parts_ms=by_part, **extra)


def param_paths(tree, prefix=""):
    """Leaf paths of a parameter tree, in train.tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in param_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in param_paths(v, f"{prefix}#{i}/")]
    return [prefix[:-1]]


def phase_train_parity(torch, params, s_np):
    """One full-width train step's loss terms and gradients, kernel path vs
    plain path, same batch and noise."""
    from diffbindfr_torch.models import score_net as sn

    check_train_parity(torch, params, s_np, sn.ScoreNetConfig(remat=True),
                       {"kernel": (True, None), "plain": (False, None)})


def check_train_parity(torch, params, s_np, cfg, runs, control=None):
    """loss_and_grads of one full-width train step (a fixed 3dbs batch of 4,
    fixed TrainNoise) for each of the two `runs`, name -> (use_kernels,
    context manager factory or None), the first against the second: loss
    terms within 1e-5, grad_norm within 1e-4 (relative), every parameter
    gradient within 1e-3 max|ref|. With `control`, a config whose step the
    second run's gradients are also compared with (bf16: the same path at
    f32), the gradients are held as tests/test_torch_train_bf16.py holds
    them: the relative L2 distance over all of them below half of the
    control's, every tensor within 0.2 relative L2 (the bf16 backward rounds
    its cotangents at every cast, so element bounds cannot hold)."""
    from diffbindfr_torch import train
    from diffbindfr_torch.data.sample import stack_samples, to_device
    from diffbindfr_torch.sampler import SamplerConfig

    tcfg, scfg = train.TrainConfig(), SamplerConfig()
    batch = to_device(stack_samples([s_np] * 4), DEV)
    noise = train.draw_noise(batch, tcfg, torch.Generator(device=DEV).manual_seed(11))
    cfgs = {path: cfg for path in runs}
    if control is not None:
        runs, cfgs = {**runs, "control": (True, None)}, {**cfgs, "control": control}
    out = {}
    for path, (use_kernels, ctx) in runs.items():
        torch.cuda.synchronize()
        t0 = time.time()
        with (ctx or contextlib.nullcontext)():
            m, g = train.loss_and_grads(params, batch, noise, cfgs[path], scfg, tcfg, use_kernels)
        m["grad_norm"] = train.global_norm(g)
        torch.cuda.synchronize()
        out[path] = ({k: float(v) for k, v in m.items()}, g)
        print(f"  {path} path: loss and gradients in {time.time() - t0:.3f} s: "
              + " ".join(f"{k} {v:.6g}" for k, v in out[path][0].items()), flush=True)
    (name_k, (mk, gk)), (name_p, (mp, gp)) = list(out.items())[:2]
    terms = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mk}
    paths = param_paths(params)
    keep = [i for i, b in enumerate(gp) if b.numel() and float(b.abs().max()) > 0]
    errs = {paths[i]: rel_err(gk[i], gp[i]) for i in keep}
    worst = max(errs, key=errs.get)
    print("  relative differences: " + " ".join(f"{k} {v:.2e}" for k, v in terms.items())
          + f"; parameter gradients max|err|/max|ref| {errs[worst]:.2e} ({worst}) over "
          f"{len(errs)} tensors ({len(gp) - len(keep)} with zero gradients skipped); above "
          f"1e-4: {sum(e > 1e-4 for e in errs.values())}", flush=True)
    bad = [k for k, v in terms.items() if not v <= (1e-4 if k == "grad_norm" else 1e-5)]
    if control is None:
        ok = errs[worst] <= 1e-3
    else:
        def l2(a, b):
            return float(torch.linalg.vector_norm(torch.cat([(x - y).flatten() for x, y in zip(
                a, b)])) / torch.linalg.vector_norm(torch.cat([y.flatten() for y in b])))

        err, ctl = l2(gk, gp), l2(out["control"][1], gp)
        per = {paths[i]: l2([gk[i]], [gp[i]]) for i in keep}
        top = max(per, key=per.get)
        print(f"  gradients' relative L2 distance {err:.3e}, the control's {ctl:.3e} (ratio "
              f"{err / ctl:.3f}); worst tensor {per[top]:.3e} ({top})", flush=True)
        ok = err < 0.5 * ctl and per[top] <= 0.2
    if bad or not ok:
        raise AssertionError(f"{name_k} path disagrees with the {name_p} path: {bad}, "
                             f"gradients {errs[worst]:.3e} ({worst})")


def phase_train(torch, smi):
    """The port's train_cli on the card; returns the launch counts per step."""
    from diffbindfr_torch import train
    from diffbindfr_torch.app import train_cli
    from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import trunk_convs as TC
    from diffbindfr_torch.sampler import SamplerConfig
    from diffbindfr_torch.utils.checkpoint import load_checkpoint, load_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train.")
    try:
        cache, out = os.path.join(tmp, "cache"), os.path.join(tmp, "out")
        os.makedirs(cache)
        for fn in sorted(os.listdir(PREP)):
            if fn.endswith(".npz"):
                shutil.copy(os.path.join(PREP, fn), cache)
        step0 = int(load_checkpoint(CKPT, device="cpu")[1] or 0)
        common = ["--stream-cache", cache, "-o", out, "-bs", "16", "--ckpt-every", "1000000",
                  "--device", DEV, "--dtype", "float32"]
        warm, timed, flat, half = 3, 20, 5, 10
        t0 = time.time()
        train_cli.main(common + ["--resume", CKPT, "--steps", str(step0 + warm)])
        print(f"  {warm} warm-up steps from diff_r2 (step {step0}) in "
              f"{time.time() - t0:.3f} s, tables and first steps included", flush=True)
        TC.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = train_cli.main(common + ["--resume", os.path.join(out, "train_state.npz"),
                                       "--steps", str(step0 + warm + timed)])
        counts = dict(TC.launches)
        peak = torch.cuda.max_memory_allocated()
        report_rate(res, f"remat on, peak memory {peak / 2**30:.2f} GiB on {smi}")
        print("  losses " + " ".join(f"{v:.3f}" for v in res["losses"]), flush=True)
        print(f"  launches in the {timed} timed steps: {counts}", flush=True)
        last = os.path.join(out, f"ckpt_{step0 + warm + timed:07d}.npz")
        p_back, st = load_checkpoint(last, use_ema=False, device=DEV)
        state = load_train_state(os.path.join(out, "train_state.npz"), DEV)
        same = all(torch.equal(a, b) for a, b in zip(train.tree_leaves(p_back),
                                                      train.tree_leaves(state.params)))
        if len(res["losses"]) != timed or not all(v == v and abs(v) < float("inf")
                                                  for v in res["losses"]):
            raise AssertionError("non-finite training loss")
        if st != step0 + warm + timed or not same:
            raise AssertionError("the checkpoint does not reload to the trained parameters")
        want = {k: 0 for k in TC.launches}
        want.update({**{k: 6 * timed for k in BWD_KERNELS}, **{k: 12 * timed for k in KERNELS}})
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")

        # without remat the backward reuses the forward's activations
        TC.reset_launches()
        res = train_cli.main(common + ["--no-remat", "--resume",
                                       os.path.join(out, "train_state.npz"),
                                       "--steps", str(step0 + warm + timed + flat)])
        no_remat = dict(TC.launches)
        report_rate(res, "remat off")
        print(f"  launches in the {flat} steps without remat: {no_remat}", flush=True)
        if not all(v == v and abs(v) < float("inf") for v in res["losses"]):
            raise AssertionError("non-finite training loss without remat")
        if no_remat != {k: 6 * flat if k in KERNELS or k in BWD_KERNELS else 0
                        for k in TC.launches}:
            raise AssertionError(f"launch counts without remat {no_remat}, expected "
                                 f"{6 * flat} each")

        # train_cli's default precision on the same steps: bf16 with the f32
        # depthwise chain (B1-B6, never B11)
        TC.reset_launches()
        res = train_cli.main(common + ["--dtype", "bfloat16", "--resume",
                                       os.path.join(out, "train_state.npz"),
                                       "--steps", str(step0 + warm + timed + flat + half)])
        bf16 = dict(TC.launches)
        report_rate(res, "bf16, remat on")
        print(f"  launches in the {half} bf16 steps: {bf16}", flush=True)
        if not all(v == v and abs(v) < float("inf") for v in res["losses"]):
            raise AssertionError("non-finite bf16 training loss")
        if bf16 != {k: v // 2 for k, v in want.items()}:
            raise AssertionError(f"bf16 launch counts {bf16}, expected half of {want}")

        # device time over 2 steps of one 128/1024 batch under the profiler
        from torch.profiler import ProfilerActivity, profile

        tcfg, scfg = train.TrainConfig(total_steps=step0 + 100), SamplerConfig()
        s_np = _load_sample_npz(SAMPLE)
        batch = to_device(stack_samples([s_np] * 4), DEV)
        gen = torch.Generator(device=DEV).manual_seed(5)
        noise = train.draw_noise(batch, tcfg, gen)
        for what, cfg in (("f32", sn.ScoreNetConfig(remat=True)),
                          ("bf16", sn.ScoreNetConfig(remat=True, compute_dtype="bfloat16",
                                                     pallas_dw_dtype="float32"))):
            state, _ = train.train_step(state, batch, noise, cfg, scfg, tcfg, device=DEV)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                for _ in range(2):
                    state, _ = train.train_step(state, batch, noise, cfg, scfg, tcfg,
                                                device=DEV)
                torch.cuda.synchronize()
                wall = time.time() - t0
            report_profile(prof, wall, f"2 {what} train steps, B=4 (128/1024)",
                           list(KERNELS) + list(BWD_KERNELS), steps=2)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def report_rate(res, what):
    """train_cli's rate after its first step (which waits for the first
    batch's decode) and over all its steps."""
    print(f"  {what}: {res['steady_steps']} steps after the first, {res['steady_samples']} "
          f"samples in {res['steady_seconds']:.3f} s: "
          f"{res['steady_samples'] / res['steady_seconds']:.3f} samples/s, "
          f"{1e3 * res['steady_seconds'] / res['steady_steps']:.1f} ms/step (all "
          f"{res['steps']} steps: {res['samples'] / res['seconds']:.3f} samples/s)", flush=True)


def phase_tables(torch, np, sp, sn, scfg):
    """The SO(3) and torus tables built on the card, their score norms
    against the tables in use (cached or built at first use), and the rows
    the sampler reads against the same rows computed on the CPU."""
    from diffbindfr_torch.geometry import so3, torus

    ts = sp.t_schedule(scfg, DEV)
    sig = sn.sigmas_from_t(ts[: scfg.actual_steps], scfg.schedule)
    checks = {"so3": (so3, lambda t: t.exp_score_norms, so3.exp_score_norm_row,
                      so3._eps_index(sig.rot)),
              "torus": (torus, lambda t: t.score_norm, torus.score_norm_row,
                        torus._sigma_index(torch.cat([sig.tor, sig.sc_tor])))}
    for name, (mod, norms, row_fn, idx) in checks.items():
        torch.cuda.synchronize()
        t0 = time.time()
        fresh = mod.compute_tables(DEV)
        card_s = time.time() - t0
        in_use = mod.tables(DEV)
        card = norms(in_use)
        # the table in use may come from the disk cache of another device
        norm_key = "exp_score_norms" if name == "so3" else "score_norm"
        same = float(np.max(np.abs(fresh[norm_key] - card.cpu().numpy()) / np.abs(fresh[norm_key])))
        rows = sorted(set(idx.tolist()))
        t0 = time.time()
        host = torch.tensor([row_fn(i, "cpu") for i in rows])
        host_s = time.time() - t0
        got = card[rows].cpu()
        err = float(((got - host).abs() / host.abs()).max())
        print(f"  {name}: whole table built on the card in {card_s:.3f} s (score norms vs "
              f"the table in use: max rel diff {same:.2e}); {len(rows)} sampler rows on the CPU "
              f"in {host_s:.3f} s; max rel diff {err:.2e}", flush=True)
        if not same <= 1e-6 or not bool(torch.isfinite(card).all()) or not err <= 1e-6:
            raise AssertionError(f"{name} score-norm table on the card disagrees with the CPU")


def phase_profile(torch, sp, params, cfg, s_np, names=tuple(KERNELS), what="2 steps, B=16"):
    """Device time by kernel over 2 sampler steps of the 16-pose batch."""
    from torch.profiler import ProfilerActivity, profile

    from diffbindfr_torch.data.sample import stack_samples, to_device

    scfg = sp.SamplerConfig(actual_steps=2)
    batch = to_device(stack_samples([s_np] * 16), DEV)
    noise = sp.draw_noise(batch, scfg, torch.Generator(device=DEV).manual_seed(2))
    with torch.no_grad():
        sp.sample(params, cfg, scfg, batch, noise)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sp.sample(params, cfg, scfg, batch, noise)
            torch.cuda.synchronize()
            wall = time.time() - t0
    return report_profile(prof, wall, what, list(names), steps=2)


def report_profile(prof, wall, what, names, steps=None):
    """Device time by kernel, the share of `names`' kernels, the busy share;
    with `steps`, the kernel launches per step. Returns (device ms, busy
    share, trunk share, launches per step) or None."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((e.key, dev_us / 1e3, e.count))
    if not rows:
        print("  the profiler saw no device time: breakdown not measured", flush=True)
        return None
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    # a symbol that several of `names` launch (B4's and B6's split-K
    # contraction) is counted once, under the names that share it
    owners = {sym: tuple(k for k in names if sym in SYMBOLS[k]) for k in names
              for sym in SYMBOLS[k]}
    by_name = {k: sum(r[1] for r in rows if any(sym in r[0] for sym in SYMBOLS[k]
                                                if len(owners[sym]) == 1)) for k in names}
    for sym, ks in owners.items():
        if len(ks) > 1:
            label = f"{sym.rstrip('(<')} (shared by {', '.join(ks)})"
            by_name[label] = sum(r[1] for r in rows if sym in r[0])
    ours = sum(r[1] for r in rows if any(sym in r[0] for k in names for sym in SYMBOLS[k]))
    # kernels only: copies and fills are device work but no kernel launch
    kernels = sum(r[2] for r in rows if not r[0].startswith(("Memcpy", "Memset")))
    per_step = kernels / steps if steps else None
    print(f"  {what} under the profiler: wall {wall * 1e3:.1f} ms, device "
          f"{total:.1f} ms ({100 * total / (wall * 1e3):.1f}% busy), trunk kernels "
          f"{ours:.1f} ms ({100 * ours / total:.1f}% of device time)"
          + (f", {per_step:.0f} kernel launches per step" if steps else ""), flush=True)
    print("  trunk kernels' device time: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in by_name.items()), flush=True)
    for key, ms, cnt in rows[:12]:
        print(f"    {ms:9.3f} ms  x{cnt:<5d} {key[:90]}", flush=True)
    return total, total / (wall * 1e3), ours / total, per_step


def rm_inputs(torch, params, s_np, layer, bsz, seed):
    """Inputs of B7-B10 at one layer: phase 5's kernel inputs (returned as
    well), the layer's finalize parameters and the counts from the masks."""
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn.trunk_convs import _dist

    args = kernel_inputs(torch, params, s_np, layer, bsz, seed)
    lc = sn._layer_consts(sn.ScoreNetConfig())[layer]
    (_, lig_pos, _, lig_x, _, lig_mask, _, zero, _, temb, lig_cut, pair_params, bond_feat,
     bond_mask) = args["pair_conv"]
    _, _, atm_pos, _, atm_x, _, atm_mask, cab, _, cut, emb_cross, fc_al, fc_la = args["cross_conv"]
    _, _, _, _, idx, valid, _, knn_params = args["knn_conv"]
    lp = {k: params[f"{k}_convs"][layer] for k in ("lig", "al", "la", "atom")}

    def fin(k):
        return {"mix": lp[k]["mix"], "ln": lp[k]["ln"]}

    lm, am = lig_mask[:, :, None] > 0, atm_mask[:, None, :] > 0
    eye = torch.eye(lig_pos.shape[1], dtype=torch.bool, device=DEV)
    d = _dist(lig_pos[:, None, :, :] - lig_pos[:, :, None, :])
    m_ll = (((d <= lig_cut) & ~eye) | (bond_mask > 0)) & lm & (lig_mask[:, None, :] > 0)
    dc = _dist(atm_pos[:, None, :, :] - lig_pos[:, :, None, :])
    m_c = ((cab[:, None, :] > 0) | (dc <= cut[:, None, None])) & lm & am
    cnt_lig, cnt_al, cnt_la, cnt_atm = (torch.clamp(m.float().sum(dim), min=1.0) for m, dim in (
        (m_ll, 2), (m_c, 2), (m_c, 1), (valid, 2)))
    lparams = {"emb_lig": params["lig_edge_emb"], "emb_cross": params["la_edge_emb"],
               "emb_atom": params["atom_edge_emb"]}
    for t in lp:
        lparams.update({f"fc_{t}": lp[t]["fc"], f"mix_{t}": lp[t]["mix"], f"ln_{t}": lp[t]["ln"]})
    rm = {
        "cross_conv_fin": (lc.cross, lc.fin, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask,
                           cab, temb, cut, emb_cross, fc_al, fc_la, fin("al"), fin("la"), cnt_al,
                           cnt_la),
        "pair_conv_fin": (lc.lig, lc.fin, lig_pos, lig_pos, lig_x, lig_x, lig_mask, lig_mask, zero,
                          zero, temb, lig_cut, {**pair_params, **fin("lig")}, bond_feat,
                          bond_mask, cnt_lig),
        "knn_conv_fin": (lc.atom, lc.fin, atm_pos, atm_x, atm_mask, idx, valid, temb,
                         {**knn_params, **fin("atom")}),
        "layer_conv": (lc, lig_pos, atm_pos, lig_x, atm_x, lig_mask, atm_mask, cab, temb, cut,
                       bond_feat, bond_mask, idx, valid, cnt_lig, cnt_al, cnt_la, cnt_atm,
                       lparams),
    }
    return rm, args


def rm_work(torch, name, rm_args, args):
    """(FLOPs, bytes, pairs) of B7-B10 on these inputs: the pair work of the
    convs they run (work()), plus per finalized row the count divide (dout),
    the block-sparse mix (2 x its input rows per output column) and the
    LayerNorm (~8 x out_dim); each input read once, each output written once."""
    lc = rm_args[0] if name == "layer_conv" else None
    fin = lc.fin if lc is not None else rm_args[1]
    meta, _ = fin.tables
    mix = 2.0 * float(sum(int(r[3 + 3 * s_]) for r in meta for s_ in range(int(r[0]))))
    per_row = fin.spec.dw.out.dim + mix + 8.0 * fin.out_dim
    bsz, nl, na = args["cross_conv"][3].shape[0], args["cross_conv"][3].shape[1], \
        args["cross_conv"][4].shape[1]
    # convs run, rows finalized, rows written
    base, fin_rows, out_rows = {
        "cross_conv_fin": (["cross_conv"], nl + na, nl + na),
        "pair_conv_fin": (["pair_conv"], nl, nl),
        "knn_conv_fin": (["knn_conv"], na, na),
        "layer_conv": (["pair_conv", "cross_conv", "knn_conv"], 2 * (nl + na), nl + na)}[name]
    flops = pairs = 0.0
    for b in base:
        f_, _, p_ = work(torch, b, args[b])
        flops, pairs = flops + f_, pairs + p_
    flops += bsz * fin_rows * per_row
    tensors = [t for t in rm_args if torch.is_tensor(t) or isinstance(t, dict)]
    return flops, nbytes(*tensors) + 4.0 * bsz * out_rows * fin.out_dim, pairs


def phase_rm_kernels(torch, params, s_np, results):
    from diffbindfr_torch.nn import layer_conv as LC
    from diffbindfr_torch.nn import trunk_convs as TC

    plain = {"cross_conv_fin": TC.cross_conv_fin_plain, "pair_conv_fin": TC.pair_conv_fin_plain,
             "knn_conv_fin": TC.knn_conv_fin_plain, "layer_conv": LC.layer_conv_plain}
    wrapper = {"cross_conv_fin": TC.cross_conv_fin, "pair_conv_fin": TC.pair_conv_fin,
               "knn_conv_fin": TC.knn_conv_fin, "layer_conv": LC.layer_conv}
    for layer, bsz in ((0, 16), (5, 16)):
        rm, args = rm_inputs(torch, params, s_np, layer, bsz, seed=layer * 100 + bsz)
        for name in RM_KERNELS:
            a = rm[name]
            with torch.no_grad():
                got = wrapper[name](*a)
                ref = plain[name](*a)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(rel_err(g_, r_) for g_, r_ in zip(got, ref))
                abs_err = max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))
                finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
                ms = time_ms(lambda: wrapper[name](*a), 3, 10)
                dev_ms, dev_how = device_ms(torch, lambda: wrapper[name](*a), name)
                plain_ms = time_ms(lambda: plain[name](*a), 1, 2)
            flops, byts, pairs = rm_work(torch, name, a, args)
            bound_ms = max(flops / PEAK_FP32, byts / PEAK_BYTES) * 1e3
            row = dict(layer=layer, batch=bsz, max_rel_err=err, max_abs_err=abs_err, ms=ms,
                       device_ms=dev_ms, device_ms_method=dev_how, plain_ms=plain_ms,
                       bound_ms=bound_ms, pairs=pairs, flops=flops, bytes=byts,
                       bound_by="operations" if flops / PEAK_FP32 >= byts / PEAK_BYTES else "bytes")
            results.setdefault(name, []).append(row)
            print(f"  {name} layer {layer} B={bsz}: max|err|/max|ref| {err:.2e} "
                  f"kernel {fmt_ms(dev_ms)} ({dev_how}; wrapper {ms:.3f} ms) "
                  f"plain {plain_ms:.3f} ms "
                  f"bound {bound_ms:.3f} ms ({row['bound_by']}) pairs {pairs:.0f}", flush=True)
            if not finite or err > 1e-4:
                raise AssertionError(f"{name} layer {layer}: kernel disagrees with plain ({err:.3e})")
            if name == "layer_conv":
                row["blocks"] = layer_block_report(torch, LC, a, layer, bsz)
            if name == "cross_conv_fin":
                row["blocks"] = cross_block_report(torch, TC, name, wrapper[name], a)
            if name in ("knn_conv_fin", "pair_conv_fin"):
                row.update(grid_report(torch, TC, name, wrapper[name], a))


def layer_block_report(torch, LC, a, layer, bsz):
    """B10's two kinds of block (ligand rows: pair conv + al; atoms: knn
    conv + la): per kind the blocks, their 64-pair tiles and how full they
    are (the plan model, layer_tile_plan, on these inputs), and the share
    of the blocks' clock64() cycles (one launch with `cycles`) and the
    longest block against the mean; each block's cycles are its SM's time
    on it, so the shares say where the card's time goes."""
    lc, lig_pos, atm_pos, _, _, lig_mask, atm_mask, cab, _, cut, _, bm, idx, valid = a[:14]
    with torch.no_grad():
        LC._layer_kernel(*a)
        g_l, g_a = LC.layer_conv_stats["groups"]
        plan = LC.layer_tile_plan(lig_pos, atm_pos, lig_mask, atm_mask, cab, lc.lig.gs_stop, cut,
                                  bm, idx, valid, g_l, g_a)
        cycles = torch.zeros(len(plan), dtype=torch.int64, device=DEV)
        LC._layer_kernel(*a, cycles=cycles)
        torch.cuda.synchronize()
    cyc = cycles.double().cpu()
    out = {}
    for kind, what in (("lig", f"ligand-row blocks ({g_l} rows: pair conv, al)"),
                       ("atom", f"atom-row blocks ({g_a} atoms: knn conv, la)")):
        sel = [i for i, blk in enumerate(plan) if blk.kind == kind]
        tiles = sum(len(t) for i in sel for t in plan[i].tiles.values())
        pairs = sum(len(p) for i in sel for t in plan[i].tiles.values() for p in t)
        c = cyc[sel]
        out[kind] = dict(blocks=len(sel), tiles=tiles, pairs=pairs,
                         tile_fill=pairs / max(1, tiles * LC.WIDE_TILE),
                         cycle_share=float(c.sum() / cyc.sum()),
                         longest_over_mean=float(c.max() / c.mean()))
        print(f"    {what}: {len(sel)} blocks, {tiles} tiles of {pairs} pairs "
              f"({100 * out[kind]['tile_fill']:.1f}% full), "
              f"{100 * out[kind]['cycle_share']:.1f}% of the block cycles, longest block "
              f"{out[kind]['longest_over_mean']:.2f}x the mean", flush=True)
    out["smem_bytes"] = LC.layer_conv_stats["smem_bytes"]
    return out


def rm_config(sn, mode, **kw):
    import dataclasses

    return dataclasses.replace(sn.ScoreNetConfig(**kw), **RM_MODES[mode][0])


def phase_rm_forward(torch, np, sn, params, s_np):
    ref = np.load(FIXTURE)
    fs = s_np._replace(lig_pos=(s_np.lig_pos + ref["shift"]) * s_np.lig_mask[:, None])
    from diffbindfr_torch.data.sample import stack_samples, to_device

    batch = to_device(stack_samples([fs]), DEV)
    t = torch.tensor([float(ref["t"])], device=DEV)
    sig = sn.sigmas_from_t(t, SCHED)
    modes = {"rowmajor": rm_config(sn, "cmt", pallas_layout="rowmajor"),
             "rowmajor+fused_epilogue": rm_config(sn, "fused_epilogue"),
             "rowmajor+fused_layer": rm_config(sn, "fused_layer")}
    bad = []
    for name, cfg in modes.items():
        with torch.no_grad():
            out = sn.apply(params, cfg, batch, t, sig, use_kernels=True)
            ms = time_ms(lambda: sn.apply(params, cfg, batch, t, sig, use_kernels=True), 1, 3)
        errs = {f: rel_err(getattr(out, f)[0], torch.from_numpy(ref[f]).to(DEV))
                for f in ("tr", "rot", "tor", "sc_tor")}
        print(f"  {name}: vs JAX fixture " + " ".join(f"{f} {e:.2e}" for f, e in errs.items())
              + f"; full-width forward B=1 {ms:.2f} ms", flush=True)
        bad += [f"{name}/{f}" for f, e in errs.items() if not e <= 1e-3]
    if bad:
        raise AssertionError(f"forward disagrees with the JAX fixture on {bad}")


def phase_rm_dock(torch, np, sn, sp, pipeline, TC, params, s_np, smi):
    """The dock in the three configurations, in turns; returns each
    configuration's launch counts."""
    from diffbindfr_torch.geometry.kabsch import masked_rmsd

    prepared = [pipeline.PreparedPair.from_prep_cache(SAMPLE)]
    scfg = sp.SamplerConfig()
    cfgs = {m: rm_config(sn, m) for m in RM_MODES}
    n_poses, want_n = 16, cfgs["cmt"].num_conv_layers * scfg.actual_steps
    for m, cfg in cfgs.items():  # warm-up: 2 steps of each
        pipeline.dock(prepared, params, cfg, sp.SamplerConfig(actual_steps=2), num_poses=n_poses,
                      batch_size=n_poses, seed=1, device=DEV, verbose=False)
    torch.cuda.synchronize()
    rates, poses, counts = {m: [] for m in cfgs}, {}, {}
    for m in ("cmt", "fused_epilogue", "fused_layer", "fused_layer", "fused_epilogue", "cmt"):
        TC.reset_launches()
        t0 = time.time()
        res = pipeline.dock(prepared, params, cfgs[m], scfg, num_poses=n_poses,
                            batch_size=n_poses, seed=0, device=DEV, verbose=False)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts[m] = dict(TC.launches)
        lig = np.stack([r.lig_pos for r in res])
        finite = bool(np.isfinite(lig).all() and all(np.isfinite(r.atom14_pos).all() for r in res))
        rates[m].append(n_poses / dt)
        poses[m] = lig
        want = {k: (want_n if k in RM_MODES[m][1] else 0) for k in TC.launches}
        print(f"  {m}: {n_poses} poses, {scfg.actual_steps} steps in {dt:.3f} s: "
              f"{n_poses / dt:.3f} poses/s; launches {counts[m]}", flush=True)
        if counts[m] != want:
            raise AssertionError(f"{m}: launch counts {counts[m]}, expected {want}")
        if not finite:
            raise AssertionError(f"{m}: non-finite poses")
    mask = torch.from_numpy(s_np.lig_mask[None].repeat(n_poses, 0)).to(DEV)
    for m in ("fused_epilogue", "fused_layer"):
        d = masked_rmsd(torch.from_numpy(poses[m]).to(DEV), torch.from_numpy(poses["cmt"]).to(DEV),
                        mask)
        print(f"  {m} vs cmt, same noise, per-pose RMSD (A): median {float(d.median()):.2e}, "
              f"max {float(d.max()):.2e}", flush=True)
    print("  poses/s on " + smi + ": " + "; ".join(
        f"{m} " + ", ".join(f"{r:.3f}" for r in v) for m, v in rates.items()), flush=True)
    return counts


def phase_rm_profile(torch, sn, sp, params, s_np, cmt):
    """Phase 8's profile (the same batch, noise and steps; its cmt numbers
    are `cmt`) for the two row-major configurations, warmed by rm_dock."""
    from torch.profiler import ProfilerActivity, profile

    from diffbindfr_torch.data.sample import stack_samples, to_device

    scfg = sp.SamplerConfig(actual_steps=2)
    batch = to_device(stack_samples([s_np] * 16), DEV)
    noise = sp.draw_noise(batch, scfg, torch.Generator(device=DEV).manual_seed(2))
    out = {"cmt": cmt}
    for m, (_, names) in RM_MODES.items():
        if m == "cmt":
            continue
        cfg = rm_config(sn, m)
        with torch.no_grad():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                sp.sample(params, cfg, scfg, batch, noise)
                torch.cuda.synchronize()
                wall = time.time() - t0
        out[m] = report_profile(prof, wall, f"{m}: 2 steps, B=16", list(names), steps=2)
    print("  per step (device ms, busy share, trunk share, kernel launches): " + "; ".join(
        f"{m} " + ("not measured" if v is None else
                   f"{v[0] / 2:.1f} ms, {100 * v[1]:.1f}%, {100 * v[2]:.1f}%, {v[3]:.0f}")
        for m, v in out.items()), flush=True)


class DecisionLog:
    """The score net's ReLU decisions in one loss-and-gradient run: every MLP
    pre-activation z (the trunk convs' plain versions through
    trunk_convs._mlp2, embeddings and heads through layers.mlp_apply), keyed
    by (trunk layer, first-layer weight, call), so that two runs of the same
    configuration line up whichever order they evaluate the layers in (the
    kernel path recomputes each layer's plain version in its backward, last
    layer first). `flips` = {key: bool mask}: positions whose ReLU derivative
    the backward takes the other way."""

    def __init__(self, torch, TC, L, LC):
        self.torch, self.TC, self.L, self.LC = torch, TC, L, LC
        self.z, self.flips, self._seen, self._layer = {}, {}, {}, None

    def _relu(self, z, w1):
        key = (self._layer, w1.data_ptr(), self._seen.get((self._layer, w1.data_ptr()), 0))
        self._seen[key[:2]] = key[2] + 1
        self.z[key] = z.detach()
        return flip_relu(self.torch).apply(z, self, key)

    @contextlib.contextmanager
    def patched(self, plain_layer=False):
        TC, L, LC = self.TC, self.L, self.LC
        saved = TC._mlp2, L.mlp_apply, LC.layer_conv_plain, LC.layer_conv
        torch = self.torch

        def mlp2(w1, b1, w2, b2, x):
            return self._relu(x @ w1 + b1, w1) @ w2 + b2

        def mlp_apply(p, x, act=torch.relu):
            z = L.linear_apply(p["l1"], x)
            h = self._relu(z, p["l1"]["w"]) if act is torch.relu else act(z)
            return L.linear_apply(p["l2"], h)

        def layer_plain(*args):
            self._layer = args[-1]["fc_lig"]["l1"]["w"].data_ptr()
            try:
                return saved[2](*args)
            finally:
                self._layer = None

        TC._mlp2, L.mlp_apply, LC.layer_conv_plain = mlp2, mlp_apply, layer_plain
        if plain_layer:
            LC.layer_conv = layer_plain
        try:
            yield self
        finally:
            TC._mlp2, L.mlp_apply, LC.layer_conv_plain, LC.layer_conv = saved


@functools.lru_cache(maxsize=None)
def flip_relu(torch):
    """ReLU whose derivative follows a DecisionLog's flips at backward time."""

    class FlipRelu(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, log, key):
            ctx.save_for_backward(z)
            ctx.log, ctx.key = weakref.ref(log), key  # the log holds no graph
            return torch.relu(z)

        @staticmethod
        def backward(ctx, g):
            (z,) = ctx.saved_tensors
            on = z > 0
            flip = ctx.log().flips.get(ctx.key)
            if flip is not None:
                on = on ^ flip
            return torch.where(on, g, torch.zeros_like(g)), None, None

    return FlipRelu


def phase_rm_grad(torch, sn, params, s_np):
    """Gradients of the train loss (B = 1, fixed noise) in the fused_layer
    configuration: the kernel path (B10 forward, its backward recomputing the
    plain version) against the same configuration with B10's plain version,
    every parameter gradient within 1e-3 max|ref|. The reference may take the
    kernel path's ReLU decision only where the two runs' pre-activations of
    one (pair, unit) straddle 0 while agreeing to 1e-4 of the call's max|z|
    (f32 rounding: one such pair can move a gradient tensor by ~1e-2 at
    B = 1), and nowhere else; each such decision is printed. The plain XLA
    path (use_kernels=False: another formulation, whose decisions cannot be
    lined up) is printed beside it."""
    from diffbindfr_torch import train
    from diffbindfr_torch.data.sample import stack_samples, to_device
    from diffbindfr_torch.nn import layer_conv as LC
    from diffbindfr_torch.nn import layers as L
    from diffbindfr_torch.nn import trunk_convs as TC
    from diffbindfr_torch.sampler import SamplerConfig

    cfg, tcfg, scfg = rm_config(sn, "fused_layer"), train.TrainConfig(), SamplerConfig()
    batch = to_device(stack_samples([s_np]), DEV)
    noise = train.draw_noise(batch, tcfg, torch.Generator(device=DEV).manual_seed(13))

    def grads(log, plain_layer):
        leaves = [p.detach().requires_grad_(True) for p in train.tree_leaves(params)]
        with log.patched(plain_layer):
            loss, _ = train.loss_fn(train.tree_unflatten(params, leaves), cfg, scfg, tcfg, batch,
                                    noise, use_kernels=True)
            g = torch.autograd.grad(loss, leaves, allow_unused=True, retain_graph=True)
        return loss, leaves, [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]

    TC.reset_launches()
    kern = DecisionLog(torch, TC, L, LC)
    loss_k, _, gk = grads(kern, False)
    launches = TC.launches["layer_conv"]
    ref = DecisionLog(torch, TC, L, LC)
    loss_r, leaves, graw = grads(ref, True)
    torch.cuda.synchronize()
    if set(kern.z) != set(ref.z) or any(kern.z[k].shape != ref.z[k].shape for k in ref.z):
        raise AssertionError("the two runs' ReLU decisions do not line up")
    flips, worst_dz, taken = {}, 0.0, []
    for key, zr in ref.z.items():
        zk = kern.z[key]
        scale = float(zr.abs().max().clamp_min(1e-30))
        worst_dz = max(worst_dz, float((zk - zr).abs().max()) / scale)
        d = (zk > 0) != (zr > 0)
        if bool(d.any()):
            flips[key] = d
            for pos in torch.nonzero(d.reshape(-1)).reshape(-1).tolist():
                taken.append((key, pos, float(zk.reshape(-1)[pos]), float(zr.reshape(-1)[pos]),
                              scale))
    ref.flips = flips
    leaves_g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, torch.autograd.grad(
        loss_r, leaves, allow_unused=True))]
    paths = param_paths(params)
    keep = [i for i, b in enumerate(graw) if b.numel() and float(b.abs().max()) > 0]
    raw = {paths[i]: rel_err(gk[i], graw[i]) for i in keep}
    tie = {paths[i]: rel_err(gk[i], leaves_g[i]) for i in keep}
    _, gx = train.loss_and_grads(params, batch, noise, cfg, scfg, tcfg, use_kernels=False)
    xla = {paths[i]: rel_err(gk[i], gx[i]) for i in keep if float(gx[i].abs().max()) > 0}
    names = {t.data_ptr(): n for t, n in zip(train.tree_leaves(params), paths)}
    for (layer, w1, call), pos, zk, zr, scale in taken:
        where = f" in the layer of {names[layer]}" if layer is not None else ""
        print(f"  ReLU decision taken the kernel path's way: {names[w1]}{where}, call {call}, "
              f"position {pos}: z {zk:.3e} (kernel path) vs {zr:.3e} (plain), max|z| "
              f"{scale:.3g}", flush=True)
    w_raw, w_tie, w_xla = (max(d_, key=d_.get) for d_ in (raw, tie, xla))
    print(f"  B10 launches {launches}; loss {float(loss_k.detach()):.6g} vs "
          f"{float(loss_r.detach()):.6g}; "
          f"pre-activations agree to {worst_dz:.2e} of each call's max|z| "
          f"({sum(z.numel() for z in ref.z.values())} in {len(ref.z)} calls); parameter "
          f"gradients over {len(keep)} tensors, max|err|/max|ref|: {raw[w_raw]:.2e} ({w_raw}), "
          f"{tie[w_tie]:.2e} ({w_tie}) with the {len(taken)} decisions above; against the "
          f"XLA plain path {xla[w_xla]:.2e} ({w_xla})", flush=True)
    bad = [t for t in taken if not abs(t[2] - t[3]) <= 1e-4 * t[4]]
    if launches != cfg.num_conv_layers or bad or not tie[w_tie] <= 1e-3:
        raise AssertionError(f"fused_layer gradients disagree with the plain version: "
                             f"{tie[w_tie]:.3e} ({w_tie}); {len(bad)} decisions beyond rounding; "
                             f"{launches} launches")


def phase_probe_bf16(torch, results):
    """P1: each variant's kernel against its plain chain, then the sweep
    times; returns the bf16x2 mul/add rate (rounded operations per second)
    at the size that fills the card."""
    from diffbindfr_torch.probes import bf16_chain as P

    tols = {"f32_fma": 1e-5, "bf16x2_mul_add": 0.0, "bf16x2_fma": 2.0 ** -8}
    checks = {}
    for v in P.VARIANTS:
        x, w = P.inputs(256, 1024, v, DEV)
        got = P.chain(x, w, 8, v).float()
        ref = P.chain_plain(x, w, 8, v).float()
        torch.cuda.synchronize()
        err, abs_err = rel_err(got, ref), float((got - ref).abs().max())
        checks[v] = (err, abs_err)
        print(f"  {v}: kernel vs plain at 8 steps, max|err|/max|ref| {err:.2e}", flush=True)
        if not bool(torch.isfinite(got).all()) or err > tols[v]:
            raise AssertionError(f"probe {v}: kernel disagrees with plain ({err:.3e})")
    rate = None
    for rows in (256, 8192):
        P.reset_launches()
        res = P.measure(rows=rows, lanes=1024, reps=2000, iters=20, device=DEV)
        launches = dict(P.launches)
        if not all(launches.values()):
            raise AssertionError(f"probe kernels not launched: {launches}")
        for v, r in res.items():
            elems, dt = rows * 1024, P.dtype_of(v)
            x, w = P.inputs(rows, 1024, v, DEV)
            plain_ms = time_ms(lambda: P.chain_plain(x, w, r["reps"], v), 0, 1)
            # each step: a multiply and two adds per element (an fma counts 2)
            ops = 3.0 * elems * r["reps"]
            peak = {"f32_fma": PEAK_FP32, "bf16x2_mul_add": PEAK_BF16X2_ROUNDED,
                    "bf16x2_fma": PEAK_BF16X2}[v]
            byts = 3.0 * elems * torch.finfo(dt).bits / 8
            bound_ms = max(ops / peak, byts / PEAK_BYTES) * 1e3
            print(f"  {v} {rows} x 1024: {r['ms_r']:.4f} ms at {r['reps']} steps, "
                  f"{r['ms_2r']:.4f} ms at {2 * r['reps']}: {r['us_per_sweep']:.4f} us per sweep, "
                  f"{r['gflops']:.0f} GFLOP/s (2 per element), {r['gops']:.0f} G rounded "
                  f"operations/s; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms", flush=True)
            if rows == 8192:
                dev_ms, dev_how = device_ms(torch, lambda: P.chain(x, w, r["reps"], v),
                                                   f"probe_bf16/{v}")
                print(f"  {v} {rows} x 1024 at {r['reps']} steps: kernel {fmt_ms(dev_ms)} "
                      f"({dev_how})", flush=True)
                results[f"probe_bf16/{v}"] = dict(
                    r, launches=launches[f"probe_bf16/{v}"], max_rel_err=checks[v][0],
                    max_abs_err=checks[v][1], ms=r["ms_r"], device_ms=dev_ms,
                    device_ms_method=dev_how, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="operations" if ops / peak >= byts / PEAK_BYTES
                    else "bytes")
        rate = res["bf16x2_mul_add"]["gops"] * 1e9
        f32 = res["f32_fma"]["gflops"]
        print(f"  {rows} x 1024: bf16x2 mul/add {res['bf16x2_mul_add']['gflops'] / f32:.2f}x, "
              f"bf16x2 fma {res['bf16x2_fma']['gflops'] / f32:.2f}x the f32 fma rate", flush=True)
    return rate


def chain_ops(c):
    """Per pair and TP-weight MLP of a conv: (fp32 operations of the f32
    chain as work() counts them, fp32 operations of the B11 chain: cb =
    sh @ ck and one add per output column into the pair sums, bf16
    operations of the B11 chain: per output column d1 products x * w, d1
    products by cb and d1 - 1 adds)."""
    ck, meta = c.tables
    f32_chain = float(sum(2 * int(m[2]) + 2 for m in meta)) + 2 * 9 * ck.shape[1]
    b11_f32 = 2.0 * 9 * ck.shape[1] + len(meta)
    b11_bf16 = float(sum(3 * int(m[2]) - 1 for m in meta))
    return f32_chain, b11_f32, b11_bf16


def b11_bound(torch, twin, a):
    """B11's bound on the inputs `a` of its f32 twin: the chain's bf16
    operations at the card's peak for separately rounded bf16x2 operations,
    its fp32 operations at the fp32 peak, against its bytes at the HBM rate.
    Returns (bound ms, "operations" or "bytes", pairs, fp32 operations, bf16
    operations, bytes)."""
    flops, byts, pairs = work(torch, twin, a)
    f32_chain, b11_f32, b11_bf16 = chain_ops(a[0])
    n_tp = 2 if twin == "cross_conv" else 1
    ops32 = flops - pairs * n_tp * (f32_chain - b11_f32)
    ops16 = pairs * n_tp * b11_bf16
    t_ops = ops32 / PEAK_FP32 + ops16 / PEAK_BF16X2_ROUNDED
    t_bytes = byts / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", pairs,
            ops32, ops16, byts)


def phase_bf16_kernels(torch, params, s_np, results, bf16_rate):
    """B11 against its plain bf16 version at the dock shapes, on the
    bf16-rounded weights the score net hands the kernels. The bound takes
    the chain's bf16 operations at the card's peak for separately rounded
    bf16x2 operations; `bf16_rate`, P1's measured mul/add rate, is printed
    beside it."""
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import trunk_convs as TC

    f32 = {k: getattr(TC, v[2]) for k, v in BF16_KERNELS.items()}
    wrapper = {k: functools.partial(fn, bf16_chain=True) for k, fn in f32.items()}
    plain = {k: functools.partial(getattr(TC, v[2] + "_plain"), bf16_chain=True)
             for k, v in BF16_KERNELS.items()}
    print(f"  bound rates: fp32 {PEAK_FP32:.3g}/s, bf16 rounded operations "
          f"{PEAK_BF16X2_ROUNDED:.3g}/s (P1 measured {bf16_rate:.3g}/s)", flush=True)
    p16 = sn._cast_f32_leaves(params, torch.bfloat16)
    for layer, bsz in ((0, 16), (5, 16)):
        args = kernel_inputs(torch, p16, s_np, layer, bsz, seed=layer * 100 + bsz)
        for name, (_, _, twin) in BF16_KERNELS.items():
            a = args[twin]
            with torch.no_grad():
                got, ref, g32 = (fn(*a) for fn in (wrapper[name], plain[name], f32[name]))
                torch.cuda.synchronize()
                got, ref, g32 = ((x if isinstance(x, tuple) else (x,)) for x in (got, ref, g32))
                err = max(rel_err(g_, r_) for g_, r_ in zip(got, ref))
                abs_err = max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))
                # the control: the f32 kernel (B1-B3) against the plain bf16 version
                ctl = max(rel_err(g_, r_) for g_, r_ in zip(g32, ref))
                finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
                # rows of masked targets: exactly 0
                masks = {"pair_conv_bf16": (a[5],), "cross_conv_bf16": (a[5], a[6]),
                         "knn_conv_bf16": (a[5].sum(-1),)}[name]
                dead = all(bool((g_[m_ <= 0] == 0).all()) for g_, m_ in zip(got, masks))
                ms = time_ms(lambda: wrapper[name](*a), 3, 10)
                dev_ms, dev_how = device_ms(torch, lambda: wrapper[name](*a), name)
                plain_ms = time_ms(lambda: plain[name](*a), 1, 2)
            bound_ms, bound_by, pairs, ops32, ops16, byts = b11_bound(torch, twin, a)
            row = dict(layer=layer, batch=bsz, max_rel_err=err, max_abs_err=abs_err,
                       control=ctl, ms=ms, device_ms=dev_ms, device_ms_method=dev_how,
                       plain_ms=plain_ms,
                       bound_ms=bound_ms, pairs=pairs, fp32_ops=ops32, bf16_ops=ops16, bytes=byts,
                       bound_by=bound_by)
            results.setdefault(name, []).append(row)
            print(f"  {name} layer {layer} B={bsz}: max|err|/max|ref| {err:.2e} (control: the "
                  f"f32 kernel {ctl:.2e}) kernel {fmt_ms(dev_ms)} ({dev_how}; wrapper {ms:.3f} ms) "
                  f"plain "
                  f"{plain_ms:.3f} ms bound "
                  f"{bound_ms:.3f} ms ({row['bound_by']}; {ops32:.3g} fp32 + {ops16:.3g} bf16 "
                  f"operations) pairs {pairs:.0f}", flush=True)
            if not finite or not dead or err > BF16_GATE:
                raise AssertionError(f"{name} layer {layer}: kernel disagrees with plain "
                                     f"({err:.3e}, dead rows zero: {dead})")
            if not BF16_GATE < ctl:
                raise AssertionError(f"{name} layer {layer}: the gate {BF16_GATE:g} cannot tell "
                                     f"the bf16 chain from f32 (control {ctl:.3e})")
            # same bits, graph capture, their blocks
            row.update(grid_report(torch, TC, name, wrapper[name], a))


def phase_bf16_forward(torch, np, sn, TC, params, s_np):
    ref, ref32 = np.load(FIXTURE_BF16), np.load(FIXTURE)
    fs = s_np._replace(lig_pos=(s_np.lig_pos + ref["shift"]) * s_np.lig_mask[:, None])
    from diffbindfr_torch.data.sample import stack_samples, to_device

    batch = to_device(stack_samples([fs]), DEV)
    t = torch.tensor([float(ref["t"])], device=DEV)
    sig = sn.sigmas_from_t(t, SCHED)
    cfg = sn.ScoreNetConfig(compute_dtype="bfloat16")
    TC.reset_launches()
    with torch.no_grad():
        out = sn.apply(params, cfg, batch, t, sig, use_kernels=True)
        torch.cuda.synchronize()
        counts = dict(TC.launches)
        ms = time_ms(lambda: sn.apply(params, cfg, batch, t, sig, use_kernels=True), 1, 3)
        # the control: the f32 forward, which is what ignoring compute_dtype gives
        out32 = sn.apply(params, sn.ScoreNetConfig(), batch, t, sig, use_kernels=True)
    bad = []
    for f, tol in BF16_FORWARD_TOL.items():
        got, ref16 = getattr(out, f)[0], torch.from_numpy(ref[f]).to(DEV)
        err, ctl = rel_err(got, ref16), rel_err(getattr(out32, f)[0], ref16)
        err32 = rel_err(got, torch.from_numpy(ref32[f]).to(DEV))
        print(f"  {f}: vs the JAX bf16 fixture {err:.2e} (bound {tol:g}); the f32 forward vs "
              f"it (control) {ctl:.2e}; vs the f32 fixture {err32:.2e}", flush=True)
        if not bool(torch.isfinite(got).all()) or not err <= tol or (
                f in BF16_SEPARATING and not tol < ctl):
            bad.append(f)
    want = {k: cfg.num_conv_layers if k in BF16_KERNELS else 0 for k in TC.launches}
    print(f"  full-width bf16 forward B=1: {ms:.2f} ms; launches {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if bad:
        raise AssertionError(f"bf16 forward disagrees with the JAX fixture on {bad}")


def phase_bf16_dock(torch, np, sn, sp, pipeline, TC, params, s_np, smi, cmt_profile):
    """The f32 cmt dock and the bf16 dock in turns, then phase 8's profile
    of the bf16 dock (`cmt_profile`: phase 8's f32 numbers); returns the
    bf16 dock's launch counts."""
    prepared = [pipeline.PreparedPair.from_prep_cache(SAMPLE)]
    scfg = sp.SamplerConfig()
    cfgs = {"f32": sn.ScoreNetConfig(), "bf16": sn.ScoreNetConfig(compute_dtype="bfloat16")}
    names = {"f32": tuple(KERNELS), "bf16": tuple(BF16_KERNELS)}
    n_poses, want_n = 16, cfgs["f32"].num_conv_layers * scfg.actual_steps
    for m, cfg in cfgs.items():  # warm-up: 2 steps of each
        pipeline.dock(prepared, params, cfg, sp.SamplerConfig(actual_steps=2), num_poses=n_poses,
                      batch_size=n_poses, seed=1, device=DEV, verbose=False)
    torch.cuda.synchronize()
    rates, counts = {m: [] for m in cfgs}, {}
    mask = s_np.lig_mask > 0
    for m in ("f32", "bf16", "bf16", "f32"):
        TC.reset_launches()
        t0 = time.time()
        res = pipeline.dock(prepared, params, cfgs[m], scfg, num_poses=n_poses,
                            batch_size=n_poses, seed=0, device=DEV, verbose=False)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts[m] = dict(TC.launches)
        lig = np.stack([r.lig_pos for r in res])
        finite = bool(np.isfinite(lig).all() and all(np.isfinite(r.atom14_pos).all() for r in res))
        rates[m].append(n_poses / dt)
        rmsd = np.sqrt(((lig[:, mask] - s_np.lig_pos[mask]) ** 2).sum(-1).mean(-1))
        want = {k: (want_n if k in names[m] else 0) for k in TC.launches}
        print(f"  {m}: {n_poses} poses, {scfg.actual_steps} steps in {dt:.3f} s: "
              f"{n_poses / dt:.3f} poses/s; RMSD to the prep-cache pose min {rmsd.min():.3f} A, "
              f"median {np.median(rmsd):.3f} A; launches {counts[m]}", flush=True)
        if counts[m] != want:
            raise AssertionError(f"{m}: launch counts {counts[m]}, expected {want}")
        if not finite:
            raise AssertionError(f"{m}: non-finite poses")
    print("  poses/s on " + smi + ": " + "; ".join(
        f"{m} " + ", ".join(f"{r:.3f}" for r in v) for m, v in rates.items()), flush=True)
    prof = {"f32": cmt_profile,
            "bf16": phase_profile(torch, sp, params, cfgs["bf16"], s_np, BF16_KERNELS,
                                  "bf16: 2 steps, B=16")}
    print("  per step (device ms, busy share, trunk share, kernel launches): " + "; ".join(
        f"{m} " + ("not measured" if v is None else
                   f"{v[0] / 2:.1f} ms, {100 * v[1]:.1f}%, {100 * v[2]:.1f}%, {v[3]:.0f}")
        for m, v in prof.items()), flush=True)
    return counts["bf16"]

def fixture_pose_results(np, pipeline, vec, stage):
    """(prepared, PoseResults) of the EC fixture's 3dbs and 3mhw poses
    (`stage`: pose0 before EC, ec_pos after), with the pocket's atom14."""
    prepared, res = [], []
    for i, n in enumerate(EC_NAMES):
        pair = pipeline.PreparedPair.from_prep_cache(os.path.join(PREP, f"{n}_r12.npz"))
        a14 = np.zeros(pair.sample.atom14_mask.shape + (3,), np.float32)
        a14[: pair.pocket.num_res] = pair.pocket.atom14_pos * pair.pocket.atom14_mask[..., None]
        prepared.append(pair)
        res += [pipeline.PoseResult(i, k, lp.copy(), a14, None)
                for k, lp in enumerate(vec[f"{n}|{stage}"])]
    return prepared, res


def phase_ec_mdn_ref(torch, np, pipeline, mdn_params, smi):
    """EC and MDN on the card against the JAX fixtures (tests/fixtures/
    torch_ec_ref.npz, torch_mdn_ref.npz): EC positions over real atoms
    <= EC_POS_GATE A, affinity <= EC_AFF_GATE relative; MDN on the
    fixture's poses before and after EC <= MDN_GATE relative. The control:
    how far EC moved the poses and how much it changed the scores."""
    from diffbindfr_torch.models import mdn_scorer as mdn

    ec, ref = np.load(FIXTURE_EC), np.load(FIXTURE_MDN)
    prepared, res = fixture_pose_results(np, pipeline, ec, "pose0")
    bsz = ec[EC_NAMES[0] + "|pose0"].shape[0]
    t0 = time.time()
    pipeline.error_correct(prepared, res, steps=150, batch_size=bsz, device=DEV, verbose=False)
    torch.cuda.synchronize()
    print(f"  EC: {len(res)} poses, 150 steps, 2 batches of {bsz} in {time.time() - t0:.3f} s "
          f"(first call) on {smi}", flush=True)
    bad = []
    for i, n in enumerate(EC_NAMES):
        mask = prepared[i].sample.lig_mask > 0
        got = np.stack([r.lig_pos for r in res if r.pair_idx == i])
        aff = np.array([r.vina_score for r in res if r.pair_idx == i])
        pos_err = float(np.abs(got - ec[n + "|ec_pos"])[:, mask].max())
        aff_err = float(np.abs(aff - ec[n + "|ec_aff"]).max() / np.abs(ec[n + "|ec_aff"]).max())
        moved = float(np.abs(ec[n + "|pose0"] - ec[n + "|ec_pos"])[:, mask].max())
        print(f"  {n} EC: positions vs JAX {pos_err:.2e} A (gate {EC_POS_GATE}; control: EC "
              f"moved atoms up to {moved:.3f} A), affinity vs JAX {aff_err:.2e} relative "
              f"(gate {EC_AFF_GATE})", flush=True)
        if not (pos_err <= EC_POS_GATE and aff_err <= EC_AFF_GATE and moved > EC_POS_GATE):
            bad.append(f"EC {n}")
    cfg = mdn.MDNConfig()
    for stage, key in (("before", "pose0"), ("after", "ec_pos")):
        prepared, res = fixture_pose_results(np, pipeline, ec, key)
        pipeline.score_mdn(prepared, res, mdn_params, cfg, batch_size=bsz, device=DEV,
                           verbose=False)
        for i, n in enumerate(EC_NAMES):
            for f, attr in (("sum_prob", "mdn_score"), ("mean_nll", "mdn_nll")):
                got = np.array([getattr(r, attr) for r in res if r.pair_idx == i])
                want = ref[f"{n}|{stage}|{f}"]
                err = float(np.abs(got - want).max() / np.abs(want).max())
                other = ref[f"{n}|{'after' if stage == 'before' else 'before'}|{f}"]
                ctrl = float(np.abs(other - want).max() / np.abs(want).max())
                print(f"  {n} MDN {stage} EC, {f}: vs JAX {err:.2e} relative (gate {MDN_GATE}; "
                      f"control: the other stage's scores differ by {ctrl:.2e})", flush=True)
                if not err <= MDN_GATE:
                    bad.append(f"MDN {n} {stage} {f}")
    if bad:
        raise AssertionError(f"EC/MDN disagree with the JAX fixtures: {bad}")


def phase_score_chain(torch, np, pipeline, prepared, docked, mdn_params, smi):
    """Phase 7's docked poses -> error_correct (150 steps) -> score_mdn on
    the card: every score finite, every pose's Vina energy (inter + intra)
    after EC no higher than before; ms per EC and per MDN batch, then the
    launches per EC step and the card's busy share over a few EC steps
    under torch.profiler."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from diffbindfr_torch.models import mdn_scorer as mdn
    from diffbindfr_torch.ops import vina

    pair, bsz = prepared[0], len(docked)
    b = pair.bucket
    ligs = vina.stack_to_device([vina.build_ligand(pair.lig, b.n_lig, b.n_tor)] * bsz, DEV)
    recs = vina.stack_to_device([vina.build_receptor(pair.pocket, b.n_atm)] * bsz, DEV)

    def energy(res):
        lp = torch.from_numpy(np.stack([r.lig_pos for r in res])).to(DEV)
        with torch.no_grad():
            return (vina.inter_energy(lp, ligs, recs) + vina.intra_energy(lp, ligs)).cpu().numpy()

    cfg = mdn.MDNConfig()
    warm = copy.deepcopy(docked)  # first calls: allocator and libraries
    pipeline.error_correct(prepared, warm, steps=150, batch_size=bsz, device=DEV, verbose=False)
    pipeline.score_mdn(prepared, warm, mdn_params, cfg, batch_size=bsz, device=DEV,
                       verbose=False)
    torch.cuda.synchronize()
    res = copy.deepcopy(docked)
    e0 = energy(res)
    t0 = time.time()
    pipeline.error_correct(prepared, res, steps=150, batch_size=bsz, device=DEV, verbose=False)
    torch.cuda.synchronize()
    ec_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    pipeline.score_mdn(prepared, res, mdn_params, cfg, batch_size=bsz, device=DEV,
                       verbose=False)
    torch.cuda.synchronize()
    mdn_ms = (time.time() - t0) * 1e3
    e1 = energy(res)
    vs = np.array([r.vina_score for r in res])
    sp_ = np.array([r.mdn_score for r in res])
    nll = np.array([r.mdn_nll for r in res])
    mask = pair.sample.lig_mask > 0
    moved = np.sqrt(((np.stack([r.lig_pos for r in res]) - np.stack(
        [r.lig_pos for r in docked])) ** 2).sum(-1)[:, mask].mean(-1))
    n_tor = pair.lig.num_torsions
    print(f"  {bsz} docked poses of {pair.name} ({n_tor} torsions of the bucket's {b.n_tor} "
          f"visited): EC 150 steps {ec_ms:.1f} ms per batch of {bsz} "
          f"({ec_ms / 150:.2f} ms per step), MDN {mdn_ms:.1f} ms per batch of {bsz}, on {smi}",
          flush=True)
    print("  Vina energy before -> after EC: " + ", ".join(
        f"{a:.2f}->{c:.2f}" for a, c in zip(e0, e1)), flush=True)
    print(f"  EC moved the poses by RMSD {moved.min():.3f}-{moved.max():.3f} A; vina_score "
          f"{vs.min():.3f}..{vs.max():.3f}; mdn_score {sp_.min():.3f}..{sp_.max():.3f}; "
          f"mdn_nll {nll.min():.3f}..{nll.max():.3f}", flush=True)
    # a few EC steps under the profiler: launches per step and busy share
    steps = 3
    lp = torch.from_numpy(np.stack([r.lig_pos for r in docked])).to(DEV)
    vina.minimize_batch(lp, ligs, recs, steps=steps, n_tor=n_tor)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        vina.minimize_batch(lp, ligs, recs, steps=steps, n_tor=n_tor)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((e.key, dev_us / 1e3, e.count))
    if rows:
        dev_ms = sum(r[1] for r in rows)
        kernels = sum(r[2] for r in rows if not r[0].startswith(("Memcpy", "Memset")))
        print(f"  EC, {steps} steps under the profiler (with the final pose and affinity): "
              f"wall {wall * 1e3:.1f} ms, device {dev_ms:.2f} ms "
              f"({100 * dev_ms / (wall * 1e3):.1f}% busy), {kernels / steps:.0f} kernel "
              f"launches per step, on {smi}", flush=True)
        for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {ms:9.3f} ms  x{cnt:<5d} {key[:90]}", flush=True)
    else:
        print("  the profiler saw no device time: EC launches and busy share not measured",
              flush=True)
    if not (np.isfinite(vs).all() and np.isfinite(sp_).all() and np.isfinite(nll).all()):
        raise AssertionError("non-finite scores")
    if not (np.isfinite(e1).all() and (e1 <= e0).all()):
        raise AssertionError(f"EC raised the energy of poses {np.nonzero(~(e1 <= e0))[0]}")


def predict_inputs(outdir, names, copy_cache=True, screen=False):
    """A jobs CSV of `names` (runs/pb_bench proteins and ligands, complex
    name = the PDB id, the ligand its own crystal ligand) in `outdir`, and
    with `copy_cache` their tracked prep caches copied into
    <outdir>/prep_cache, where predict looks for its pairs first. `screen`
    adds the 16 ligands of runs/screen_demo/mols on 3dbs's pocket (complex
    `3dbs_<stem>`). Returns the CSV."""
    import csv

    os.makedirs(os.path.join(outdir, "prep_cache"))
    path = os.path.join(outdir, "jobs.csv")
    pdb3 = os.path.join(PB_BENCH, "3dbs", "3dbs_protein_contact_chains.pdb")
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name",
                    "crystal_ligand"])
        for n in names:
            lig = os.path.join(PB_BENCH, n, f"{n}_ligand.sdf")
            w.writerow([os.path.join(PB_BENCH, n, f"{n}_protein_contact_chains.pdb"), n, lig,
                        n, n, lig])
            for ext in (".npz", ".rec.pkl") if copy_cache else ():
                shutil.copy(os.path.join(PREP, f"{n}_r12{ext}"),
                            os.path.join(outdir, "prep_cache"))
        for f in sorted(os.listdir(SCREEN_MOLS)) if screen else ():
            stem = f[: -len(".sdf")]
            w.writerow([pdb3, "3dbs", os.path.join(SCREEN_MOLS, f), stem, f"3dbs_{stem}",
                        os.path.join(PB_BENCH, "3dbs", "3dbs_ligand.sdf")])
    return path


def xtc_frames(path):
    """(natoms, step) of each frame of an XTC file, from the frame headers
    (compressed frames: the byte count after the header skips the data)."""
    import struct

    with open(path, "rb") as fh:
        data = fh.read()
    off, frames = 0, []
    while off < len(data):
        magic, natoms, step = struct.unpack_from(">iii", data, off)
        if magic != 1995:
            raise AssertionError(f"{path}: bad XTC magic at byte {off}")
        off += 16 + 36 + 4
        if natoms <= 9:
            off += 12 * natoms
        else:
            (nbytes,) = struct.unpack_from(">i", data, off + 4 + 24 + 4)
            off += 4 + 24 + 4 + 4 + nbytes + (-nbytes) % 4
        frames.append((natoms, step))
    return frames


def predict_run(torch, TC, pipeline, cli, argv, n_poses, extra=()):
    """cli.main(argv) with every launch counter set to 0 just before and
    read just after. The pipeline functions that cli.py calls through the
    module are wrapped meanwhile, and the functions `extra` names ((module,
    name) pairs), so each stage's wall time (the card synchronised on both
    sides) adds up in `stage`. Returns (counts, stage seconds, main()'s wall
    seconds, the prepared pairs and final results that export_and_rank
    received, the EC and MDN batch count)."""
    stage, seen, orig = {}, {}, {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage[name] = stage.get(name, 0.0) + time.time() - t0
            seen[name] = args
            return out
        return run

    wrapped = [(pipeline, name) for name in ("prep", "dock", "error_correct", "save_poses",
                                             "score_mdn", "export_and_rank")] + list(extra)
    for mod, name in wrapped:
        orig[mod, name] = getattr(mod, name)
        setattr(mod, name, timed(name, orig[mod, name]))
    try:
        TC.reset_launches()
        t0 = time.time()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(TC.launches)
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
    if rc != 0:
        raise AssertionError(f"{cli.__name__} exited with {rc}")
    prepared, results = seen["export_and_rank"][:2]
    if len(results) != n_poses:
        raise AssertionError(f"{len(results)} poses, expected {n_poses}")
    bs = int(argv[argv.index("-bs") + 1])
    return counts, stage, wall, prepared, results, len(pipeline._batches(prepared, results, bs))


def predict_read_back(np, out, prepared, results, names):
    """Phase 26's read-back gates on one predict run into `out` (-np N
    --cluster-rank 2.0 --save-poses -traj --export-top 5 at 20 steps): a row
    with finite scores and metrics per pose in results.csv; one row per
    complex in each top-1 table, `rank_score` mdn_nll in the clustered one;
    5 structure sets per complex that read back at their poses within
    1e-3 A, each with a 20-frame lig_traj.xtc; poses.npz back through
    load_poses unchanged."""
    import csv

    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.constants import residues as rc
    from diffbindfr_torch.io.pdb import parse_pdb
    from diffbindfr_torch.io.sdf import parse_sdf

    total = len(results)
    with open(os.path.join(out, "results.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    if len(rows) != total:
        raise AssertionError(f"{len(rows)} rows in results.csv, expected {total}")
    for col in ("mdn_score", "mdn_nll", "vina_score", "l_rmsd", "centroid", "chi1_rate",
                "sc_rmsd"):
        vals = np.array([float(r[col]) for r in rows])
        if not np.isfinite(vals).all():
            raise AssertionError(f"results.csv: non-finite {col}")
    for table in ("results_mdn_top1.csv", "results_mdn_nll_top1.csv",
                  "results_vina_top1.csv", "results_cluster_top1.csv"):
        with open(os.path.join(out, table), newline="") as fh:
            top = list(csv.DictReader(fh))
        if sorted(r["complex_name"] for r in top) != sorted(names):
            raise AssertionError(f"{table}: rows {[r['complex_name'] for r in top]}")
        if table == "results_cluster_top1.csv" and {r["rank_score"] for r in top} != {
                "mdn_nll"}:
            raise AssertionError("results_cluster_top1.csv: rank_score is not mdn_nll")
        if table == "results_mdn_nll_top1.csv":
            print("  top-1 by mdn_nll (a reading): " + ", ".join(
                f"{r['complex_name']} pose {r['pose']} l_rmsd {float(r['l_rmsd']):.3f} A"
                for r in top), flush=True)
    # the exported structures read back
    by_key = {(prepared[r.pair_idx].name, r.pose_idx): r for r in results}
    lig_err = prot_err = 0.0
    for pair in prepared:
        kept = [r for r in rows if r["complex_name"] == pair.name and r["lig_sdf"]]
        if len(kept) != 5:
            raise AssertionError(f"{pair.name}: {len(kept)} structure sets, expected 5")
        na, pk = pair.lig.num_atoms, pair.pocket
        nres = pk.num_res
        a37 = rc.restype_atom14_to_atom37[pk.aatype]
        ks, ss = np.nonzero(pk.atom14_mask[:nres])
        for row in kept:
            r = by_key[(pair.name, int(row["pose"]))]
            lig = parse_sdf(row["lig_sdf"])[0].coords
            lig_err = max(lig_err, float(np.abs(lig - (r.lig_pos[:na] + pk.center)).max()))
            prot = parse_pdb(row["prot_pdb"])
            got = prot.atom_positions[pk.pocket_res_indices[ks], a37[ks, ss]]
            want_pos = r.atom14_pos[:nres][ks, ss] + pk.center
            prot_err = max(prot_err, float(np.abs(got - want_pos).max()))
            frames = xtc_frames(os.path.join(os.path.dirname(row["lig_sdf"]),
                                             "lig_traj.xtc"))
            if [f[1] for f in frames] != list(range(20)) or {f[0] for f in frames} != {na}:
                raise AssertionError(f"{row['lig_sdf']}: trajectory frames {frames[:3]}...")
    print(f"  read back: lig_final.sdf vs lig_pos + center max {lig_err:.2e} A, "
          f"prot_final.pdb pocket atoms vs atom14_pos + center max {prot_err:.2e} A "
          f"(gate 1e-3); 20-frame lig_traj.xtc per kept pose", flush=True)
    if not (lig_err <= 1e-3 and prot_err <= 1e-3):
        raise AssertionError("exported structures do not read back")
    back = pipeline.load_poses(os.path.join(out, "poses.npz"), prepared)
    same = len(back) == total and all(
        np.array_equal(a.lig_pos, b.lig_pos) and np.array_equal(a.atom14_pos, b.atom14_pos)
        and (a.pair_idx, a.pose_idx) == (b.pair_idx, b.pose_idx)
        and np.float32(a.vina_score) == np.float32(b.vina_score)
        for a, b in zip(back, results))
    if not same:
        raise AssertionError("poses.npz does not come back through load_poses unchanged")
    print(f"  poses.npz: {total} poses back through load_poses unchanged", flush=True)


def phase_predict(torch, np, TC, smi):
    """The port's predict command end to end on the card (see the module
    docstring, phase 26)."""
    from diffbindfr_torch.app import cli
    from diffbindfr_torch.app import pipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    try:
        out = os.path.join(tmp, "run1")
        jobs = predict_inputs(out, PREDICT_NAMES)
        n_poses, bs = 40, 16
        argv = ["predict", "-i", jobs, "-o", out, "-ckt", CKPT, "-mdn", MDN_CKPT,
                "-np", str(n_poses), "-bs", str(bs), "--cluster-rank", "2.0", "--save-poses",
                "-traj", "--export-top", "5"]
        counts, stage, wall, prepared, results, n_batches = predict_run(
            torch, TC, pipeline, cli, argv, n_poses * len(PREDICT_NAMES))
        total = len(results)
        print(f"  run 1 (bf16, EC 150 steps, {len(PREDICT_NAMES)} complexes x {n_poses} poses, "
              f"-bs {bs}): launches {counts}", flush=True)
        print(f"  stages: prep {stage['prep']:.3f} s; dock {stage['dock']:.3f} s "
              f"({total / stage['dock']:.3f} poses/s); EC {stage['error_correct']:.3f} s "
              f"({1e3 * stage['error_correct'] / n_batches:.1f} ms per batch, {n_batches} "
              f"batches); save_poses {stage['save_poses']:.3f} s; MDN {stage['score_mdn']:.3f} s "
              f"({1e3 * stage['score_mdn'] / n_batches:.1f} ms per batch); export "
              f"{stage['export_and_rank']:.3f} s ({1e3 * stage['export_and_rank'] / total:.1f} "
              f"ms per row, {16e3 * stage['export_and_rank'] / total:.1f} ms per 16 rows; 5 "
              f"structure sets and trajectories per complex); main() "
              f"{wall:.3f} s: {wall / total:.4f} s per pose end to end, on {smi}", flush=True)
        want = {k: 6 * 20 * 3 * len(PREDICT_NAMES) if k in BF16_KERNELS else 0
                for k in TC.launches}
        if counts != want:
            raise AssertionError(f"run 1 launch counts {counts}, expected {want}")
        predict_read_back(np, out, prepared, results, PREDICT_NAMES)

        out2 = os.path.join(tmp, "run2")
        jobs2 = predict_inputs(out2, ("3dbs",))
        argv2 = ["predict", "-i", jobs2, "-o", out2, "-ckt", CKPT, "-mdn", MDN_CKPT,
                 "--dtype", "float32", "-np", "16", "-bs", "16"]
        counts2, stage2, wall2, _, res2, _ = predict_run(torch, TC, pipeline, cli, argv2, 16)
        print(f"  run 2 (f32, 3dbs, 16 poses): launches {counts2}; dock {stage2['dock']:.3f} s "
              f"({16 / stage2['dock']:.3f} poses/s), EC {stage2['error_correct']:.3f} s, MDN "
              f"{stage2['score_mdn']:.3f} s, export {stage2['export_and_rank']:.3f} s, main() "
              f"{wall2:.3f} s", flush=True)
        want2 = {k: 120 if k in KERNELS else 0 for k in TC.launches}
        if counts2 != want2:
            raise AssertionError(f"run 2 launch counts {counts2}, expected {want2}")
        if not all(np.isfinite(r.lig_pos).all() and np.isfinite(r.mdn_nll) for r in res2):
            raise AssertionError("run 2: non-finite poses or scores")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def same_tree(np, a, b, skip=()):
    """Whether two prep values are equal: records field by field (fields in
    `skip` left out), arrays in value, dtype and shape."""
    import dataclasses

    if dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and all(
            same_tree(np, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(b) if f.name not in skip)
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return a == b


def same_real_rows(np, a, b):
    """Two padded samples' arrays agree on the rows both hold and are zero
    (the padding) beyond them: the same real rows under other buckets."""
    if a.dtype != b.dtype or a.ndim != b.ndim:
        return False
    m = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))
    return (np.array_equal(a[m], b[m]) and np.count_nonzero(a) == np.count_nonzero(a[m])
            and np.count_nonzero(b) == np.count_nonzero(b[m]))


def prep_timed(cli, argv):
    """cli.main(argv) (a `predict -j prep` run); its wall seconds."""
    t0 = time.time()
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)} exited with {rc}")
    return time.time() - t0


def prep_library(np, cli, tmp, smi, sizes=(64, 640)):
    """A library screen's prep: the 16 records of runs/screen_demo/mols
    repeated into one SDF, `lib.sdf#i` on 3dbs's pocket, `predict -j prep`
    of the first n records for each n in `sizes`, at -nw 0 and -nw 4. Every
    pair prepared. Prints seconds per pair and, from the two sizes, each
    setting's fixed and per-pair seconds and the pair count from which -nw
    4 is the faster."""
    import csv

    mols = sorted(os.listdir(SCREEN_MOLS))
    lib = os.path.join(tmp, "library.sdf")
    with open(lib, "w") as out:
        for i in range(max(sizes)):
            with open(os.path.join(SCREEN_MOLS, mols[i % len(mols)])) as fh:
                out.write(fh.read().rstrip("\n") + "\n$$$$\n")
    pdb3 = os.path.join(PB_BENCH, "3dbs", "3dbs_protein_contact_chains.pdb")
    secs = {}
    # the first run, untimed, pays the process's first imports and parses
    for n, nw, timed in [(min(sizes), 0, False)] + [(n, nw, True) for n in sizes
                                                      for nw in (0, 4)]:
        d = os.path.join(tmp, f"lib{n}_nw{nw}" + ("" if timed else "_warm"))
        os.makedirs(d)
        jobs = os.path.join(d, "jobs.csv")
        with open(jobs, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name",
                        "crystal_ligand"])
            for i in range(n):
                w.writerow([pdb3, "3dbs", f"{lib}#{i}", f"lib{i}", f"lib_{i}",
                            os.path.join(PB_BENCH, "3dbs", "3dbs_ligand.sdf")])
        t = prep_timed(cli, ["predict", "-j", "prep", "-nw", str(nw), "-i", jobs, "-o", d])
        done = [f for f in os.listdir(os.path.join(d, "prep_cache")) if f.endswith(".npz")]
        if len(done) != n or os.path.exists(os.path.join(d, "failed.csv")):
            raise AssertionError(f"library prep -nw {nw}: {len(done)} of {n} pairs prepared")
        if timed:
            secs[n, nw] = t
            print(f"  library prep of {n} records on 3dbs's pocket, -nw {nw}: {t:.3f} s "
                  f"({t / n:.4f} s per pair)", flush=True)
    lo, hi = min(sizes), max(sizes)
    fit = {}
    for nw in (0, 4):
        per = (secs[hi, nw] - secs[lo, nw]) / (hi - lo)
        fit[nw] = (secs[lo, nw] - per * lo, per)
        print(f"  -nw {nw}: {fit[nw][0]:.3f} s fixed + {fit[nw][1]:.5f} s per pair", flush=True)
    saved = fit[0][1] - fit[4][1]
    even = (fit[4][0] - fit[0][0]) / saved if saved > 0 else float("inf")
    print(f"  -nw 4 is the faster from {even:.0f} pairs on, on the host of {smi}", flush=True)


def bucket_kernels(torch, TC, params, samples, new_buckets, f32=True, check_graph=False):
    """B11 (and with `f32` B1-B3) on the kernel inputs of each (name, prep
    npz) of `samples`, layers 0 and 5, B = 16, diff_r2 weights (B11 on their
    bf16 rounding): each against its plain version at phase 5's (1e-4) and
    phase 18's (BF16_GATE) bounds, its CUDA-graph replay time, plain time
    and bound; with `check_graph` a CUDA-graph replay must give the eager
    call's bits. Each row goes into new_buckets[kernel]."""
    from diffbindfr_torch.data.sample import _load_sample_npz
    from diffbindfr_torch.models import score_net as sn

    f32 = {k: (getattr(TC, k), getattr(TC, k + "_plain")) for k in KERNELS} if f32 else {}
    b11 = {k: (functools.partial(getattr(TC, v[2]), bf16_chain=True),
               functools.partial(getattr(TC, v[2] + "_plain"), bf16_chain=True), v[2])
           for k, v in BF16_KERNELS.items()}
    p16 = sn._cast_f32_leaves(params, torch.bfloat16)
    for n, path in samples:
        s_np = _load_sample_npz(path)
        for layer in (0, 5):
            seed = 2700 + layer
            a32 = kernel_inputs(torch, params, s_np, layer, 16, seed)
            a16 = kernel_inputs(torch, p16, s_np, layer, 16, seed)
            plan = [(k, fn, pl, a32[k], 1e-4, k) for k, (fn, pl) in f32.items()]
            plan += [(k, fn, pl, a16[tw], BF16_GATE, tw) for k, (fn, pl, tw) in b11.items()]
            for name, fn, plain, a, gate, twin in plan:
                with torch.no_grad():
                    got, ref = fn(*a), plain(*a)
                    torch.cuda.synchronize()
                    got, ref = ((x if isinstance(x, tuple) else (x,)) for x in (got, ref))
                    err = max(rel_err(g_, r_) for g_, r_ in zip(got, ref))
                    abs_err = max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))
                    finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
                    g_ms = graph_ms_or_none(torch, lambda: fn(*a))
                    plain_ms = time_ms(lambda: plain(*a), 1, 2)
                same = graph_same(torch, lambda: fn(*a)) if check_graph else None
                if name in KERNELS:
                    flops, byts, pairs = work(torch, name, a)
                    t_ops, t_bytes = flops / PEAK_FP32, byts / PEAK_BYTES
                    bound_ms = max(t_ops, t_bytes) * 1e3
                    bound_by = "operations" if t_ops >= t_bytes else "bytes"
                else:
                    bound_ms, bound_by, pairs = b11_bound(torch, twin, a)[:3]
                row = dict(complex=n, n_lig=int(s_np.lig_feat.shape[0]),
                           n_atm=int(s_np.atm_pos.shape[0]), layer=layer, batch=16,
                           max_rel_err=err, max_abs_err=abs_err, graph_ms=g_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           pairs=pairs)
                if check_graph:
                    row["graph_same"] = same
                new_buckets.setdefault(name, []).append(row)
                print(f"  {name} {n} (n_lig {row['n_lig']}, n_atm {row['n_atm']}) layer "
                      f"{layer} B=16: max|err|/max|ref| {err:.2e} (gate {gate:g}) graph "
                      f"replay {fmt_ms(g_ms)} plain {plain_ms:.3f} ms bound "
                      f"{bound_ms:.4f} ms ({bound_by}) pairs {pairs:.0f}"
                      + ("" if same is None else f"; graph replay same bits: {same}"),
                      flush=True)
                if not finite or err > gate:
                    raise AssertionError(f"{name} {n} layer {layer}: kernel disagrees with "
                                         f"plain ({err:.3e})")
                if check_graph and not same:
                    raise AssertionError(f"{name} {n} layer {layer}: graph replay differs")


def phase_prep_predict(torch, np, TC, params, smi, new_buckets):
    """Host prep from raw files, predict from raw inputs and the trunk
    kernels at the buckets a fresh prep picks (see the module docstring,
    phase 27). `new_buckets` receives each kernel's rows at those shapes."""
    from diffbindfr_torch.app import cli
    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.chem.records import load_prep_record

    tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        # (a) predict -j prep of 18 pairs, serial and in 4 spawn workers
        dirs, secs = {}, {}
        for nw in (0, 4):
            dirs[nw] = os.path.join(tmp, f"prep_nw{nw}")
            jobs = predict_inputs(dirs[nw], PREDICT_NAMES, copy_cache=False, screen=True)
            secs[nw] = prep_timed(cli, ["predict", "-j", "prep", "-nw", str(nw), "-i", jobs,
                                        "-o", dirs[nw]])
        cache = {nw: os.path.join(d, "prep_cache") for nw, d in dirs.items()}
        names = sorted(f[: -len("_r12.npz")] for f in os.listdir(cache[0]) if f.endswith(".npz"))
        n_pairs = len(PREDICT_NAMES) + len(os.listdir(SCREEN_MOLS))
        print(f"  prep of {n_pairs} pairs from raw files (-j prep): -nw 0 {secs[0]:.3f} s "
              f"({secs[0] / n_pairs:.4f} s per pair), -nw 4 {secs[4]:.3f} s "
              f"({secs[4] / n_pairs:.4f} s per pair, the workers' start included), on the "
              f"host of {smi}", flush=True)
        if len(names) != n_pairs or any(os.path.exists(os.path.join(d, "failed.csv"))
                                        for d in dirs.values()):
            raise AssertionError(f"{len(names)} of {n_pairs} pairs prepared")
        for n in names:  # the workers' entries are the serial prep's
            rec0, rec4 = (load_prep_record(os.path.join(cache[nw], f"{n}_r12.rec.pkl"))
                          for nw in (0, 4))
            with np.load(os.path.join(cache[0], f"{n}_r12.npz")) as z0, \
                    np.load(os.path.join(cache[4], f"{n}_r12.npz")) as z4:
                same = z0.files == z4.files and all(same_tree(np, z4[k], z0[k]) for k in z0.files)
            if not (same and set(rec0) == set(rec4)
                    and all(same_tree(np, rec4[k], rec0[k]) for k in rec0)):
                raise AssertionError(f"{n}: -nw 4 and -nw 0 prepared different entries")
        for n in PREDICT_NAMES:  # against the tracked caches
            got, ref = (load_prep_record(os.path.join(d, f"{n}_r12.rec.pkl"))
                        for d in (cache[0], PREP))
            bad = [k for k in ref if k != "bucket" and not same_tree(
                np, got[k], ref[k], skip=("chain_ids",) if k == "pocket" else ())]
            with np.load(os.path.join(cache[0], f"{n}_r12.npz")) as z, \
                    np.load(os.path.join(PREP, f"{n}_r12.npz")) as zr:
                bad += [k for k in zr.files if not same_real_rows(np, z[k], zr[k])]
                b = (int(z["lig_feat"].shape[0]), int(z["atm_pos"].shape[0]))
            print(f"  {n}: fresh bucket (n_lig, n_atm) {b}, tracked ({ref['bucket'].n_lig}, "
                  f"{ref['bucket'].n_atm}); chain_ids {got['pocket'].chain_ids} (tracked "
                  f"{ref['pocket'].chain_ids}); real rows and record fields differing from the "
                  f"tracked cache: {bad or 'none'}", flush=True)
            if bad or b != PREP_BUCKETS[n]:
                raise AssertionError(f"{n}: fresh prep differs from the tracked cache in {bad}, "
                                     f"bucket {b}")
        stamp = {f: os.stat(os.path.join(cache[4], f)).st_mtime_ns
                 for f in os.listdir(cache[4])}
        again = prep_timed(cli, ["predict", "-j", "prep", "-nw", "4", "-i",
                                 os.path.join(dirs[4], "jobs.csv"), "-o", dirs[4]])
        if {f: os.stat(os.path.join(cache[4], f)).st_mtime_ns
                for f in os.listdir(cache[4])} != stamp:
            raise AssertionError("a second prep rewrote cache entries")
        print(f"  second -nw 4 run: all {n_pairs} pairs from the cache in {again:.3f} s",
              flush=True)
        prep_library(np, cli, tmp, smi)

        # (b) predict from raw inputs at its defaults
        out = os.path.join(tmp, "raw")
        jobs = predict_inputs(out, PREDICT_NAMES, copy_cache=False)
        n_poses, bs = 40, 16
        argv = ["predict", "-i", jobs, "-o", out, "-ckt", CKPT, "-mdn", MDN_CKPT,
                "-np", str(n_poses), "-bs", str(bs), "--cluster-rank", "2.0", "--save-poses",
                "-traj", "--export-top", "5"]
        counts, stage, wall, prepared, results, n_batches = predict_run(
            torch, TC, pipeline, cli, argv, n_poses * len(PREDICT_NAMES))
        total = len(results)
        print(f"  predict from raw files (bf16, EC 150 steps, {len(PREDICT_NAMES)} complexes x "
              f"{n_poses} poses, -bs {bs}, buckets "
              f"{[(p.name, p.bucket.n_lig, p.bucket.n_atm) for p in prepared]}): launches "
              f"{counts}", flush=True)
        print(f"  stages: prep {stage['prep']:.3f} s ({stage['prep'] / len(prepared):.4f} s per "
              f"pair); dock {stage['dock']:.3f} s ({total / stage['dock']:.3f} poses/s); EC "
              f"{stage['error_correct']:.3f} s ({1e3 * stage['error_correct'] / n_batches:.1f} "
              f"ms per batch, {n_batches} batches); save_poses {stage['save_poses']:.3f} s; MDN "
              f"{stage['score_mdn']:.3f} s; export {stage['export_and_rank']:.3f} s; main() "
              f"{wall:.3f} s: {wall / total:.4f} s per pose end to end, on {smi}", flush=True)
        want = {k: 6 * 20 * 3 * len(PREDICT_NAMES) if k in BF16_KERNELS else 0
                for k in TC.launches}
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        if {p.name: (p.bucket.n_lig, p.bucket.n_atm) for p in prepared} != PREP_BUCKETS:
            raise AssertionError("predict did not dock at the fresh buckets")
        predict_read_back(np, out, prepared, results, PREDICT_NAMES)

        # (c) B1-B3 and B11 at the fresh buckets, against their plain versions;
        # the tracked 3dbs cache's bucket beside them, timed the same way
        samples = [(n, os.path.join(cache[0], f"{n}_r12.npz")) for n in PREDICT_NAMES]
        bucket_kernels(torch, TC, params, samples + [("3dbs, tracked cache", SAMPLE)],
                       new_buckets)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def http(port, path, body=None):
    """(status, JSON reply, seconds) of a GET (body None) or POST to the
    server on localhost:port."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), time.time() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.time() - t0


def concurrently(port, bodies):
    """POST every body of `bodies` to /dock at once, each from its own
    thread; their (status, reply, seconds) in order."""
    out = [None] * len(bodies)

    def ask(i):
        out[i] = http(port, "/dock", bodies[i])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return out


def serve_request(name, **kw):
    """A /dock request for a runs/pb_bench complex: its contact chains and
    its crystal ligand (which defines the pocket)."""
    d = os.path.join(PB_BENCH, name)
    return {"protein": os.path.join(d, f"{name}_protein_contact_chains.pdb"),
            "ligand": os.path.join(d, f"{name}_ligand.sdf"), **kw}


def parse_sdf_block(tmp, sdf):
    """The coordinates of an SDF block (a reply row's)."""
    from diffbindfr_torch.io.sdf import parse_sdf

    path = os.path.join(tmp, "reply.sdf")
    with open(path, "w") as fh:
        fh.write(sdf)
    return parse_sdf(path)[0].coords


def sdf_error(np, tmp, sdf, pair, res):
    """max |SDF coordinates - (lig_pos + center)| of one reply row (A)."""
    na = pair.lig.num_atoms
    return float(np.abs(parse_sdf_block(tmp, sdf) - (res.lig_pos[:na] + pair.pocket.center)).max())


def phase_serve(torch, np, TC, smi):
    """The serving daemon on the card (see the module docstring, phase 28).
    Returns each B11 kernel's launches in rounds (a) and (b)."""
    from diffbindfr_torch.app import pipeline, serve

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    server, prep = None, pipeline.prep
    try:
        args = serve.build_parser().parse_args(["-ckt", CKPT, "-mdn", MDN_CKPT, "--cache-dir",
                                                os.path.join(tmp, "cache"), "--port", "0"])
        svc = serve.make_service(args, verbose=False)
        # a full batch ends the drain at once; the window only has to outlast
        # a concurrent request's prep in its handler thread
        svc.max_wait_s = 2.0
        rounds, preps, prep_starts = [], [], []
        run = svc.dock_engine.run

        def dock(pairs, num_poses, seed):
            torch.cuda.synchronize()
            t0 = time.time()
            res = run(pairs, num_poses=num_poses, seed=seed)
            torch.cuda.synchronize()
            rounds.append(dict(pairs=list(pairs), counts=list(num_poses), seed=seed,
                               results=res, dock_s=time.time() - t0, t0=t0))
            return res

        def counted_prep(*a, **kw):
            preps.append(a[0])
            prep_starts.append((a[0][0].complex_name, time.time()))
            return prep(*a, **kw)

        svc.dock_engine.run = dock
        pipeline.prep = counted_prep
        server = serve.DockServer(svc, port=0).start()
        print(f"  serve at the defaults (bf16, -bs {args.batch_size}, EC {args.ec_steps} steps, "
              f"{args.steps} steps, diff_r2 + mdn_r4b) on http://127.0.0.1:{server.port}, "
              f"drain window {svc.max_wait_s} s", flush=True)
        t0 = time.time()
        svc.warmup(*[serve_request("3dbs")[k] for k in ("protein", "ligand")])
        torch.cuda.synchronize()
        print(f"  warm-up on 3dbs (prep, a round of 1 pose, EC, MDN): {time.time() - t0:.3f} s",
              flush=True)

        # (a) two concurrent requests on the 3dbs pair: one round, one batch
        rounds.clear()
        preps.clear()
        TC.reset_launches()
        replies = concurrently(server.port, [serve_request("3dbs", num_poses=8)] * 2)
        torch.cuda.synchronize()
        counts_a = dict(TC.launches)
        want = {k: 6 * 20 if k in BF16_KERNELS else 0 for k in TC.launches}
        print(f"  (a) 2 concurrent requests, 3dbs x 8 poses each: statuses "
              f"{[r[0] for r in replies]}, latencies "
              f"{', '.join(f'{r[2]:.3f} s' for r in replies)}; {len(rounds)} round(s), counts "
              f"{[rd['counts'] for rd in rounds]}; preps {len(preps)}; launches {counts_a}",
              flush=True)
        if [r[0] for r in replies] != [200, 200]:
            raise AssertionError(f"(a) replies {[(r[0], r[1].get('error')) for r in replies]}")
        if counts_a != want or len(rounds) != 1 or preps:
            raise AssertionError(f"(a) launches {counts_a} in {len(rounds)} rounds, {len(preps)} "
                                 f"preps; expected {want} in one round, no prep")
        served = rounds[0]
        pairs = served["pairs"]
        # (c) the same round run directly on the engines
        eng = pipeline.DockEngine(svc.dock_engine.params, svc.dock_engine.net_cfg,
                                  svc.dock_engine.sampler_cfg, batch_size=svc.batch_size,
                                  device=DEV, verbose=False)
        torch.cuda.synchronize()
        t0 = time.time()
        direct = eng.run(pairs, num_poses=served["counts"], seed=served["seed"])
        torch.cuda.synchronize()
        direct_s = time.time() - t0
        pipeline.ECEngine(steps=svc.ec_engine.steps, batch_size=svc.batch_size, device=DEV,
                          verbose=False).run(pairs, direct)
        pipeline.MDNEngine(svc.mdn_engine.mdn_params, svc.mdn_engine.mdn_cfg,
                           batch_size=svc.batch_size, device=DEV, verbose=False).run(pairs, direct)
        pos_err = max(float(np.abs(a.lig_pos - b.lig_pos).max())
                      for a, b in zip(served["results"], direct))
        score_err = max(abs(getattr(a, f) - getattr(b, f)) / max(abs(getattr(b, f)), 1e-30)
                        for a, b in zip(served["results"], direct)
                        for f in ("vina_score", "mdn_score", "mdn_nll"))
        n_a = sum(served["counts"])
        print(f"  (c) served round vs the engines run directly: poses max {pos_err:.2e} A "
              f"(gate 1e-3), scores max {score_err:.2e} relative (gate 1e-3); dock "
              f"{n_a / served['dock_s']:.3f} poses/s served, {n_a / direct_s:.3f} poses/s "
              f"direct ({served['dock_s']:.3f} / {direct_s:.3f} s), on {smi}", flush=True)
        if len(direct) != n_a or not (pos_err <= 1e-3 and score_err <= 1e-3):
            raise AssertionError("(c) the served poses are not the direct run's")
        # (d) each reply's rows: its own group of the round, best first, the
        # SDF at lig_pos + center
        groups = {}
        for i, (_, body, _) in enumerate(replies):
            rows = body["poses"]
            if [r["mdn_score"] for r in rows] != sorted((r["mdn_score"] for r in rows),
                                                        reverse=True):
                raise AssertionError(f"(d) reply {i}: rows not best first")
            errs = {}
            for gi in range(len(pairs)):
                by_pose = {r.pose_idx: r for r in served["results"] if r.pair_idx == gi}
                errs[gi] = max(sdf_error(np, tmp, row["sdf"], pairs[gi],
                                         by_pose[row["pose"]]) for row in rows)
            gi = min(errs, key=errs.get)
            groups[i] = (gi, errs[gi])
        print(f"  (d) replies' SDF vs lig_pos + center of their round group: "
              f"{ {i: f'group {g}, {e:.2e} A' for i, (g, e) in groups.items()} } (gate 1e-3)",
              flush=True)
        if sorted(g for g, _ in groups.values()) != [0, 1] or max(
                e for _, e in groups.values()) > 1e-3:
            raise AssertionError("(d) the replies' SDFs are not their round's poses")

        # (b) two buckets in one round: 3dbs (cached) and 3mhw (prepared now)
        rounds.clear()
        preps.clear()
        TC.reset_launches()
        replies = concurrently(server.port, [serve_request("3dbs", num_poses=8),
                                             serve_request("3mhw", num_poses=8)])
        torch.cuda.synchronize()
        counts_b = dict(TC.launches)
        want = {k: 2 * 6 * 20 if k in BF16_KERNELS else 0 for k in TC.launches}
        print(f"  (b) concurrent 3dbs and 3mhw, 8 poses each: statuses "
              f"{[r[0] for r in replies]}, latencies "
              f"{', '.join(f'{r[2]:.3f} s' for r in replies)}; {len(rounds)} round(s), buckets "
              f"{[[(p.bucket.n_lig, p.bucket.n_atm) for p in rd['pairs']] for rd in rounds]}; "
              f"preps {[j.complex_name for js in preps for j in js]}; launches {counts_b}; "
              f"dock {16 / rounds[0]['dock_s']:.3f} poses/s", flush=True)
        if [r[0] for r in replies] != [200, 200]:
            raise AssertionError(f"(b) replies {[(r[0], r[1].get('error')) for r in replies]}")
        if counts_b != want or len(rounds) != 1 or len(preps) != 1:
            raise AssertionError(f"(b) launches {counts_b} in {len(rounds)} rounds, "
                                 f"{len(preps)} preps; expected {want} in one round, one prep")
        err_b = 0.0
        for body in (r[1] for r in replies):
            gi = [p.name for p in rounds[0]["pairs"]].index(body["complex_name"])
            by_pose = {r.pose_idx: r for r in rounds[0]["results"] if r.pair_idx == gi}
            err_b = max([err_b] + [sdf_error(np, tmp, row["sdf"],
                                             rounds[0]["pairs"][gi], by_pose[row["pose"]])
                                   for row in body["poses"]])
        print(f"  (b) SDF vs lig_pos + center max {err_b:.2e} A", flush=True)
        if err_b > 1e-3:
            raise AssertionError("(b) the replies' SDFs are not their poses")

        # (d) health, the bad requests, shutdown with a request in flight
        code, health, _ = http(server.port, "/health")
        conf = http(server.port, "/dock", serve_request("3dbs", num_poses=2, n_conformers=2))
        bad_file = http(server.port, "/dock", serve_request(
            "3dbs", ligand=os.path.join(tmp, "missing.sdf")))
        print(f"  (d) /health {code} {health}; n_conformers 2: {conf[0]}, "
              f"{len(conf[1].get('poses', []))} poses in {conf[2]:.3f} s; missing "
              f"file: {bad_file[0]} {bad_file[1]}", flush=True)
        if code != 200 or health["device"] != DEV or health["warm_buckets"] != 2:
            raise AssertionError(f"/health: {code} {health}")
        if conf[0] != 200 or len(conf[1]["poses"]) != 2 or bad_file[0] != 400:
            raise AssertionError("the n_conformers request was not served, or the missing "
                                 "file did not get 400")

        # (e) embeddings beside card work: an n_conformers request whose prep
        # embeds (a CUDA-graph capture in its handler thread) while a round
        # of 16 poses docks, then two concurrent n_conformers requests for
        # two more ligands, both embedding at once (dock only: no EC, MDN)
        docking = threading.Event()

        def dock_flagged(*a, **kw):
            docking.set()
            return dock(*a, **kw)

        svc.dock_engine.run = dock_flagged
        rounds.clear()
        prep_starts.clear()
        busy = []
        t = threading.Thread(target=lambda: busy.append(http(server.port, "/dock", serve_request(
            "3dbs", num_poses=16, seed=1))))
        t.start()
        if not docking.wait(300):
            raise AssertionError("(e) the 16-pose round never reached the card")
        beside = http(server.port, "/dock", serve_request("3mhw", num_poses=2, n_conformers=2,
                                                          ec=False, score=False))
        t.join(600)
        busy_end = rounds[0]["t0"] + rounds[0]["dock_s"] if rounds else 0.0
        overlap = [n for n, ts in prep_starts if n.startswith("3mhw") and ts < busy_end]
        two = concurrently(server.port, [serve_request(n, num_poses=2, n_conformers=2, ec=False,
                                                       score=False) for n in ("2zec", "3pp0")])
        replies_e = busy + [beside] + two
        finite = all(np.isfinite(parse_sdf_block(tmp, row["sdf"])).all()
                     for r in replies_e if r[0] == 200 for row in r[1]["poses"])
        print(f"  (e) 3mhw n_conformers 2 sent while a 16-pose 3dbs round docked: "
              f"{beside[0]} in {beside[2]:.3f} s, its prep began "
              f"{(busy_end - prep_starts[0][1]) if prep_starts else float('nan'):.3f} s before "
              f"that round's dock ended; the round's request {busy[0][0] if busy else None}; "
              f"2zec and 3pp0 n_conformers 2 at once: {[r[0] for r in two]} in "
              f"{', '.join(f'{r[2]:.3f} s' for r in two)}; all poses finite: {finite}",
              flush=True)
        if [r[0] for r in replies_e] != [200] * 4 or [len(r[1]["poses"]) for r in replies_e] != [
                16, 2, 2, 2] or not finite:
            raise AssertionError(f"(e) replies {[(r[0], r[1].get('error')) for r in replies_e]}")
        if not overlap:
            raise AssertionError("(e) the n_conformers prep did not begin while the round docked")
        entered = threading.Event()

        def dock_entered(*a, **kw):
            entered.set()
            return dock(*a, **kw)

        svc.dock_engine.run = dock_entered
        last = []
        t = threading.Thread(target=lambda: last.append(http(server.port, "/dock", serve_request(
            "3mhw", num_poses=1, ec=False, score=False))))
        t.start()
        if not entered.wait(300):
            raise AssertionError("the last request never reached the card")
        bye = http(server.port, "/shutdown", {})
        t.join(300)
        svc._worker.join(300)
        print(f"  /shutdown with a request in flight: {bye[0]} {bye[1]}; the request: "
              f"{last[0][0] if last else None}, {len(last[0][1].get('poses', [])) if last else 0} "
              f"pose(s); worker stopped: {not svc._worker.is_alive()}", flush=True)
        if bye[0] != 200 or not last or last[0][0] != 200 or svc._worker.is_alive():
            raise AssertionError("/shutdown did not serve the request in flight")
        server = None
        return {k: (counts_a[k], counts_b[k]) for k in BF16_KERNELS}
    finally:
        pipeline.prep = prep
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


EVAL_NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


def phase_eval(torch, np, TC, params, smi, new_buckets):
    """The evaluation protocol on the card (see the module docstring, phase
    29). Returns each B11 kernel's launches."""
    import csv

    from diffbindfr_torch.app import eval_cli, pipeline, rescore_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        data = os.path.join(tmp, "pb")
        for n in EVAL_NAMES:  # a copy: the pb job maker may write into its data
            os.makedirs(os.path.join(data, n))
            for f in os.listdir(os.path.join(PB_BENCH, n)):
                shutil.copy(os.path.join(PB_BENCH, n, f), os.path.join(data, n))
        out = os.path.join(tmp, "out")
        n_poses, bs = 16, 16
        argv = ["-d", data, "-o", out, "-ckt", CKPT, "-mdn", MDN_CKPT, "-np", str(n_poses),
                "-bs", str(bs)]
        counts, stage, wall, prepared, results, n_batches = predict_run(
            torch, TC, pipeline, eval_cli, argv, n_poses * len(EVAL_NAMES),
            extra=[(eval_cli, "validity_rows")])
        total = len(results)
        buckets = sorted({(p.bucket.n_lig, p.bucket.n_atm) for p in prepared})
        print(f"  eval_cli (pb, {len(EVAL_NAMES)} complexes x {n_poses} poses, -bs {bs}, bf16, "
              f"EC 150 steps, validity on; buckets {buckets}): launches {counts}", flush=True)
        print(f"  stages: prep {stage['prep']:.3f} s; dock {stage['dock']:.3f} s "
              f"({total / stage['dock']:.3f} poses/s); EC {stage['error_correct']:.3f} s "
              f"({1e3 * stage['error_correct'] / n_batches:.1f} ms per batch, {n_batches} "
              f"batches); save_poses {stage['save_poses']:.3f} s; MDN {stage['score_mdn']:.3f} s; "
              f"export {stage['export_and_rank']:.3f} s; validity {stage['validity_rows']:.3f} s "
              f"({stage['validity_rows'] / total:.4f} s per pose, "
              f"{100 * stage['validity_rows'] / wall:.1f}% of the run); main() {wall:.3f} s: "
              f"{wall / total:.4f} s per pose end to end, on {smi}", flush=True)
        want = {k: 6 * 20 * 5 if k in BF16_KERNELS else 0 for k in TC.launches}
        if counts != want or n_batches != 5:
            raise AssertionError(f"launch counts {counts} over {n_batches} batches, expected "
                                 f"{want} over 5")
        with open(os.path.join(out, "results.csv"), newline="") as fh:
            rows = list(csv.DictReader(fh))
        with open(os.path.join(out, "validity.csv"), newline="") as fh:
            vrows = list(csv.DictReader(fh))
        for col in ("mdn_score", "mdn_nll", "vina_score", "l_rmsd", "centroid", "chi1_rate",
                    "sc_rmsd"):
            if not np.isfinite([float(r[col]) for r in rows]).all():
                raise AssertionError(f"results.csv: non-finite {col}")
        missing = [f for f in ("metrics_report.txt", "poses.npz", "results_mdn_nll_top1.csv")
                   if not os.path.exists(os.path.join(out, f))]
        if len(rows) != total or len(vrows) != total or missing:
            raise AssertionError(f"{len(rows)} results rows, {len(vrows)} validity rows, "
                                 f"missing {missing}")
        with open(os.path.join(out, "results_mdn_nll_top1.csv"), newline="") as fh:
            top = list(csv.DictReader(fh))
        share = sum(int(v["pass"]) for v in vrows) / len(vrows)
        print(f"  validity: {100 * share:.1f}% of {len(vrows)} poses pass all checks; top-1 by "
              f"mdn_nll (a reading): " + ", ".join(
                  f"{r['complex_name']} pose {r['pose']} l_rmsd {float(r['l_rmsd']):.3f} A"
                  for r in top), flush=True)

        # B11 at the bucket no earlier phase runs: (n_lig 32, n_atm 1024); B1-B3
        # there too (no path launches them at this bucket: its docks are bf16),
        # for their times and bounds
        small = [p for p in prepared if (p.bucket.n_lig, p.bucket.n_atm) == (32, 1024)]
        if not small:
            raise AssertionError(f"no pair at (32, 1024): {buckets}")
        bucket_kernels(torch, TC, params, [(small[0].name, small[0].sample_path)], new_buckets,
                       check_graph=True)

        # rescore both ways on the card: the fast path's MDN scores are eval's
        t0 = time.time()
        r_out = os.path.join(tmp, "rescore")
        if rescore_cli.main(["--poses", out, "-d", data, "-mdn", MDN_CKPT, "-o", r_out]) != 0:
            raise AssertionError("rescore --poses failed")
        fast_s = time.time() - t0
        with open(os.path.join(r_out, "results.csv"), newline="") as fh:
            rescored = {(r["complex_name"], r["pose"]): r for r in csv.DictReader(fh)}
        err = max(abs(float(rescored[r["complex_name"], r["pose"]][c]) - float(r[c]))
                  / max(abs(float(r[c])), 1e-30) for r in rows for c in ("mdn_score", "mdn_nll"))
        t0 = time.time()
        g_out = os.path.join(tmp, "rescore_generic")
        if rescore_cli.main(["-i", os.path.join(out, "results.csv"), "-mdn", MDN_CKPT, "-o",
                             g_out]) != 0:
            raise AssertionError("rescore -i failed")
        generic_s = time.time() - t0
        with open(os.path.join(g_out, "results.csv"), newline="") as fh:
            generic = list(csv.DictReader(fh))
        print(f"  rescore --poses: {len(rescored)} poses in {fast_s:.3f} s, MDN vs eval's max "
              f"{err:.2e} relative (gate 1e-3); rescore -i results.csv: {len(generic)} poses in "
              f"{generic_s:.3f} s", flush=True)
        if len(rescored) != total or err > 1e-3:
            raise AssertionError("rescore --poses does not give eval's MDN scores")
        if len(generic) != total or not np.isfinite(
                [float(r["mdn_nll"]) for r in generic]).all():
            raise AssertionError("rescore -i did not score every pose")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


RELAX_GATE = 1e-2  # A, the card against the JAX relax fixture (as EC_POS_GATE)
RELAX_MODES = {"rigid": [], "angular": ["--angular-hb"], "explicit_h": ["--explicit-h"],
               "flex": ["--flex"], "cartesian": ["--cartesian"]}
# phase 30's eval: two complexes that share a bucket (one batch of 16)
RELAX_EVAL_NAMES = ("2src", "2zec")
# phase 30 (c): steps of each `relax` mode on its one pose (the command's
# default is 300; the gates there are a finite pose and the files written)
RELAX_MODE_STEPS = 100


def relax_fixture_check(torch, np, pipeline, smi):
    """Phase 30 (a): the relax engine (Cartesian, 300 steps), the joint flex
    minimizer and the explicit-H angular rigid minimizer on the card against
    tests/fixtures/torch_relax_ref.npz (the JAX package on the CPU): max
    error over real atoms against RELAX_GATE, the distance each moved the
    poses as the control. Returns the Cartesian ms per step."""
    from diffbindfr_torch.ops import vina

    ref = np.load(FIXTURE_RELAX)
    bad, step_ms = [], []
    for name in EC_NAMES:
        pair = pipeline.PreparedPair.from_prep_cache(os.path.join(PREP, f"{name}_r12.npz"))
        pose0, a14_0 = ref[name + "|pose0"], ref[name + "|a14_0"]
        res = [pipeline.PoseResult(0, k, p.copy(), a.copy(), None)
               for k, (p, a) in enumerate(zip(pose0, a14_0))]
        torch.cuda.synchronize()
        t0 = time.time()
        pipeline.cartesian_relax([pair], res, steps=300, batch_size=len(res), device=DEV,
                                 verbose=False)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.time() - t0) / 300)
        lmask = np.arange(pose0.shape[1]) < pair.lig.num_atoms
        got = np.stack([r.lig_pos for r in res])
        got14 = np.stack([r.atom14_pos for r in res])
        lig_err = float(np.abs(got - ref[name + "|cart_pos"])[:, lmask].max())
        rec_err = float(np.abs(got14 - ref[name + "|cart_a14"]).max())
        moved = float(np.abs(ref[name + "|cart_pos"] - pose0)[:, lmask].max())
        rmoved = float(np.abs(ref[name + "|cart_a14"] - a14_0).max())
        print(f"  {name} Cartesian relax ({len(res)} poses, 300 steps, {step_ms[-1]:.2f} ms per "
              f"step incl. the first call): ligand vs JAX {lig_err:.2e} A, receptor "
              f"{rec_err:.2e} A (gate {RELAX_GATE}; control: the relax moved ligand atoms up "
              f"to {moved:.3f} A, receptor atoms {rmoved:.3f} A)", flush=True)
        if not (lig_err <= RELAX_GATE and rec_err <= RELAX_GATE and moved > RELAX_GATE):
            bad.append(f"Cartesian {name}")
    pair = pipeline.PreparedPair.from_prep_cache(os.path.join(PREP, "3dbs_r12.npz"))
    b, na, pk = pair.bucket, pair.lig.num_atoms, pair.pocket
    pose0 = ref["flex|pose0"]
    vl = vina.build_ligand(pair.lig, b.n_lig, b.n_tor)
    ligs = vina.stack_to_device([vl] * len(pose0), DEV)
    lp = torch.from_numpy(pose0).to(DEV)
    frec = vina.stack_to_device([vina.build_flex_receptor(pk, -(-pk.num_res // 8) * 8)]
                                * len(pose0), DEV)
    # the torsion loops stop after the ligand's last real torsion (minimize_batch's n_tor)
    n_tor = pair.lig.num_torsions
    t0 = time.time()
    pos, p14, aff = vina.joint_minimize_batch(lp, ligs, frec, steps=300, n_tor=n_tor)
    torch.cuda.synchronize()
    flex_s = time.time() - t0
    acc = np.asarray(vl.acceptor)[:na] > 0
    recs = vina.stack_to_device([vina.build_receptor(pk, b.n_atm, explicit_polar_h=True,
                                                     opt_acceptors=p[:na][acc]) for p in pose0],
                                DEV)
    t0 = time.time()
    xpos, xaff = vina.minimize_batch(lp, ligs, recs, steps=300, angular_hb=True, n_tor=n_tor)
    torch.cuda.synchronize()
    xh_s = time.time() - t0
    for what, got, got_aff, secs, key in (
            ("flex joint", pos, aff, flex_s, "flex"), ("explicit-H rigid", xpos, xaff, xh_s, "xh")):
        err = float(np.abs(got.cpu().numpy() - ref[key + "|pos"])[:, :na].max())
        aerr = float(np.abs(got_aff.cpu().numpy() - ref[key + "|aff"]).max()
                     / np.abs(ref[key + "|aff"]).max())
        moved = float(np.abs(ref[key + "|pos"] - pose0)[:, :na].max())
        line = (f"  3dbs {what} ({len(pose0)} poses, 300 steps, {secs:.3f} s): ligand vs JAX "
                f"{err:.2e} A")
        if key == "flex":
            a14_err = float(np.abs(p14.cpu().numpy() - ref["flex|a14"]).max())
            line += f", side chains {a14_err:.2e} A"
            err = max(err, a14_err)
        print(line + f" (gate {RELAX_GATE}), affinity {aerr:.2e} relative (gate {EC_AFF_GATE}; "
              f"control: moved up to {moved:.3f} A)", flush=True)
        if not (err <= RELAX_GATE and aerr <= EC_AFF_GATE and moved > RELAX_GATE):
            bad.append(what)
    if bad:
        raise AssertionError(f"relax disagrees with the JAX fixture: {bad}")
    return step_ms


def relax_profile(torch, np, prepared, results, smi):
    """Three Cartesian relax steps of the run's 16 poses under
    torch.profiler: launches per step and the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from diffbindfr_torch.ops import cartesian, vina

    pair = prepared[0]
    b = pair.bucket
    tabs = [vina.stack_to_device([t] * len(results), DEV) for t in (
        cartesian.build_cartesian_ligand(pair.lig, b.n_lig),
        vina.build_ligand(pair.lig, b.n_lig, b.n_tor),
        cartesian.build_cartesian_receptor(pair.pocket, b.n_atm))]
    lp = torch.from_numpy(np.stack([r.lig_pos for r in results])).to(DEV)
    a14 = torch.from_numpy(np.stack([r.atom14_pos for r in results])).to(DEV)
    steps = 3
    cartesian.cartesian_minimize_batch(lp, a14, *tabs, steps=steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        cartesian.cartesian_minimize_batch(lp, a14, *tabs, steps=steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((e.key, dev_us / 1e3, e.count))
    if not rows:
        print("  the profiler saw no device time: relax launches and busy share not measured",
              flush=True)
        return None
    dev_ms = sum(r[1] for r in rows)
    kernels = sum(r[2] for r in rows if not r[0].startswith(("Memcpy", "Memset")))
    print(f"  Cartesian relax, {steps} steps of {len(results)} poses under the profiler (with "
          f"the set-up and the scatter-back): wall {wall * 1e3:.1f} ms, device {dev_ms:.2f} ms "
          f"({100 * dev_ms / (wall * 1e3):.1f}% busy), {kernels / steps:.0f} kernel launches per "
          f"step, on {smi}", flush=True)
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {ms:9.3f} ms  x{cnt:<5d} {key[:90]}", flush=True)
    return kernels / steps


def relax_modes(np, TC, cli, out, tmp):
    """Phase 30 (c): `relax` in each mode on a pose exported by `out`'s run,
    each mode on its own copy: a finite pose, `_relaxed.pdb` where the mode
    writes one, no trunk kernel launched; seconds per mode."""
    import csv

    from diffbindfr_torch.io.pdb import parse_pdb
    from diffbindfr_torch.io.sdf import parse_sdf

    with open(os.path.join(out, "results.csv"), newline="") as fh:
        rows = [r for r in csv.DictReader(fh) if r["lig_sdf"]][:1]
    TC.reset_launches()
    for mode, flags in RELAX_MODES.items():
        mdir = os.path.join(tmp, "relax_" + mode)
        kept = []
        for r in rows:
            dst = os.path.join(mdir, f"pose_{r['pose']}")
            os.makedirs(dst)
            for col in ("lig_sdf", "prot_pdb"):
                shutil.copy(r[col], dst)
            kept.append({"lig_sdf": os.path.join(dst, os.path.basename(r["lig_sdf"])),
                         "prot_pdb": os.path.join(dst, os.path.basename(r["prot_pdb"]))})
        table = os.path.join(mdir, "results.csv")
        with open(table, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["lig_sdf", "prot_pdb"])
            w.writeheader()
            w.writerows(kept)
        before = [parse_sdf(k["lig_sdf"])[0].coords for k in kept]
        t0 = time.time()
        if cli.main(["relax", "-i", table, "--steps", str(RELAX_MODE_STEPS)] + flags) != 0:
            raise AssertionError(f"relax {mode} failed")
        secs = time.time() - t0
        moved = 0.0
        for k, c0 in zip(kept, before):
            c = parse_sdf(k["lig_sdf"])[0].coords
            if not (np.isfinite(c).all() and c.shape == c0.shape):
                raise AssertionError(f"relax {mode}: bad pose in {k['lig_sdf']}")
            moved = max(moved, float(np.abs(c - c0).max()))
            pdb = k["lig_sdf"][: -len(".sdf")] + "_relaxed.pdb"
            if (mode in ("flex", "cartesian")) != os.path.exists(pdb):
                raise AssertionError(f"relax {mode}: _relaxed.pdb {os.path.exists(pdb)}")
            if os.path.exists(pdb) and not np.isfinite(parse_pdb(pdb).atom_positions).all():
                raise AssertionError(f"relax {mode}: non-finite {pdb}")
        print(f"  relax {' '.join(flags) or '(rigid)'}: {len(kept)} pose ({RELAX_MODE_STEPS} "
              f"steps) in {secs:.3f} s; moved atoms up to {moved:.3f} A; finite", flush=True)
    if any(TC.launches.values()):
        raise AssertionError(f"relax launched trunk kernels: {TC.launches}")


def phase_relax(torch, np, TC, smi):
    """Relax on the card (see the module docstring, phase 30). Returns each
    B11 kernel's launches in `predict --cart-relax` and in the eval."""
    from diffbindfr_torch.app import cli, eval_cli, pipeline

    step_ms = relax_fixture_check(torch, np, pipeline, smi)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_relax_")
    try:
        out = os.path.join(tmp, "predict")
        jobs = predict_inputs(out, ("3dbs",))
        argv = ["predict", "-i", jobs, "-o", out, "-ckt", CKPT, "-mdn", MDN_CKPT, "-np", "16",
                "-bs", "16", "--cart-relax", "--cluster-rank", "2.0", "--save-poses", "-traj",
                "--export-top", "5"]
        counts, stage, wall, prepared, results, _ = predict_run(
            torch, TC, pipeline, cli, argv, 16, extra=[(pipeline, "cartesian_relax")])
        relax_s = stage["cartesian_relax"]
        print(f"  predict --cart-relax (bf16, EC 150 steps, relax 300 steps, 3dbs x 16 poses, "
              f"-bs 16): launches {counts}", flush=True)
        print(f"  stages: prep {stage['prep']:.3f} s; dock {stage['dock']:.3f} s; EC "
              f"{stage['error_correct']:.3f} s; relax {relax_s:.3f} s ({1e3 * relax_s / 300:.2f} "
              f"ms per step, {100 * relax_s / wall:.1f}% of the run); save_poses "
              f"{stage['save_poses']:.3f} s; MDN {stage['score_mdn']:.3f} s; export "
              f"{stage['export_and_rank']:.3f} s; main() {wall:.3f} s: {wall / 16:.4f} s per "
              f"pose end to end, on {smi}", flush=True)
        print(f"  relax ms per step at the fixture's 4-pose batches (first calls): "
              + ", ".join(f"{v:.2f}" for v in step_ms), flush=True)
        want = {k: 120 if k in BF16_KERNELS else 0 for k in TC.launches}
        if counts != want:
            raise AssertionError(f"predict --cart-relax launch counts {counts}, expected {want}")
        predict_read_back(np, out, prepared, results, ("3dbs",))
        relax_profile(torch, np, prepared, results, smi)

        relax_modes(np, TC, cli, out, tmp)

        data = os.path.join(tmp, "pb")
        for n in RELAX_EVAL_NAMES:
            os.makedirs(os.path.join(data, n))
            for f in os.listdir(os.path.join(PB_BENCH, n)):
                shutil.copy(os.path.join(PB_BENCH, n, f), os.path.join(data, n))
        e_out = os.path.join(tmp, "eval")
        argv = ["-d", data, "-o", e_out, "-ckt", CKPT, "-mdn", MDN_CKPT, "-np", "8", "-bs", "16",
                "--cart-relax"]
        e_counts, e_stage, e_wall, _, _, n_batches = predict_run(
            torch, TC, pipeline, eval_cli, argv, 8 * len(RELAX_EVAL_NAMES),
            extra=[(pipeline, "cartesian_relax"), (eval_cli, "validity_rows")])
        with open(os.path.join(e_out, "relax_ab.json")) as fh:
            ab = json.load(fh)
        with open(os.path.join(e_out, "validity_prerelax.csv")) as fh:
            n_pre = len(fh.read().splitlines()) - 1
        print(f"  eval_cli --cart-relax ({len(RELAX_EVAL_NAMES)} complexes x 8 poses, -bs 16, "
              f"{n_batches} batch): launches {e_counts}; dock {e_stage['dock']:.3f} s, EC "
              f"{e_stage['error_correct']:.3f} s, relax {e_stage['cartesian_relax']:.3f} s, "
              f"validity (before and after) {e_stage['validity_rows']:.3f} s, main() "
              f"{e_wall:.3f} s, on {smi}", flush=True)
        print(f"  relax_ab.json (a reading): {json.dumps(ab)}", flush=True)
        e_want = {k: 120 * n_batches if k in BF16_KERNELS else 0 for k in TC.launches}
        keys = {"validity_pass_pre", "validity_pass_post", "oracle_l_rmsd_pre",
                "oracle_l_rmsd_post", "oracle_mean_pre", "oracle_mean_post"}
        if e_counts != e_want or n_pre != 16 or set(ab) != keys or sorted(
                ab["oracle_l_rmsd_post"]) != sorted(RELAX_EVAL_NAMES):
            raise AssertionError(f"eval --cart-relax: launches {e_counts} (expected {e_want}), "
                                 f"{n_pre} pre-relax validity rows, relax_ab keys {sorted(ab)}")
        return {k: (counts[k], e_counts[k]) for k in BF16_KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ligand fields of a DockingSample: a cross-dock entry of scorer_pose_set takes
# them from one complex and the pocket fields from another (same padding)
LIG_FIELDS = ("lig_feat", "lig_pos", "lig_ref_pos", "lig_mask", "lig_e_src", "lig_e_dst",
              "lig_e_feat", "lig_e_mask", "tor_src", "tor_dst", "tor_mask", "rot_node_mask")


def scorer_pose_set(np, outdir, seed=0):
    """A small MDN pose set in tools/make_scorer_poses.py's npz format, made
    with a numpy seed from the tracked prep records (their samples made
    again at a fresh prep's buckets): self-dock entries 2zec (n_lig 32,
    n_atm 1024) and 3mhw (32, 768), the crystal ligand turned by up to 0.3
    rad about its centroid and moved 0.3-6 A (L-RMSD 0.8-6 A), side chains
    jittered by 0.05 A; one cross-dock entry, 3mhw's ligand in 2zec's pocket
    (`2zec__3mhw`, L-RMSD NaN), in 2zec's bucket, so train_cli's stratified
    self/cross draw runs there. Returns the file names."""
    from diffbindfr_torch.chem.records import load_prep_record
    from diffbindfr_torch.data.sample import make_sample
    from diffbindfr_torch.mdn_train import crystal_atom14

    rng = np.random.default_rng(seed)

    def turn(v):
        a = np.linalg.norm(v)
        k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / a
        return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k

    def poses(s, shifts):
        m = s.lig_mask > 0
        c = s.lig_pos[m].mean(0)
        out, rmsd = [], []
        for d in shifts:
            axis = rng.normal(size=3)
            u = rng.normal(size=3)
            p = (s.lig_pos - c) @ turn(axis / np.linalg.norm(axis) * rng.uniform(0, 0.3)).T
            p = ((p + c + d * u / np.linalg.norm(u)) * s.lig_mask[:, None]).astype(np.float32)
            out.append(p)
            rmsd.append(np.sqrt(((p[m] - s.lig_pos[m]) ** 2).sum(-1).mean()))
        return np.stack(out), np.asarray(rmsd, np.float32)

    def jitter(s, k):
        a14 = crystal_atom14(s)
        noise = rng.normal(size=(k,) + a14.shape) * 0.05 * s.atom14_mask[None, ..., None]
        return (a14[None] + noise).astype(np.float32)

    samples = {}
    for n in ("2zec", "3mhw"):
        rec = load_prep_record(os.path.join(PREP, f"{n}_r12.rec.pkl"))
        samples[n] = make_sample(rec["lig"], rec["pocket"])
    sets = {}
    for n, s in samples.items():
        lig, rmsd = poses(s, [0.3, 1.0, 2.0, 3.0, 4.5, 6.0])
        sets[n] = (s, lig, jitter(s, len(rmsd)), rmsd, True)
    cross = samples["2zec"]._replace(**{f: getattr(samples["3mhw"], f) for f in LIG_FIELDS})
    lig, _ = poses(cross, [0.5, 1.5, 2.5, 3.0])
    sets["2zec__3mhw"] = (cross, lig, jitter(cross, 4), np.full(4, np.nan, np.float32), False)
    os.makedirs(outdir, exist_ok=True)
    for n, (s, lig, a14, rmsd, is_self) in sets.items():
        np.savez(os.path.join(outdir, f"{n}.npz"), **{f"s_{k}": v for k, v in s._asdict().items()},
                 lig_pos=lig, atom14_pos=a14, l_rmsd=rmsd, is_self=np.array(is_self))
    return sorted(f"{n}.npz" for n in sets)


def pb_train_inputs(tmp):
    """(-p paths, -l paths): copies of runs/pb_bench's contact-chain receptors
    with their ligands beside them as `<stem>_crystal.sdf` (the crystal pose
    `-p` discovers), and those ligands."""
    recs, ligs = [], []
    for n in sorted(os.listdir(PB_BENCH)):
        src = os.path.join(PB_BENCH, n)
        for dst, name in ((f"{n}.pdb", f"{n}_protein_contact_chains.pdb"),
                          (f"{n}_crystal.sdf", f"{n}_ligand.sdf"), (f"{n}_lig.sdf", f"{n}_ligand.sdf")):
            shutil.copy(os.path.join(src, name), os.path.join(tmp, dst))
        recs.append(os.path.join(tmp, f"{n}.pdb"))
        ligs.append(os.path.join(tmp, f"{n}_lig.sdf"))
    return recs, ligs


@contextlib.contextmanager
def plain_convs(TC):
    """The trunk's conv wrappers replaced by their plain versions (autograd
    through them), so the kernel path runs without a kernel on the card."""
    saved = {k: getattr(TC, k) for k in ("pair_conv", "cross_conv", "knn_conv")}
    for k in saved:
        setattr(TC, k, getattr(TC, f"{k}_plain"))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(TC, k, v)


def phase_train_cli(torch, np, TC, params, s_np, smi):
    """train_cli at its defaults (bf16) from job tables with validation, then
    its MDN scorer training on the card and on the CPU; returns the trunk
    kernels' launches in the diffusion run's training steps and dock."""
    from diffbindfr_torch import train
    from diffbindfr_torch.app import pipeline, train_cli
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.utils.checkpoint import load_checkpoint, load_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_cli.")
    real_dock, real_eval = pipeline.dock, train.eval_step
    try:
        recs, ligs = pb_train_inputs(tmp)
        docks, evals = [], [0]

        def dock(prepared, p, net_cfg, scfg, num_poses=40, batch_size=16, **kw):
            plan = pipeline.DockEngine(p, net_cfg, scfg, batch_size, device=DEV).batches(
                prepared, num_poses)
            before = dict(TC.launches)
            res = real_dock(prepared, p, net_cfg, scfg, num_poses, batch_size, **kw)
            docks.append(({k: TC.launches[k] - before[k] for k in before}, len(plan), len(res)))
            return res

        def eval_step(*a, **kw):
            evals[0] += 1
            return real_eval(*a, **kw)

        pipeline.dock, train.eval_step = dock, eval_step
        step0 = int(load_checkpoint(CKPT, device="cpu")[1] or 0)
        steps, out = 10, os.path.join(tmp, "bf16")
        TC.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = train_cli.main(["-p", *recs, "-l", *ligs, "-o", out, "--resume", CKPT, "--steps",
                              str(step0 + steps), "--holdout", "2zec", "--val-poses", "4",
                              "--ckpt-every", "1000000", "--log-every", "5", "--device", DEV])
        wall = time.time() - t0
        counts = dict(TC.launches)
        peak = torch.cuda.max_memory_allocated()
        pipeline.dock, train.eval_step = real_dock, real_eval
        report_rate(res, f"bf16 (the default), -bs 8, remat, peak memory {peak / 2**30:.2f} GiB "
                         f"on {smi}")
        print(f"  main() {wall:.3f} s with prep and validation; losses "
              + " ".join(f"{v:.3f}" for v in res["losses"]), flush=True)
        (dock_counts, n_batches, n_poses), = docks
        train_counts = {k: counts[k] - dock_counts[k] for k in counts}
        print(f"  validation dock: {n_poses} poses in {n_batches} batches, launches "
              f"{dock_counts}; {evals[0]} evaluation forwards; launches in the {steps} steps "
              f"and evaluations: {train_counts}", flush=True)
        want_dock = {k: 120 * n_batches if k in KERNELS else 0 for k in counts}
        want = {k: 0 for k in counts}
        want.update({**{k: 6 * steps for k in BWD_KERNELS},
                     **{k: 12 * steps + 6 * evals[0] for k in KERNELS}})
        if dock_counts != want_dock or train_counts != want:
            raise AssertionError(f"launch counts: dock {dock_counts} (expected {want_dock}), "
                                 f"training {train_counts} (expected {want})")
        if len(res["losses"]) != steps or not np.isfinite(res["losses"]).all():
            raise AssertionError("non-finite bf16 training loss")
        state = load_train_state(os.path.join(out, "train_state.npz"), DEV)
        best, bstep = load_checkpoint(os.path.join(out, "ckpt_best.npz"), use_ema=True, device=DEV)
        if bstep != step0 + steps or not all(torch.equal(a, b) for a, b in zip(
                train.tree_leaves(best), train.tree_leaves(state.ema_params))):
            raise AssertionError("ckpt_best.npz does not reload to the trained EMA")

        # one full-width bf16 step: kernels against their plain versions on the card
        cfg = sn.ScoreNetConfig(compute_dtype="bfloat16", pallas_dw_dtype="float32", remat=True)
        check_train_parity(torch, params, s_np, cfg,
                           {"bf16 kernel": (True, None),
                            "bf16 plain-conv": (True, lambda: plain_convs(TC))},
                           control=sn.ScoreNetConfig(remat=True))

        # the MDN scorer: on the card against the same run on the CPU
        pose_dir = os.path.join(tmp, "poses")
        scorer_pose_set(np, pose_dir)
        jobs = os.path.join(tmp, "mdn_jobs.csv")
        with open(jobs, "w") as fh:
            fh.write("protein,protein_name,ligand,ligand_name,complex_name,crystal_ligand\n")
            for n in ("3mhw", "2zec"):
                lig = os.path.join(PB_BENCH, n, f"{n}_ligand.sdf")
                fh.write(f"{os.path.join(PB_BENCH, n, n + '_protein_contact_chains.pdb')},"
                         f"{n},{lig},{n}_ligand,{n},{lig}\n")
        base = ["--model", "mdn", "--resume", MDN_CKPT, "--warmup", "2", "--seed", "3",
                "--log-every", "1000"]
        TC.reset_launches()
        for name, extra in (("crystal", ["-i", jobs]), ("pose", ["--pose-dir", pose_dir])):
            runs = {dev: train_cli.main(base + extra + ["--steps", "4", "-bs", "2", "-o",
                                                        os.path.join(tmp, f"mdn_{name}_{dev}"),
                                                        "--device", dev])
                    for dev in (DEV, "cpu")}
            got, ref = (np.asarray(runs[d]["losses"]) for d in (DEV, "cpu"))
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            print(f"  mdn {name}: losses {' '.join(f'{v:.5f}' for v in got)} on the card, "
                  f"max rel. difference to the CPU run {err:.2e}", flush=True)
            if not err <= 1e-4 or not np.isfinite(got).all():
                raise AssertionError(f"mdn {name}: the card's losses {got} vs the CPU's {ref}")
            torch.cuda.reset_peak_memory_stats()
            timed = train_cli.main(base + extra + ["--steps", "10", "-o",
                                                   os.path.join(tmp, f"mdn_{name}_timed"),
                                                   "--device", DEV])
            report_rate(timed, f"mdn {name}, -bs 8, peak memory "
                               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
        if any(TC.launches.values()):
            raise AssertionError(f"the MDN runs launched trunk kernels: {dict(TC.launches)}")
        return {k: {"train_bf16": train_counts[k], "train_val_dock": dock_counts[k]}
                for k in list(KERNELS) + list(BWD_KERNELS) + list(BF16_KERNELS)}
    finally:
        pipeline.dock, train.eval_step = real_dock, real_eval
        shutil.rmtree(tmp, ignore_errors=True)


def probe_row(torch, results, name, got, ref, ms, dev, plain_ms, ops, peak, byts,
              library_ms=None, err=None, **extra):
    """Record one probe kernel's row (`dev`: device_ms's (ms, method)); the
    bound is the larger of `ops` at `peak` (a number, or a list of (ops,
    peak)) and `byts` at the HBM rate."""
    dev_ms, dev_how = dev
    parts = ops if isinstance(ops, list) else [(ops, peak)]
    t_ops = sum(o / p for o, p in parts)
    t_bytes = byts / PEAK_BYTES
    abs_err = float((got.double() - ref.double()).abs().max())
    row = dict(max_abs_err=abs_err, max_rel_err=rel_err(got.double(), ref.double()) if err is None
               else err, ms=ms, device_ms=dev_ms, device_ms_method=dev_how, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms,
               **extra)
    results[name] = row
    print(f"  {name}: max|err|/max|ref| {row['max_rel_err']:.2e} kernel {fmt_ms(dev_ms)} "
          f"({dev_how}; wrapper {ms:.4f} ms) plain {plain_ms:.4f} ms "
          f"bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}) library {fmt_ms(library_ms)}"
          + (f" ({fmt_ms(extra.get('library_device_ms'))} by graph replay)"
             if library_ms is not None else ""), flush=True)
    return row


def drive(torch, mods, main, argv, want):
    """Run a probe's entry point (`main(argv)`, what `python -m
    diffbindfr_torch.probes.<name>` runs) with every count of `mods` set to 0
    just before; the counts must equal `want` (counter -> launches; all others
    0). Returns the counts."""
    for m in mods:
        m.reset_launches()
    rc = main(argv)
    torch.cuda.synchronize()
    counts = {k: v for m in mods for k, v in m.launches.items()}
    expect = {k: want.get(k, 0) for k in counts}
    print(f"  entry point {main.__module__} {' '.join(argv)}: rc {rc}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if rc != 0 or counts != expect:
        raise AssertionError(f"{main.__module__} {argv}: rc {rc}, launches {counts}, "
                             f"expected {expect}")
    return counts


def phase_probe_mlp(torch, results):
    """P4 (and P3's mlps): the fused MLP kernel against its plain version
    at R = 1024 and R = 32; the entry point's launches."""
    from diffbindfr_torch.probes import mlp

    for R in (mlp.R_BLOCK, mlp.R_CHUNK):
        e, w1, b1, w2, b2 = args = mlp.inputs(R, DEV)
        got, ref = mlp.mlp(*args), mlp.mlp_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        if not bool(torch.isfinite(got).all()) or not err <= 1e-5:
            raise AssertionError(f"probe_mlp R={R}: kernel disagrees with plain ({err:.3e})")
        ms = time_ms(lambda: mlp.mlp(*args), 3, 20)
        dev = device_ms(torch, lambda: mlp.mlp(*args), "probe_mlp")
        dev_ms = dev[0]
        plain_ms = time_ms(lambda: mlp.mlp_plain(*args), 3, 20)
        # no single library call computes it: addmm, relu, mm as a reading
        calls3 = lambda: torch.mm(w2, torch.relu(torch.addmm(b1, w1, e)))  # noqa: E731
        three, three_dev = time_ms(calls3, 3, 20), graph_ms_or_none(torch, calls3)
        ops, byts = mlp.work(R)
        print(f"  R={R}: addmm + relu + mm {three:.4f} ms, {fmt_ms(three_dev)} by graph replay "
              "(a reading, not a library call)", flush=True)
        row = probe_row(torch, results, "probe_mlp" if R == mlp.R_BLOCK else "probe_mlp/R32",
                        got, ref, ms, dev, plain_ms, ops, PEAK_FP32, byts, R=R,
                        three_calls_ms=three, three_calls_device_ms=three_dev)
        if dev_ms:
            print(f"  R={R}: {ops / (dev_ms * 1e-3) / 1e9:.0f} GFLOP/s on the kernel's device "
                  f"time, {row['bound_ms'] / dev_ms:.1%} of its bound", flush=True)
    # what the profiler records of the kernel's launches over 5 calls: made
    # bare (as device_ms makes them), with 20 ms host pauses at the ends of
    # the profiler's window, each inside a record_function span, and beside
    # one aten kernel per call
    args = mlp.inputs(mlp.R_BLOCK, DEV)

    def beside_aten():
        torch.zeros(1, device=DEV)
        return mlp.mlp(*args)

    bare = lambda: mlp.mlp(*args)  # noqa: E731
    for how, fn, span, pause in (("bare", bare, False, 0.0), ("pause", bare, False, 0.02),
                                 ("in_span", bare, True, 0.0),
                                 ("beside_aten", beside_aten, False, 0.0)):
        per, names = profile_kernel(torch, fn, "probe_mlp", 5, span, pause)
        _, seen, launched = per["probe_mlp_kernel("]
        print(f"  profiler, 5 calls {how}: {seen} events of probe_mlp_kernel for {launched} "
              f"grids; device kernels seen: {names}", flush=True)
        results["probe_mlp"]["profiler_events_" + how] = [seen, launched]
    want = 8 + 2 * (mlp.MEASURE_ITERS + 1)  # 8 timed calls, then measure() at 2 widths
    results["probe_mlp"]["launches"] = drive(torch, [mlp], mlp.main, [], {"probe_mlp": want})[
        "probe_mlp"]


def phase_probe_mxu_ops(torch, results):
    """P2: legality, and both chain forms at the tool's 4096 grid steps over
    64 input blocks, each against its plain version; the tool's rates; the
    entry point's launches."""
    from diffbindfr_torch.probes import mxu_ops as M

    a = M.legality_inputs(DEV)
    got, ref = M.legality(a), M.legality_plain(a)
    err = rel_err(got, ref)
    if not err <= 1e-6 or bool(got[:, 10:].any()):
        raise AssertionError(f"legality: kernel disagrees with plain ({err:.3e})")
    probe_row(torch, results, "probe_mxu_ops/legality", got, ref,
              time_ms(lambda: M.legality(a), 3, 20),
              device_ms(torch, lambda: M.legality(a), "probe_mxu_ops/legality"),
              time_ms(lambda: M.legality_plain(a), 3, 20), 128 * (6 + 15), PEAK_FP32,
              4.0 * 128 * (8 + 16))
    metas, wn_p, din_p, dout_p, kdim, d3max = M.plan()
    src, w, cb = M.chain_inputs(M.NBLK, DEV)
    cbT = M.transpose_cb(cb)
    madds, flops = M.counts()
    in_bytes = 4.0 * M.NBLK * M.LANES * sum(chain_rows_read(metas))  # each input block once
    # vpu: the tool's rounded bf16 operations per step (Σ mul_p·128·d1·(1 + 2 d3))
    got, ref = M.chain_vpu(src, w, cb, M.REPS), M.chain_vpu_plain(src, w, cb, M.REPS)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err <= 1e-6 or bool(got[..., 4:].any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"chain_vpu: kernel disagrees with plain ({err:.3e})")
    vpu = probe_row(torch, results, "probe_mxu_ops/chain_vpu", got, ref,
                    time_ms(lambda: M.chain_vpu(src, w, cb, M.REPS), 1, 5),
                    device_ms(torch, lambda: M.chain_vpu(src, w, cb, M.REPS),
                              "probe_mxu_ops/chain_vpu"),
                    time_ms(lambda: M.chain_vpu_plain(src, w, cb, M.REPS), 0, 1),
                    float(madds) * M.REPS, PEAK_BF16X2_ROUNDED, in_bytes + nbytes(got),
                    reps=M.REPS, nblk=M.NBLK)
    del got, ref
    # mxu: the tensor-core FLOPs plus the lhs products (rounded bf16)
    got, ref = M.chain_mxu(src, w, cbT, M.REPS), M.chain_mxu_plain(src, w, cbT, M.REPS)
    torch.cuda.synchronize()
    e5, ratio = M.mxu_errors(got, ref)
    print(f"  chain_mxu: d3 = {d3max} rows max|err|/max|ref| {e5:.2e} (gate 1e-5); other rows "
          f"at {ratio:.2f} of one bf16 unit + 1e-5 max|ref| (gate 1)", flush=True)
    if not (e5 <= 1e-5 and ratio <= 1.0) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"chain_mxu: kernel disagrees with plain ({e5:.3e}, {ratio:.3f})")
    lhs_ops = float(sum(m["mul_p"] * m["d1"] * M.LANES for m in metas)) * M.REPS
    mxu = probe_row(torch, results, "probe_mxu_ops/chain_mxu", got, ref,
                    time_ms(lambda: M.chain_mxu(src, w, cbT, M.REPS), 1, 5),
                    device_ms(torch, lambda: M.chain_mxu(src, w, cbT, M.REPS),
                              "probe_mxu_ops/chain_mxu"),
                    time_ms(lambda: M.chain_mxu_plain(src, w, cbT, M.REPS), 0, 1),
                    [(float(flops) * M.REPS, PEAK_BF16_TC), (lhs_ops, PEAK_BF16X2_ROUNDED)], None,
                    in_bytes + nbytes(got), err=e5, bf16_unit_ratio=ratio, reps=M.REPS,
                    nblk=M.NBLK)
    del got, ref
    for what, key in (("wrapper", "ms"), ("kernel", "device_ms")):
        ta, tb = vpu[key], mxu[key]
        if ta and tb:
            print(f"  the tool's rates on the {what} times: VPU-form {ta:.4f} ms "
                  f"({madds * M.REPS / (ta * 1e-3) / 1e12:.2f} Tmadd/s), MXU-form {tb:.4f} ms "
                  f"({flops * M.REPS / (tb * 1e-3) / 1e12:.2f} TF/s eff): speedup x{ta / tb:.2f}",
                  flush=True)
    counts = drive(torch, [M], M.main, ["both"],
                   {"probe_mxu_ops/legality": 1, "probe_mxu_ops/chain_vpu": 1 + M.RUNS,
                    "probe_mxu_ops/chain_mxu": 1 + M.RUNS})
    for k, v in counts.items():
        results[k]["launches"] = v


def chain_rows_read(metas):
    """(src, w, cb) rows that a depthwise chain over the path metas reads:
    the union of its paths' rows."""
    src, w, cb = set(), set(), set()
    for m in metas:
        for r0 in m["src_rows"]:
            src.update(range(r0, r0 + m["mul_p"]))
        w.update(range(m["w_row"], m["w_row"] + m["mul_p"]))
        cb.update(range(m["cb_off"], m["cb_off"] + m["d1"] * m["d3"]))
    return len(src), len(w), len(cb)


def mosaic_counter(word):
    """The launch counter of the kernel that serves the P3 probe `word`."""
    if word == "mlp":
        return "probe_mlp"
    return "probe_mosaic/" + MOSAIC_ROWS["onehot" if word == "prec" else word][0]


def mosaic_work(word, args, out):
    """(fp32 operations, bytes) of one P3 probe on these inputs: each input
    element that its function reads, read once, and the output written
    once."""
    from diffbindfr_torch.probes import cm_layout, mlp, mosaic

    if word == "mlp":
        return mlp.work(args[0].shape[1])
    out_bytes = float(nbytes(out))
    if word == "dw":
        metas = cm_layout.tmetas(mosaic.dw_spec())[0]
        per_lane = sum(m["mul_p"] * (1 + m["d1"] + 2 * m["d1"] * m["d3"]) for m in metas)
        R = args[0].shape[1]
        read = (sum(chain_rows_read(metas)) + 1) * R * 4.0  # + the mask
        return float(out.shape[0] * R * per_lane), read + out_bytes
    if word == "abt":
        (m, k), n = args[0].shape, args[1].shape[0]
        return 2.0 * m * n * k, nbytes(*args) + out_bytes
    # the elements read: 3d x[:, 0:8] and x[:, 128:136]; onehot/prec the 8
    # columns a[:, :8] (p // 128 < 8); 4d b[1, 1]; the others all of each input
    if word == "3d":
        byts = 4.0 * 2 * args[0].shape[0] * 8
    elif word in ("onehot", "prec"):
        byts = 4.0 * args[0].shape[0] * 8
    elif word == "4d":
        byts = float(nbytes(args[0][1, 1]))
    else:
        byts = float(nbytes(*args))
    # 3d: 2 products and 2 sums per written element; bcast: 4 operations per
    # element (exp counted once); 4d: 1; msel: 1 sum per input; copies: 0
    ops = {"3d": 4 * 16 * 8 * 2, "bcast": 4 * out.numel(), "4d": out.numel(),
           "msel": args[0].numel()}
    return float(ops.get(word, 0)), byts + out_bytes


def phase_probe_mosaic(torch, results):
    """P3: each probe's kernel against its plain version (exact where a copy
    or one rounding, else mosaic.TOL), the library call beside it where one
    computes the same function, the Hopper form of probe_precision; the entry
    point's launches per probe."""
    from diffbindfr_torch.probes import mlp, mosaic

    tf = mosaic.onehot_matrix(64, 1024, 128, True, DEV)
    m8 = mosaic.onehot_matrix(1024, 8, 128, device=DEV)
    library = {"onehot": lambda a: torch.matmul(a, tf), "abt": lambda a, b: torch.matmul(a, b.t()),
               "msel": lambda z: torch.matmul(z, m8), "tile": lambda a: a.repeat(1, 8),
               "4d": lambda b: b[1, 1] * 2}
    library["prec"] = library["onehot"]
    for word in mosaic.WORDS:
        fn, plain, _ = mosaic.FUNCS[word]
        args = mosaic.inputs(word, DEV)
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        tol = mosaic.TOL[word]
        ok = torch.equal(got, ref) if tol == 0 else rel_err(got, ref) <= tol
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"probe {word}: kernel disagrees with plain "
                                 f"({rel_err(got, ref):.3e}, tolerance {tol})")
        if word in ("onehot", "prec"):
            moved = args[0][:, torch.arange(1024, device=DEV) // 128]
            if not torch.equal(got, moved) or not torch.equal(ref, moved):
                raise AssertionError(f"{word}: the movement is not bit-exact")
        ops, byts = mosaic_work(word, args, got)
        lib = library.get(word)
        lib_ms = lib_dev = None
        if lib:
            if tol == 0 and not torch.equal(lib(*args), ref):
                raise AssertionError(f"{word}: the library call is not exact with TF32 off")
            lib_ms = time_ms(lambda: lib(*args), 3, 20)
            lib_dev = graph_ms_or_none(torch, lambda: lib(*args))  # beside device_ms
        name = "probe_mosaic/" + MOSAIC_ROWS[word][0]
        probe_row(torch, results, name, got, ref, time_ms(lambda: fn(*args), 3, 20),
                  device_ms(torch, lambda: fn(*args), mosaic_counter(word)),
                  time_ms(lambda: plain(*args), 3, 20), ops, PEAK_FP32, byts, lib_ms,
                  library_device_ms=lib_dev)
        if word == "4d":
            # both at a launch's floor: kernel and library call in one window
            k_ms, l_ms = paired_graph_ms(torch, [lambda: fn(*args), lambda: lib(*args)])
            print(f"  4d in one graph-replay window (turns, median of 10 replays of 20 "
                  f"calls): kernel {k_ms:.4g} ms, library call {l_ms:.4g} ms, kernel / library "
                  f"{k_ms / l_ms:.4g}", flush=True)
            results[name]["paired_graph_ms"] = {"kernel": k_ms, "library": l_ms}
    # probe_precision on this card: TF32 in a movement dot. The gather and
    # the fp32 matmul (TF32 off) were exact above; the control turns TF32 on
    a = mosaic.inputs("prec", DEV)[0]
    tf = mosaic.onehot_matrix(64, 1024, 128, True, DEV)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, tf)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    moved = a[:, torch.arange(1024, device=DEV) // 128]
    d = float((tf32 - moved).abs().max())
    print(f"  precision: the gather and the fp32 matmul (TF32 off) move a[:, p // 128] bit "
          f"for bit; control, the same matmul with TF32 on: "
          + ("also exact at these values (the check cannot tell TF32 here)" if d == 0 else
             f"max|err| {d:.3e} ({d / float(moved.abs().max()):.2e} of max|ref|): TF32 rounds "
             "the moved values, which the check sees"), flush=True)
    results["probe_mosaic/precision"]["tf32_control_max_abs_err"] = d
    for word in mosaic.WORDS:
        key = mosaic_counter(word)
        counts = drive(torch, [mosaic, mlp], mosaic.main, [word], {key: 1 + mosaic.RUNS})
        results["probe_mosaic/" + MOSAIC_ROWS[word][0]]["launches"] = counts[key]



def fake_reference_sd(cfg, seed=0):
    """A random state dict with the reference TensorProductModel's key names
    and shapes (tpscore.py:203-411) for the port's ScoreNetConfig `cfg`,
    drawn from numpy's default_rng(seed): the port's copy of the JAX
    package's test function (tests/test_e3nn_import.py `_fake_reference_sd`,
    key for key and value for value; tests/test_torch_ckpt_import.py holds
    the two equal)."""
    import numpy as np

    from diffbindfr_torch.nn import irreps as IR
    from diffbindfr_torch.utils import e3nn_compat as E

    rng = np.random.default_rng(seed)
    sd = {}

    def lin(prefix, din, dout, bias=True):
        sd[f"{prefix}.weight"] = rng.normal(size=(dout, din)).astype(np.float32) * 0.2
        if bias:
            sd[f"{prefix}.bias"] = rng.normal(size=(dout,)).astype(np.float32) * 0.1

    def simple(prefix, din, dout, hidden=None, bias=True):
        hidden = dout if hidden is None else hidden
        lin(f"{prefix}.lin.0", din, hidden, bias)
        lin(f"{prefix}.lin.3", hidden, dout, bias)

    def ln(prefix, irr):
        irr = IR.Irreps.parse(irr)
        ni = sum(m for m, _ in irr.items)
        sd[f"{prefix}.mean_shift"] = np.concatenate([
            (np.ones(m) if (ir.l == 0 and ir.p == 1) else np.zeros(m))
            for m, ir in irr.items]).astype(np.float32)[None, :]
        sd[f"{prefix}.affine_weight"] = np.ones(ni, np.float32)
        sd[f"{prefix}.affine_bias"] = np.zeros(irr.num_scalars, np.float32)

    def conv(prefix, in_s, in2, out_s, nef):
        fe = E.E3nnFCTP(IR.Irreps.parse(in_s), in2, IR.Irreps.parse(out_s))
        simple(f"{prefix}.fc", nef, fe.weight_numel, hidden=nef)
        ln(f"{prefix}.batch_norm", out_s)

    ns, sed, ded = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim
    sh = IR.Irreps.parse("1x0e+1x1o+1x2e")
    simple("lig_node_embedding", cfg.lig_node_dim + sed, ns)
    simple("lig_edge_embedding", cfg.lig_edge_dim + sed + ded, ns)
    for i, n in enumerate(cfg.atom_cat_dims):
        sd[f"atom_node_embedding.atom_emb_list.{i}.weight"] = rng.normal(
            size=(n, ns)).astype(np.float32) * 0.2
    lin("atom_node_embedding.scalar_lin", ns + sed, ns, bias=False)
    simple("atom_edge_embedding", sed + ded, ns)
    simple("la_edge_embedding", sed + ded, ns)
    for fam in ("lig_conv_layers", "atom_conv_layers", "cross_al_conv_layers",
                "cross_la_conv_layers"):
        for li in range(cfg.num_conv_layers):
            in_s, out_s = cfg.layer_irreps(li)
            conv(f"{fam}.{li}", in_s, sh, out_s, 3 * ns)
    final_in = cfg.layer_irreps(cfg.num_conv_layers - 1)[1]
    simple("center_edge_embedding", sed + ded, ns)
    conv("final_conv", final_in, sh, "2x1o+2x1e", 2 * ns)
    simple("tr_final_layer", 1 + sed, 1, hidden=ns)
    simple("rot_final_layer", 1 + sed, 1, hidden=ns)
    simple("tor_edge_embedding", ded, ns)
    e_slots = E.full_tp_slots_e3nn(sh, IR.Irreps.parse("1x2e"))
    e_in2 = IR.Irreps(tuple((s["mul"], IR.Irrep(s["l"], s["p"])) for s in e_slots))
    conv("tor_bond_conv", final_in, e_in2, f"{ns}x0o+{ns}x0e", 3 * ns)
    simple("tor_final_layer", 2 * ns, 1, hidden=ns, bias=False)
    simple("sc_edge_embedding", ded, ns)
    conv("sc_tor_bond_conv", final_in, e_in2, f"{ns}x0o+{ns}x0e", 3 * ns)
    simple("sc_tor_final_layer", 2 * ns, 1, hidden=ns, bias=False)
    return sd


def signed_volumes(np, pos, quads):
    """Signed volume of each chiral quad (center, three neighbours)."""
    p0, p1, p2, p3 = (pos[quads[:, k]] for k in range(4))
    return (np.cross(p1 - p0, p2 - p0) * (p3 - p0)).sum(-1)


def phase_conformers(torch, np, TC, smi):
    """Conformer starts on the card (see the module docstring, phase 32)."""
    import csv

    from diffbindfr_torch import sampler as sp
    from diffbindfr_torch.app import cli
    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.chem import embed as E
    from diffbindfr_torch.chem.ligand_feats import featurize_ligand
    from diffbindfr_torch.chem.mol import perceive
    from diffbindfr_torch.io.sdf import parse_sdf

    worst, n_terms = 0.0, 0
    for n in EVAL_NAMES:
        lig = featurize_ligand(perceive(parse_sdf(
            os.path.join(PB_BENCH, n, f"{n}_ligand.sdf"))[0]), n)
        r = E.build_restraints(lig)
        # each restraint term and its gradient at equal positions (4 MDS
        # starts) on the card and on the CPU, at both phases' weights
        lo, hi = E._distance_bounds(lig, r)
        rng = np.random.default_rng(0)
        x0 = E.mirrored_inits(np.stack([E._mds_init(lo, hi, rng) for _ in range(4)]), r)
        for w_nb, _ in E.PHASES:
            got = {}
            for dev in (DEV, "cpu"):
                x = torch.as_tensor(x0, device=dev).requires_grad_(True)
                terms = E.restraint_terms(x, E.restraint_tensors(r, dev), w_nb)
                got[dev] = {k: (v.detach().double().cpu(), torch.autograd.grad(
                    v.sum(), x, retain_graph=True)[0].double().cpu()) for k, v in terms.items()}
            for k, (v, g) in got["cpu"].items():
                worst = max(worst, rel_err(got[DEV][k][0], v), rel_err(got[DEV][k][1], g))
                n_terms += 1
        if n == "3dbs":  # the CUDA-graph refinement against the eager one
            t = E.restraint_tensors(r, DEV)
            secs = {}
            for graph in (True, False):
                torch.cuda.synchronize()
                t0 = time.time()
                secs[graph] = (E.refine(x0.copy(), t, 500, DEV, graph=graph), time.time() - t0)
            drift = float(np.abs(secs[True][0][0] - secs[False][0][0]).max())
            print(f"  {n}: refinement of 4 starts, CUDA graph {secs[True][1]:.3f} s, eager "
                  f"{secs[False][1]:.3f} s; conformers {drift:.2e} A apart (gate 1e-4)",
                  flush=True)
            if not drift <= 1e-4:
                raise AssertionError("the graphed refinement disagrees with the eager one")
        torch.cuda.synchronize()
        t0 = time.time()
        confs = E.embed_conformers(lig, 2, seed=0, device=DEV)
        torch.cuda.synchronize()
        secs = time.time() - t0
        bad = [i for i, c in enumerate(confs) if not (
            E.conformer_ok(c, lig, r) and np.array_equal(
                np.sign(signed_volumes(np, c, r.chiral_quads)), r.chiral_sign))]
        print(f"  {n}: {lig.num_atoms} atoms, {len(r.chiral_quads)} chiral centres: 2 "
              f"conformers in {secs:.3f} s on the card; failing ok()/chirality: {bad or 'none'}",
              flush=True)
        if confs.shape != (2, lig.num_atoms, 3) or not np.isfinite(confs).all() or bad:
            raise AssertionError(f"{n}: conformers {confs.shape}, failing {bad}")
    print(f"  restraint terms and gradients, card vs CPU at equal positions: max rel err "
          f"{worst:.2e} over {n_terms} terms (gate {EMBED_GATE:g})", flush=True)
    if not worst <= EMBED_GATE:
        raise AssertionError("the card's restraint terms disagree with the CPU's")

    # predict -nc 2 -np 8 of 3dbs from its raw files
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conformers_")
    sample, starts = sp.sample, []

    def spy(params, net_cfg, cfg, batch, noise, **kw):
        starts.append(batch.lig_ref_pos.cpu().numpy())
        return sample(params, net_cfg, cfg, batch, noise, **kw)

    try:
        out = os.path.join(tmp, "nc")
        jobs = predict_inputs(out, ("3dbs",), copy_cache=False)
        sp.sample = spy
        argv = ["predict", "-i", jobs, "-o", out, "-ckt", CKPT, "-mdn", MDN_CKPT, "-np", "8",
                "-bs", "16", "-nc", "2"]
        counts, stage, wall, prepared, results, _ = predict_run(torch, TC, pipeline, cli,
                                                                argv, 8)
    finally:
        sp.sample = sample
    try:
        pair = prepared[0]
        confs, na = pair.conformers, pair.lig.num_atoms
        if confs is None or confs.shape != (2, na, 3) or len(starts) != 1:
            raise AssertionError(f"conformers {None if confs is None else confs.shape}, "
                                 f"{len(starts)} sampler calls")

        def dmat(p):
            return np.linalg.norm(p[:, None] - p[None, :], axis=-1)

        err = max(float(np.abs(dmat(starts[0][po, :na]) - dmat(confs[po % 2])).max())
                  for po in range(8))
        pad = float(np.abs(starts[0][:8, na:]).max()) if starts[0].shape[1] > na else 0.0
        with open(os.path.join(out, "results.csv"), newline="") as fh:
            rows = list(csv.DictReader(fh))
        coords = np.concatenate([parse_sdf(r["lig_sdf"])[0].coords for r in rows])
        print(f"  predict -nc 2 -np 8 (3dbs from raw files, bf16): prep with the embedding "
              f"{stage['prep']:.3f} s, dock {stage['dock']:.3f} s, main() {wall:.3f} s "
              f"({wall / 8:.4f} s per pose) on {smi}; launches {counts}", flush=True)
        print(f"  replica starts vs conformer po % 2: internal distances max {err:.2e} A "
              f"(gate 1e-4), padding rows {pad:g}; {len(rows)} exported poses, "
              f"finite {bool(np.isfinite(coords).all())}", flush=True)
        want = {k: 120 if k in BF16_KERNELS else 0 for k in TC.launches}
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        if not (err <= 1e-4 and pad == 0.0 and len(rows) == 8 and np.isfinite(coords).all()):
            raise AssertionError("the replicas did not start from their conformers")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tp_flops(tp):
    """Multiply-adds x 2 of one pair through a weighted 'fc' TP (per path:
    the CG contraction and the weight contraction, as
    irreps.apply_fc_tensor_product computes them)."""
    fl = 0
    for p in tp.paths:
        d1, d2, d3 = 2 * p.l1 + 1, 2 * p.l2 + 1, 2 * p.l3 + 1
        if p.mul2 == 1:
            fl += 2 * (d2 * d1 * d3 + p.mul1 * d1 * d3 + p.mul1 * p.mul3 * d3)
        else:
            fl += 2 * (p.mul1 * p.mul2 * d1 * d2 * d3 + p.mul1 * p.mul2 * p.mul3 * d3)
    return fl


def phase_fc_import(torch, np, TC, smi):
    """Reference-checkpoint import and the 'fc' dock on the card (see the
    module docstring, phase 33)."""
    from types import SimpleNamespace

    from diffbindfr_torch.app import cli
    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.data.sample import DockingSample, stack_samples, to_device
    from diffbindfr_torch.models import mdn_scorer as mdn
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import layers as L
    from diffbindfr_torch.utils.checkpoint import load_checkpoint

    ref = np.load(FIXTURE_FC)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fc_")
    convert = [sys.executable, "-m", "diffbindfr_torch.utils.torch_import"]
    try:
        cfg = sn.ScoreNetConfig(conv_mode="fc", compute_dtype="float32")
        t0 = time.time()
        sd = fake_reference_sd(cfg)
        pth, net = os.path.join(tmp, "ref.pth"), os.path.join(tmp, "net.npz")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        proc = subprocess.run(convert + [pth, "-o", net, "--arch", "score_net",
                                         "--unverified-scorenet"],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"torch_import failed: {proc.stderr[-2000:]}")
        print(f"  full-width reference state dict ({len(sd)} tensors, "
              f"{sum(v.size for v in sd.values())} values) -> torch_import --arch score_net: "
              f"{time.time() - t0:.3f} s; {proc.stdout.strip().splitlines()[-1]}", flush=True)
        params, _ = load_checkpoint(net, device=DEV)
        s = DockingSample(**{f: ref["sample|" + f] for f in DockingSample._fields})
        nt = len(ref["t"])
        batch = to_device(stack_samples([s] * nt), DEV)
        t = torch.from_numpy(ref["t"]).to(DEV)
        sig = sn.Sigmas(*[torch.from_numpy(ref["sig|" + k]).to(DEV)
                          for k in ("tr", "rot", "tor", "sc_tor")])
        with torch.no_grad():
            out = sn.apply(params, cfg, batch, t, sig, use_kernels=False)
        errs = {f: rel_err(getattr(out, f), torch.from_numpy(ref[f]).to(DEV))
                for f in ("tr", "rot", "tor", "sc_tor")}
        print(f"  converted 'fc' forward at t {ref['t'].tolist()} vs the JAX fixture: "
              + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()) + f" (gate {FC_GATE:g})",
              flush=True)
        if not all(e <= FC_GATE for e in errs.values()):
            raise AssertionError(f"the converted model disagrees with JAX: {errs}")

        # the MDN head: the fixture's synthetic reference block through the CLI
        mpth, mnpz = os.path.join(tmp, "mdn.pth"), os.path.join(tmp, "mdn.npz")
        torch.save({"state_dict": {k[len("mdn|sd|"):]: torch.from_numpy(ref[k])
                                   for k in ref.files if k.startswith("mdn|sd|")}}, mpth)
        proc = subprocess.run(convert + [mpth, "-o", mnpz, "--arch", "mdn"], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"torch_import --arch mdn failed: {proc.stderr[-2000:]}")
        mp, _ = load_checkpoint(mnpz, device=DEV)
        lig_s, pro_s = (torch.from_numpy(ref[k]).to(DEV)[None] for k in ("mdn|lig_s", "mdn|pro_s"))
        nl, nr = lig_s.shape[1], pro_s.shape[1]
        ns_ = SimpleNamespace(atom14_mask=torch.ones(1, nr, 14, device=DEV),
                              lig_mask=torch.ones(1, nl, device=DEV),
                              res_mask=torch.ones(1, nr, device=DEV),
                              lig_e_src=torch.zeros(1, 1, dtype=torch.int64, device=DEV),
                              lig_e_dst=torch.zeros(1, 1, dtype=torch.int64, device=DEV))
        with torch.no_grad():
            head = mdn.mdn_head(mp, mdn.MDNConfig(), lig_s, pro_s,
                                torch.zeros(1, nl, 3, device=DEV),
                                torch.zeros(1, nr, 14, 3, device=DEV), ns_)
        merrs = {f: rel_err(getattr(head, f)[0], torch.from_numpy(ref["mdn|" + f]).to(DEV))
                 for f in ("pi", "sigma", "mu")}
        print("  imported MDN head vs the JAX fixture: "
              + ", ".join(f"{f} {e:.2e}" for f, e in merrs.items()), flush=True)
        if not all(e <= FC_GATE for e in merrs.values()):
            raise AssertionError(f"the imported MDN head disagrees with JAX: {merrs}")

        # predict --conv-mode fc with the converted checkpoint (bf16, the
        # tracked 3dbs cache at its (128, 1024) bucket); the per-pair work
        # is counted by wrapping the TP's messages
        flops = {"pairs": 0, "flop": 0}
        messages = L.tp_conv_messages

        def counted(p, spec, src, sh, e):
            pairs = int(np.prod(e.shape[:-1]))
            ne, hid, numel = e.shape[-1], p["fc"]["l1"]["w"].shape[1], spec.tp.weight_numel
            flops["pairs"] += pairs
            flops["flop"] += pairs * (2 * ne * hid + 2 * hid * numel + tp_flops(spec.tp))
            return messages(p, spec, src, sh, e)

        out_dir = os.path.join(tmp, "fc")
        jobs = predict_inputs(out_dir, ("3dbs",))
        argv = ["predict", "-i", jobs, "-o", out_dir, "-ckt", net, "-mdn", MDN_CKPT,
                "--conv-mode", "fc", "-np", "4", "-bs", "4"]
        torch.cuda.reset_peak_memory_stats()
        L.tp_conv_messages = counted
        try:
            counts, stage, wall, prepared, results, _ = predict_run(torch, TC, pipeline, cli,
                                                                    argv, 4)
        finally:
            L.tp_conv_messages = messages
        peak = torch.cuda.max_memory_allocated()
        finite = all(np.isfinite(r.lig_pos).all() and np.isfinite(r.mdn_nll) for r in results)
        print(f"  predict --conv-mode fc -np 4 -bs 4 (bf16, 3dbs, bucket "
              f"({prepared[0].bucket.n_lig}, {prepared[0].bucket.n_atm})): dock "
              f"{stage['dock']:.3f} s ({stage['dock'] / 4:.4f} s per pose), EC "
              f"{stage['error_correct']:.3f} s, MDN {stage['score_mdn']:.3f} s, main() "
              f"{wall:.3f} s ({wall / 4:.4f} s per pose); 'fc' pairs {flops['pairs']} "
              f"({flops['pairs'] / 4 / 20:.0f} per pose and step), {flops['flop']:.4e} flop, "
              f"{flops['flop'] / stage['dock'] / 1e12:.3f} TFLOP/s over the dock; peak memory "
              f"{peak / 2**30:.3f} GiB; chunk {L.FC_CHUNK_PAIRS} pairs; launches {counts}; "
              f"on {smi}", flush=True)
        if any(counts.values()):
            raise AssertionError(f"the 'fc' dock launched trunk kernels: {counts}")
        if not finite:
            raise AssertionError("non-finite 'fc' poses or scores")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# one f32 'fc' train step's gradients, the card against the CPU: relative L2
# distance over every parameter gradient (the two sum in other orders)
FC_GRAD_GATE = 1e-4
SAMPLE_3MHW = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3mhw_r12.npz")


def pb_jobs_csv(path):
    """A crystal job table of runs/pb_bench's five complexes (receptor,
    its ligand, the ligand as the crystal pose)."""
    with open(path, "w") as fh:
        fh.write("protein,protein_name,ligand,ligand_name,complex_name,crystal_ligand\n")
        for n in sorted(os.listdir(PB_BENCH)):
            lig = os.path.join(PB_BENCH, n, f"{n}_ligand.sdf")
            fh.write(f"{os.path.join(PB_BENCH, n, n + '_protein_contact_chains.pdb')},{n},"
                     f"{lig},{n}_ligand,{n},{lig}\n")
    return path


def phase_fc_train(torch, np, TC, smi):
    """'fc' training on the card (the module docstring, phase 34)."""
    from torch.profiler import ProfilerActivity, profile

    from diffbindfr_torch import train
    from diffbindfr_torch.app import train_cli
    from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import layers as L
    from diffbindfr_torch.sampler import SamplerConfig
    from diffbindfr_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from diffbindfr_torch.utils.torch_import import import_score_net

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fc_train.")
    real_chunk = L._chunk_mean
    chunks = [0]

    def counted(*a):
        chunks[0] += 1
        return real_chunk(*a)

    try:
        t0 = time.time()
        cfg = sn.ScoreNetConfig(conv_mode="fc")
        params, _ = import_score_net(fake_reference_sd(cfg), cfg)
        net = os.path.join(tmp, "net.npz")
        save_checkpoint(net, params)
        print(f"  the synthetic reference converted and saved in {time.time() - t0:.3f} s",
              flush=True)
        jobs = pb_jobs_csv(os.path.join(tmp, "jobs.csv"))
        steps = 3
        TC.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        L._chunk_mean = counted
        t0 = time.time()
        try:
            res = train_cli.main(["-i", jobs, "-o", os.path.join(tmp, "out"), "--conv-mode",
                                  "fc", "--resume", net, "--steps", str(steps), "-bs", "8",
                                  "--log-every", "1", "--ckpt-every", "1000000", "--device",
                                  DEV])
        finally:
            L._chunk_mean = real_chunk
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = dict(TC.launches)
        report_rate(res, f"'fc' train_cli from the converted reference, bf16 (the default), "
                         f"-bs 8, remat, peak memory {peak / 2**30:.3f} GiB on {smi}")
        print(f"  main() {wall:.3f} s with prep; losses "
              + " ".join(f"{v:.4f}" for v in res["losses"])
              + f"; {res['samples']} samples; chunk runs {chunks[0]} ({chunks[0] / steps:.0f} "
              f"per step: a trunk conv's chunks run 3 times a step under remat, forward, "
              f"recompute, backward; a head conv's twice); trunk kernel launches {counts}", flush=True)
        if any(counts.values()):
            raise AssertionError(f"'fc' training launched trunk kernels: {counts}")
        if len(res["losses"]) != steps or not np.isfinite(res["losses"]).all():
            raise AssertionError(f"'fc' training losses {res['losses']}")
        tuned, step = load_checkpoint(os.path.join(tmp, "out", f"ckpt_{steps:07d}.npz"),
                                      use_ema=False, device=DEV)
        start, _ = load_checkpoint(net, use_ema=False, device=DEV)
        moved = max(float((a - b).abs().max()) for a, b in zip(
            train.tree_leaves(tuned), train.tree_leaves(start)) if a.numel())
        print(f"  fine-tuned checkpoint at step {step}: max |change| from the import "
              f"{moved:.3e}", flush=True)
        if step != steps or not 0 < moved < 1.0:
            raise AssertionError(f"the fine-tuned checkpoint: step {step}, change {moved}")

        # one bf16 step of the same model under the profiler (3mhw, B = 8)
        s_np = _load_sample_npz(SAMPLE_3MHW)
        tcfg, scfg = train.TrainConfig(), SamplerConfig()
        batch = to_device(stack_samples([s_np] * 8), DEV)
        noise = train.draw_noise(batch, tcfg, torch.Generator(device=DEV).manual_seed(4))
        bcfg = sn.ScoreNetConfig(conv_mode="fc", compute_dtype="bfloat16", remat=True)
        t0 = time.time()
        train.loss_and_grads(tuned, batch, noise, bcfg, scfg, tcfg, use_kernels=False)
        torch.cuda.synchronize()
        warm = time.time() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            train.loss_and_grads(tuned, batch, noise, bcfg, scfg, tcfg, use_kernels=False)
            torch.cuda.synchronize()
            pwall = time.time() - t0
        t0 = time.time()
        report_profile(prof, pwall, f"one bf16 'fc' train step (3mhw, B = 8; {warm:.3f} s "
                                    f"without the profiler)", [], steps=1)
        print(f"  the profile read in {time.time() - t0:.3f} s", flush=True)

        # one f32 step's gradients: the card against the CPU (3mhw, B = 1)
        one = stack_samples([s_np])
        noise = train.draw_noise(one, tcfg, torch.Generator().manual_seed(12))
        fcfg = sn.ScoreNetConfig(conv_mode="fc", remat=True)
        grads, terms = {}, {}
        for dev in (DEV, "cpu"):
            p = start if dev == DEV else load_checkpoint(net, use_ema=False, device="cpu")[0]
            t0 = time.time()
            m, g = train.loss_and_grads(p, to_device(one, dev), train.TrainNoise(
                *[v.to(dev) for v in noise]), fcfg, scfg, tcfg, use_kernels=False)
            grads[dev] = [x.detach().double().cpu() for x in g]
            terms[dev] = {k: float(v) for k, v in m.items()}
            print(f"  f32 'fc' step on {dev}: {time.time() - t0:.3f} s, "
                  + " ".join(f"{k} {v:.6g}" for k, v in terms[dev].items()), flush=True)
        diff = torch.cat([(a - b).flatten() for a, b in zip(grads[DEV], grads["cpu"])])
        ref = torch.cat([b.flatten() for b in grads["cpu"]])
        rel = float(diff.norm() / ref.norm())
        print(f"  f32 'fc' gradients, the card against the CPU: relative L2 {rel:.3e} over "
              f"{len(ref)} entries (gate {FC_GRAD_GATE:g})", flush=True)
        if not rel <= FC_GRAD_GATE:
            raise AssertionError(f"'fc' gradients on the card vs the CPU: {rel:.3e}")
    finally:
        L._chunk_mean = real_chunk
        shutil.rmtree(tmp, ignore_errors=True)


def phase_split(torch, np, TC, params, smi):
    """The dock split over a mesh, KarmaDock, and a trace (the module
    docstring, phase 35)."""
    from diffbindfr_torch import parallel
    from diffbindfr_torch import sampler as sp
    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
    from diffbindfr_torch.mdn_train import crystal_atom14
    from diffbindfr_torch.models import karmadock as kd
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.utils import observe

    cfg, scfg = sn.ScoreNetConfig(), sp.SamplerConfig()
    prepared = [pipeline.PreparedPair.from_prep_cache(SAMPLE)]
    runs = {}
    for name, bs, devices in (("unsplit", 16, None), ("unsplit, B = 8", 8, None),
                              ("split", 16, [DEV + ":0", DEV + ":0"])):
        eng = pipeline.DockEngine(params, cfg, scfg, batch_size=bs, device=DEV, verbose=False,
                                  devices=devices)
        if (name == "split") != eng.split:
            raise AssertionError(f"{name}: DockEngine.split is {eng.split}")
        if name != "split":  # the split's shards have the shapes B = 8 warmed
            eng.run(prepared, num_poses=16, seed=5)
        TC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res = eng.run(prepared, num_poses=16, seed=3)
        torch.cuda.synchronize()
        runs[name] = (np.stack([r.lig_pos for r in res]), np.stack([r.atom14_pos for r in res]),
                      time.time() - t0, dict(TC.launches))
    def dist(a, b):
        return max(float(np.abs(runs[a][0] - runs[b][0]).max()),
                   float(np.abs(runs[a][1] - runs[b][1]).max()))

    for name, (_, _, t, c) in runs.items():
        print(f"  16 poses of 3dbs, 20 steps, {name}"
              + (" over make_mesh([cuda:0, cuda:0]) (two shards of 8 on one card, not two "
                 "cards)" if name == "split" else "")
              + f": {t:.3f} s ({16 / t:.3f} poses/s), launches {c}", flush=True)
    err, b16, ctl = dist("split", "unsplit, B = 8"), dist("split", "unsplit"), dist(
        "unsplit, B = 8", "unsplit")
    print(f"  max |pose difference|: split vs the unsplit dock at the shards' batch size "
          f"{err:.3e} A (gate 1e-3); vs the unsplit dock at B = 16 {b16:.3e} A, where the "
          f"unsplit docks at B = 8 and 16 differ by {ctl:.3e} A (the kernels' row groups "
          f"follow the batch; 20 steps amplify the sums' other order) on {smi}", flush=True)
    if not (err <= 1e-3 and np.isfinite(runs["split"][0]).all()):
        raise AssertionError(f"the split dock differs from the unsplit one by {err:.3e} A")
    want = {name: {k: n if k in KERNELS else 0 for k in TC.launches}
            for name, n in (("unsplit", 120), ("unsplit, B = 8", 240), ("split", 240))}
    if any(runs[name][3] != want[name] for name in runs):
        raise AssertionError(f"launch counts: { {n: r[3] for n, r in runs.items()} }")

    # KarmaDock at its default width on the card against its CPU run
    kcfg = kd.KarmaDockConfig()
    kp = kd.init_params(torch.Generator().manual_seed(0), kcfg)
    s_np = _load_sample_npz(SAMPLE)
    rng = np.random.default_rng(0)
    lig = np.stack([(s_np.lig_pos + rng.normal(size=s_np.lig_pos.shape) * 0.5)
                    * s_np.lig_mask[:, None] for _ in range(4)]).astype(np.float32)
    p14 = np.stack([crystal_atom14(s_np)] * 4).astype(np.float32)
    outs = {}
    for dev in (DEV, "cpu"):
        b = to_device(stack_samples([s_np] * 4), dev)
        kpd = parallel.replicate([torch.device(dev)], kp)[0]
        t0 = time.time()
        with torch.no_grad():
            o = kd.apply(kpd, kcfg, b, torch.from_numpy(lig).to(dev),
                         torch.from_numpy(p14).to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        outs[dev] = {f: getattr(o, f).cpu() for f in o._fields}
        print(f"  KarmaDock (hidden {kcfg.mdn.hidden}, {kcfg.egnn_layers} EGNN layers) on 4 "
              f"poses of 3dbs on {dev}: {time.time() - t0:.3f} s", flush=True)
    kerr = {f: rel_err(outs[DEV][f], outs["cpu"][f]) for f in outs["cpu"]}
    print("  KarmaDock, the card against the CPU: " + ", ".join(
        f"{f} {e:.2e}" for f, e in kerr.items()) + " of max|ref| (gate 1e-4)", flush=True)
    if not all(e <= 1e-4 for e in kerr.values()):
        raise AssertionError(f"KarmaDock on the card vs the CPU: {kerr}")

    # observe.trace around one bf16 dock step: the trace names B11's kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace.")
    try:
        bcfg = sn.ScoreNetConfig(compute_dtype="bfloat16")
        one = sp.SamplerConfig(actual_steps=1)
        batch = to_device(stack_samples([s_np] * 16), DEV)
        noise = sp.draw_noise(batch, one, torch.Generator(device=DEV).manual_seed(6))
        with torch.no_grad():
            sp.sample(params, bcfg, one, batch, noise)
            t0 = time.time()
            with observe.trace(tmp) as prof:
                sp.sample(params, bcfg, one, batch, noise)
            twall = time.time() - t0
        with open(prof.trace_path) as fh:
            names = {str(e.get("name", "")) for e in json.load(fh)["traceEvents"]}
        found = {k: [sym for sym in SYMBOLS[k] if any(sym in n for n in names)]
                 for k in BF16_KERNELS}
        print(f"  observe.trace of one bf16 dock step (B = 16): {twall:.3f} s with the "
              f"export, {os.path.getsize(prof.trace_path) / 2**20:.2f} MiB, {len(names)} "
              f"distinct event names; B11 symbols found {found}", flush=True)
        if not all(found.values()):
            raise AssertionError(f"the trace does not name every B11 kernel: {found}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import numpy as np
    import torch

    with Phase("device"):
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this run needs a GPU")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
              flush=True)
        sys.path.insert(0, ROOT)
        from diffbindfr_torch.utils.device import resolve_device

        resolve_device(DEV)

    from diffbindfr_torch import sampler as sp
    from diffbindfr_torch.app import pipeline
    from diffbindfr_torch.data.sample import _load_sample_npz, stack_samples, to_device
    from diffbindfr_torch.geometry.kabsch import masked_rmsd
    from diffbindfr_torch.models import score_net as sn
    from diffbindfr_torch.nn import trunk_convs as TC
    from diffbindfr_torch.utils import cuda_build
    from diffbindfr_torch.utils.checkpoint import load_checkpoint

    with Phase("build"):
        cuda_build.load()
        for line in "\n".join(cuda_build.build_log).splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip(), flush=True)
            elif "Compiling entry function" in line:  # the kernel the next lines describe
                print("  " + line.strip().replace("ptxas info    : ", "")[:100], flush=True)

    with Phase("load"):
        params, step = load_checkpoint(CKPT, use_ema=True, device=DEV)
        s_np = _load_sample_npz(SAMPLE)
        print(f"  checkpoint step {step}; sample {os.path.relpath(SAMPLE, ROOT)}", flush=True)

    scfg = sp.SamplerConfig()
    with Phase("tables"):
        phase_tables(torch, np, sp, sn, scfg)

    per_kernel = {}
    with Phase("kernels"):
        phase_kernels(torch, params, s_np, per_kernel)

    cfg = sn.ScoreNetConfig()
    with Phase("forward"):
        ref = np.load(FIXTURE)
        fs = s_np._replace(lig_pos=(s_np.lig_pos + ref["shift"]) * s_np.lig_mask[:, None])
        batch = to_device(stack_samples([fs]), DEV)
        t = torch.tensor([float(ref["t"])], device=DEV)
        sig = sn.sigmas_from_t(t, SCHED)
        with torch.no_grad():
            out_k = sn.apply(params, cfg, batch, t, sig, use_kernels=True)
            out_p = sn.apply(params, cfg, batch, t, sig, use_kernels=False)
            fwd_ms = time_ms(lambda: sn.apply(params, cfg, batch, t, sig, use_kernels=True), 1, 3)
        errs = {}
        for f in ("tr", "rot", "tor", "sc_tor"):
            k_, p_ = getattr(out_k, f)[0], getattr(out_p, f)[0]
            r_ = torch.from_numpy(ref[f]).to(DEV)
            errs[f] = {"vs_jax": rel_err(k_, r_), "vs_plain": rel_err(k_, p_)}
            print(f"  {f}: kernels vs JAX fixture {errs[f]['vs_jax']:.2e}, "
                  f"vs plain path on the card {errs[f]['vs_plain']:.2e}", flush=True)
        print(f"  full-width forward B=1: {fwd_ms:.2f} ms", flush=True)
        bad = [f for f, e in errs.items() if not e["vs_jax"] <= 1e-3]
        if bad:
            raise AssertionError(f"forward disagrees with the JAX fixture on {bad}")

    with Phase("dock"):
        prepared = [pipeline.PreparedPair.from_prep_cache(SAMPLE)]
        n_poses, steps = 16, scfg.actual_steps
        # first call: warms the allocator and the libraries
        t0 = time.time()
        pipeline.dock(prepared, params, cfg, scfg, num_poses=n_poses, batch_size=n_poses,
                      seed=1, device=DEV, verbose=False)
        torch.cuda.synchronize()
        print(f"  first (cold) dock call: {time.time() - t0:.3f} s", flush=True)
        TC.reset_launches()
        t0 = time.time()
        res = pipeline.dock(prepared, params, cfg, scfg, num_poses=n_poses,
                            batch_size=n_poses, seed=0, device=DEV, verbose=False)
        torch.cuda.synchronize()
        dock_s = time.time() - t0
        counts = dict(TC.launches)
        print(f"  launches during dock: {counts}", flush=True)
        docked = res  # phase 22 scores these poses
        lig = np.stack([r.lig_pos for r in res])
        finite = bool(np.isfinite(lig).all() and all(np.isfinite(r.atom14_pos).all() for r in res))
        mask = s_np.lig_mask > 0
        rmsd = np.sqrt(((lig[:, mask] - s_np.lig_pos[mask]) ** 2).sum(-1).mean(-1))
        print(f"  {n_poses} poses, {steps} steps in {dock_s:.3f} s: "
              f"{n_poses / dock_s:.3f} poses/s on {smi}", flush=True)
        print(f"  RMSD to the prep-cache pose: min {rmsd.min():.3f} A, "
              f"median {np.median(rmsd):.3f} A; per pose "
              + " ".join(f"{v:.2f}" for v in rmsd), flush=True)
        # rerun poses 0..3 through the plain path with the same noise
        gen = torch.Generator(device=DEV).manual_seed(0)
        full = to_device(stack_samples([s_np] * n_poses), DEV)
        noise = sp.draw_noise(full, scfg, gen).select([0, 1, 2, 3])
        four = to_device(stack_samples([s_np] * 4), DEV)
        with torch.no_grad():
            plain = sp.sample(params, cfg, scfg, four, noise, use_kernels=False)
        m4 = four.lig_mask
        dk = masked_rmsd(torch.from_numpy(lig[:4]).to(DEV), plain.lig_pos, m4).tolist()
        print("  kernel vs plain path, same noise, per-pose RMSD (A): "
              + ", ".join(f"{v:.2e}" for v in dk), flush=True)
        want = 6 * steps
        if counts != {k: want if k in KERNELS else 0 for k in TC.launches}:
            raise AssertionError(f"launch counts {counts}, expected {want} each")
        if not finite:
            raise AssertionError("non-finite poses")

    with Phase("profile"):
        cmt_profile = phase_profile(torch, sp, params, cfg, s_np)

    with Phase("bwd_kernels"):
        phase_bwd_kernels(torch, params, s_np, per_kernel)

    with Phase("train_parity"):
        phase_train_parity(torch, params, s_np)

    with Phase("train"):
        train_counts = phase_train(torch, smi)

    with Phase("rm_kernels"):
        phase_rm_kernels(torch, params, s_np, per_kernel)

    with Phase("rm_forward"):
        phase_rm_forward(torch, np, sn, params, s_np)

    with Phase("rm_dock"):
        rm_counts = phase_rm_dock(torch, np, sn, sp, pipeline, TC, params, s_np, smi)

    with Phase("rm_profile"):
        phase_rm_profile(torch, sn, sp, params, s_np, cmt_profile)

    with Phase("rm_grad"):
        phase_rm_grad(torch, sn, params, s_np)

    with Phase("probe_bf16"):
        bf16_rate = phase_probe_bf16(torch, per_kernel)

    with Phase("bf16_kernels"):
        phase_bf16_kernels(torch, params, s_np, per_kernel, bf16_rate)

    with Phase("bf16_forward"):
        phase_bf16_forward(torch, np, sn, TC, params, s_np)

    with Phase("bf16_dock"):
        bf16_counts = phase_bf16_dock(torch, np, sn, sp, pipeline, TC, params, s_np, smi,
                                      cmt_profile)

    # the stages of predict after the dock: plain PyTorch on the card (the
    # JAX package runs them as XLA, with no Pallas kernel)
    with Phase("ec_mdn_ref"):
        mdn_params, _ = load_checkpoint(MDN_CKPT, use_ema=True, device=DEV)
        phase_ec_mdn_ref(torch, np, pipeline, mdn_params, smi)

    with Phase("score_chain"):
        phase_score_chain(torch, np, pipeline, prepared, docked, mdn_params, smi)

    # the probes' plain versions and library yardsticks run fp32 matmuls in
    # full fp32: TF32 off, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    with Phase("probe_mlp"):
        phase_probe_mlp(torch, per_kernel)

    with Phase("probe_mxu_ops"):
        phase_probe_mxu_ops(torch, per_kernel)

    with Phase("probe_mosaic"):
        phase_probe_mosaic(torch, per_kernel)

    with Phase("predict"):
        phase_predict(torch, np, TC, smi)

    fresh = {}
    with Phase("prep_predict"):
        phase_prep_predict(torch, np, TC, params, smi, fresh)

    with Phase("serve"):
        serve_counts = phase_serve(torch, np, TC, smi)

    with Phase("eval"):
        eval_counts = phase_eval(torch, np, TC, params, smi, fresh)

    with Phase("relax"):
        relax_counts = phase_relax(torch, np, TC, smi)

    with Phase("train_cli"):
        cli_counts = phase_train_cli(torch, np, TC, params, s_np, smi)

    with Phase("conformers"):
        phase_conformers(torch, np, TC, smi)

    with Phase("fc_import"):
        phase_fc_import(torch, np, TC, smi)

    with Phase("fc_train"):
        phase_fc_train(torch, np, TC, smi)

    with Phase("split"):
        phase_split(torch, np, TC, params, smi)

    rows = []
    for name, (src, repl) in KERNELS.items():
        main_row = [r for r in per_kernel[name] if r["layer"] == 5 and r["batch"] == 16][0]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": counts[name], "max_abs_err": main_row["max_abs_err"],
                     "max_rel_err": main_row["max_rel_err"], "ms": main_row["ms"],
                     "device_ms": main_row["device_ms"],
                     "device_ms_method": main_row["device_ms_method"],
                     "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
                     "bound_by": main_row["bound_by"], "library_ms": None,
                     "layer": 5, "batch": 16,
                     **{k: main_row[k] for k in ("graph_same", "blocks") if k in main_row},
                     "buckets": fresh[name], "path_launches": cli_counts[name]})
    for name, (src, repl, _) in BWD_KERNELS.items():
        # the training shapes: layer 5, the 128/1024 batch of 4
        main_row = [r for r in per_kernel[name] if r["layer"] == 5 and r["batch"] == 4][0]
        b16 = [r for r in per_kernel[name] if r["layer"] == 5 and r["batch"] == 16][0]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": train_counts[name], "max_abs_err": main_row["max_abs_err"],
                     "max_rel_err": main_row["max_rel_err"],
                     "tie_rel_err": main_row["tie_rel_err"],
                     "ties_taken": main_row["ties_taken"], "ms": main_row["ms"],
                     "device_ms": main_row["device_ms"],
                     "device_ms_method": main_row["device_ms_method"],
                     "plain_ms": main_row["plain_ms"],
                     "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                     "library_ms": None, "layer": 5, "batch": 4,
                     **{k: main_row[k] for k in ("pairs_listed", "slots", "tiles", "sms",
                                                 "pass_us_per_tile", "splits", "scratch_bytes",
                                                 "parts_ms") if k in main_row},
                     "batch_16": {k: b16[k] for k in ("device_ms", "device_ms_method",
                                                      "bound_ms", "pairs")},
                     "path_launches": cli_counts[name]})
    for name, (src, repl) in RM_KERNELS.items():
        # the dock shapes at layer 5; launches from the dock in the
        # configuration that runs the kernel
        main_row = [r for r in per_kernel[name] if r["layer"] == 5 and r["batch"] == 16][0]
        mode = "fused_layer" if name == "layer_conv" else "fused_epilogue"
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": rm_counts[mode][name], "max_abs_err": main_row["max_abs_err"],
                     "max_rel_err": main_row["max_rel_err"], "ms": main_row["ms"],
                     "device_ms": main_row["device_ms"],
                     "device_ms_method": main_row["device_ms_method"],
                     "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
                     "bound_by": main_row["bound_by"], "library_ms": None,
                     "layer": 5, "batch": 16,
                     **{k: main_row[k] for k in ("graph_same", "blocks") if k in main_row}})
    for name, (src, repl, _) in BF16_KERNELS.items():
        # the dock shapes at layer 5; launches from the bf16 dock
        main_row = [r for r in per_kernel[name] if r["layer"] == 5 and r["batch"] == 16][0]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": bf16_counts[name], "max_abs_err": main_row["max_abs_err"],
                     "max_rel_err": main_row["max_rel_err"], "ms": main_row["ms"],
                     "device_ms": main_row["device_ms"],
                     "device_ms_method": main_row["device_ms_method"],
                     "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
                     "bound_by": main_row["bound_by"], "library_ms": None,
                     "layer": 5, "batch": 16,
                     **{k: main_row[k] for k in ("graph_same", "blocks") if k in main_row},
                     "buckets": fresh[name],
                     "path_launches": {"serve_shared_round": serve_counts[name][0],
                                       "serve_two_buckets": serve_counts[name][1],
                                       "eval": eval_counts[name],
                                       "predict_cart_relax": relax_counts[name][0],
                                       "eval_cart_relax": relax_counts[name][1],
                                       **cli_counts[name]}})
    for name in sorted(k for k in per_kernel if k.startswith("probe_bf16/")):
        r = per_kernel[name]
        # 8192 x 1024 elements, 2000 steps; launches from its measurement
        rows.append({"name": name, "route": "cuda", "source": PROBE[0], "replaces": PROBE[1],
                     "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                     "max_rel_err": r["max_rel_err"], "ms": r["ms"], "device_ms": r["device_ms"],
                     "device_ms_method": r["device_ms_method"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "rows": r["rows"], "reps": r["reps"], "gflops": r["gflops"]})
    keys = ("launches", "max_abs_err", "max_rel_err", "ms", "device_ms", "device_ms_method",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    probes = dict(PROBE_KERNELS)
    for word, (row, line) in MOSAIC_ROWS.items():
        src = PROBE_KERNELS["probe_mlp"][0] if word == "mlp" else MOSAIC_SOURCE
        probes["probe_mosaic/" + row] = (src, "tools/probe_mosaic.py" + line)
    served = {"probe_mosaic/mlps": "probe_mlp", "probe_mosaic/precision": "probe_mosaic/onehot"}
    for name, (src, repl) in probes.items():
        r = per_kernel[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     **{k: r[k] for k in keys},
                     **{k: v for k, v in r.items() if k in (
                         "reps", "nblk", "bf16_unit_ratio", "tf32_control_max_abs_err",
                         "library_device_ms", "three_calls_ms", "three_calls_device_ms",
                         "paired_graph_ms")}})
        if name in served:
            rows[-1]["served_by"] = served[name]
        if name == "probe_mlp":
            r32 = per_kernel["probe_mlp/R32"]
            rows[-1].update(R=1024, r32_ms=r32["ms"], r32_device_ms=r32["device_ms"],
                            r32_bound_ms=r32["bound_ms"], r32_plain_ms=r32["plain_ms"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # report and fail: every phase must pass
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
