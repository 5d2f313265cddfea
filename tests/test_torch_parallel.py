"""Replica split and distributed helpers of the port (diffbindfr_torch/
parallel/, DockEngine's mesh, the kernels' launch device) on the CPU.

  * two gloo processes on localhost (tests/torch_dist_worker.py, each with
    its own time limit), after tests/test_dist_2proc.py: the rendezvous,
    the contiguous job split, gradients all-reduced over the ranks' shares
    equal to the full batch's, and a sampler batch split over the two ranks
    whose gathered poses equal one process's run of the whole batch;
  * DockEngine over make_mesh([cpu, cpu]) gives the unsplit run's poses:
    bit for bit those of the unsplit engine at the shard's batch size (the
    same sampler calls on the same noise rows), and within 1e-4 A of the
    unsplit engine at the whole batch size, whose matmuls have twice the
    rows and so sum in another order on the CPU (measured 1.9e-5 A after
    3 steps of a 2-layer net: 10 units in the last place of a 20 A
    coordinate);
  * shard_batch / replicate, and the single-process no-op of dist;
  * every kernel launch takes its tensors' device and stream
    (trunk_convs._on_device), checked with the CUDA calls stubbed.
"""
import ast
import glob
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffbindfr_torch import parallel as PX
from diffbindfr_torch import sampler as sp
from diffbindfr_torch.app import pipeline
from diffbindfr_torch.models import score_net as sn
from diffbindfr_torch.nn import trunk_convs as TC
from diffbindfr_torch.parallel import dist as D

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_dist_worker as W  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, coord, str(r), "2", outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    res = [np.load(o) for o in outs]
    assert bool(res[0]["is_main"]) and not bool(res[1]["is_main"])
    # the job table: contiguous, disjoint, covering
    assert list(res[0]["jobs"]) == [f"job{i}" for i in range(5)]
    assert list(res[1]["jobs"]) == [f"job{i}" for i in range(5, 10)]
    # the all-reduced gradient is the full batch's on both ranks
    for r in res:
        assert float(r["loss"]) == pytest.approx(float(r["exp_loss"]), rel=1e-6)
        np.testing.assert_allclose(r["grad"], r["exp_grad"], rtol=1e-6)
    np.testing.assert_array_equal(res[0]["grad"], res[1]["grad"])
    # the ranks' rows cover the batch; gathered, they are one process's run
    assert sorted(np.concatenate([r["rows"] for r in res]).tolist()) == list(range(W.NREP))
    np.testing.assert_array_equal(res[0]["gathered"], res[1]["gathered"])
    params, cfg, scfg, host, noise = W.sampler_inputs()
    batch = type(host)(*[torch.as_tensor(v) for v in host])
    with torch.no_grad():
        want = sp.sample(params, cfg, scfg, batch, noise, use_kernels=False).lig_pos.numpy()
    got = res[0]["gathered"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5, np.abs(got - want).max()


def _small_engine_inputs():
    cfg = sn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=1)
    params = sn.init_params(torch.Generator().manual_seed(5), cfg)
    scfg = sp.SamplerConfig(inference_steps=3, actual_steps=2)
    prepared = [pipeline.PreparedPair.from_prep_cache(W.SAMPLE)]
    return params, cfg, scfg, prepared


def test_dock_engine_split_matches_unsplit():
    """6 poses in batches of 4 (the second padded) over make_mesh([cpu,
    cpu]): each device samples 2 rows of each batch. Against the unsplit
    engine at batch size 2, whose generator draws the same noise for every
    real pose (draws go pose by pose), every pose and trajectory is equal
    bit for bit; against the unsplit engine at batch size 4 within 1e-4 A
    (module docstring)."""
    params, cfg, scfg, prepared = _small_engine_inputs()
    kw = dict(device="cpu", verbose=False, keep_trajectory=True, use_kernels=False)
    two = pipeline.DockEngine(params, cfg, scfg, batch_size=4,
                              devices=PX.make_mesh(["cpu", "cpu"]), **kw)
    assert two.split and len(two.mesh) == 2
    # one copy of the parameters per distinct device
    assert two.replicas[0] is two.replicas[1]
    got = two.run(prepared, num_poses=6, seed=7)
    for bs, tol in ((2, 0.0), (4, 1e-4)):
        one = pipeline.DockEngine(params, cfg, scfg, batch_size=bs, **kw)
        assert not one.split
        want = one.run(prepared, num_poses=6, seed=7)
        assert [(r.pair_idx, r.pose_idx) for r in want] == [(r.pair_idx, r.pose_idx)
                                                            for r in got]
        for ra, rb in zip(want, got):
            for f in ("lig_pos", "atom14_pos", "chi", "lig_traj", "atom14_traj"):
                x, y = getattr(ra, f), getattr(rb, f)
                assert x.shape == y.shape and np.isfinite(y).all(), f
                assert np.abs(x - y).max() <= tol, (bs, f, np.abs(x - y).max())
    # a batch size the mesh does not divide runs unsplit
    three = pipeline.DockEngine(params, cfg, scfg, devices=["cpu"] * 3, **kw)
    assert not three.split


def test_shard_batch_and_replicate():
    mesh = PX.make_mesh(["cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 2
    host = sp.SamplerNoise(*[np.arange(12.0).reshape(4, 3)] * 8)
    parts = PX.shard_batch(mesh, host)
    assert len(parts) == 2 and all(isinstance(p, sp.SamplerNoise) for p in parts)
    np.testing.assert_array_equal(parts[1].prior_rot.numpy(), host.prior_rot[2:])
    with pytest.raises(ValueError, match="do not split"):
        PX.shard_batch(PX.make_mesh(["cpu"] * 3), host)
    tree = {"a": [torch.ones(2)], "b": torch.zeros(3)}
    reps = PX.replicate(mesh, tree)
    assert reps[0] is reps[1] and torch.equal(reps[0]["a"][0], tree["a"][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PX.make_mesh()


def test_dist_single_process_is_a_no_op(monkeypatch):
    for k in D._COORD_ENV + ("WORLD_SIZE", "NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed(device="cpu") == (0, 1)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert D._env_world_size() == 1 and D.is_main_process()
    jobs = list(range(7))
    assert D.shard_jobs_for_host(jobs) == jobs
    assert [D.shard_jobs_for_host(jobs, i, 3) for i in range(3)] == [[0, 1, 2], [3, 4, 5], [6]]


def test_launches_take_their_tensors_device(monkeypatch):
    """_on_device makes the tensors' device current for the launches inside
    and yields that device's stream (CUDA calls stubbed); no module of nn/
    asks for the bare current-device stream (current_stream() with no
    device), which belongs to whatever device happens to be current."""
    seen = []

    class Dev:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            seen.append(("enter", self.d))

        def __exit__(self, *a):
            seen.append(("exit", self.d))

    class Stream:
        def __init__(self, d):
            self.cuda_stream = f"stream-of-{d}"

    monkeypatch.setattr(TC.torch.cuda, "device", Dev)
    monkeypatch.setattr(TC.torch.cuda, "current_stream", lambda d=None: Stream(d))
    dev = torch.device("cuda", 1)
    with TC._on_device(dev) as st:
        assert st == "stream-of-cuda:1" and seen == [("enter", dev)]
    assert seen[-1] == ("exit", dev)
    pkg = os.path.join(ROOT, "diffbindfr_torch")
    for path in glob.glob(os.path.join(pkg, "nn", "*.py")):
        tree = ast.parse(open(path).read())
        bare = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "current_stream"
                and not n.args and not n.keywords]
        assert not bare, (path, bare)
