"""The serving daemon of the port (diffbindfr_torch/app/serve.py) on the CPU,
in process, against the JAX package's diffbindfr_tpu/app/serve.py.

A small net (the weights of tests/fixtures/torch_predict_ref.npz: ns 8, nv
4, 2 layers; 2 SDE steps), batch_size 4, 5 EC steps and the full-width MDN
of runs/mdn_r4b. Two concurrent /dock requests for 3mhw (runs/pb_bench; 1
and 3 poses) share one device round, seen through the engine's calls (the
drain waits up to 5 s for a full batch); their poses
and scores equal a direct run of the engines with the same counts and
seed, bit for bit; each reply's rows are the JAX `_pose_payload` /
`_sort_key` of the same PoseResults on the JAX prep of the same pair. The
bad requests get the JAX handler's codes and texts, /health its keys; a
repeated request preps nothing; /shutdown serves the request in flight.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import jobs as JJ
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.app import serve as JS
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.sampler import SamplerConfig as JSamplerConfig
from diffbindfr_torch import sampler as sp
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.app import serve as TS
from diffbindfr_torch.models import mdn_scorer as mdn
from diffbindfr_torch.models import score_net as sn
from diffbindfr_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
MDN_CKPT = os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz")
SMALL_CKPT = os.path.join(ROOT, "tests/fixtures/torch_predict_ref.npz")
CFG = sn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
SCFG = sp.SamplerConfig(inference_steps=4, actual_steps=2)
BS, EC_STEPS, POSES = 4, 5, 2


def _req(name, **kw):
    d = os.path.join(PB, name)
    return {"protein": os.path.join(d, f"{name}_protein_contact_chains.pdb"),
            "ligand": os.path.join(d, f"{name}_ligand.sdf"), "num_poses": POSES, **kw}


def _post(port, path, body):
    """(status, JSON reply) of a POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def weights():
    params, _ = load_checkpoint(SMALL_CKPT, device="cpu")
    mdn_params, _ = load_checkpoint(MDN_CKPT, device="cpu")
    return params, mdn_params


def _server(weights, tmp):
    params, mdn_params = weights
    svc = TS.DockService(params, CFG, SCFG, mdn_params=mdn_params, mdn_cfg=mdn.MDNConfig(),
                         batch_size=BS, ec_steps=EC_STEPS, cache_dir=str(tmp),
                         max_wait_s=5.0, device="cpu", verbose=False)
    return TS.DockServer(svc).start()


def _spy(svc):
    """Record each dock round's (pairs, counts, seed, results)."""
    rounds = []
    run = svc.dock_engine.run

    def dock(pairs, num_poses, seed):
        out = run(pairs, num_poses=num_poses, seed=seed)
        rounds.append((list(pairs), list(num_poses), seed, out))
        return out

    svc.dock_engine.run = dock
    return rounds


def test_concurrent_requests_share_a_round(weights, tmp_path, monkeypatch):
    """Requests for 1 and 3 poses of 3mhw, sent together, fill one batch of
    BS: one dock round with both, the pair prepared once."""
    server = _server(weights, tmp_path / "cache")
    svc = server.service
    rounds = _spy(svc)
    preps = []
    prep = TP.prep
    monkeypatch.setattr(TP, "prep", lambda *a, **k: preps.append(a) or prep(*a, **k))
    try:
        replies = {}

        def ask(n):
            replies[n] = _post(server.port, "/dock", _req("3mhw", num_poses=n))

        threads = [threading.Thread(target=ask, args=(n,)) for n in (1, BS - 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert {n: r[0] for n, r in replies.items()} == {1: 200, BS - 1: 200}
        # one round of both requests, on one prepared pair
        assert len(rounds) == 1 and sorted(rounds[0][1]) == [1, BS - 1] and rounds[0][2] == 0
        pairs, counts, seed, served = rounds[0]
        assert pairs[0] is pairs[1] and pairs[0].name == "3mhw_protein_contact_chains_3mhw_ligand"
        assert len(preps) == 1

        # the same poses and scores as the engines run directly
        params, mdn_params = weights
        direct = TP.DockEngine(params, CFG, SCFG, batch_size=BS, device="cpu",
                               verbose=False).run(pairs, num_poses=counts, seed=seed)
        TP.ECEngine(steps=EC_STEPS, batch_size=BS, device="cpu", verbose=False).run(pairs,
                                                                                     direct)
        TP.MDNEngine(mdn_params, mdn.MDNConfig(), batch_size=BS, device="cpu",
                     verbose=False).run(pairs, direct)
        assert len(direct) == len(served) == BS
        for a, b in zip(served, direct):
            assert (a.pair_idx, a.pose_idx) == (b.pair_idx, b.pose_idx)
            np.testing.assert_array_equal(a.lig_pos, b.lig_pos)
            np.testing.assert_array_equal(a.atom14_pos, b.atom14_pos)
            assert (a.vina_score, a.mdn_score, a.mdn_nll) == (b.vina_score, b.mdn_score,
                                                             b.mdn_nll)

        # each reply: the JAX payload rows of its PoseResults on the JAX prep
        req, name = _req("3mhw"), pairs[0].name
        job = JJ.Job(protein=req["protein"], protein_name=name, ligand=req["ligand"],
                     ligand_name=name, complex_name=name, crystal_ligand=req["ligand"])
        jprep, fails = JP.prep([job], 12.0, cache_dir=str(tmp_path / "jax"), verbose=False)
        assert not fails
        for i, n in enumerate(counts):
            mine = [r for r in served if r.pair_idx == i]
            want = sorted((JS._pose_payload(jprep[0], r, None) for r in mine), key=JS._sort_key)
            assert replies[n][1] == {"complex_name": name, "poses": json.loads(json.dumps(want))}

        # a repeated request preps nothing: the pair cache serves it
        code, body = _post(server.port, "/dock", _req("3mhw", num_poses=1, seed=3))
        assert code == 200 and len(body["poses"]) == 1 and len(preps) == 1
        assert len(rounds) == 2 and rounds[1][2] == 3
        status, health = _get(server.port, "/health")
        assert status == 200 and health == {"status": "ok", "device": "cpu",
                                            "warm_buckets": 1, "requests_served": 3}
    finally:
        server.stop()


def test_bad_requests_and_health_match_jax(weights, tmp_path):
    """The JAX handler's replies, code and text, to the same bad requests;
    /health's keys; a request with n_conformers > 0 (ROADMAP A14, ported)
    is served: 200 with its poses."""
    port_server = _server(weights, tmp_path / "t")
    jcfg = jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2)
    # the bad requests end before the dock: the JAX service needs no weights
    jsvc = JS.DockService({}, jcfg,
                          JSamplerConfig(inference_steps=4, actual_steps=2), batch_size=BS,
                          ec_steps=EC_STEPS, cache_dir=str(tmp_path / "j"), verbose=False)
    jax_server = JS.DockServer(jsvc).start()
    try:
        bad = [{}, {"ligand": "x.sdf"},
               _req("3mhw", ligand=str(tmp_path / "missing.sdf")),
               _req("3mhw", protein=str(tmp_path / "missing.pdb"))]
        for body in bad:
            got = _post(port_server.port, "/dock", body)
            want = _post(jax_server.port, "/dock", body)
            assert got[0] == want[0] == 400, body
            assert got == want or got[1]["error"].split(":")[:2] == want[1]["error"].split(":")[:2]
        for path in ("/nowhere",):
            assert _post(port_server.port, path, {}) == _post(jax_server.port, path, {})
            assert _get(port_server.port, path) == _get(jax_server.port, path)
        (c1, h1), (c2, h2) = _get(port_server.port, "/health"), _get(jax_server.port, "/health")
        assert c1 == c2 == 200 and set(h1) == set(h2) and h1 == h2
        code, body = _post(port_server.port, "/dock", _req("3mhw", n_conformers=2))
        assert code == 200 and len(body["poses"]) == POSES
    finally:
        port_server.stop()
        jax_server.stop()


def test_shutdown_serves_the_request_in_flight(weights, tmp_path):
    server = _server(weights, tmp_path / "cache")
    svc = server.service
    started = threading.Event()
    run = svc.dock_engine.run

    def dock(*a, **kw):
        started.set()
        return run(*a, **kw)

    svc.dock_engine.run = dock
    reply = {}
    t = threading.Thread(target=lambda: reply.update(r=_post(server.port, "/dock",
                                                             _req("3mhw", num_poses=BS))))
    t.start()
    assert started.wait(120)
    assert _post(server.port, "/shutdown", {}) == (200, {"status": "bye"})
    t.join(120)
    assert reply["r"][0] == 200 and len(reply["r"][1]["poses"]) == BS
    svc._worker.join(60)
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        svc.submit(None, 1, False, False)
