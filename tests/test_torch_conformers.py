"""Conformer starts of the port (`-nc > 0`: app/prepare.py prep with
n_conformers, pipeline.start_refs, predict -nc, serve's n_conformers) and
serve's bounded pair cache, on the CPU, against the JAX package where it has
the same function.

Prep embeds each ligand once (chem/embed.py, seed 0) and writes the
conformers into the record in the JAX package's format; a second prep
resumes from the cache without embedding. `_cache_hit` decides as JAX's
does on records with 2 conformers at n = 2 and 4, except at n = 0, where
the JAX package attaches a cached record's conformers (so its cached -nc 0
run docks from conformers and a fresh one does not) and the port attaches
none. The dock hands replica po the conformer po % C, zero-padded, as the
JAX DockEngine stages it. `predict -nc 2` at the small config (ns=8, nv=4,
2 layers, 3 steps of the default grid, the weights of
tests/fixtures/torch_predict_ref.npz) on 3mhw with the same conformers in
its cache and the JAX key splits replayed as its noise exports poses within
1e-3 A of the JAX sampler's. A serve request with n_conformers docks from
conformers; the pair cache keeps at most max(2 * batch_size, 32) pairs, and
a ligand or receptor rewritten in place is featurised again. Serve's dock
worker holds embed.CARD_LOCK through each round, and an embedding on a CUDA
device holds it through its card work.
"""
import csv
import os
import pickle
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu import sampler as JSP
from diffbindfr_tpu.app import jobs as JJ
from diffbindfr_tpu.app import pipeline as JP
from diffbindfr_tpu.models import score_net as jsn
from diffbindfr_tpu.utils import load_checkpoint as jload_checkpoint
from diffbindfr_torch import sampler as TSP
from diffbindfr_torch.app import cli
from diffbindfr_torch.app import jobs as TJ
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.app import prepare as TPR
from diffbindfr_torch.app import serve as TS
from diffbindfr_torch.chem import embed as TE
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.io.sdf import parse_sdf, to_sdf_block
from diffbindfr_torch.models import score_net as tsn
from diffbindfr_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_predict import BSZ, _replay_noise, jax_tables  # noqa: E402,F401

PB = os.path.join(ROOT, "runs/pb_bench")
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
SMALL_CKPT = os.path.join(ROOT, "tests/fixtures/torch_predict_ref.npz")
STEPS = 3


def _row(n):
    d = os.path.join(PB, n)
    lig = f"{d}/{n}_ligand.sdf"
    return [f"{d}/{n}_protein_contact_chains.pdb", n, lig, n, n, lig]


def _jobs_csv(path, names):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["protein", "protein_name", "ligand", "ligand_name", "complex_name",
                    "crystal_ligand"])
        w.writerows(_row(n) for n in names)
    return str(path)


def _conformers(na, seed):
    """Centred random 'conformers' [2, na, 3] (the tests inject them)."""
    c = np.random.default_rng(seed).normal(size=(2, na, 3)).astype(np.float32) * 2.0
    return c - c.mean(1, keepdims=True)


def _cache_with_conformers(tmp, names, n_conf=2, embed=False):
    """The tracked cache entries of `names` in tmp/cache, each record
    carrying n_conf injected conformers (random ones, or with `embed` the
    port's embedding of the record's ligand); returns (cache dir,
    conformers)."""
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache, exist_ok=True)
    confs = {}
    for i, n in enumerate(names):
        shutil.copy(os.path.join(PREP, f"{n}_r12.npz"), cache)
        with open(os.path.join(PREP, f"{n}_r12.rec.pkl"), "rb") as fh:
            rec = pickle.load(fh)
        confs[n] = (TE.embed_conformers(load_prep_record(os.path.join(PREP, f"{n}_r12.rec.pkl"))[
            "lig"], n_conf, seed=0, device="cpu") if embed
            else _conformers(rec["lig"].num_atoms, i)[:n_conf])
        rec["conformers"] = confs[n]
        with open(os.path.join(cache, f"{n}_r12.rec.pkl"), "wb") as fh:
            pickle.dump(rec, fh)
    return cache, confs


def test_prep_embeds_and_resumes(tmp_path, monkeypatch):
    """prep(n_conformers=2) of 3mhw from its raw files: the pair and its
    record carry 2 float32 conformers of the ligand's atoms, as
    chem/embed.embed_conformers gives them for seed 0; a second prep
    resumes from the cache with no embedding; a worker's prep (in process)
    embeds on the CPU; an -nc 0 prep of the same cache attaches none."""
    jobs = TJ.load_jobs_csv(_jobs_csv(tmp_path / "jobs.csv", ("3mhw",)))
    cache = str(tmp_path / "cache")
    prepared, fails = TP.prep(jobs, 12.0, cache_dir=cache, verbose=False, n_conformers=2,
                              device="cpu")
    assert not fails
    pair = prepared[0]
    confs = pair.conformers
    assert confs.shape == (2, pair.lig.num_atoms, 3) and confs.dtype == np.float32
    np.testing.assert_array_equal(confs, TE.embed_conformers(_world(pair), 2, seed=0,
                                                             device="cpu"))
    rec = load_prep_record(os.path.join(cache, "3mhw_r12.rec.pkl"))
    np.testing.assert_array_equal(rec["conformers"], confs)

    def refuse(*a, **kw):
        raise AssertionError("embedded again")

    monkeypatch.setattr(TE, "embed_conformers", refuse)
    again, fails = TP.prep(jobs, 12.0, cache_dir=cache, verbose=False, n_conformers=2,
                           device="cpu")
    assert not fails and again[0].sample_path == pair.sample_path
    np.testing.assert_array_equal(again[0].conformers, confs)
    plain, _ = TP.prep(jobs, 12.0, cache_dir=cache, verbose=False)
    assert plain[0].conformers is None
    monkeypatch.undo()

    seen = []
    real = TE.embed_conformers
    monkeypatch.setattr(TE, "embed_conformers",
                        lambda *a, **kw: seen.append(kw["device"]) or real(*a, **kw))
    os.makedirs(tmp_path / "w")
    out = TPR._worker_prep(([(0, jobs[0])], 12.0, str(tmp_path / "w"), 2))
    assert [o[1] for o in out] == ["ok"] and seen == ["cpu"]
    np.testing.assert_array_equal(out[0][2][0]["conformers"], confs)


def _world(pair):
    """The pair's ligand record at its input (world-frame) pose, which
    prep embeds from."""
    import dataclasses

    return dataclasses.replace(pair.lig, pos=pair.crystal_pos)


@pytest.mark.parametrize("n", [0, 2, 4])
def test_cache_hit_matches_jax(tmp_path, n):
    """On the tracked 3dbs record with 2 conformers: at n = 2 both packages
    serve it with the same conformers, at n = 4 both prepare the pair again,
    and a record without conformers is prepared again for n > 0 by both. At
    n = 0 both serve it, the JAX package with the record's conformers
    attached (its reference fault), the port with none."""
    cache, confs = _cache_with_conformers(str(tmp_path), ("3dbs",))
    rec = load_prep_record(os.path.join(cache, "3dbs_r12.rec.pkl"))
    with open(os.path.join(cache, "3dbs_r12.rec.pkl"), "rb") as fh:
        jrec = pickle.load(fh)
    row = _row("3dbs")
    tjob = TJ.Job(protein=row[0], protein_name=row[1], ligand=row[2], ligand_name=row[3],
                  complex_name=row[4], crystal_ligand=row[5])
    jjob = JJ.Job(protein=row[0], protein_name=row[1], ligand=row[2], ligand_name=row[3],
                  complex_name=row[4], crystal_ligand=row[5])
    spath = os.path.join(cache, "3dbs_r12.npz")
    jhit = JP._cache_hit(jrec, jjob, spath, n)
    thit = TPR._cache_hit(rec, tjob, n)
    assert thit == (jhit is not None) == (n <= 2)
    if thit and n:
        np.testing.assert_array_equal(TPR.cached_conformers(rec, n), jhit["conformers"])
    if n == 0:
        np.testing.assert_array_equal(jhit["conformers"], confs["3dbs"])
        assert TPR.cached_conformers(rec, n) is None
    bare = {**rec, "conformers": None}
    assert TPR._cache_hit(bare, tjob, n) == (JP._cache_hit({**jrec, "conformers": None},
                                                           jjob, spath, n) is not None)


def test_replica_starts_match_jax(tmp_path, monkeypatch):
    """3dbs and 3mhw from a cache with 2 conformers each, 5 poses each in
    batches of 4: every replica's lig_ref_pos (padding replicas included)
    equals the one the JAX DockEngine stages for it (conformer po % 2,
    zero-padded, times the ligand mask), batch by batch."""
    names = ("3dbs", "3mhw")
    cache, _ = _cache_with_conformers(str(tmp_path), names)
    csv_path = _jobs_csv(tmp_path / "jobs.csv", names)
    tpairs, _ = TP.prep(TJ.load_jobs_csv(csv_path), 12.0, cache_dir=cache, verbose=False,
                        n_conformers=2)
    jpairs, _ = JP.prep(JJ.load_jobs_csv(csv_path), 12.0, cache_dir=cache, verbose=False,
                        n_conformers=2)
    staged = []

    def capture(fn, params, block, slots, refs, key, **kw):
        bs, nl = refs.shape[:2]
        mask = np.asarray(block.lig_mask)[np.asarray(slots)]
        staged.append(np.asarray(refs) * mask[..., None])
        return SimpleNamespace(lig_pos=np.zeros((bs, nl, 3)), atom14_pos=np.zeros((bs, 1, 14, 3)),
                               chi=np.zeros((bs, 1, 4)))

    monkeypatch.setattr(JP, "_dispatch_with_retry", capture)
    eng = JP.DockEngine({}, jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2), JSP.SamplerConfig(),
                        batch_size=4, verbose=False)
    eng.run(jpairs, num_poses=5, seed=0)
    teng = TP.DockEngine({}, tsn.ScoreNetConfig(), TSP.SamplerConfig(), batch_size=4,
                         device="cpu", verbose=False)
    plan = teng.batches(tpairs, 5)
    assert len(plan) == len(staged) == 4
    for (_, chunk), want in zip(plan, staged):
        reps = chunk + [chunk[0]] * (4 - len(chunk))
        got = TP.start_refs(TP._stack(tpairs, [i for i, _ in reps]), tpairs, reps)
        np.testing.assert_array_equal(got.lig_ref_pos, want)
        for j, (pi, po) in enumerate(reps):
            c = tpairs[pi].conformers[po % 2]
            np.testing.assert_array_equal(got.lig_ref_pos[j, : c.shape[0]], c)


def test_predict_nc_matches_jax(tmp_path, monkeypatch):
    """`predict --cpu -nc 2 -np 2 -bs 2 -no_ec -no_score --dtype float32`
    of 3mhw, small net, 3 steps of the default grid, from a cache with the
    port's 2 embedded conformers, the
    JAX key splits of its batch replayed as its noise: each exported
    lig_final.sdf within 1e-3 A of the JAX sampler's pose from the same
    starts (lig_ref_pos = conformer po % 2) plus the pocket centre."""
    cache, confs = _cache_with_conformers(str(tmp_path), ("3mhw",), embed=True)
    out = tmp_path / "out"
    shutil.copytree(cache, out / "prep_cache")
    csv_path = _jobs_csv(tmp_path / "jobs.csv", ("3mhw",))
    key = jax.random.PRNGKey(5)
    s = TP.PreparedPair.from_prep_cache(str(out / "prep_cache" / "3mhw_r12.npz")).sample
    jcfg = JSP.SamplerConfig(inference_steps=22, actual_steps=STEPS)
    monkeypatch.setattr(TSP, "draw_noise", lambda batch, cfg, gen: _replay_noise(key, s, jcfg))
    argv = ["predict", "--cpu", "-i", csv_path, "-o", str(out), "-ckt", SMALL_CKPT, "-nc", "2",
            "-np", str(BSZ), "-bs", str(BSZ), "-no_ec", "-no_score", "--dtype", "float32",
            "--cfg-options",
            "score_net.ns=8", "score_net.nv=4", "score_net.num_conv_layers=2",
            "sampler.inference_steps=22", f"sampler.actual_steps={STEPS}"]
    assert cli.main(argv) == 0

    jp = jax.tree.map(jnp.asarray, jload_checkpoint(SMALL_CKPT, use_ema=False)[0])
    js = JP._load_sample_npz(os.path.join(PREP, "3mhw_r12.npz"))
    na = confs["3mhw"].shape[1]
    refs = np.zeros((BSZ,) + js.lig_ref_pos.shape, np.float32)
    for po in range(BSZ):
        refs[po, :na] = confs["3mhw"][po % 2]
    jb = jax.tree.map(lambda x: jnp.asarray(np.stack([x] * BSZ)), js)
    jb = jb._replace(lig_ref_pos=jnp.asarray(refs) * jb.lig_mask[..., None])
    res = JSP.sample(jp, jsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2, dropout=0.0),
                     jcfg, jb, key)
    rec = load_prep_record(str(out / "prep_cache" / "3mhw_r12.rec.pkl"))
    center = rec["pocket"].center
    for po in range(BSZ):
        got = parse_sdf(str(out / "3mhw" / f"pose_{po}" / "lig_final.sdf"))[0].coords
        want = np.asarray(res.lig_pos[po])[:na] + center
        assert np.abs(got - want).max() <= 1e-3, po


def _service(weights, tmp, bs=4):
    params, mdn_params = weights
    from diffbindfr_torch.models import mdn_scorer as mdn

    return TS.DockService(params, tsn.ScoreNetConfig(ns=8, nv=4, num_conv_layers=2),
                          TSP.SamplerConfig(inference_steps=4, actual_steps=2),
                          mdn_params=mdn_params, mdn_cfg=mdn.MDNConfig(), batch_size=bs,
                          ec_steps=5, cache_dir=str(tmp), device="cpu", verbose=False)


@pytest.fixture(scope="module")
def weights():
    params, _ = load_checkpoint(SMALL_CKPT, device="cpu")
    mdn_params, _ = load_checkpoint(os.path.join(ROOT, "runs/mdn_r4b/ckpt_best.npz"),
                                    device="cpu")
    return params, mdn_params


def test_serve_request_with_conformers(weights, tmp_path, monkeypatch):
    """A /dock request for 3mhw with n_conformers 2 (2 poses): 200, its pair
    prepared with 2 conformers on the service's device, and each replica
    started from its conformer; the dock worker samples holding
    embed.CARD_LOCK, which an embedding on the card holds, so no graph
    capture in a handler thread overlaps its round; the same request without n_conformers is another
    pair, with none."""
    import json
    import urllib.request

    svc = _service(weights, tmp_path / "cache")
    starts = []
    sample = TSP.sample

    def spy(params, net_cfg, cfg, batch, noise, **kw):
        assert TE.CARD_LOCK.locked()
        starts.append(batch.lig_ref_pos.numpy())
        return sample(params, net_cfg, cfg, batch, noise, **kw)

    monkeypatch.setattr(TSP, "sample", spy)
    server = TS.DockServer(svc).start()
    try:
        d = os.path.join(PB, "3mhw")
        body = {"protein": f"{d}/3mhw_protein_contact_chains.pdb", "ligand": f"{d}/3mhw_ligand.sdf",
                "num_poses": 2, "n_conformers": 2}
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/dock",
                                     data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200 and len(json.loads(r.read())["poses"]) == 2
        pair = svc.prepare(body)
        confs = pair.conformers
        assert confs is not None and confs.shape == (2, pair.lig.num_atoms, 3)
        for po in range(2):
            np.testing.assert_array_equal(starts[0][po, : confs.shape[1]], confs[po])
        assert svc.prepare({**body, "n_conformers": 0}).conformers is None
    finally:
        server.stop()


def test_card_embedding_holds_the_card_lock(monkeypatch):
    """embed_conformers on a CUDA device moves its restraints to the card and
    refines under embed.CARD_LOCK (so serve's handler threads and its dock
    worker take turns on the card); here the device is stood in for by the
    CPU, and the conformers are those of an embedding on the CPU."""
    from diffbindfr_torch.utils import device as D

    from diffbindfr_torch.chem.ligand_feats import featurize_ligand
    from diffbindfr_torch.chem.mol import perceive

    lig = featurize_ligand(perceive(parse_sdf(os.path.join(PB, "3mhw", "3mhw_ligand.sdf"))[0]),
                           "3mhw")
    want = TE.embed_conformers(lig, 2, seed=0, steps=5, device="cpu")
    held = []
    tensors, refine = TE.restraint_tensors, TE.refine
    monkeypatch.setattr(D, "resolve_device", lambda dev: SimpleNamespace(type="cuda"))
    monkeypatch.setattr(TE, "restraint_tensors", lambda r, dev: held.append(
        TE.CARD_LOCK.locked()) or tensors(r, torch.device("cpu")))
    monkeypatch.setattr(TE, "refine", lambda inits, t, steps, dev: held.append(
        TE.CARD_LOCK.locked()) or refine(inits, t, steps, torch.device("cpu")))
    got = TE.embed_conformers(lig, 2, seed=0, steps=5, device="cuda")
    assert held and all(held) and not TE.CARD_LOCK.locked()
    np.testing.assert_array_equal(got, want)


def test_serve_pair_cache_is_bounded_and_sees_rewrites(weights, tmp_path, monkeypatch):
    """Streaming 40 distinct pairs (one receptor and ligand, 40 pocket
    centres) through DockService.prepare keeps at most max(2 * 4, 32) = 32
    pairs and as many prep locks, the most recent ones; a repeated request
    prepares nothing. Then through the real prep and the service's disk
    cache: a ligand rewritten in place with its atoms moved is featurised
    again, and so is the pocket of a receptor rewritten in place."""
    svc = _service(weights, tmp_path / "cache")
    calls = []
    real = TP.prep

    def fake(jobs, *a, **kw):
        calls.append(jobs[0].center)
        return [object()], []

    monkeypatch.setattr(TP, "prep", fake)
    d = os.path.join(PB, "3mhw")
    base = {"protein": f"{d}/3mhw_protein_contact_chains.pdb", "ligand": f"{d}/3mhw_ligand.sdf"}
    for i in range(40):
        svc.prepare({**base, "center": [float(i), 0.0, 0.0]})
    assert svc.pair_capacity == 32 and len(svc._pair_cache) == 32 and len(calls) == 40
    assert len(svc._key_locks) <= 32
    svc.prepare({**base, "center": [39.0, 0.0, 0.0]})
    assert len(calls) == 40  # the latest pair stayed cached
    svc.prepare({**base, "center": [0.0, 0.0, 0.0]})
    assert len(calls) == 41  # the oldest was dropped

    made = []
    for name in ("featurize_ligand", "build_pocket_record"):
        fn = getattr(TPR, name)
        monkeypatch.setattr(TPR, name, lambda *a, _n=name, _f=fn, **kw: made.append(_n)
                            or _f(*a, **kw))
    monkeypatch.setattr(TP, "prep", lambda *a, **kw: calls.append("real") or real(*a, **kw))
    prot, lig = tmp_path / "prot.pdb", tmp_path / "lig.sdf"
    shutil.copy(base["protein"], prot)
    shutil.copy(base["ligand"], lig)

    def rewrite(path, text):  # in place, with a later modification time
        mtime = os.stat(path).st_mtime_ns
        path.write_text(text)
        os.utime(path, ns=(mtime + 10**9, mtime + 10**9))

    req = {"protein": str(prot), "ligand": str(lig), "crystal_ligand": base["ligand"]}
    first = svc.prepare(req)
    assert svc.prepare(req) is first and calls.count("real") == 1
    featurised = ["featurize_ligand", "build_pocket_record"]  # one prep that misses the cache
    assert made == featurised
    raw = parse_sdf(str(lig))[0]
    rewrite(lig, to_sdf_block(raw, raw.coords + 1.0))
    fresh = svc.prepare(req)
    assert calls.count("real") == 2 and made == featurised * 2
    np.testing.assert_allclose(fresh.lig.pos, first.lig.pos + 1.0, atol=1e-3)

    def shift_x(line):
        if line.startswith(("ATOM", "HETATM")):
            return f"{line[:30]}{float(line[30:38]) + 0.05:8.3f}{line[38:]}"
        return line

    rewrite(prot, "".join(shift_x(ln) for ln in prot.read_text().splitlines(keepends=True)))
    moved = svc.prepare(req)
    assert calls.count("real") == 3 and made == featurised * 3
    np.testing.assert_allclose(moved.pocket.center, first.pocket.center + [0.05, 0.0, 0.0],
                               atol=1e-4)
