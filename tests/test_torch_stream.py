"""The port's streaming data layer (diffbindfr_torch/data/stream.py) against
the JAX package's (diffbindfr_tpu/data/stream.py): on a temporary copy of
the five prep caches (the stream writes manifest.jsonl into its cache
directory), the same manifest, the same draws, the same grouped batches and
the same token-budget batch sizes with the same seed. Exact equality: both
are numpy on the same files.
"""
import json
import os
import shutil

import numpy as np
import pytest

from diffbindfr_tpu.data import stream as JS
from diffbindfr_torch.data import stream as TS
from diffbindfr_torch.data.sample import Buckets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")


@pytest.fixture
def caches(tmp_path):
    """Two copies of the prep caches: one per stream, as each writes a manifest."""
    dirs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        for n in NAMES:
            shutil.copy(os.path.join(PREP, f"{n}_r12.npz"), d)
        dirs.append(str(d))
    return dirs


def test_manifest_matches(caches):
    je, te = JS.build_manifest(caches[0]), TS.build_manifest(caches[1])
    assert [(e.name, os.path.basename(e.path), e.bucket.__dict__) for e in je] == \
        [(e.name, os.path.basename(e.path), e.bucket.__dict__) for e in te]
    with open(os.path.join(caches[1], TS.MANIFEST_NAME)) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["name"] for r in rows] == [f"{n}_r12" for n in NAMES]
    # incremental: a second call reads the manifest back
    assert [e.name for e in TS.build_manifest(caches[1])] == [e.name for e in te]


@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (3, 1, 2)])
def test_shuffle_stream_draws_match(caches, seed, host, hosts):
    js = JS.ShuffleStream(JS.build_manifest(caches[0]), buffer_size=3, seed=seed,
                          host_id=host, num_hosts=hosts)
    ts = TS.ShuffleStream(TS.build_manifest(caches[1]), buffer_size=3, seed=seed,
                          host_id=host, num_hosts=hosts)
    for _ in range(12):
        (je, jsample), (te, tsample) = js.draw(), ts.draw()
        assert je.name == te.name
        for a, b in zip(jsample, tsample):
            np.testing.assert_array_equal(a, b)
    assert js.epoch == ts.epoch and js.resident_samples() == ts.resident_samples()


def test_grouped_batches_match_through_the_prefetcher(caches):
    jb = JS.GroupedBatcher(JS.ShuffleStream(JS.build_manifest(caches[0]), seed=5),
                           base_bs=16)
    tp = TS.Prefetcher(TS.GroupedBatcher(TS.ShuffleStream(TS.build_manifest(caches[1]), seed=5),
                                         base_bs=16), depth=2)
    try:
        for _ in range(4):
            jbucket, jbatch, jnames = jb.next_batch()
            tbucket, tbatch, tnames = tp.next_batch()
            assert jnames == tnames and jbucket.__dict__ == tbucket.__dict__
            for a, b in zip(jbatch, tbatch):
                np.testing.assert_array_equal(a, b)
    finally:
        tp.close()
    # the prefetcher decodes ahead, so its batcher has emitted at least as many
    ahead = {tuple(b.__dict__.values()): st["batches"] for b, st in tp.batcher.stats.items()}
    assert all(ahead[tuple(b.__dict__.values())] >= st["batches"] for b, st in jb.stats.items())


def test_bucket_batch_size_matches():
    # -bs 16: 4 samples per step in the 128/1024 bucket, 7 in 96/768
    for b, want in ((Buckets(128, 288, 48, 128, 1024), 4), (Buckets(96, 224, 32, 96, 768), 7),
                    (Buckets(), 16), (Buckets(32, 80, 12, 48, 384), 42)):
        assert TS.bucket_batch_size(b, 16) == want
        assert JS.bucket_batch_size(JS.Buckets(**b.__dict__), 16) == want
