"""PyTorch port building blocks against the JAX package: irreps, spherical
harmonics, tensor products, layers, checkpoint and sample loaders.

Inputs come from a numpy seed; both frameworks compute in f32 on the CPU.
Tolerance: elementwise and short reductions in f32 -> rtol/atol 1e-5 unless
stated; results that must be exact (tables, indices, masks) are compared
with equality.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.nn import irreps as JI
from diffbindfr_tpu.nn import layers as JL
from diffbindfr_tpu.utils import checkpoint as JC
from diffbindfr_torch.data import sample as TS
from diffbindfr_torch.nn import irreps as TI
from diffbindfr_torch.nn import layers as TL
from diffbindfr_torch.utils import checkpoint as TCK

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER = "8x0e+4x1o+4x1e+8x0o"
SH = "1x0e+1x1o+1x2e"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("ls", [(1, 1, 0), (1, 1, 2), (1, 2, 1), (2, 2, 2), (0, 2, 2)])
def test_clebsch_gordan_tables_identical(ls):
    np.testing.assert_array_equal(TI.clebsch_gordan(*ls), JI.clebsch_gordan(*ls))


def test_tp_specs_identical():
    a = TI.compile_dw_tensor_product(LADDER, SH, 2)
    b = JI.compile_dw_tensor_product(LADDER, SH, 2)
    assert str(a.out) == str(b.out) and a.weight_numel == b.weight_numel
    assert [tuple(vars(p).values()) for p in a.paths] == [tuple(vars(p).values()) for p in b.paths]
    lin_a, lin_b = TI.compile_linear(str(a.out), LADDER), JI.compile_linear(str(b.out), LADDER)
    assert lin_a.blocks == lin_b.blocks and lin_a.weight_numel == lin_b.weight_numel


def test_spherical_harmonics_match(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0  # zero vector maps to (1, 0, ...)
    _close(TI.spherical_harmonics_l2(_t(v)), JI.spherical_harmonics_l2(jnp.asarray(v)))


def test_dw_and_full_tensor_products_match(rng):
    spec_t = TI.compile_dw_tensor_product(LADDER, SH, 2)
    spec_j = JI.compile_dw_tensor_product(LADDER, SH, 2)
    x1 = rng.normal(size=(5, 7, spec_t.in1.dim)).astype(np.float32)
    sh = np.asarray(JI.spherical_harmonics_l2(jnp.asarray(rng.normal(size=(5, 7, 3)), jnp.float32)))
    w = rng.normal(size=(5, 7, spec_t.weight_numel)).astype(np.float32)
    _close(TI.apply_dw_tensor_product(spec_t, _t(x1), _t(sh), _t(w)),
           JI.apply_dw_tensor_product(spec_j, jnp.asarray(x1), jnp.asarray(sh), jnp.asarray(w)))
    full_t = TI.compile_full_tensor_product(SH, "1x2e", lmax_out=1)
    full_j = JI.compile_full_tensor_product(SH, "1x2e", lmax_out=1)
    b = rng.normal(size=(5, 7, 5)).astype(np.float32)
    _close(TI.apply_full_tensor_product(full_t, _t(sh), _t(b)),
           JI.apply_full_tensor_product(full_j, jnp.asarray(sh), jnp.asarray(b)))


def test_linear_both_layouts_match(rng):
    lin_t = TI.compile_linear("8x0e+4x1o+4x1o+4x2e", LADDER)
    lin_j = JI.compile_linear("8x0e+4x1o+4x1o+4x2e", LADDER)
    x = rng.normal(size=(6, lin_t.in_irreps.dim)).astype(np.float32)
    w = rng.normal(size=(lin_t.weight_numel,)).astype(np.float32)
    _close(TI.apply_linear(lin_t, _t(x), _t(w)),
           JI.apply_linear(lin_j, jnp.asarray(x), jnp.asarray(w)))
    _close(TI.apply_linear_cm(lin_t, _t(x), _t(w)),
           JI.apply_linear_cm(lin_j, jnp.asarray(x), jnp.asarray(w)))


def test_mlp_embeddings_and_encoder_match(rng):
    p = {"l1": {"w": rng.normal(size=(9, 6)), "b": rng.normal(size=6)},
         "l2": {"w": rng.normal(size=(6, 4)), "b": rng.normal(size=4)}}
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
    pt = TCK.params_from_numpy(p, device="cpu")
    x = rng.normal(size=(3, 5, 9)).astype(np.float32)
    _close(TL.mlp_apply(pt, _t(x)), JL.mlp_apply(pj, jnp.asarray(x)))
    d = (rng.random((4, 11)) * 30).astype(np.float32)
    _close(TL.gaussian_smearing(_t(d), 0.0, 32.0, 32),
           JL.gaussian_smearing(jnp.asarray(d), 0.0, 32.0, 32), rtol=1e-4, atol=1e-6)
    t = rng.random(5).astype(np.float32)
    for dim in (32, 33):
        _close(TL.sinusoidal_time_emb(_t(t), dim), JL.sinusoidal_time_emb(jnp.asarray(t), dim),
               rtol=1e-4, atol=1e-4)  # sin/cos of arguments up to 1000
    enc = JL.atom_encoder_init(jax.random.PRNGKey(3), 6, (5, 7), 4)
    cats = rng.integers(0, 5, size=(10, 2)).astype(np.int32)
    sc = rng.normal(size=(10, 4)).astype(np.float32)
    pt = TCK.params_from_numpy(jax.tree.map(np.asarray, enc), device="cpu")
    _close(TL.atom_encoder_apply(pt, torch.from_numpy(cats).long(), _t(sc)),
           JL.atom_encoder_apply(enc, jnp.asarray(cats), jnp.asarray(sc)))


def test_layer_norms_and_conv_finalize_match(rng):
    spec_j = JL.make_conv_spec(LADDER, SH, LADDER, "sep")
    spec_t = TL.make_conv_spec(LADDER, SH, LADDER)
    pj = JL.tp_conv_init(jax.random.PRNGKey(1), spec_j, 24)
    pj["ln"] = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
                            pj["ln"])
    pt = TCK.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    agg = rng.normal(size=(3, 4, spec_t.msg_dim)).astype(np.float32)
    _close(TL.tp_conv_finalize(pt, spec_t, _t(agg)),
           JL.tp_conv_finalize(pj, spec_j, jnp.asarray(agg)), rtol=1e-4, atol=1e-5)
    _close(TL.tp_conv_finalize_cm(pt, spec_t, _t(agg)),
           JL.tp_conv_finalize_cm(pj, spec_j, jnp.asarray(agg)), rtol=1e-4, atol=1e-5)
    x = rng.normal(size=(5, spec_t.out.dim)).astype(np.float32)
    _close(TL.irreps_layer_norm_apply(pt["ln"], spec_t.out, _t(x)),
           JL.irreps_layer_norm_apply(pj["ln"], spec_j.out, jnp.asarray(x)), rtol=1e-4)
    _close(TL.irreps_layer_norm_apply_cm(pt["ln"], spec_t.out, _t(x)),
           JL.irreps_layer_norm_apply_cm(pj["ln"], spec_j.out, jnp.asarray(x)), rtol=1e-4)
    src = rng.normal(size=(4, 6, spec_t.dw.in1.dim)).astype(np.float32)
    sh = np.asarray(JI.spherical_harmonics_l2(jnp.asarray(rng.normal(size=(4, 6, 3)), jnp.float32)))
    attr = rng.normal(size=(4, 6, 24)).astype(np.float32)
    _close(TL.tp_conv_messages(pt, spec_t, _t(src), _t(sh), _t(attr)),
           JL.tp_conv_messages(pj, spec_j, jnp.asarray(src), jnp.asarray(sh),
                               jnp.asarray(attr)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [16, 40])  # short (message dtype) and long (f32 accumulate) axes
def test_masked_mean_and_pad_match(rng, n):
    m = rng.normal(size=(3, n, 5)).astype(np.float32)
    mask = (rng.random((3, n)) > 0.4).astype(np.float32)
    mask[0] = 0.0
    _close(TL.masked_mean(_t(m), _t(mask), 1), JL.masked_mean(jnp.asarray(m), jnp.asarray(mask), 1))
    _close(TL.pad_to_dim(_t(m), 9), JL.pad_to_dim(jnp.asarray(m), 9))


def test_knn_edges_exact_with_ties(rng):
    # an integer grid: many exactly equidistant neighbours; ties go to the lower index
    pos = rng.integers(-3, 4, size=(60, 3)).astype(np.float32)
    mask = (rng.random(60) > 0.15).astype(np.float32)
    idx_t, val_t = TL.knn_edges(_t(pos), _t(pos), _t(mask), _t(mask), k=16, cutoff=2.5,
                                exclude_self=True)
    idx_j, val_j = JL.knn_edges(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mask),
                                jnp.asarray(mask), k=16, cutoff=2.5, exclude_self=True)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(np.where(val_t.numpy(), idx_t.numpy(), -1),
                                  np.where(np.asarray(val_j), np.asarray(idx_j), -1))
    # batched call = per-sample calls
    idx_b, val_b = TL.knn_edges(_t(np.stack([pos, pos[::-1]])), _t(np.stack([pos, pos[::-1]])),
                                _t(np.stack([mask, mask[::-1]])), _t(np.stack([mask, mask[::-1]])),
                                k=16, cutoff=2.5, exclude_self=True)
    np.testing.assert_array_equal(idx_b[0].numpy(), idx_t.numpy())


def test_checkpoint_loader_reads_flat_npz(tmp_path, rng):
    params = {"a": {"w": rng.normal(size=(3, 2)).astype(np.float32)},
              "convs": [{"b": np.ones(2, np.float32)}, {"b": np.zeros(2, np.float32)}]}
    ema = jax.tree.map(lambda x: x + 1.0, params)
    path = str(tmp_path / "ck.npz")
    JC.save_checkpoint(path, params, ema_params=ema, step=7)
    got, step = TCK.load_checkpoint(path, use_ema=True, device="cpu")
    assert step == 7 and isinstance(got["convs"], list) and len(got["convs"]) == 2
    np.testing.assert_array_equal(got["a"]["w"].numpy(), ema["a"]["w"])
    raw, _ = TCK.load_checkpoint(path, use_ema=False, device="cpu")
    np.testing.assert_array_equal(raw["convs"][1]["b"].numpy(), params["convs"][1]["b"])


def test_prep_cache_sample_and_buckets():
    from diffbindfr_tpu.app.pipeline import _load_sample_npz as jload
    from diffbindfr_tpu.data import sample as JS

    path = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")
    s_t, s_j = TS._load_sample_npz(path), jload(path)
    assert TS.DockingSample._fields == JS.DockingSample._fields
    for a, b in zip(s_t, s_j):
        np.testing.assert_array_equal(a, b)
    assert TS.LIG_BUCKET_LEVELS == JS.LIG_BUCKET_LEVELS
    assert TS.POCKET_BUCKET_LEVELS == JS.POCKET_BUCKET_LEVELS
    b = TS.bucket_of(s_t)
    assert (b.n_lig, b.n_tor, b.n_res, b.n_atm) == (128, 48, 128, 1024)
    for args in [(35, 76, 5, 113, 927), (20, 40, 3, 40, 300), (90, 200, 30, 70, 600)]:
        assert dataclass_tuple(TS.choose_bucket(*args)) == dataclass_tuple(JS.choose_bucket(*args))
    batch = TS.to_device(TS.stack_samples([s_t, s_t]), "cpu")
    assert batch.lig_pos.shape == (2, 128, 3) and batch.atm_feat.dtype == torch.int64


def dataclass_tuple(b):
    return (b.n_lig, b.n_lig_edges, b.n_tor, b.n_res, b.n_atm)
