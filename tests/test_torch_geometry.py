"""Geometry of the PyTorch port against the JAX package: rotations, Kabsch,
torsion updates and modify_conformer on the 3dbs prep-cache sample, the
AF2 side-chain rebuild, and the SO(3) / torus score norms at a handful of
grid points (never the full tables).

Tolerance: f32 geometry through SVDs and chained rotations -> atol 1e-4 A
on coordinates; score norms are f64 sums cast to f32 -> rtol 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app.pipeline import _load_sample_npz as jload
from diffbindfr_tpu.geometry import chi as JCHI
from diffbindfr_tpu.geometry import kabsch as JK
from diffbindfr_tpu.geometry import rotations as JR
from diffbindfr_tpu.geometry import so3 as JSO3
from diffbindfr_tpu.geometry import torsion as JT
from diffbindfr_tpu.geometry import torus as JTOR
from diffbindfr_torch.geometry import chi as TCHI
from diffbindfr_torch.geometry import frames as TF
from diffbindfr_torch.geometry import kabsch as TK
from diffbindfr_torch.geometry import rotations as TR
from diffbindfr_torch.geometry import so3 as TSO3
from diffbindfr_torch.geometry import torsion as TT
from diffbindfr_torch.geometry import torus as TTOR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache/3dbs_r12.npz")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rotations_match(rng):
    v = rng.normal(size=(50, 3)).astype(np.float32) * 2.0
    v[0] = 0.0
    v[1] = 1e-6
    R_t, R_j = TR.axis_angle_to_matrix(_t(v)), JR.axis_angle_to_matrix(jnp.asarray(v))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=2e-6)
    np.testing.assert_allclose(TR.matrix_to_axis_angle(R_t).numpy(),
                               np.asarray(JR.matrix_to_axis_angle(R_j)), atol=5e-5)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(TR.quaternion_to_matrix(_t(q)).numpy(),
                               np.asarray(JR.quaternion_to_matrix(jnp.asarray(q))), atol=1e-6)
    R = TR.random_rotation((5,), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(), np.eye(3)[None].repeat(5, 0),
                               atol=1e-5)


def test_kabsch_and_frames_match(rng):
    a = rng.normal(size=(4, 30, 3)).astype(np.float32)
    R = np.asarray(JR.axis_angle_to_matrix(jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)))
    b = np.einsum("bij,bnj->bni", R, a) + rng.normal(size=(4, 1, 3)).astype(np.float32)
    mask = (rng.random((4, 30)) > 0.2).astype(np.float32)
    Rt, tt = TK.kabsch_align(_t(a), _t(b), _t(mask))
    Rj, tj = JK.kabsch_align(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(TK.masked_rmsd(_t(a), _t(b), _t(mask)).numpy(),
                               np.asarray(JK.masked_rmsd(jnp.asarray(a), jnp.asarray(b),
                                                         jnp.asarray(mask))), rtol=1e-5)
    o, x, y = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3))
    fr = TF.from_3_points(_t(o), _t(x), _t(y))
    from diffbindfr_tpu.geometry import frames as JF

    fj = JF.from_3_points(jnp.asarray(o), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(fr.rot.numpy(), np.asarray(fj.rot), atol=1e-5)
    p = rng.normal(size=(6, 3)).astype(np.float32)
    back = TF.apply_inverse(fr, TF.apply(fr, _t(p)))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-5)


def test_modify_conformer_matches_on_3dbs(rng):
    s = jload(SAMPLE)
    bsz = 3
    nt = s.tor_mask.shape[0]
    pos = np.stack([s.lig_pos + rng.normal(size=3).astype(np.float32) for _ in range(bsz)])
    tr = rng.normal(size=(bsz, 3)).astype(np.float32)
    rot = rng.normal(size=(bsz, 3)).astype(np.float32)
    tor = rng.uniform(-np.pi, np.pi, size=(bsz, nt)).astype(np.float32)
    bonds = np.stack([s.tor_src, s.tor_dst], -1)
    want = jax.vmap(lambda p, a, r, u: JT.modify_conformer(
        p, jnp.asarray(s.lig_mask > 0), a, r, jnp.asarray(bonds),
        jnp.asarray(s.rot_node_mask > 0), u, jnp.asarray(s.tor_mask > 0)))(
        jnp.asarray(pos), jnp.asarray(tr), jnp.asarray(rot), jnp.asarray(tor))
    rep = lambda x: _t(np.stack([x] * bsz))  # noqa: E731
    got = TT.modify_conformer(_t(pos), rep(s.lig_mask > 0), _t(tr), _t(rot),
                              rep(bonds).long(), rep(s.rot_node_mask > 0), _t(tor),
                              rep(s.tor_mask > 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_build_atom14_matches_on_3dbs(rng):
    s = jload(SAMPLE)
    tors = s.torsion_angle + rng.normal(size=s.torsion_angle.shape).astype(np.float32)
    sincos = np.stack([np.sin(tors), np.cos(tors)], -1).astype(np.float32)
    args = (sincos, s.backbone_rots, s.backbone_transl, s.default_frame, s.template_pos,
            s.group_idx, s.atom14_mask)
    want = JCHI.build_atom14(*[jnp.asarray(a) for a in args])
    got = TCHI.build_atom14(*[_t(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _so3_reference_row(i):
    """exp_score_norms[i] by the JAX package's numpy table code, one row."""
    grid = 10 ** np.linspace(np.log10(JSO3.MIN_EPS), np.log10(JSO3.MAX_EPS), JSO3.N_EPS)
    om = np.linspace(0, np.pi, JSO3.X_N + 1)[1:]
    ex = JSO3._expansion(om, grid[i])
    sc = JSO3._score_series(ex, om, grid[i])
    pdf = ex * (1 - np.cos(om)) / np.pi
    return np.float32(np.sqrt(np.sum(sc**2 * pdf) / np.sum(pdf) / np.pi))


def _sampler_rows():
    """The SO(3) grid rows the default 20-step sampler reads."""
    from diffbindfr_torch.models import score_net as TSN
    from diffbindfr_torch.sampler import SamplerConfig, t_schedule

    cfg = SamplerConfig()
    sig = TSN.sigmas_from_t(t_schedule(cfg)[: cfg.actual_steps], cfg.schedule).rot
    return TSO3._eps_index(sig).tolist()


# grid ends and middle, and every sampler row: at its smallest sigmas the
# series underflows near omega = pi, where the port drops the points below
# the sum's rounding-error bound
@pytest.mark.parametrize("i", [0, 137, 500, 998] + _sampler_rows())
def test_so3_score_norm_rows_match(i):
    np.testing.assert_allclose(TSO3.exp_score_norm_row(i), _so3_reference_row(i), rtol=1e-6)


@pytest.mark.slow
def test_so3_score_norm_rows_match_on_full_grid():
    # all 1000 rows against the JAX package's table (minutes on the CPU)
    want = JSO3.tables().exp_score_norms.astype(np.float32)
    got = np.array([TSO3.exp_score_norm_row(i) for i in range(JSO3.N_EPS)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    print("max rel diff", float(np.max(np.abs(got - want) / want)))


def test_torus_score_norms_match_on_reduced_grid(monkeypatch):
    # the JAX package's table code on a 21-point sigma grid, this port row by row
    monkeypatch.setattr(JTOR, "SIGMA_N", 20)
    monkeypatch.setattr(TTOR, "SIGMA_N", 20)
    want = JTOR._compute_tables()["score_norm"]
    got = np.array([TTOR.score_norm_row(i) for i in range(21)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_score_norm_grid_indices_match(rng):
    sig = np.concatenate([rng.uniform(0.005, 6.0, 300), [0.01, 2.0, 3.14, 1e-4, 50.0]])
    sig = sig.astype(np.float32)
    np.testing.assert_array_equal(TSO3._eps_index(_t(sig)).numpy(),
                                  np.asarray(JSO3._eps_index(jnp.asarray(sig))))
    np.testing.assert_array_equal(TTOR._sigma_index(_t(sig)).numpy(),
                                  np.asarray(JTOR._sigma_index(jnp.asarray(sig))))


# ---- the device tables: the port's own rows against the JAX package's tables,
# and the lookups on the JAX package's tables

@pytest.mark.parametrize("rows", [[0, 1, 50], [137, 500], [998, 999]])
def test_so3_table_rows_match(rows):
    """cdf and exp_score_norms everywhere; the per-omega score where the
    density is at least 1e-9 of its row's peak (below that the JAX table
    holds the series' rounding noise, up to 3e5 at eps 0.01, omega near pi)."""
    jt = JSO3.tables()
    r = TSO3.compute_rows(rows)
    np.testing.assert_allclose(r["exp_score_norms"].to(torch.float32).numpy(),
                               jt.exp_score_norms[rows].astype(np.float32), rtol=1e-6)
    cdf = r["cdf_vals"].numpy()
    np.testing.assert_allclose(cdf.astype(np.float32), jt.cdf_vals[rows], rtol=0, atol=1e-6)
    pdf = np.diff(cdf, prepend=0.0, axis=1)
    keep = pdf > 1e-9 * pdf.max(axis=1, keepdims=True)
    assert keep.sum(axis=1).min() >= 40
    got = r["score_norms"].to(torch.float32).numpy()
    np.testing.assert_allclose(got[keep], jt.score_norms[rows].astype(np.float32)[keep],
                               rtol=1e-6)


def test_torus_table_rows_match():
    rows = [0, 1, 700, 1400, 2000]
    jt = JTOR.tables()
    r = TTOR.compute_rows(rows)
    np.testing.assert_allclose(r["score"].to(torch.float32).numpy(), jt.score[rows], rtol=1e-6)
    np.testing.assert_allclose(r["score_norm"].to(torch.float32).numpy(), jt.score_norm[rows],
                               rtol=1e-6)


@pytest.fixture
def jax_tables_on_cpu():
    saved = dict(TSO3._tables), dict(TTOR._tables)
    jt = JSO3.tables()
    TSO3.set_tables(TSO3.SO3Tables.from_numpy("cpu", **jt._asdict()))
    tt = JTOR.tables()
    TTOR.set_tables(TTOR.TorusTables.from_numpy("cpu", score=tt.score, score_norm=tt.score_norm))
    yield
    for mod, old in zip((TSO3, TTOR), saved):
        mod._tables.clear()
        mod._tables.update(old)


def test_so3_lookups_match(jax_tables_on_cpu, rng):
    eps = np.concatenate([rng.uniform(0.03, 1.55, 60), [0.01, 0.0101, 2.0, 1e-3]])
    eps = eps.astype(np.float32)
    vec = (rng.normal(size=(eps.size, 3)) * rng.uniform(0.01, 3.1, (eps.size, 1)))
    vec = vec.astype(np.float32)
    np.testing.assert_array_equal(TSO3.score_norm(_t(eps)).numpy(),
                                  np.asarray(JSO3.score_norm(jnp.asarray(eps))))
    want = jax.vmap(JSO3.score_vec)(jnp.asarray(eps), jnp.asarray(vec))
    np.testing.assert_allclose(TSO3.score_vec(_t(eps), _t(vec)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # sample_vec with the JAX draws injected (so3.py:sample_vec splits its key in two)
    keys = jax.random.split(jax.random.PRNGKey(3), eps.size)
    want = jax.vmap(JSO3.sample_vec)(keys, jnp.asarray(eps))
    k12 = jax.vmap(jax.random.split)(keys)
    normal = jax.vmap(lambda k: jax.random.normal(k, (3,)))(k12[:, 0])
    uniform = jax.vmap(lambda k: jax.random.uniform(k, ()))(k12[:, 1])
    got = TSO3.sample_vec(_t(eps), normal=_t(normal), uniform=_t(uniform))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # and from a generator: rotation angles inside (0, pi]
    drawn = TSO3.sample_vec(_t(eps), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (eps.size, 3)
    assert float(torch.linalg.norm(drawn, dim=-1).max()) <= np.pi + 1e-6


def test_torus_lookups_match(jax_tables_on_cpu, rng):
    x = rng.uniform(-9.0, 9.0, (40, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1e-7, -np.pi]
    sigma = rng.uniform(0.03, 3.2, (40, 1)).astype(np.float32)
    np.testing.assert_allclose(TTOR.score(_t(x), _t(sigma)).numpy(),
                               np.asarray(JTOR.score(jnp.asarray(x), jnp.asarray(sigma))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TTOR.score_norm(_t(sigma[:, 0])).numpy(),
                                  np.asarray(JTOR.score_norm(jnp.asarray(sigma[:, 0]))))
    key = jax.random.PRNGKey(5)
    want = JTOR.sample(key, jnp.asarray(sigma), (40, 1))
    normal = jax.random.normal(key, (40, 1))
    np.testing.assert_allclose(TTOR.sample(_t(sigma), normal=_t(normal)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
