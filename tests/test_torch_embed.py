"""Conformer embedding of the port (diffbindfr_torch/chem/embed.py) against
the JAX package's (diffbindfr_tpu/chem/embed.py), on the CPU, on the
crystal ligands of the five runs/pb_bench complexes.

The host half is the same numpy code: restraint tables, distance bounds and
mirrored MDS starts are bit-equal. The refinement is held where the two
frameworks can be compared step by step: each restraint term and its
gradient at equal positions (the JAX terms are its own loss closure,
captured from a 1-step embed and evaluated with the other tables emptied)
within 1e-5 of max|ref|, and ten Adam updates started from a JAX optax
state within 1e-5 A. Free-running, the two 1000-update refinements drift
apart by f32 rounding only: the final conformers are compared within 1e-3 A
(measured <= 4e-5 A on 3dbs and 3mhw), the final losses within 1e-3
relative, and ok()'s decisions must agree. The port's 3dbs conformers pass
tests/test_embed.py's geometry checks.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffbindfr_tpu.chem import embed as JE
from diffbindfr_tpu.chem.ligand_feats import featurize_ligand as j_featurize
from diffbindfr_tpu.chem.mol import perceive as j_perceive
from diffbindfr_tpu.io.sdf import parse_sdf as j_parse_sdf
from diffbindfr_torch.app.validity import (_chiral_volumes, _graph_distance_ge3,
                                           _neighbor_lists, _plane_dev, _sp2_rings,
                                           _stereo_double_bonds)
from diffbindfr_torch.chem import embed as TE
from diffbindfr_torch.chem.ligand_feats import featurize_ligand
from diffbindfr_torch.chem.mol import perceive
from diffbindfr_torch.io.sdf import parse_sdf

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
TABLES = {"pairs": ("pi",), "planar": ("pq",), "chiral": ("cq",), "ez": ("ez",)}
EMPTY = {"pi": 2, "pq": 4, "cq": 4, "ez": 2}


def _sdf(n):
    return os.path.join(ROOT, "runs/pb_bench", n, f"{n}_ligand.sdf")


@pytest.fixture(scope="module")
def ligands():
    """name -> (port LigandRecord, JAX LigandRecord, JAX loss closure)."""
    out = {}
    for n in NAMES:
        tl = featurize_ligand(perceive(parse_sdf(_sdf(n))[0]), n)
        jl = j_featurize(j_perceive(j_parse_sdf(_sdf(n))[0]), n)
        out[n] = (tl, jl, _jax_loss(jl))
    return out


def _jax_loss(jl):
    """The JAX package's restraint loss closure for `jl`, captured from a
    1-update embed (it is built inside embed_conformers)."""
    seen = []
    real = jax.value_and_grad

    def spy(fn, *a, **kw):
        seen.append(fn)
        return real(fn, *a, **kw)

    jax.value_and_grad = spy
    try:
        JE.embed_conformers(jl, 1, seed=0, steps=1)
    finally:
        jax.value_and_grad = real
    return seen[0]


def _jax_term(loss, name):
    """loss(pos, w_nb) with every restraint table but `name`'s emptied (for
    'nonbonded', all of them); the other terms then add exact zeros."""
    vals = {k: c.cell_contents for k, c in zip(loss.__code__.co_freevars, loss.__closure__)}
    keep = TABLES.get(name, ())
    for k, width in EMPTY.items():
        if k not in keep:
            vals[k] = jnp.zeros((0, width), jnp.int32)
    cells = tuple(types.CellType(vals[k]) for k in loss.__code__.co_freevars)
    return types.FunctionType(loss.__code__, loss.__globals__, loss.__name__,
                              loss.__defaults__, cells)


def _starts(lig, r, n=4, seed=0):
    lo, hi = TE._distance_bounds(lig, r)
    rng = np.random.default_rng(seed)
    return TE.mirrored_inits(np.stack([TE._mds_init(lo, hi, rng) for _ in range(n)]), r)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_restraints_bounds_and_starts_equal_jax(ligands, name):
    """build_restraints, _distance_bounds and the mirrored MDS starts of
    seed 0: every array equal to the JAX package's, value and dtype."""
    tl, jl, _ = ligands[name]
    tr, jr = TE.build_restraints(tl), JE.build_restraints(jl)
    for f in tr._fields:
        a, b = getattr(tr, f), getattr(jr, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(TE._distance_bounds(tl, tr), JE._distance_bounds(jl, jr)):
        np.testing.assert_array_equal(a, b)
    lo, hi = JE._distance_bounds(jl, jr)
    rng = np.random.default_rng(0)
    want = np.stack([JE._mds_init(lo, hi, rng) for _ in range(4)])
    if jr.chiral_quads.shape[0]:  # the JAX embed's mirror step, inline there
        q, s0 = jr.chiral_quads[0], jr.chiral_sign[0]
        for i in range(4):
            p = want[i]
            v = np.dot(np.cross(p[q[1]] - p[q[0]], p[q[2]] - p[q[0]]), p[q[3]] - p[q[0]])
            if np.sign(v) != s0:
                want[i, :, 2] *= -1.0
    np.testing.assert_array_equal(_starts(tl, tr), want)


@pytest.mark.parametrize("name", NAMES)
def test_loss_terms_and_gradients_match_jax(ligands, name):
    """Each restraint term and its gradient at the 4 MDS starts and at
    perturbed copies of them (the non-bonded term at the second phase's
    weight), and the summed loss and its gradient at both phases' weights:
    within 1e-5 of max|ref| of the JAX ones."""
    tl, _, loss = ligands[name]
    r = TE.build_restraints(tl)
    t = TE.restraint_tensors(r, "cpu")
    x0 = _starts(tl, r)
    x0 = np.concatenate([x0, x0 + np.random.default_rng(1).normal(
        scale=0.3, size=x0.shape).astype(np.float32)])
    x = torch.from_numpy(x0).requires_grad_(True)
    w_nb = TE.PHASES[-1][0]
    terms = TE.restraint_terms(x, t, w_nb)
    assert set(terms) <= {"pairs", "nonbonded", "planar", "chiral", "ez"}
    for k, v in terms.items():
        (g,) = torch.autograd.grad(v.sum(), x, retain_graph=True)
        fn = _jax_term(loss, k)
        w = w_nb if k == "nonbonded" else 0.0
        jv, jg = jax.vmap(jax.value_and_grad(lambda p: fn(p, w)))(jnp.asarray(x0))
        assert _rel(v.detach().numpy(), jv) <= 1e-5, k
        assert _rel(g.numpy(), jg) <= 1e-5, k
    for w_nb, _ in TE.PHASES:
        v = TE.restraint_loss(x, t, w_nb)
        (g,) = torch.autograd.grad(v.sum(), x)
        jv, jg = jax.vmap(jax.value_and_grad(lambda p: loss(p, w_nb)))(jnp.asarray(x0))
        assert _rel(v.detach().numpy(), jv) <= 1e-5 and _rel(g.numpy(), jg) <= 1e-5, w_nb


@pytest.mark.parametrize("name", ("3dbs", "2zec"))
def test_ten_adam_steps_from_jax_state(ligands, name):
    """From the JAX state after 7 updates of optax.adam over
    cosine_decay_schedule (each phase's weight and learning rate, 500
    updates a phase), ten updates of the port's adam_step land within 1e-5
    A of ten JAX updates, with mu and nu within 1e-5 of max|ref|."""
    tl, _, loss = ligands[name]
    r = TE.build_restraints(tl)
    t = TE.restraint_tensors(r, "cpu")
    x0 = jnp.asarray(_starts(tl, r, n=2))
    for w_nb, lr0 in TE.PHASES:
        opt = optax.adam(optax.cosine_decay_schedule(lr0, 500))

        @jax.jit
        def step(pos, st, w_nb=w_nb, opt=opt):
            g = jax.vmap(jax.grad(lambda p: loss(p, w_nb)))(pos)
            up, st = opt.update(g, st)
            return optax.apply_updates(pos, up), st

        pos, st = x0, opt.init(x0)
        for _ in range(7):
            pos, st = step(pos, st)
        count = int(st[0].count)
        tp = torch.from_numpy(np.asarray(pos))
        mu, nu = (torch.from_numpy(np.asarray(v)) for v in (st[0].mu, st[0].nu))
        for i in range(10):
            pos, st = step(pos, st)
            tp, mu, nu, _ = TE.adam_step(tp, mu, nu, count + i, t, w_nb, 500, lr0)
        assert np.abs(tp.numpy() - np.asarray(pos)).max() <= 1e-5, w_nb
        assert _rel(mu.numpy(), st[0].mu) <= 1e-5 and _rel(nu.numpy(), st[0].nu) <= 1e-5


def test_adam_scalars_follow_optax():
    """The learning rate of cosine_decay_schedule and the bias corrections
    at updates 0, 1, 250, 499, 500 and 700 (past the schedule's end)."""
    sched = optax.cosine_decay_schedule(0.08, 500)
    for c in (0, 1, 250, 499, 500, 700):
        lr, c1, c2 = TE.adam_scalars(c, 500, 0.08)
        assert lr == pytest.approx(float(sched(c)), rel=1e-6, abs=1e-12)
        assert c1 == pytest.approx(1 - 0.9 ** (c + 1), rel=1e-5)
        assert c2 == pytest.approx(1 - 0.999 ** (c + 1), rel=1e-4)


@pytest.fixture(scope="module")
def embedded_3dbs(ligands):
    tl = ligands["3dbs"][0]
    return tl, TE.embed_conformers(tl, 4, seed=0, device="cpu")


def test_port_conformers_pass_the_geometry_checks(embedded_3dbs):
    """tests/test_embed.py's checks on the port's 4 conformers of 3dbs:
    bond lengths within 10%, chiral signs and E/Z classes kept, aromatic
    rings flat, no internal clashes, and neither the crystal's distances nor
    each other's."""
    lig, confs = embedded_3dbs
    assert confs.shape == (4, lig.num_atoms, 3) and confs.dtype == np.float32
    b = lig.bonds
    ref = np.linalg.norm(lig.pos[b[:, 0]] - lig.pos[b[:, 1]], axis=-1)
    nbrs = _neighbor_lists(lig.bonds, lig.num_atoms)
    chiral = {j: np.sign(v) for j, v in _chiral_volumes(lig.pos, nbrs) if abs(v) > 0.25}
    assert chiral
    nb = _graph_distance_ge3(lig.bonds, lig.num_atoms)

    def dmat(p):
        return np.linalg.norm(p[:, None] - p[None, :] + 1e-9, axis=-1)

    for c in confs:
        np.testing.assert_allclose(np.linalg.norm(c[b[:, 0]] - c[b[:, 1]], axis=-1), ref,
                                   rtol=0.1)
        got = dict(_chiral_volumes(c, nbrs))
        assert all(np.sign(got[j]) == s for j, s in chiral.items())
        for _, _, sa, sb, _, _ in _stereo_double_bonds(lig):
            assert abs(np.linalg.norm(c[sa] - c[sb]) - np.linalg.norm(lig.pos[sa] - lig.pos[sb])) < 0.6
        for ring in _sp2_rings(lig):
            assert _plane_dev(c[np.asarray(ring)]) < 0.25
        assert dmat(c)[nb].min() > 1.8
        assert np.abs(dmat(c) - dmat(lig.pos)).mean() > 0.1
        np.testing.assert_allclose(c.mean(0), 0.0, atol=1e-4)
    assert max(np.abs(dmat(confs[i]) - dmat(confs[j])).mean()
               for i in range(4) for j in range(i + 1, 4)) > 0.1


@pytest.mark.parametrize("name", ("3dbs", "3mhw"))
def test_free_running_embed_tracks_jax(ligands, name):
    """embed_conformers(n=2, seed 0, 500 + 500 updates) of both packages:
    the conformers within 1e-3 A (the two frameworks' f32 roundings part
    the trajectories; measured <= 4e-5 A), their final restraint losses
    within 1e-3 relative, and ok()'s decision on each the same."""
    tl, jl, loss = ligands[name]
    got = TE.embed_conformers(tl, 2, seed=0, device="cpu")
    want = JE.embed_conformers(jl, 2, seed=0)
    drift = float(np.abs(got - want).max())
    print(f"{name}: conformers {drift:.2e} A apart")
    assert got.shape == want.shape and drift <= 1e-3
    r = TE.build_restraints(tl)
    tl_ = TE.restraint_loss(torch.from_numpy(got), TE.restraint_tensors(r, "cpu"), 2.0).numpy()
    jl_ = np.asarray(jax.vmap(lambda p: loss(p, 2.0))(jnp.asarray(want)))
    assert _rel(tl_, jl_) <= 1e-3
    assert [TE.conformer_ok(c, tl, r) for c in got] == [TE.conformer_ok(c, tl, r) for c in want]
