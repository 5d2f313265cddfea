"""Error correction of the PyTorch port (diffbindfr_torch/ops/vina.py,
geometry/torsion.py:pose_transform, app/pipeline.py ECEngine) against the
JAX package's diffbindfr_tpu/ops/vina.py on the same inputs.

Inputs: the five tracked prep records (runs/eval_r5_scsrc/prep_cache), read
by the JAX package's pickle on the reference side and by the port's
load_prep_record on the port's side; poses are the crystal poses moved by
seeded numpy noise. Tolerances: the builders are bit-identical; pose
1e-5 A; energies 1e-5 relative; the energy gradient 1e-4 relative; a 20-step
minimize_batch 1e-3 A on positions and 1e-4 relative on the affinity (f32
sums in another order through 20 Adam steps); the full-width EC fixture
(150 steps, tests/fixtures/torch_ec_ref.npz) 1e-3 A and 1e-4 relative.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.geometry import torsion as jtor
from diffbindfr_tpu.ops import vina as jvina
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.geometry import torsion as ttor
from diffbindfr_torch.ops import vina as tvina

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_ec_ref.npz")
FIX_NAMES, FIX_POSES, FIX_STEPS = ("3dbs", "3mhw"), 4, 150
# the small bucket of the parity tests: every pair but 3mhw fits it
SMALL_LIG, SMALL_TOR, SMALL_ATM = 64, 12, 1024
SMALL_NAMES = ("3pp0", "2src", "2zec", "3dbs")


def _jax_record(name):
    with open(os.path.join(PREP, f"{name}_r12.rec.pkl"), "rb") as fh:
        return pickle.load(fh)


def _records():
    return {n: (_jax_record(n), load_prep_record(os.path.join(PREP, f"{n}_r12.rec.pkl")))
            for n in NAMES}


@pytest.fixture(scope="module")
def records():
    return _records()


def _perturbed(lig, vlig, npad, seed, scale=0.6):
    """Crystal pose padded to npad, moved by seeded Gaussian noise (A)."""
    crystal = np.zeros((npad, 3), np.float32)
    crystal[: lig.num_atoms] = lig.pos
    rng = np.random.default_rng(seed)
    return (crystal + rng.normal(scale=scale, size=crystal.shape).astype(np.float32)
            * np.asarray(vlig.mask)[:, None]).astype(np.float32)


def _jstack(trees):
    return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)


def _small_batch(records):
    jl, jr, tl, tr, pos = [], [], [], [], []
    for i, n in enumerate(SMALL_NAMES):
        jrec, trec = records[n]
        jl.append(jvina.build_ligand(jrec["lig"], SMALL_LIG, SMALL_TOR))
        jr.append(jvina.build_receptor(jrec["pocket"], SMALL_ATM))
        tl.append(tvina.build_ligand(trec["lig"], SMALL_LIG, SMALL_TOR))
        tr.append(tvina.build_receptor(trec["pocket"], SMALL_ATM))
        pos.append(_perturbed(trec["lig"], tl[-1], SMALL_LIG, seed=10 + i))
    return (_jstack(jl), _jstack(jr), tvina.stack_to_device(tl, "cpu"),
            tvina.stack_to_device(tr, "cpu"), np.stack(pos))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_builders_are_bit_identical(records, name):
    """build_ligand / build_receptor at the pair's bucket: every field equal
    in value, dtype and shape (3mhw: 0 torsions, rot_node_mask [0, A])."""
    jrec, trec = records[name]
    b = trec["bucket"]
    for jb, tb in ((jvina.build_ligand(jrec["lig"], b.n_lig, b.n_tor),
                    tvina.build_ligand(trec["lig"], b.n_lig, b.n_tor)),
                   (jvina.build_receptor(jrec["pocket"], b.n_atm),
                    tvina.build_receptor(trec["pocket"], b.n_atm))):
        assert jb._fields == tb._fields
        for f in jb._fields:
            ja, ta = np.asarray(getattr(jb, f)), np.asarray(getattr(tb, f))
            assert ja.dtype == ta.dtype and ja.shape == ta.shape, f
            assert np.array_equal(ja, ta), f
    if name == "3mhw":
        assert trec["lig"].rot_node_mask.shape[0] == 0


def test_pose_transform_matches_jax(records):
    """Torsions, then the rigid move about the centroid: 1e-5 A."""
    _, _, tl, _, pos = _small_batch(records)
    rng = np.random.default_rng(3)
    B = pos.shape[0]
    tr = rng.normal(size=(B, 3)).astype(np.float32)
    rot = rng.normal(scale=0.5, size=(B, 3)).astype(np.float32)
    tor = rng.uniform(-np.pi, np.pi, size=(B, SMALL_TOR)).astype(np.float32)
    got = ttor.pose_transform(torch.from_numpy(pos), tl.mask > 0, torch.from_numpy(tr),
                              torch.from_numpy(rot), tl.tor_bonds, tl.rot_node_mask > 0,
                              torch.from_numpy(tor), tl.tor_mask > 0).numpy()
    for b in range(B):
        want = jtor.pose_transform(jnp.asarray(pos[b]), jnp.asarray(tl.mask[b].numpy() > 0),
                                   tr[b], rot[b], jnp.asarray(tl.tor_bonds[b].numpy()),
                                   jnp.asarray(tl.rot_node_mask[b].numpy() > 0), tor[b],
                                   jnp.asarray(tl.tor_mask[b].numpy() > 0))
        np.testing.assert_allclose(got[b], np.asarray(want), atol=1e-5)


def test_energies_and_gradient_match_jax(records):
    """inter / intra / affinity (and the hoisted-table forms the minimizer
    runs) at 1e-5 relative; the gradient of the total energy in (tr, rot,
    tor) at a random pose-parameter point at 1e-4 relative."""
    jl, jr, tl, tr_, pos = _small_batch(records)
    tpos = torch.from_numpy(pos)
    B = pos.shape[0]
    j_inter = jax.vmap(jvina.inter_energy)(jnp.asarray(pos), jl, jr)
    j_intra = jax.vmap(jvina.intra_energy)(jnp.asarray(pos), jl)
    j_aff = jax.vmap(jvina.affinity)(jnp.asarray(pos), jl, jr)
    for got, want in ((tvina.inter_energy(tpos, tl, tr_), j_inter),
                      (tvina._inter_energy_tab(tpos, tr_.pos, tvina._inter_tab(tl, tr_)), j_inter),
                      (tvina.intra_energy(tpos, tl), j_intra),
                      (tvina._intra_energy_tab(tpos, tvina._intra_tab(tl)), j_intra),
                      (tvina.affinity(tpos, tl, tr_), j_aff)):
        for b in range(B):
            assert abs(float(got[b]) - float(want[b])) <= 1e-5 * abs(float(want[b])), (b, got, want)

    rng = np.random.default_rng(4)
    p = {"tr": rng.normal(scale=0.3, size=(B, 3)).astype(np.float32),
         "rot": rng.normal(scale=0.2, size=(B, 3)).astype(np.float32),
         "tor": rng.normal(scale=0.5, size=(B, SMALL_TOR)).astype(np.float32)}

    def jenergy(pp, lp, lig, rec):
        pose = jtor.pose_transform(lp, lig.mask > 0, pp["tr"], pp["rot"], lig.tor_bonds,
                                   lig.rot_node_mask > 0, pp["tor"], lig.tor_mask > 0)
        return jvina.inter_energy(pose, lig, rec) + jvina.intra_energy(pose, lig)

    jg = jax.vmap(jax.grad(jenergy))(p, jnp.asarray(pos), jl, jr)
    leaves = [torch.from_numpy(p[k]).requires_grad_(True) for k in ("tr", "rot", "tor")]
    pose = ttor.pose_transform(tpos, tl.mask > 0, leaves[0], leaves[1], tl.tor_bonds,
                               tl.rot_node_mask > 0, leaves[2], tl.tor_mask > 0)
    e = tvina.inter_energy(pose, tl, tr_) + tvina.intra_energy(pose, tl)
    tg = torch.autograd.grad(e.sum(), leaves)
    for k, g in zip(("tr", "rot", "tor"), tg):
        err = _rel(g.numpy(), np.asarray(jg[k]))
        assert err <= 1e-4, (k, err)


def test_minimize_batch_20_steps_matches_jax(records):
    """20 Adam steps at the small bucket against the JAX minimize_batch
    under jit on the CPU: positions 1e-3 A over real atoms, affinity 1e-4
    relative. Stopping the torsion loop at the batch's largest torsion count
    gives the same poses as visiting every padded slot."""
    jl, jr, tl, tr_, pos = _small_batch(records)
    jpos, jaff = jax.jit(lambda c, l, r: jvina.minimize_batch(c, l, r, steps=20,
                                                              tor_unroll=1))(
        jnp.asarray(pos), jl, jr)
    jpos, jaff = np.asarray(jpos), np.asarray(jaff)
    n_tor = max(records[n][1]["lig"].num_torsions for n in SMALL_NAMES)
    tpos, taff = tvina.minimize_batch(torch.from_numpy(pos), tl, tr_, steps=20, n_tor=n_tor)
    mask = tl.mask.numpy() > 0
    moved = np.abs(pos - jpos)[mask].max()
    err = np.abs(tpos.numpy() - jpos)[mask].max()
    print(f"20 steps: max move {moved:.3f} A, port vs JAX {err:.2e} A, affinity "
          f"rel {_rel(taff.numpy(), jaff):.2e}")
    assert moved > 0.05  # the minimizer moved the poses: the check can see a fault
    assert err <= 1e-3
    assert _rel(taff.numpy(), jaff) <= 1e-4
    apos, aaff = tvina.minimize_batch(torch.from_numpy(pos), tl, tr_, steps=20)
    np.testing.assert_allclose(apos.numpy(), tpos.numpy(), atol=1e-6)
    np.testing.assert_allclose(aaff.numpy(), taff.numpy(), rtol=1e-6)


def _fixture_inputs(trec, name):
    b = trec["bucket"]
    vl = tvina.build_ligand(trec["lig"], b.n_lig, b.n_tor)
    return np.stack([_perturbed(trec["lig"], vl, b.n_lig, seed=100 * k + len(name))
                     for k in range(FIX_POSES)])


def test_ec_engine_matches_fixture():
    """The port's ECEngine on the CPU (150 steps, both buckets, 3mhw with 0
    torsions) against the JAX minimize_batch at full width, stored in
    tests/fixtures/torch_ec_ref.npz: positions 1e-3 A over real atoms,
    vina_score 1e-4 relative; the distance the poses moved printed as the
    control."""
    ref = np.load(FIXTURE)
    prepared = [TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{n}_r12.npz"))
                for n in FIX_NAMES]
    results = []
    for i, (n, pair) in enumerate(zip(FIX_NAMES, prepared)):
        pose0 = ref[n + "|pose0"]
        np.testing.assert_array_equal(pose0, _fixture_inputs(
            {"lig": pair.lig, "bucket": pair.bucket}, n))
        a14 = np.zeros(pair.sample.atom14_mask.shape + (3,), np.float32)
        for k in range(FIX_POSES):
            results.append(TP.PoseResult(i, k, pose0[k].copy(), a14, np.zeros(1)))
    TP.error_correct(prepared, results, steps=FIX_STEPS, batch_size=FIX_POSES, device="cpu",
                     verbose=False)
    for i, (n, pair) in enumerate(zip(FIX_NAMES, prepared)):
        rs = [r for r in results if r.pair_idx == i]
        got = np.stack([r.lig_pos for r in rs])
        mask = pair.sample.lig_mask > 0
        err = np.abs(got - ref[n + "|ec_pos"])[:, mask].max()
        moved = np.abs(ref[n + "|pose0"] - ref[n + "|ec_pos"])[:, mask].max()
        aff = np.array([r.vina_score for r in rs])
        print(f"{n}: EC moved up to {moved:.3f} A; port vs JAX {err:.2e} A, affinity rel "
              f"{_rel(aff, ref[n + '|ec_aff']):.2e}")
        assert err <= 1e-3, n
        assert _rel(aff, ref[n + "|ec_aff"]) <= 1e-4, n


@pytest.mark.slow
def test_write_ec_fixture():
    """Regenerates tests/fixtures/torch_ec_ref.npz from the JAX package on
    the CPU: 3dbs and 3mhw at their buckets, FIX_POSES seeded perturbed
    crystal poses each, FIX_STEPS steps of the JAX minimize_batch (what
    ECEngine runs). The MDN fixture reads these poses."""
    out = {}
    for n in FIX_NAMES:
        jrec = _jax_record(n)
        trec = load_prep_record(os.path.join(PREP, f"{n}_r12.rec.pkl"))
        b = trec["bucket"]
        pose0 = _fixture_inputs(trec, n)
        jl = jvina.build_ligand(jrec["lig"], b.n_lig, b.n_tor)
        jr = jvina.build_receptor(jrec["pocket"], b.n_atm)
        ligs, recs = _jstack([jl] * FIX_POSES), _jstack([jr] * FIX_POSES)
        pos, aff = jax.jit(lambda c, l, r: jvina.minimize_batch(c, l, r, steps=FIX_STEPS))(
            jnp.asarray(pose0), ligs, recs)
        out[n + "|pose0"] = pose0
        out[n + "|ec_pos"] = np.asarray(pos, np.float32)
        out[n + "|ec_aff"] = np.asarray(aff, np.float32)
    np.savez_compressed(FIXTURE, **out)
    assert all(np.isfinite(v).all() for v in np.load(FIXTURE).values())
