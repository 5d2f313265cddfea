"""Cartesian fine-relax of the PyTorch port (diffbindfr_torch/ops/cartesian.py
and app/pipeline.py CartesianRelaxEngine, what `predict --cart-relax` runs)
against the JAX package's diffbindfr_tpu/ops/cartesian.py, on the CPU.

Inputs: the tracked prep records (runs/eval_r5_scsrc/prep_cache), read by
the JAX package's pickle on the reference side and by the port's
load_prep_record on the port's side; poses are the crystal poses moved by
seeded numpy noise (for the fixture: by seeded torsion, rotation and
translation changes, as the relax receives docked poses), receptors the
pocket's atom14 moved by smaller noise.
Tolerances: the builders' integer tables equal, their f32 fields 1e-6;
every energy term and the gradient of relax_energy 1e-5 relative; 30
minimizer steps 1e-4 A. The full-length fixture (300 steps at the pairs'
buckets, tests/fixtures/torch_relax_ref.npz) is held on the card by
chip_smoke.py; here its inputs are rebuilt and checked.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.ops import cartesian as JC
from diffbindfr_tpu.ops import vina as JV
from diffbindfr_torch.app import pipeline as TP
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.ops import cartesian as TC
from diffbindfr_torch.ops import vina as TV

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
FIXTURE = os.path.join(ROOT, "tests/fixtures/torch_relax_ref.npz")
# the fixture: Cartesian relax of FIX_POSES poses of each of FIX_NAMES at
# their buckets, FIX_STEPS steps (the default of every command); the flex
# joint minimizer and the explicit-H rigid minimizer on FLEX_POSES of 3dbs
FIX_NAMES, FIX_POSES, FLEX_POSES, FIX_STEPS = ("3dbs", "3mhw"), 4, 2, 300
# the small shapes of the live parity tests
NL, NT, NA, NR, STEPS = 48, 12, 1024, 128, 30


def _jax_record(name):
    with open(os.path.join(PREP, f"{name}_r12.rec.pkl"), "rb") as fh:
        return pickle.load(fh)


def _port_record(name):
    return load_prep_record(os.path.join(PREP, f"{name}_r12.rec.pkl"))


def relax_inputs(lig, pocket, nl, nr, seed):
    """(pose [nl, 3], atom14 [nr, 14, 3]): the crystal ligand padded to nl
    and moved by seeded noise (0.5 A), the pocket's atom14 padded to nr and
    its existing atoms moved by 0.1 A."""
    rng = np.random.default_rng(seed)
    p = np.zeros((nl, 3), np.float32)
    p[: lig.num_atoms] = lig.pos
    p += (rng.normal(scale=0.5, size=p.shape) * (np.arange(nl) < lig.num_atoms)[:, None]
          ).astype(np.float32)
    a = np.zeros((nr, 14, 3), np.float32)
    m = pocket.atom14_mask[..., None]
    a[: pocket.num_res] = pocket.atom14_pos * m + (
        rng.normal(scale=0.1, size=pocket.atom14_pos.shape) * m).astype(np.float32)
    return p, a


def _jstack(trees):
    return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)


@pytest.fixture(scope="module")
def batch():
    """3dbs and 3mhw at (NL, NT, NA, NR): the JAX and port tables, poses and
    receptors, and a second seeded point (x, drec) to evaluate at."""
    jt, tt, pos, a14 = [], [], [], []
    for i, n in enumerate(("3dbs", "3mhw")):
        jr, tr = _jax_record(n), _port_record(n)
        jt.append((JC.build_cartesian_ligand(jr["lig"], NL), JV.build_ligand(jr["lig"], NL, NT),
                   JC.build_cartesian_receptor(jr["pocket"], NA)))
        tt.append((TC.build_cartesian_ligand(tr["lig"], NL), TV.build_ligand(tr["lig"], NL, NT),
                   TC.build_cartesian_receptor(tr["pocket"], NA)))
        p, a = relax_inputs(tr["lig"], tr["pocket"], NL, NR, seed=i)
        pos.append(p)
        a14.append(a)
    jtabs = [_jstack([t[k] for t in jt]) for k in range(3)]
    ttabs = [TV.stack_to_device([t[k] for t in tt], "cpu") for k in range(3)]
    rng = np.random.default_rng(7)
    pos, a14 = np.stack(pos), np.stack(a14)
    x = pos + (rng.normal(scale=0.2, size=pos.shape) * (ttabs[0].mask.numpy()[..., None] > 0)
               ).astype(np.float32)
    drec = (rng.normal(scale=0.05, size=(2, NA, 3)) * ttabs[2].mask.numpy()[..., None]
            ).astype(np.float32)
    return jtabs, ttabs, pos, a14, x, drec


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_builders_match_jax(name):
    """build_cartesian_ligand / build_cartesian_receptor at the pair's
    bucket: integer tables equal, f32 fields within 1e-6, dtypes and shapes
    equal; 3mhw (no torsions) and every E/Z and chiral table included."""
    jr, tr = _jax_record(name), _port_record(name)
    b = tr["bucket"]
    for jb, tb in ((JC.build_cartesian_ligand(jr["lig"], b.n_lig),
                    TC.build_cartesian_ligand(tr["lig"], b.n_lig)),
                   (JC.build_cartesian_receptor(jr["pocket"], b.n_atm),
                    TC.build_cartesian_receptor(tr["pocket"], b.n_atm))):
        assert jb._fields == tb._fields
        for f in jb._fields:
            ja, ta = np.asarray(getattr(jb, f)), np.asarray(getattr(tb, f))
            assert ja.dtype == ta.dtype and ja.shape == ta.shape, f
            if ja.dtype.kind == "f":
                np.testing.assert_allclose(ta, ja, atol=1e-6, err_msg=f)
            else:
                np.testing.assert_array_equal(ta, ja, err_msg=f)


def test_energy_terms_and_gradient_match_jax(batch):
    """Each term (bonded, the two clash terms, Vina inter and intra, the
    restraints through relax_energy) and the gradient of relax_energy in
    the ligand coordinates and the receptor displacements: 1e-5 relative."""
    (jcl, jvl, jcr), (tcl, tvl, tcr), pos, a14, x, drec = batch
    w = JC.RelaxWeights()
    tx, td = torch.from_numpy(x), torch.from_numpy(drec)
    rp0 = TC.pack_receptor(torch.from_numpy(a14), tcr)
    rec_pos = rp0 + td
    tabs = TC._pair_tabs(tcl, tvl, tcr)
    got = {"bonded": TC.ligand_bonded_energy(tx, tcl, TC.RelaxWeights()),
           "clash": TC.clash_energy(tx, rec_pos, tabs, TC.RelaxWeights()),
           "vina_inter": TV._inter_energy_tab(tx, rec_pos, tabs.vtab),
           "vina_intra": TV.intra_energy(tx, tvl)}

    def jterms(x_, d_, a14_, cl, vl, cr):
        rp = a14_.reshape(-1, 3)[cr.pack_idx] + d_
        return {"bonded": JC.ligand_bonded_energy(x_, cl, w),
                "clash": JC.clash_energy(x_, rp, cl, cr, w),
                "vina_inter": JC._vina_inter(x_, rp, vl, cr),
                "vina_intra": JV.intra_energy(x_, vl)}

    want = jax.jit(jax.vmap(jterms))(jnp.asarray(x), jnp.asarray(drec), jnp.asarray(a14),
                                     jcl, jvl, jcr)
    for k in got:
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
        assert np.abs(np.asarray(want[k])).min() > 0, k  # every term is at work

    def jenergy(x_, d_, x0, a14_, cl, vl, cr):
        return JC.relax_energy(x_, d_, x0, a14_.reshape(-1, 3)[cr.pack_idx], cl, vl, cr, w)

    je, (jgx, jgd) = jax.jit(jax.vmap(jax.value_and_grad(jenergy, argnums=(0, 1))))(
        jnp.asarray(x), jnp.asarray(drec), jnp.asarray(pos), jnp.asarray(a14), jcl, jvl, jcr)
    leaves = [tx.clone().requires_grad_(True), td.clone().requires_grad_(True)]
    te = TC.relax_energy(*leaves, torch.from_numpy(pos), rp0, tcl, tvl, tcr, TC.RelaxWeights())
    gx, gd = torch.autograd.grad(te.sum(), leaves)
    assert _rel(te.detach().numpy(), je) <= 1e-5
    assert _rel(gx.numpy(), jgx) <= 1e-5
    assert _rel(gd.numpy(), jgd) <= 1e-5


def test_minimize_30_steps_matches_jax(batch):
    """cartesian_minimize_batch, 30 steps, B = 2 (3mhw without torsions),
    against the JAX cartesian_minimize_batch under jit: ligand and receptor
    atoms within 1e-4 A; padded ligand rows and the atom14 slots outside
    the packed pocket never move; the relax moved both (the control)."""
    (jcl, jvl, jcr), (tcl, tvl, tcr), pos, a14, _, _ = batch
    jx, ja = jax.jit(lambda *a: JC.cartesian_minimize_batch(*a, steps=STEPS))(
        jnp.asarray(pos), jnp.asarray(a14), jcl, jvl, jcr)
    jx, ja = np.asarray(jx), np.asarray(ja)
    tx, ta = TC.cartesian_minimize_batch(torch.from_numpy(pos), torch.from_numpy(a14),
                                         tcl, tvl, tcr, steps=STEPS)
    tx, ta = tx.numpy(), ta.numpy()
    lmask = tcl.mask.numpy() > 0
    packed = np.zeros((2, NR * 14), bool)
    for b in range(2):
        packed[b, tcr.pack_idx[b].numpy()[tcr.mask[b].numpy() > 0]] = True
    packed = packed.reshape(2, NR, 14)
    print(f"moved: ligand {np.abs(jx - pos)[lmask].max():.3f} A, receptor "
          f"{np.abs(ja - a14).max():.3f} A; port vs JAX {np.abs(tx - jx).max():.2e} / "
          f"{np.abs(ta - ja).max():.2e} A")
    assert np.abs(jx - pos)[lmask].max() > 0.05 and np.abs(ja - a14).max() > 0.01
    assert np.abs(tx - jx).max() <= 1e-4 and np.abs(ta - ja).max() <= 1e-4
    np.testing.assert_array_equal(tx[~lmask], pos[~lmask])
    np.testing.assert_array_equal(ta[~packed], a14[~packed])


def test_engine_equals_the_function(batch):
    """CartesianRelaxEngine (through cartesian_relax) on three poses of
    3dbs at batch size 2 (two batches, the second padded) equals
    cartesian_minimize_batch on the same poses, and leaves the scores."""
    pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, "3dbs_r12.npz"))
    b = pair.bucket
    ins = [relax_inputs(pair.lig, pair.pocket, b.n_lig, b.n_res, seed=20 + k) for k in range(3)]
    results = [TP.PoseResult(0, k, p.copy(), a.copy(), np.zeros(1), vina_score=-1.0 * k)
               for k, (p, a) in enumerate(ins)]
    TP.cartesian_relax([pair], results, steps=5, batch_size=2, device="cpu", verbose=False)
    tabs = [TV.stack_to_device([t] * 3, "cpu") for t in (
        TC.build_cartesian_ligand(pair.lig, b.n_lig), TV.build_ligand(pair.lig, b.n_lig, b.n_tor),
        TC.build_cartesian_receptor(pair.pocket, b.n_atm))]
    x, a14 = TC.cartesian_minimize_batch(torch.from_numpy(np.stack([i[0] for i in ins])),
                                         torch.from_numpy(np.stack([i[1] for i in ins])),
                                         *tabs, steps=5)
    for k, r in enumerate(results):
        assert np.abs(r.lig_pos - x[k].numpy()).max() <= 1e-6
        assert np.abs(r.atom14_pos - a14[k].numpy()).max() <= 1e-6
        assert r.vina_score == -1.0 * k and r.mdn_score is None
        assert np.abs(r.lig_pos - ins[k][0]).max() > 1e-3


def docked_inputs(pair, seed):
    """(pose [n_lig, 3], atom14 [n_res, 14, 3]) at the pair's bucket, as the
    relax receives them: the crystal conformer moved by seeded torsion
    (0.6 rad), rotation (0.15 rad) and translation (0.8 A) changes, so its
    covalent geometry stays intact; the pocket's atom14 as relax_inputs."""
    from diffbindfr_torch.geometry.torsion import pose_transform

    b = pair.bucket
    pose, a14 = relax_inputs(pair.lig, pair.pocket, b.n_lig, b.n_res, seed)
    crystal = np.zeros_like(pose)
    crystal[: pair.lig.num_atoms] = pair.lig.pos
    vl = TV.stack_to_device([TV.build_ligand(pair.lig, b.n_lig, b.n_tor)], "cpu")
    rng = np.random.default_rng(seed + 1)
    move = [torch.from_numpy(rng.normal(scale=s, size=(1, n)).astype(np.float32))
            for s, n in ((0.8, 3), (0.15, 3), (0.6, b.n_tor))]
    pose = pose_transform(torch.from_numpy(crystal[None]), vl.mask > 0, move[0], move[1],
                          vl.tor_bonds, vl.rot_node_mask > 0, move[2], vl.tor_mask > 0)
    return pose[0].numpy(), a14


def fixture_inputs(name):
    """The fixture's inputs for one pair: FIX_POSES docked-like (pose,
    atom14) at the pair's bucket (the flex and explicit-H minimizers take
    3dbs's first FLEX_POSES)."""
    pair = TP.PreparedPair.from_prep_cache(os.path.join(PREP, f"{name}_r12.npz"))
    ins = [docked_inputs(pair, seed=100 * k + len(name)) for k in range(FIX_POSES)]
    return pair, np.stack([i[0] for i in ins]), np.stack([i[1] for i in ins])


def test_fixture_holds_its_inputs():
    """tests/fixtures/torch_relax_ref.npz holds the poses this file makes,
    finite outputs, and relaxes that moved the poses."""
    ref = np.load(FIXTURE)
    for n in FIX_NAMES:
        _, pose0, a14 = fixture_inputs(n)
        np.testing.assert_array_equal(ref[n + "|pose0"], pose0)
        np.testing.assert_array_equal(ref[n + "|a14_0"], a14)
        for k in ("cart_pos", "cart_a14"):
            assert np.isfinite(ref[f"{n}|{k}"]).all()
        assert np.abs(ref[n + "|cart_pos"] - pose0).max() > 0.1
    for k in ("flex|pose0", "flex|pos", "flex|a14", "flex|aff", "xh|pos", "xh|aff"):
        assert np.isfinite(ref[k]).all(), k


@pytest.mark.slow
def test_write_relax_fixture():
    """Regenerates tests/fixtures/torch_relax_ref.npz from the JAX package on
    the CPU: cartesian_minimize_batch (FIX_STEPS) on FIX_POSES poses each of
    3dbs and 3mhw at their buckets; on the first FLEX_POSES poses of 3dbs,
    joint_minimize_batch over the pocket's chis (pad to 8 residues) and the
    explicit-H angular rigid minimize (each pose's receptor protonated
    against its ligand's acceptors), FIX_STEPS steps each."""
    out = {}
    for n in FIX_NAMES:
        jr = _jax_record(n)
        pair, pose0, a14 = fixture_inputs(n)
        b = pair.bucket
        cls, vls, crs = (_jstack([t] * FIX_POSES) for t in (
            JC.build_cartesian_ligand(jr["lig"], b.n_lig),
            JV.build_ligand(jr["lig"], b.n_lig, b.n_tor),
            JC.build_cartesian_receptor(jr["pocket"], b.n_atm)))
        x, a = jax.jit(lambda *args: JC.cartesian_minimize_batch(*args, steps=FIX_STEPS))(
            jnp.asarray(pose0), jnp.asarray(a14), cls, vls, crs)
        out.update({n + "|pose0": pose0, n + "|a14_0": a14,
                    n + "|cart_pos": np.asarray(x, np.float32),
                    n + "|cart_a14": np.asarray(a, np.float32)})
    jr = _jax_record("3dbs")
    pair, pose0, _ = fixture_inputs("3dbs")
    b, na = pair.bucket, pair.lig.num_atoms
    pose0 = pose0[:FLEX_POSES]
    vl = JV.build_ligand(jr["lig"], b.n_lig, b.n_tor)
    frec = JV.build_flex_receptor(jr["pocket"], -(-jr["pocket"].num_res // 8) * 8)
    pos, p14, aff = jax.jit(lambda lp, ls: JV.joint_minimize_batch(lp, ls, frec,
                                                                   steps=FIX_STEPS))(
        jnp.asarray(pose0), _jstack([vl] * FLEX_POSES))
    out.update({"flex|pose0": pose0, "flex|pos": np.asarray(pos, np.float32),
                "flex|a14": np.asarray(p14, np.float32), "flex|aff": np.asarray(aff, np.float32)})
    acc = np.asarray(vl.acceptor)[:na] > 0
    recs = [JV.build_receptor(jr["pocket"], b.n_atm, explicit_polar_h=True,
                              opt_acceptors=p[:na][acc]) for p in pose0]
    pos, aff = jax.jit(lambda lp, ls, rs: JV.minimize_batch(lp, ls, rs, steps=FIX_STEPS,
                                                            angular_hb=True))(
        jnp.asarray(pose0), _jstack([vl] * FLEX_POSES), _jstack(recs))
    out.update({"xh|pos": np.asarray(pos, np.float32), "xh|aff": np.asarray(aff, np.float32)})
    np.savez_compressed(FIXTURE, **out)
    assert all(np.isfinite(v).all() for v in np.load(FIXTURE).values())


def test_pads_too_small_are_refused():
    """A pad below a table's count raises naming the table (no silent
    truncation)."""
    with pytest.raises(ValueError, match="angle"):
        TC.build_cartesian_ligand(_port_record("3dbs")["lig"], 64, pad_angles=4)
