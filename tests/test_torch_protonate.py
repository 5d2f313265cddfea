"""Explicit polar hydrogens and the angular H-bond term of the PyTorch port
(diffbindfr_torch/chem/protonate.py; ops/vina.py build_receptor(
explicit_polar_h=), inter_energy(angular_hb=) and minimize_batch(
angular_hb=), which `relax --angular-hb / --explicit-h` run) against the
JAX package's chem/protonate.py and ops/vina.py, on the CPU.

Inputs: the tracked prep records (runs/eval_r5_scsrc/prep_cache), read by
the JAX package's pickle on the reference side and by the port's
load_prep_record on the port's side, and the tracked pb_bench ligands for
ligand_polar_h; poses are the crystal poses moved by seeded numpy noise.
Tolerances: hydrogen positions and the receptor tables 1e-5 A (the port
runs the same numpy; they come out equal); the angular energy 1e-5
relative and its gradient 1e-5 relative; 30 minimizer steps 1e-4 A on
positions and 1e-4 relative on the affinity.
"""
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbindfr_tpu.chem import mol as JM
from diffbindfr_tpu.chem import protonate as JP
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse
from diffbindfr_tpu.ops import vina as jvina
from diffbindfr_torch.chem import mol as TM
from diffbindfr_torch.chem import protonate as TPR
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.io.sdf import parse_ligand_file as tparse
from diffbindfr_torch.ops import vina as tvina

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
LIGANDS = sorted(glob.glob(os.path.join(ROOT, "runs/pb_bench/*/*_ligand.sdf")))
NL, NT, NA = 64, 12, 1024  # every pair but 3mhw's 96-atom ligand pad fits here
STEPS = 30


def _records(name):
    path = os.path.join(PREP, f"{name}_r12.rec.pkl")
    with open(path, "rb") as fh:
        return pickle.load(fh), load_prep_record(path)


def _pose(lig, seed, scale=0.4):
    """The crystal pose padded to NL, moved by seeded Gaussian noise (A)."""
    p = np.zeros((NL, 3), np.float32)
    p[: lig.num_atoms] = lig.pos
    noise = np.random.default_rng(seed).normal(scale=scale, size=p.shape).astype(np.float32)
    return p + noise * (np.arange(NL) < lig.num_atoms)[:, None]


def _same_ph(t, j):
    np.testing.assert_allclose(t.pos, j.pos, atol=1e-5)
    np.testing.assert_array_equal(t.parent, j.parent)
    assert len(t.rot_groups) == len(j.rot_groups)
    for (tr, to, td), (jr, jo, jd) in zip(t.rot_groups, j.rot_groups):
        assert tr == jr
        np.testing.assert_allclose(to, jo, atol=1e-5)
        np.testing.assert_allclose(td, jd, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_protein_hydrogens_match_jax(name):
    """protein_polar_h, optimize_rotatable against the ligand's acceptors,
    donor_h_axes: hydrogens within 1e-5 A, parents and groups equal; the
    rotatable groups are turned (the check can see a fault)."""
    jrec, trec = _records(name)
    pk = trec["pocket"]
    jh = JP.protein_polar_h(pk.aatype, pk.atom14_pos, pk.atom14_mask)
    th = TPR.protein_polar_h(pk.aatype, pk.atom14_pos, pk.atom14_mask)
    _same_ph(th, jh)
    assert len(th.rot_groups) > 0
    acc = np.concatenate([pk.atom14_pos.reshape(-1, 3)[:50], trec["lig"].pos])
    jo, to = JP.optimize_rotatable(jh, acc), TPR.optimize_rotatable(th, acc)
    _same_ph(to, jo)
    assert np.abs(to.pos - th.pos).max() > 0.1
    n = pk.atom14_pos.reshape(-1, 3).shape[0]
    for got, want in zip(TPR.donor_h_axes(to, pk.atom14_pos.reshape(-1, 3), n),
                         JP.donor_h_axes(jo, pk.atom14_pos.reshape(-1, 3), n)):
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("path", LIGANDS, ids=[os.path.basename(p)[:4] for p in LIGANDS])
def test_ligand_hydrogens_match_jax(path):
    jm, tm = JM.perceive(jparse(path)[0]), TM.perceive(tparse(path)[0])
    args = lambda m: (m.elements, m.coords, m.bonds, m.bond_orders, m.implicit_h)  # noqa: E731
    _same_ph(TPR.ligand_polar_h(*args(tm)), JP.ligand_polar_h(*args(jm)))


@pytest.mark.parametrize("name", ("3dbs", "2zec"))
def test_explicit_h_receptor_matches_jax(name):
    """build_receptor(explicit_polar_h=True, opt_acceptors=the ligand's
    acceptors): every field, hb_dir and hb_has included, within 1e-5; the
    explicit axes differ from the implicit ones (the check can see them)."""
    jrec, trec = _records(name)
    tl = tvina.build_ligand(trec["lig"], NL, NT)
    na = trec["lig"].num_atoms
    pos = _pose(trec["lig"], seed=1)
    acc = pos[:na][np.asarray(tl.acceptor)[:na] > 0]
    jr = jvina.build_receptor(jrec["pocket"], NA, explicit_polar_h=True, opt_acceptors=acc)
    tr = tvina.build_receptor(trec["pocket"], NA, explicit_polar_h=True, opt_acceptors=acc)
    for f in jr._fields:
        want, got = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert want.dtype == got.dtype and want.shape == got.shape, f
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f)
    implicit = tvina.build_receptor(trec["pocket"], NA)
    assert np.abs(implicit.hb_dir - tr.hb_dir).max() > 0.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("explicit,name", ((False, "3dbs"), (True, "2zec")),
                         ids=("implicit", "explicit"))
def test_angular_energy_gradient_and_minimize_match_jax(explicit, name):
    """inter_energy(angular_hb=True) and its gradient in the ligand
    coordinates at 1e-5 relative; 30 steps of minimize_batch(angular_hb=
    True) at B = 1 against the JAX `minimize`: positions 1e-4 A, affinity
    1e-4 relative; the angular term changes the energy and the minimizer
    moves the pose (the checks can see a fault)."""
    jrec, trec = _records(name)
    pos = _pose(trec["lig"], seed=10)
    na = trec["lig"].num_atoms
    tl = tvina.build_ligand(trec["lig"], NL, NT)
    jl = jvina.build_ligand(jrec["lig"], NL, NT)
    acc = pos[:na][np.asarray(tl.acceptor)[:na] > 0] if explicit else None
    jr = jvina.build_receptor(jrec["pocket"], NA, explicit_polar_h=explicit, opt_acceptors=acc)
    tr = tvina.build_receptor(trec["pocket"], NA, explicit_polar_h=explicit, opt_acceptors=acc)
    L, R = tvina.stack_to_device([tl], "cpu"), tvina.stack_to_device([tr], "cpu")
    tp = torch.from_numpy(pos[None]).requires_grad_(True)
    te = tvina.inter_energy(tp, L, R, angular_hb=True)
    tg = torch.autograd.grad(te.sum(), tp)[0][0].numpy()
    plain = tvina.inter_energy(tp, L, R)[0].item()
    je, jg = jax.value_and_grad(lambda x: jvina.inter_energy(x, jl, jr, angular_hb=True))(
        jnp.asarray(pos))
    assert _rel(te[0].item(), je) <= 1e-5
    assert _rel(tg, jg) <= 1e-5
    assert abs(plain - float(je)) > 1e-3
    jmin = jax.jit(lambda c, l, r: jvina.minimize(c, l, r, steps=STEPS, angular_hb=True,
                                                  tor_unroll=1))
    jpos, jaff = jmin(jnp.asarray(pos), jl, jr)
    tpos, taff = tvina.minimize_batch(torch.from_numpy(pos[None]), L, R, steps=STEPS,
                                      angular_hb=True)
    mask = np.asarray(tl.mask) > 0
    err = np.abs(tpos[0].numpy() - np.asarray(jpos))[mask].max()
    moved = np.abs(np.asarray(jpos) - pos)[mask].max()
    print(f"{name}: moved {moved:.3f} A, port vs JAX {err:.2e} A")
    assert moved > 0.05 and err <= 1e-4
    assert _rel(taff[0].item(), jaff) <= 1e-4
