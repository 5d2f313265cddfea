"""The PoseBusters-style validity suite of the port
(diffbindfr_torch/app/validity.py) against the JAX package's
diffbindfr_tpu/app/validity.py, on the CPU.

Inputs: the five runs/pb_bench complexes (ligand records and pockets of
radius 12 from each package's own host featurisation of the same files),
with five poses each: the crystal pose, a seeded perturbed pose, its mirror
image, a squashed pose and a pose moved out of the pocket. Every check of
`check_pose` must be equal (3mhw's crystal pose fails the suite in both);
the energy ratio and the overlap fraction are numpy with the same seeds,
held to 1e-9 relative. The ring sets of the flatness and stereo checks
come from the port's own cycle basis (chem/mol.py), held equal on all 21
tracked ligands. `run_table` writes the same CSV.
"""
import csv
import glob
import os

import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import validity as JV
from diffbindfr_tpu.chem import ligand_feats as JF
from diffbindfr_tpu.chem import mol as JM
from diffbindfr_tpu.chem import protein_feats as JPF
from diffbindfr_tpu.io.pdb import parse_pdb as jparse_pdb
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse
from diffbindfr_torch.app import validity as TV
from diffbindfr_torch.chem import ligand_feats as TF
from diffbindfr_torch.chem import mol as TM
from diffbindfr_torch.chem import protein_feats as TPF
from diffbindfr_torch.io.pdb import parse_pdb as tparse_pdb
from diffbindfr_torch.io.sdf import parse_ligand_file as tparse

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "runs/pb_bench")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
LIGANDS = (sorted(glob.glob(os.path.join(PB, "*/*_ligand.sdf")))
           + sorted(glob.glob(os.path.join(ROOT, "runs/screen_demo/mols/*.sdf"))))
POSES = ("crystal", "perturbed", "mirror", "squashed", "far")
RTOL = 1e-9


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _records(name, F, M, PF, parse, parse_pdb):
    """(ligand record in the pocket frame, pocket record) of one package."""
    d = os.path.join(PB, name)
    lig = F.featurize_ligand(M.perceive(parse(os.path.join(d, f"{name}_ligand.sdf"))[0]), name)
    prot = parse_pdb(os.path.join(d, f"{name}_protein_contact_chains.pdb"))
    pocket = PF.build_pocket_record(prot, lig.pos, cutoff=12.0)
    lig.pos = lig.pos - pocket.center
    return lig, pocket


@pytest.fixture(scope="module")
def records():
    """name -> ((JAX lig, JAX pocket), (port lig, port pocket))."""
    return {n: (_records(n, JF, JM, JPF, jparse, jparse_pdb),
                _records(n, TF, TM, TPF, tparse, tparse_pdb)) for n in NAMES}


def _poses(lig, seed):
    """The five poses of one ligand (pocket frame, float32 as the engines
    give them)."""
    ref = lig.pos.astype(np.float64)
    c = ref.mean(0)
    rng = np.random.default_rng(seed)
    squash = (ref - c) * np.array([1.0, 1.0, 0.5]) + c
    out = {"crystal": ref, "perturbed": ref + rng.normal(scale=0.35, size=ref.shape),
           "mirror": (ref - c) * np.array([-1.0, 1.0, 1.0]) + c, "squashed": squash,
           "far": ref + np.array([30.0, 0.0, 0.0])}
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_the_inputs_have_fused_rings():
    """21 tracked ligands, 19 of them with a fused ring system (rings that
    share a bond), where the ring basis matters."""
    assert len(LIGANDS) == 21
    fused = 0
    for p in LIGANDS:
        lig = TF.featurize_ligand(TM.perceive(tparse(p)[0]))
        rings = TM.cycle_basis(TV._graph(lig))
        edges = [{frozenset((r[k], r[(k + 1) % len(r)])) for k in range(len(r))}
                 for r in rings]
        fused += any(a & b for i, a in enumerate(edges) for b in edges[i + 1:])
    assert fused == 19


@pytest.mark.parametrize("path", LIGANDS, ids=lambda p: os.path.basename(p)[:-4])
def test_ring_sets_match_jax(path):
    """`_sp2_rings` (ring for ring, in order) and `_stereo_double_bonds`
    equal the JAX ones (networkx's cycle basis there)."""
    jl = JF.featurize_ligand(JM.perceive(jparse(path)[0]))
    tl = TF.featurize_ligand(TM.perceive(tparse(path)[0]))
    assert TV._sp2_rings(tl) == JV._sp2_rings(jl)
    assert TV._stereo_double_bonds(tl) == JV._stereo_double_bonds(jl)


def _recorded(monkeypatch, mod, fn_name, log):
    """Wrap mod.fn_name so that check_pose's calls log their values."""
    fn = getattr(mod, fn_name)

    def rec(*args, **kw):
        out = fn(*args, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(mod, fn_name, rec)


@pytest.mark.parametrize("name", NAMES)
def test_check_pose_matches_jax(records, name, monkeypatch):
    """Every check on the five poses equal to the JAX suite's, against the
    input pocket (crystal, mirror, far) or a moved per-pose receptor
    (atom14_pos, bucket-padded: perturbed, squashed); the energy ratio and
    the overlap fraction that check_pose computes within RTOL; 3mhw's
    crystal pose fails the suite."""
    (jl, jp), (tl, tp) = records[name]
    seed = NAMES.index(name)
    moved = tp.atom14_pos + np.random.default_rng(seed).normal(
        scale=0.2, size=tp.atom14_pos.shape).astype(np.float32)
    padded = np.concatenate([moved, np.zeros((3, 14, 3), np.float32)])
    logs = {}
    for mod in (JV, TV):
        for fn in ("internal_energy_ratio", "volume_overlap_fraction"):
            _recorded(monkeypatch, mod, fn, logs.setdefault((mod, fn), []))
    for kind, pose in _poses(tl, seed).items():
        a14 = padded if kind in ("perturbed", "squashed") else None
        want = JV.check_pose(jl, jp, pose, atom14_pos=a14)
        got = TV.check_pose(tl, tp, pose, atom14_pos=a14)
        assert got == want, (name, kind)
        if name == "3mhw" and kind == "crystal":
            assert not want["pass"]
    for fn in ("internal_energy_ratio", "volume_overlap_fraction"):
        got, want = logs[(TV, fn)], logs[(JV, fn)]
        assert len(got) == len(want) == len(POSES)
        assert max(_rel(g, w) for g, w in zip(got, want)) <= RTOL, fn


def test_run_table_matches_jax(tmp_path):
    """`run_table` over a results table of the five crystal ligands in
    their contact-chain receptors writes the CSV the JAX one writes."""
    src = tmp_path / "results.csv"
    with open(src, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["complex_name", "pose", "lig_sdf", "prot_pdb"])
        for n in NAMES:
            d = os.path.join(PB, n)
            w.writerow([n, 0, os.path.join(d, f"{n}_ligand.sdf"),
                        os.path.join(d, f"{n}_protein_contact_chains.pdb")])
    want = JV.run_table(str(src), str(tmp_path / "jax.csv"), verbose=False)
    got = TV.run_table(str(src), str(tmp_path / "port.csv"), verbose=False)
    with open(want) as a, open(got) as b:
        assert b.read() == a.read()
