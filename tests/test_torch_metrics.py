"""The port's pose metrics (diffbindfr_torch/metrics/pose.py), its VF2
automorphism enumerator and its clustering (app/cluster.py) against the JAX
package's, which enumerates automorphisms with networkx.

Inputs: the JAX package's saved poses of the five tracked complexes
(runs/eval_r5_scsrc/poses.npz, 40 per complex) and their prep records, and a
synthetic ligand with more automorphisms than clustering keeps. Metrics
within 1e-9 (the same numpy operations give the same floats); automorphism
lists and cluster outputs exactly equal, in order.
"""
import os
import pickle

import networkx as nx
import numpy as np
import pytest
import torch

from diffbindfr_tpu.app import cluster as JCL
from diffbindfr_tpu.app import export as JEX
from diffbindfr_tpu.constants import residues as JRC
from diffbindfr_tpu.metrics import pose as JM
from diffbindfr_torch.app import cluster as TCL
from diffbindfr_torch.app import export as TEX
from diffbindfr_torch.chem.records import load_prep_record
from diffbindfr_torch.constants import residues as TRC
from diffbindfr_torch.metrics import pose as TM

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "runs/eval_r5_scsrc/prep_cache")
POSES = os.path.join(ROOT, "runs/eval_r5_scsrc/poses.npz")
NAMES = ("2src", "2zec", "3dbs", "3mhw", "3pp0")
N_AUTO = {"2src": 24, "2zec": 4, "3dbs": 8, "3mhw": 1, "3pp0": 6}


def _records(name):
    with open(os.path.join(PREP, f"{name}_r12.rec.pkl"), "rb") as fh:
        jrec = pickle.load(fh)  # the JAX package's classes
    return jrec, load_prep_record(os.path.join(PREP, f"{name}_r12.rec.pkl"))


def _networkx_automorphisms(bonds, elements, n):
    """The automorphisms as networkx enumerates them, built as the JAX
    package builds its graph (diffbindfr_tpu/metrics/pose.py:32-46), with no
    cap on their number."""
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for a, b in map(tuple, bonds):
        g.add_edge(int(a), int(b))
    for i, el in enumerate(elements):
        g.nodes[i]["el"] = el
    gm = nx.algorithms.isomorphism.GraphMatcher(
        g, g, node_match=nx.algorithms.isomorphism.categorical_node_match("el", ""))
    return [np.array([m[i] for i in range(n)], np.int64) for m in gm.isomorphisms_iter()]


def _tris_cf3():
    """Benzene with CF3 on every other ring carbon: 6 ring symmetries x 6^3
    fluorine permutations = 1296 automorphisms, over clustering's 32."""
    el = ["C"] * 6
    bonds = [(i, (i + 1) % 6) for i in range(6)]
    for k in range(3):
        c = len(el)
        el.append("C")
        bonds.append((2 * k, c))
        for _ in range(3):
            el.append("F")
            bonds.append((c, len(el) - 1))
    return np.asarray(bonds, np.int64), el


def test_residue_tables_equal_jax():
    """The residue tables that export and the metrics read, copied into the
    port: same values, dtypes and shapes."""
    for n in ("atom37_names", "atom37_order", "restype_1to3", "restype_3to1",
              "restypes_with_x", "restype_name_to_atom14_names"):
        assert getattr(TRC, n) == getattr(JRC, n), n
    for n in ("restype_atom14_to_atom37", "restype_atom14_mask", "chi_angles_mask",
              "chi_angles_to_atom14", "chi_pi_periodic"):
        a, b = getattr(TRC, n), getattr(JRC, n)
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    for res3 in ("ALA", "MSE", "UNK", "HOH", "TRP"):
        assert TRC.aatype_from_resname(res3) == JRC.aatype_from_resname(res3)


@pytest.mark.parametrize("name", NAMES)
def test_automorphisms_in_networkx_order(name):
    _, trec = _records(name)
    lig = trec["lig"]
    want = _networkx_automorphisms(lig.bonds, lig.elements, lig.num_atoms)
    got = TM._automorphisms(lig.bonds, lig.elements, lig.num_atoms)
    assert len(got) == len(want) == N_AUTO[name]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_automorphisms_past_the_cluster_cap():
    """On 1296 automorphisms the order decides which 32 the clustering keeps:
    the list equals networkx's in order, and pose_rmsd_matrix (truncated to
    the first 32) equals the JAX package's exactly, as does ligand_rmsd."""
    bonds, el = _tris_cf3()
    want = _networkx_automorphisms(bonds, el, len(el))
    got = TM._automorphisms(bonds, el, len(el))
    assert len(got) == len(want) == 1296 > TCL._MAX_PERMS
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    rng = np.random.default_rng(1)
    poses = rng.normal(size=(6, len(el), 3)).astype(np.float32) * 2.0
    np.testing.assert_array_equal(TCL.pose_rmsd_matrix(poses, bonds, el),
                                  JCL.pose_rmsd_matrix(poses, bonds, el))
    assert TM.ligand_rmsd(poses[0], poses[1], bonds, el) == JM.ligand_rmsd(
        poses[0], poses[1], bonds, el)
    # a single atom, no bonds: one (identity) automorphism
    assert [list(p) for p in TM._automorphisms(np.zeros((0, 2), np.int64), ["C"], 1)] == [[0]]


@pytest.mark.parametrize("name", NAMES)
def test_pose_metrics_match_jax(name):
    """pose_metrics (l_rmsd, centroid against the world-frame crystal pose;
    chi1_rate, sc_rmsd against the input pocket) on 8 saved poses, and the
    four metric functions directly, within 1e-9 of the JAX package."""
    jrec, trec = _records(name)
    data = np.load(POSES)
    lig_pos, a14 = data[f"{name}|lig_pos"][:8], data[f"{name}|atom14_pos"][:8]
    for lp, ap in zip(lig_pos, a14):
        got = TEX.pose_metrics(trec["lig"], trec["pocket"], lp, ap,
                               crystal_lig_pos=trec["crystal_pos"], holo_pocket=trec["pocket"])
        want = JEX.pose_metrics(jrec["lig"], jrec["pocket"], lp, ap,
                                crystal_lig_pos=jrec["crystal_pos"], holo_pocket=jrec["pocket"])
        g, w = got.as_dict(), want.as_dict()
        assert set(g) == set(w) == {"l_rmsd", "centroid", "chi1_rate", "sc_rmsd"}
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-9, (name, k, g[k], w[k])
    pk, lig = trec["pocket"], trec["lig"]
    pred = lig_pos[0][: lig.num_atoms] + pk.center
    ref = trec["crystal_pos"]
    assert abs(TM.ligand_rmsd(pred, ref, lig.bonds, lig.elements)
               - JM.ligand_rmsd(pred, ref, lig.bonds, lig.elements)) <= 1e-9
    assert abs(TM.centroid_distance(pred, ref) - JM.centroid_distance(pred, ref)) <= 1e-9
    r = pk.num_res
    p14 = a14[0][:r] + pk.center
    r14 = pk.atom14_pos + pk.center
    for fn in ("chi1_accuracy", "sidechain_rmsd"):
        g = getattr(TM, fn)(pk.aatype, p14, r14, pk.atom14_mask)
        w = getattr(JM, fn)(pk.aatype, p14, r14, pk.atom14_mask)
        assert abs(g - w) <= 1e-9, (name, fn)


@pytest.mark.parametrize("name", NAMES)
def test_cluster_functions_match_jax(name):
    """pose_rmsd_matrix over all 40 saved poses, single_linkage at three
    cutoffs and cluster_rank in its three modes (with tied scores): exact."""
    _, trec = _records(name)
    lig = trec["lig"]
    lp = np.load(POSES)[f"{name}|lig_pos"][:, : lig.num_atoms]
    d = TCL.pose_rmsd_matrix(lp, lig.bonds, lig.elements)
    np.testing.assert_array_equal(d, JCL.pose_rmsd_matrix(lp, lig.bonds, lig.elements))
    rng = np.random.default_rng(2)
    scores = np.round(rng.normal(size=len(lp)), 1)  # rounding makes ties
    for cut in (1.0, 2.0, 4.0):
        labels = TCL.single_linkage(d, cut)
        np.testing.assert_array_equal(labels, JCL.single_linkage(d, cut))
        for mode in ("best", "mean", "size"):
            np.testing.assert_array_equal(TCL.cluster_rank(labels, scores, mode),
                                          JCL.cluster_rank(labels, scores, mode))
