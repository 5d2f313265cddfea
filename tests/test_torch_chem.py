"""Host ligand chemistry of the PyTorch port (diffbindfr_torch/chem/mol.py,
gasteiger.py, ligand_feats.py and the constant tables it reads) against the
JAX package's, on the CPU.

The port's molecular graph is its own adjacency structure, and its
`cycle_basis` follows networkx 3.6.1's: checked cycle for cycle, in order,
on the 21 tracked ligands (19 with fused rings) and on random graphs from a
numpy seed. Everything else is exact: the port runs the same numpy
operations in the same order, so perception, Gasteiger charges, torsions
and the featurised record are bit-identical (value, dtype, shape).
"""
import dataclasses
import glob
import os

import networkx as nx
import numpy as np
import pytest
import torch

from diffbindfr_tpu.chem import gasteiger as JG
from diffbindfr_tpu.chem import ligand_feats as JF
from diffbindfr_tpu.chem import mol as JM
from diffbindfr_tpu.constants import ligands as JLC
from diffbindfr_tpu.constants import periodic as JPT
from diffbindfr_tpu.constants import residues as JRC
from diffbindfr_tpu.io.sdf import parse_ligand_file as jparse
from diffbindfr_torch.chem import gasteiger as TG
from diffbindfr_torch.chem import ligand_feats as TF
from diffbindfr_torch.chem import mol as TM
from diffbindfr_torch.constants import ligands as TLC
from diffbindfr_torch.constants import periodic as TPT
from diffbindfr_torch.constants import residues as TRC
from diffbindfr_torch.io.sdf import parse_ligand_file as tparse

# one intra-op thread: tier-1 runs six test processes on the machine's cores,
# and a torch OpenMP pool in each spins against the others
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGANDS = (sorted(glob.glob(os.path.join(ROOT, "runs/pb_bench/*/*_ligand.sdf")))
           + sorted(glob.glob(os.path.join(ROOT, "runs/screen_demo/mols/*.sdf"))))
IDS = [os.path.basename(p)[: -len(".sdf")] for p in LIGANDS]


def _same(a, b, what):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.fixture(scope="module")
def mols():
    """(JAX Molecule, port Molecule) of each tracked ligand."""
    return {p: (JM.perceive(jparse(p)[0]), TM.perceive(tparse(p)[0])) for p in LIGANDS}


def test_the_inputs():
    """21 ligands: the five pb_bench complexes and the 16 of screen_demo."""
    assert len(LIGANDS) == 21


def _mol_graph(n, edges):
    g = TM.MolGraph(n)
    for a, b in edges:
        g.add_edge(a, b)
    return g


def _nx_graph(n, edges):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    return g


@pytest.mark.parametrize("seed", range(8))
def test_cycle_basis_matches_networkx_on_random_graphs(seed):
    """Random graphs (a few components, fused cycles, self loops) built with
    the same edge insertion order: the same cycles, in networkx's order."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 40))
    edges = []
    for _ in range(int(rng.integers(n, 2 * n))):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a == b and rng.random() > 0.2:
            continue
        edges.append((a, b))
    want = nx.cycle_basis(_nx_graph(n, edges))
    assert TM.cycle_basis(_mol_graph(n, edges)) == want
    assert len(want) > 0


@pytest.mark.parametrize("seed", range(4))
def test_graph_queries_match_networkx(seed):
    """degree, neighbour order, has_path and the connected component after
    removing each edge and adding it back (networkx moves it to the end of
    both adjacency dicts; so does the port's graph)."""
    rng = np.random.default_rng(100 + seed)
    n = 25
    edges = sorted({tuple(sorted(int(x) for x in rng.integers(0, n, 2))) for _ in range(30)})
    g, h = _mol_graph(n, edges), _nx_graph(n, edges)
    for a, b in edges:
        g.remove_edge(a, b)
        h.remove_edge(a, b)
        assert g.has_path(a, b) == nx.has_path(h, a, b)
        assert g.component(b) == nx.node_connected_component(h, b)
        g.add_edge(a, b)
        h.add_edge(a, b)
    for i in range(n):
        assert g.degree(i) == h.degree(i)
        assert list(g.neighbors(i)) == list(h.neighbors(i))


@pytest.mark.parametrize("path", LIGANDS, ids=IDS)
def test_cycle_basis_matches_networkx_on_ligands(path, mols):
    jm, tm = mols[path]
    assert TM.cycle_basis(tm.graph) == nx.cycle_basis(jm.graph)
    assert tm.rings == jm.rings


def test_most_ligands_have_fused_rings(mols):
    """19 of the 21: an atom in two rings of the basis."""
    fused = sum(int((tm.num_rings_per_atom > 1).any()) for _, tm in mols.values())
    assert fused == 19


@pytest.mark.parametrize("path", LIGANDS, ids=IDS)
def test_perceive_gasteiger_torsions_and_features_match_jax(path, mols):
    """perceive field by field, the ring-bond mask, Gasteiger charges,
    conjugation, pharmacophores, find_torsions and featurize_ligand (every
    field of the LigandRecord): bit-identical."""
    jm, tm = mols[path]
    for f in dataclasses.fields(jm):
        if f.name not in ("raw", "graph"):
            _same(getattr(tm, f.name), getattr(jm, f.name), f.name)
    for i in range(jm.num_atoms):
        assert list(tm.graph.neighbors(i)) == list(jm.graph.neighbors(i))
    _same(TM.ring_bond_mask(tm), JM.ring_bond_mask(jm), "ring_bond_mask")
    _same(TG.gasteiger_charges(tm), JG.gasteiger_charges(jm), "gasteiger")
    _same(TF._conjugated_bonds(tm), JF._conjugated_bonds(jm), "conjugated")
    _same(TF._pharmacophores(tm), JF._pharmacophores(jm), "pharmacophores")
    for got, want in zip(TF.find_torsions(tm), JF.find_torsions(jm)):
        _same(got, want, "find_torsions")
    # fresh molecules: find_torsions reorders the graph's adjacency
    jm, tm = JM.perceive(jparse(path)[0]), TM.perceive(tparse(path)[0])
    jl, tl = JF.featurize_ligand(jm, "x"), TF.featurize_ligand(tm, "x")
    assert [f.name for f in dataclasses.fields(tl)] == [f.name for f in dataclasses.fields(jl)]
    for f in dataclasses.fields(jl):
        _same(getattr(tl, f.name), getattr(jl, f.name), f.name)
    assert tl.node_feat.shape[1] == TLC.LIG_NODE_FEAT_DIM == 27
    assert tl.edge_feat.shape[1] == TLC.LIG_EDGE_FEAT_DIM == 10


def test_hydrogens_are_folded_into_counts():
    """3dbs's ligand file has explicit hydrogens, and two more are bonded to
    its first atom here: perceive drops them and counts them on their heavy
    atoms, as the JAX package does."""
    path = os.path.join(ROOT, "runs/pb_bench/3dbs/3dbs_ligand.sdf")
    raw_j, raw_t = jparse(path)[0], tparse(path)[0]
    n = raw_t.num_atoms
    heavy = sum(e != "H" for e in raw_t.elements)
    assert heavy < n
    hs = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
    for raw in (raw_j, raw_t):
        raw.elements = list(raw.elements) + ["H", "H"]
        raw.coords = np.concatenate([raw.coords, raw.coords[:1] + hs])
        raw.bonds = np.concatenate([raw.bonds, [[0, n], [n + 1, 0]]])
        raw.bond_orders = np.concatenate([raw.bond_orders, [1, 1]])
        raw.formal_charges = np.concatenate([raw.formal_charges, [0, 0]])
    jm, tm = JM.perceive(raw_j), TM.perceive(raw_t)
    assert tm.num_atoms == heavy and tm.implicit_h[0] == 0
    for f in dataclasses.fields(jm):
        if f.name not in ("raw", "graph"):
            _same(getattr(tm, f.name), getattr(jm, f.name), f.name)


LIGAND_TABLES = ("atom_types", "atom_types_with_h", "atomtype_to_id", "hybridization_types",
                 "hybridization_to_id", "bond_types", "connect_types", "num_connect_types",
                 "connect_to_id", "bond_stereo_types", "bond_stereo_to_id",
                 "pharmacophore_families", "num_pharmacophores", "pharmacophore_to_id",
                 "ring_sizes", "num_ring_sizes", "num_radical_classes", "num_h_classes",
                 "LIG_NODE_FEAT_DIM", "LIG_EDGE_FEAT_DIM")
PERIODIC_TABLES = ("ATOMIC_NUMBER", "SYMBOL_BY_NUMBER", "ATOMIC_WEIGHT", "COVALENT_RADIUS",
                   "VDW_RADIUS", "DEFAULT_VALENCE", "GASTEIGER_PARAMS")
RESIDUE_TABLES = ("restype_rigid_group_default_frame", "restype_atom14_rigid_group_positions",
                  "restype_atom14_to_rigid_group", "restype_atom14_torsion_edges",
                  "restype_chi_bond_atom14", "atom37_to_element", "atom37_to_coarse",
                  "atom_elements", "coarse_atom_types", "chi_angles_mask",
                  "chi_angles_to_atom14", "chi_pi_periodic", "restype_atom14_to_atom37",
                  "restype_atom14_mask", "atom37_names", "restypes",
                  "restype_name_to_atom14_names")


@pytest.mark.parametrize("name", LIGAND_TABLES + PERIODIC_TABLES + RESIDUE_TABLES)
def test_constant_tables_match_jax(name):
    """The port's own copies of the tables prep reads equal the JAX
    package's (which parses residue_data.txt): value, dtype and shape."""
    for tmod, jmod in ((TLC, JLC), (TPT, JPT), (TRC, JRC)):
        if hasattr(jmod, name):
            _same(getattr(tmod, name), getattr(jmod, name), name)
            return
    raise AssertionError(name)


def test_gasteiger_params_and_types_index_match_jax():
    for el in ("C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "H", "B", "Zn"):
        for hyb in ("SP", "SP2", "SP3", "other", "*"):
            assert TPT.gasteiger_params(el, hyb) == JPT.gasteiger_params(el, hyb)
    for v in ("C", "Se", "other", "H"):
        assert TLC.types_index(v, TLC.atom_types_with_h) == JLC.types_index(
            v, JLC.atom_types_with_h)
