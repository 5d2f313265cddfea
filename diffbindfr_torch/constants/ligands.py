"""Ligand chemistry vocabularies: the port's copy of
diffbindfr_tpu/constants/ligands.py.

The categorical vocabularies of the reference featurizer
(druglib/utils/obj/ligand_constants.py:19-192), so the 27-dim node and
10-dim edge feature layout is preserved, without RDKit.
"""
from __future__ import annotations

# frequent ligand heavy atoms; everything else maps to 'other'
atom_types = ["C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "Si", "B", "other"]
atom_types_with_h = atom_types + ["H"]
atomtype_to_id = {v: i for i, v in enumerate(atom_types_with_h)}

hybridization_types = ["SP", "SP2", "SP3", "SP3D", "SP3D2", "other"]
hybridization_to_id = {v: i for i, v in enumerate(hybridization_types)}

# SDF/MOL bond orders; 4 == aromatic
bond_types = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC", "other"]
# graph connectivity may add a geometric no-bond edge class
connect_types = bond_types + ["NoneType"]
num_connect_types = len(connect_types)  # 6 -> one-hot width in edge features
connect_to_id = {v: i for i, v in enumerate(connect_types)}

bond_stereo_types = [
    "STEREONONE", "STEREOANY", "STEREOZ", "STEREOE", "STEREOTRANS", "STEREOCIS",
]
bond_stereo_to_id = {v: i for i, v in enumerate(bond_stereo_types)}

# pharmacophore feature families (RDKit BaseFeatures.fdef family names); the
# ligand node features end in these eight flags, in this order
pharmacophore_families = [
    "Acceptor", "Donor", "Aromatic", "Hydrophobe",
    "LumpedHydrophobe", "NegIonizable", "PosIonizable", "ZnBinder",
]
num_pharmacophores = len(pharmacophore_families)
pharmacophore_to_id = {v: i for i, v in enumerate(pharmacophore_families)}

# ring sizes tracked by the per-atom ring-membership vector
ring_sizes = list(range(3, 9))
num_ring_sizes = len(ring_sizes)

num_radical_classes = 6  # 0..4 + other
num_h_classes = 10  # 0..8 + other

# resulting feature widths (the reference model config,
# DiffBindFR/configs/diffbindfr_ts.py:119-122)
LIG_NODE_FEAT_DIM = 13 + num_ring_sizes + num_pharmacophores  # = 27
LIG_EDGE_FEAT_DIM = num_connect_types + 4  # = 10


def types_index(value, vocab) -> int:
    """Index of value in vocab, mapping unknowns to the trailing 'other'."""
    try:
        return vocab.index(value)
    except ValueError:
        return len(vocab) - 1
