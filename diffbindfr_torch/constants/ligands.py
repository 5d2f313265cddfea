"""Ligand vocabularies the port reads (counterpart of the pharmacophore
block of diffbindfr_tpu/constants/ligands.py).

The ligand node features end in the eight pharmacophore family flags, in
this order (RDKit BaseFeatures.fdef family names).
"""
from __future__ import annotations

pharmacophore_families = [
    "Acceptor", "Donor", "Aromatic", "Hydrophobe",
    "LumpedHydrophobe", "NegIonizable", "PosIonizable", "ZnBinder",
]
num_pharmacophores = len(pharmacophore_families)
pharmacophore_to_id = {v: i for i, v in enumerate(pharmacophore_families)}
