"""Pose metrics of the port (counterpart of diffbindfr_tpu/metrics/)."""
from .pose import centroid_distance, chi1_accuracy, ligand_rmsd, sidechain_rmsd

__all__ = ["centroid_distance", "chi1_accuracy", "ligand_rmsd", "sidechain_rmsd"]
