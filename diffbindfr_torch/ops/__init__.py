"""Pose operations after the dock (counterparts of diffbindfr_tpu/ops/)."""
