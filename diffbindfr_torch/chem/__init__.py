"""Prep records of the port (counterparts of diffbindfr_tpu/chem/)."""
