"""Host chemistry of the port: ligand perception and featurisation, pocket
featurisation and the prep records (counterparts of diffbindfr_tpu/chem/)."""
