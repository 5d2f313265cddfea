"""File readers and writers of the port (counterparts of diffbindfr_tpu/io/)."""
