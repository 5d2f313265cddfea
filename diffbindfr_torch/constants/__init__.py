"""The port's own copies of the constant tables it reads
(counterparts of diffbindfr_tpu/constants/)."""
