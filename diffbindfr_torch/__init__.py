"""PyTorch/CUDA port of diffbindfr_tpu for NVIDIA Hopper (H100).

Imports torch, numpy and the standard library only: never jax and never the
JAX package (`import diffbindfr_torch` must work on a machine without JAX).
Module names follow diffbindfr_tpu so each module's counterpart is easy to
find. The score network's three trunk convs run forward and backward
through hand-written CUDA kernels (`nn/trunk_convs.py`, sources in
`csrc/`) when given CUDA tensors.
"""
