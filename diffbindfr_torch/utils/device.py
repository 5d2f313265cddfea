"""Device selection for the port's entry points.

Entry points default to the card. Asking for CUDA on a machine without one
raises instead of silently running on the CPU; only an explicit
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch device for an entry point and pin f32 numerics.

    The JAX reference computes these paths in full float32, so TF32 is
    switched off for matmuls and convolutions wherever the port runs.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
