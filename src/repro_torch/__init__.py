"""PyTorch/CUDA port of the λScale reproduction (``repro`` is the JAX
reference it is tested against).

The port runs on an NVIDIA GPU by default: an entry point given no device
picks ``cuda`` and raises when there is none; ``device="cpu"`` runs the
same code on the CPU, where every kernel wrapper takes its plain PyTorch
version.  Importing the package loads neither JAX nor ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, and raises
    when no CUDA device is present (never a silent CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
