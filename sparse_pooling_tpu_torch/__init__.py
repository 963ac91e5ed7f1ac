"""PyTorch + CUDA port of the SHPL fusion detector for NVIDIA Hopper.

A second package beside ``sparse_pooling_tpu`` (the JAX reference). It
imports ``torch`` and numpy only. Plain tensor code is PyTorch; the SHPL
pool (patch and ELL forms) and the grouped RPN crop are hand-written CUDA
kernels under ``csrc/``, built at first use by ``kernels.py``.

Entry points take ``device`` (default ``"cuda"``) and raise when no card is
present unless the caller asks for ``"cpu"``; they never fall back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and
    absent (no silent CPU fallback)."""

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
