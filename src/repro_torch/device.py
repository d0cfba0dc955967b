"""Where an entry point of the port runs.

Every entry point takes ``device=``: CUDA unless the caller asks for
another device.  The CPU runs only the plain PyTorch versions of the
kernels (the tests ask for it explicitly); with no card and no explicit
``device="cpu"`` an entry point raises instead of carrying on quietly
on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``, CUDA when ``None``; raises when
    CUDA is asked for and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
