"""Where an entry point of the port runs.

Every entry point takes ``device=``: CUDA unless the caller asks for
another device.  The CPU runs only the plain PyTorch versions of the
kernels (the tests ask for it explicitly); with no card and no explicit
``device="cpu"`` an entry point raises instead of carrying on quietly
on the CPU.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def place(arrays: Sequence, device=None) -> Tuple[torch.Tensor, ...]:
    """``arrays`` (tensors or numpy arrays) as tensors on one device:
    ``device`` when given, else the device the tensors already lie on
    (CUDA when none is a tensor yet).  Raises when the tensors lie on
    several devices, or on one no kernel of the port runs on."""
    if device is None:
        devs = {a.device for a in arrays if isinstance(a, torch.Tensor)}
        if len(devs) > 1:
            raise ValueError(
                f"inputs on several devices: {sorted(map(str, devs))}")
        device = devs.pop() if devs else None
    dev = resolve(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return tuple(torch.as_tensor(a).to(dev) for a in arrays)


class StickyCudaError(Exception):
    """A CUDA error that poisons the context (an illegal address, a
    launch failure, a trap or device assert): every later call on the
    card fails too.  Deliberately not a ``RuntimeError``, so no handler
    of expected failures (``resilience.EXPECTED_ERRORS``) takes it: the
    tuning runtime never quarantines it and moves on, it propagates."""
