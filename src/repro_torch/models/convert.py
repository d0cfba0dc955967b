"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the JAX package's parameter dict as numpy
arrays (``np.asarray`` of each leaf; bfloat16 arrives as ml_dtypes'
``bfloat16``) and returns the port's tensors with the same names,
stacked layout and types.  Nothing is downloaded: the tests make the
reference's random weights and hand them to both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig
from .model import param_dtype, param_shapes


def tensor_from_numpy(a: np.ndarray, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """``a`` as a tensor of ``dtype``: bfloat16 bit for bit (through its
    16-bit pattern), other types through torch's own conversion."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(params: Dict[str, np.ndarray], cfg: ModelConfig,
                      device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameters as the port's: every name of
    ``param_shapes(cfg)`` with its shape and type (``model.param_dtype``:
    the config's, but the Mamba blocks' float32 ``A_log``, ``D`` and
    ``dt_bias``), on ``device`` (CUDA unless said otherwise).  Raises
    on a missing, extra or misshapen parameter."""
    from ..device import resolve

    dev = resolve(device)
    shapes = param_shapes(cfg)
    if set(params) != set(shapes):
        raise ValueError(f"parameters {sorted(set(params) ^ set(shapes))} "
                         f"differ from {cfg.name}'s")
    out = {}
    for name, (shape, _) in shapes.items():
        a = np.asarray(params[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape} != {shape}")
        out[name] = tensor_from_numpy(a, param_dtype(cfg, name), dev)
    return out
