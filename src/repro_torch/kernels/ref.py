"""Plain PyTorch oracles of the hand-written kernels in this package.

Each function is the mathematical definition, as the JAX package's
``kernels/ref.py`` writes it: float32 arithmetic, written for clarity,
not speed.  ``ops.*(use_kernel=False)`` returns these; the kernel tests
hold the kernels against them.  ``attention`` and ``ssd_scan`` arrive
with their kernels.
"""
from __future__ import annotations

import torch


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.float() @ y.float()


def groupby_fold(keys: torch.Tensor, values: torch.Tensor,
                 num_keys: int) -> torch.Tensor:
    """Dense keyed sum: out[k] = sum of values[i] with keys[i] == k.
    Keys outside ``[0, num_keys)`` match no row of the one-hot matrix,
    so they are dropped."""
    onehot = (keys.reshape(-1, 1)
              == torch.arange(num_keys, device=keys.device)).float()
    return torch.einsum("ik,i...->k...", onehot, values.float())


def filter_reduce(x: torch.Tensor, lo, hi,
                  weight: torch.Tensor) -> torch.Tensor:
    """TPC-H Q6 shape: sum(weight[i] * x[i]) over lo <= x[i] < hi."""
    pred = (x >= lo) & (x < hi)
    return torch.sum(torch.where(pred, x.float() * weight.float(), 0.0))
