"""Seeds for the generators: any whole number, folded to 64 bits."""
from __future__ import annotations

import numpy as np
import torch


def fold(seed: int) -> int:
    return int(seed) % (1 << 64)


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` (the card's own, so data is made
    there in a few large calls) seeded from ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(fold(seed))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for stream ``stream`` of ``seed`` (traffic,
    samples), independent of the device's."""
    return np.random.default_rng([fold(seed), int(stream)])
