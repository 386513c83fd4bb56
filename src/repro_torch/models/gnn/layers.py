"""Shared initialisers for the GNN model zoo."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["glorot"]


def glorot(
    generator: torch.Generator, shape: Sequence[int], device="cpu"
) -> torch.Tensor:
    """Glorot-uniform f32 weight drawn from ``generator`` (a CPU generator)."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = torch.empty(tuple(shape), dtype=torch.float32)
    w.uniform_(-limit, limit, generator=generator)
    return w.to(device)
