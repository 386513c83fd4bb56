"""Shared initialisers for the GNN model zoo."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["glorot", "linear_init", "mlp_init"]


def glorot(
    generator: torch.Generator, shape: Sequence[int], device="cpu"
) -> torch.Tensor:
    """Glorot-uniform f32 weight drawn from ``generator`` (a CPU generator)."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = torch.empty(tuple(shape), dtype=torch.float32)
    w.uniform_(-limit, limit, generator=generator)
    return w.to(device)


def linear_init(
    generator: torch.Generator, in_dim: int, out_dim: int, device="cpu", *, bias: bool = True
) -> Dict:
    """``{"w": glorot [in, out], "b": zeros [out]}`` (no ``b`` without bias)."""
    p = {"w": glorot(generator, (in_dim, out_dim), device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=device)
    return p


def mlp_init(
    generator: torch.Generator, dims: List[int], device="cpu", *, bias: bool = True
) -> Dict:
    """One linear per consecutive pair of ``dims``: ``{"layers": [...]}``."""
    return {"layers": [linear_init(generator, dims[i], dims[i + 1], device, bias=bias)
                       for i in range(len(dims) - 1)]}
