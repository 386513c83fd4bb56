"""Normalization layers (RMSNorm / LayerNorm), computed in f32 and cast back
to the input's dtype, as the reference's ``repro/models/lm/norm.py``.

Each ``*_init`` takes a parameter maker (``transformer.TensorMaker`` for
tensors, ``transformer.ShapeMaker`` for the shapes alone)."""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm", "make_norm"]


def rmsnorm_init(make, dim: int) -> Dict:
    return {"scale": make.ones((dim,), torch.float32)}


def layernorm_init(make, dim: int) -> Dict:
    return {"scale": make.ones((dim,), torch.float32), "bias": make.zeros((dim,), torch.float32)}


def rmsnorm(params: Dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps)) * params["scale"]
    return y.to(x.dtype)


def layernorm(params: Dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def make_norm(kind: str):
    """(init, apply) of a norm kind."""
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(f"unknown norm {kind!r}")
