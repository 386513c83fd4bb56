"""Affine int8 quantization utilities (Eq. 5 of the paper), in PyTorch.

The numerical foundation of the mixed-precision path: the GNN engine
quantizes unprotected node embeddings and weights to int8 and runs them
through the int8 FTE stream (kernels/quant_matmul).

Quantization follows Eq. 5:  x_q = clip(round(x/s + z), q_min, q_max)
De-quantization:             x̂  = (x_q - z) * s

The operation order is the reference's (``repro/core/quantization.py``), so
the results are bitwise equal: ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "QuantParams",
    "compute_scale_zp",
    "quantize",
    "dequantize",
    "quantize_per_channel",
    "INT8_MIN",
    "INT8_MAX",
]

INT8_MIN = -128
INT8_MAX = 127


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Scale/zero-point pair; tensors broadcast against the quantized tensor."""

    scale: torch.Tensor  # f32, scalar or per-channel
    zero_point: torch.Tensor  # f32 (kept float; rounding applied at quantize)


def compute_scale_zp(
    x: torch.Tensor,
    *,
    axis: Optional[int] = None,
    symmetric: bool = True,
    qmin: int = INT8_MIN,
    qmax: int = INT8_MAX,
    eps: float = 1e-8,
) -> QuantParams:
    """Min/max calibration. ``axis`` keeps that axis (per-channel); None is
    per-tensor. Symmetric mode (z=0) suits integer matmuls."""
    if axis is None:
        lo = torch.min(x)
        hi = torch.max(x)
    else:
        red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        lo = torch.amin(x, dim=red, keepdim=True)
        hi = torch.amax(x, dim=red, keepdim=True)
    if symmetric:
        amax = torch.maximum(torch.abs(lo), torch.abs(hi))
        scale = torch.clamp_min(amax / qmax, eps)
        zp = torch.zeros_like(scale)
    else:
        scale = torch.clamp_min((hi - lo) / (qmax - qmin), eps)
        zp = qmin - lo / scale
    return QuantParams(
        scale=scale.to(torch.float32), zero_point=zp.to(torch.float32)
    )


def quantize(
    x: torch.Tensor,
    qp: QuantParams,
    *,
    qmin: int = INT8_MIN,
    qmax: int = INT8_MAX,
    dtype=torch.int8,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Eq. 5: clip(round(x/s + z)); written into ``out`` (a tensor of x's
    shape, possibly a view) when given."""
    q = torch.clamp(torch.round(x / qp.scale + qp.zero_point), qmin, qmax)
    return q.to(dtype) if out is None else out.copy_(q)


def dequantize(
    xq: torch.Tensor, qp: QuantParams, dtype=torch.float32
) -> torch.Tensor:
    return ((xq.to(torch.float32) - qp.zero_point) * qp.scale).to(dtype)


def quantize_per_channel(
    w: torch.Tensor, *, axis: int = -1
) -> Tuple[torch.Tensor, QuantParams]:
    """Symmetric per-channel weight quantization; returns (int8 weights, qp)."""
    qp = compute_scale_zp(w, axis=axis, symmetric=True)
    return quantize(w, qp), qp
