"""Feature Transformation Engine (FTE) — the regular-compute phase.

The FTE is a mixed-precision matmul stream:

* float stream — f32 ``h @ W`` for Degree-Quant-protected nodes. The
  reference leaves this product to XLA outside any kernel; here it is
  ``torch.matmul`` in float32;
* int8 stream  — int8×int8→int32 (``kernels/quant_matmul``) with per-channel
  dequant for the rest.

``transform_mixed_precision`` routes disjoint node sets through the two
streams — the isolated per-precision NoC sub-networks of §3.2.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from repro_torch.core.quantization import (
    QuantParams,
    compute_scale_zp,
    quantize,
    quantize_per_channel,
)
from repro_torch.kernels.quant_matmul import ops as qm_ops

__all__ = [
    "transform_dense",
    "transform_int8",
    "transform_mixed_precision",
]

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


def transform_dense(
    h: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    activation: Activation = None,
) -> torch.Tensor:
    """Float FTE stream: y = act(h @ W + b)."""
    y = h @ w
    if b is not None:
        y = y + b
    if activation is not None:
        y = activation(y)
    return y


def transform_int8(
    h: torch.Tensor,
    w_q: torch.Tensor,
    w_qp: QuantParams,
    b: Optional[torch.Tensor] = None,
    activation: Activation = None,
    a_qp: Optional[QuantParams] = None,
    w_packed: Optional[qm_ops.RepackedWeight] = None,
) -> torch.Tensor:
    """int8 FTE stream: symmetric-quantized activations × per-channel int8
    weights, int32 accumulate, float de-quant.

    y ≈ (s_a s_w) · (h_q @ W_q), since both quantizations are symmetric (z=0).
    ``w_packed`` is the load-time relayout of ``w_q``
    (``kernels.quant_matmul.repack_weight``); without it the weight is
    relaid per call.
    """
    if a_qp is None:
        a_qp = compute_scale_zp(h, symmetric=True)
    h_q = quantize(h, a_qp)
    if w_packed is not None:
        acc = qm_ops.quant_matmul_repacked(h_q, w_packed)
    else:
        acc = qm_ops.quant_matmul(h_q, w_q)
    y = acc.to(torch.float32) * (a_qp.scale * w_qp.scale.reshape(1, -1))
    if b is not None:
        y = y + b
    if activation is not None:
        y = activation(y)
    return y


def transform_mixed_precision(
    h: torch.Tensor,
    node_group_ids: Mapping[str, torch.Tensor],
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    activation: Activation = None,
    *,
    w_q: Optional[torch.Tensor] = None,
    w_qp: Optional[QuantParams] = None,
    a_qp: Optional[QuantParams] = None,
    w_packed: Optional[qm_ops.RepackedWeight] = None,
) -> torch.Tensor:
    """Route each precision group's rows through its FTE stream.

    ``node_group_ids`` maps precision tag → node indices (a disjoint cover of
    rows of ``h``; numpy arrays or index tensors). Rows in no group stay 0.
    Weight int8 copies are derived once if not provided; ``a_qp`` fixes the
    int8 activation scale/zero-point (per-call min/max calibration over the
    int8 rows otherwise).
    """
    out = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32, device=h.device)
    for tag, ids in node_group_ids.items():
        ids = torch.as_tensor(ids, device=h.device).long()
        if ids.numel() == 0:
            continue
        rows = h[ids]
        if tag == "float":
            y = transform_dense(rows, w, b, activation)
        elif tag == "int8":
            if w_q is None or w_qp is None:
                w_q, w_qp = quantize_per_channel(w, axis=-1)
            y = transform_int8(
                rows, w_q, w_qp, b, activation, a_qp=a_qp, w_packed=w_packed
            )
        else:
            raise ValueError(f"unknown precision tag {tag!r}")
        out[ids] = y
    return out
