"""Aggregation Engine (AGE) — device-side execution of the event-driven tiles.

``aggregate_edge_tiles`` runs the planner's dense edge tiles through the AGE
kernel (``kernels/segment_agg``): each tile gathers neighbour embeddings,
reduces them by local segment, and nodes split across tiles are assembled from
their partial sums (partial-response combining). Compute ∝ E.

``aggregate_mixed_precision`` runs it once per Degree-Quant precision group:
the float group on f32 rows, the int8 group on rows quantized to int8 and
dequantized, as the reference does (``repro/core/aggregation.py``).

The per-edge ``coeff`` folds the aggregation function into the plan:
sum → 1, mean → 1/deg, GCN → 1/√(d̂_i d̂_j). Invalid lanes carry coeff 0.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.quantization import (
    QuantParams,
    compute_scale_zp,
    dequantize,
    quantize,
)
from repro_torch.kernels.segment_agg import ops as seg_ops

__all__ = [
    "DeviceTilePlan",
    "to_device_plan",
    "aggregate_edge_tiles",
    "aggregate_mixed_precision",
]


class DeviceTilePlan(NamedTuple):
    """Device mirror of ``scheduler.EdgeTilePlan`` plus its split map."""

    gather_idx: torch.Tensor  # int32[T, E]
    coeff: torch.Tensor  # f32[T, E]
    seg_ids: torch.Tensor  # int32[T, E]
    out_node: torch.Tensor  # int32[T, S]
    split: seg_ops.SplitMap  # which segments feed nodes split across tiles


def to_device_plan(plan: sched.EdgeTilePlan, device) -> DeviceTilePlan:
    """Upload a tile plan; its split map is computed here, once per plan."""
    if plan.gather_idx.size and (
        plan.gather_idx.min() < 0 or plan.gather_idx.max() >= max(plan.num_nodes, 1)
    ):
        raise ValueError(f"gather_idx outside [0, {plan.num_nodes})")
    split = seg_ops.split_segment_map(plan.out_node, plan.seg_ids, plan.num_nodes)

    def up(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return DeviceTilePlan(
        gather_idx=up(plan.gather_idx, torch.int32),
        coeff=up(plan.coeff, torch.float32),
        seg_ids=up(plan.seg_ids, torch.int32),
        out_node=up(plan.out_node, torch.int32),
        split=split.to(device),
    )


def aggregate_edge_tiles(
    x: torch.Tensor, dplan: DeviceTilePlan, *, num_nodes: int
) -> torch.Tensor:
    """Event-driven aggregation over one plan's tiles: f32[num_nodes, D]."""
    return seg_ops.aggregate_tiles(
        x,
        dplan.gather_idx,
        dplan.coeff,
        dplan.seg_ids,
        dplan.out_node,
        dplan.split,
        num_nodes=num_nodes,
    )


def aggregate_mixed_precision(
    x: torch.Tensor,
    plans: Dict[str, sched.EdgeTilePlan],
    *,
    num_nodes: int,
    qp: Optional[QuantParams] = None,
    device_plans: Optional[Dict[str, DeviceTilePlan]] = None,
) -> torch.Tensor:
    """Mixed-precision AGE: the float plan consumes fp32 embeddings; the int8
    plan consumes int8-quantized embeddings, dequantized before accumulate.

    The two streams write disjoint node sets, so the combined output is just
    the sum of the two. ``qp`` overrides the activation scale/zero-point
    (per-call min/max calibration otherwise) — the engine passes its per-plan
    static quant state here. ``device_plans`` supplies already-uploaded
    ``DeviceTilePlan`` mirrors keyed like ``plans``.
    """
    for tag in plans:
        if tag not in ("float", "int8"):
            raise ValueError(f"unknown precision tag {tag!r}")
    device_plans = device_plans or {}

    def dplan(tag):
        return device_plans.get(tag) or to_device_plan(plans[tag], x.device)

    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    if "float" in plans:
        out = out + aggregate_edge_tiles(x, dplan("float"), num_nodes=num_nodes)
    if "int8" in plans:
        if qp is None:
            qp = compute_scale_zp(x, symmetric=True)
        xdq = dequantize(quantize(x, qp), qp)
        out = out + aggregate_edge_tiles(xdq, dplan("int8"), num_nodes=num_nodes)
    return out
