"""Aggregation Engine (AGE) — device-side execution of the event-driven tiles.

``aggregate_edge_tiles`` runs the planner's dense edge tiles through the AGE
kernel (``kernels/segment_agg``): each tile gathers neighbour embeddings,
reduces them by local segment, and nodes split across tiles are assembled from
their partial sums (partial-response combining). Compute ∝ E.

``aggregate_mixed_precision`` runs it once per Degree-Quant precision group:
the float group on f32 rows, the int8 group on rows quantized to int8 and
dequantized, as the reference does (``repro/core/aggregation.py``). The int8
group passes the codes and their scale: the kernels dequantize in registers,
so it gathers a quarter of the bytes. Both groups write their disjoint node
rows into one zero-filled output.

The per-edge ``coeff`` folds the aggregation function into the plan:
sum → 1, mean → 1/deg, GCN → 1/√(d̂_i d̂_j). Invalid lanes carry coeff 0.
Runtime coefficients (GAT attention) arrive per request in graph edge space
and run the multi-head kernel (``kernels/segment_agg/attn_ops.py``), which
reads them through the plan's ``edge_ids``: an ``[E, H]`` matrix with
``x [N, H, dh]``, a 1-D vector as one head ``[E, 1]``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.quantization import QuantParams, compute_scale_zp, quantize
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.kernels.segment_agg import ops as seg_ops

__all__ = [
    "DeviceTilePlan",
    "to_device_plan",
    "tile_edge_coeff",
    "aggregate_edge_tiles",
    "aggregate_mixed_precision",
    "segment_max_edge_tiles",
    "edge_segment_sum_tiles",
]


class DeviceTilePlan(NamedTuple):
    """Device mirror of ``scheduler.EdgeTilePlan`` plus its split map.

    ``edge_ids`` maps lanes to graph edges for runtime coefficients. It is
    uploaded with every plan, static-coeff modes included, which never read
    it: int32[T, E], 59 MB for the Yelp plans of both precision groups.
    """

    gather_idx: torch.Tensor  # int32[T, E]
    coeff: torch.Tensor  # f32[T, E]
    seg_ids: torch.Tensor  # int32[T, E]
    out_node: torch.Tensor  # int32[T, S]
    split: seg_ops.SplitMap  # which segments feed nodes split across tiles
    edge_ids: torch.Tensor  # int32[T, E]; -1 on padding lanes


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
        edge_ids=up(plan.edge_ids, torch.int32),
    )


def tile_edge_coeff(
    dplan: DeviceTilePlan, edge_coeff: torch.Tensor, *, fill: float = 0.0
) -> torch.Tensor:
    """Scatter a per-edge runtime matrix into tile layout: f32[T, E(, H)].

    ``edge_coeff`` is indexed by graph edge position (the space
    ``EdgeTilePlan.edge_ids`` maps lanes into) and may carry a trailing head
    axis; padding lanes (edge id -1) read ``fill``.
    """
    e = edge_coeff.shape[0]
    padded = torch.cat([
        edge_coeff,
        torch.full((1,) + tuple(edge_coeff.shape[1:]), fill, dtype=edge_coeff.dtype,
                   device=edge_coeff.device),
    ])
    idx = torch.where(dplan.edge_ids < 0, e, dplan.edge_ids).long()
    return padded[idx]


def aggregate_edge_tiles(
    x: torch.Tensor,
    dplan: DeviceTilePlan,
    *,
    num_nodes: int,
    edge_coeff: Optional[torch.Tensor] = None,
    qp: Optional[QuantParams] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Event-driven aggregation over one plan's tiles: f32[num_nodes, …].

    ``x`` is f32 or int8 codes with their ``qp``. ``edge_coeff`` supplies
    runtime per-edge coefficients (graph edge space), multiplied with the
    static coeff (1 on every real lane of a ``"runtime"`` plan), and read
    through ``edge_ids`` by the multi-head kernel: ``[E, H]`` with ``x [N,
    H, dh]``, each head's coefficients applying to its slice of the row; a
    1-D ``edge_coeff`` as one head over the whole row (head-uniform
    coefficients on ``x [N, H, dh]`` treat the heads as feature columns).
    With ``out`` (f32, contiguous, ``(num_nodes,) + x.shape[1:]``) the rows
    of this plan's nodes are written into it and every other row is left as
    it is; without, they go into zeros.
    """
    if edge_coeff is not None and edge_coeff.dim() == 2:
        return attn_ops.aggregate_tiles_mh(
            x, dplan.gather_idx, dplan.edge_ids, edge_coeff.contiguous(), dplan.coeff,
            dplan.seg_ids, dplan.out_node, dplan.split, num_nodes=num_nodes, qp=qp, out=out)
    rows = x.reshape(x.shape[0], -1)
    flat = None if out is None else out.view(num_nodes, -1)
    if edge_coeff is None:
        res = seg_ops.aggregate_tiles(rows, dplan.gather_idx, dplan.coeff, dplan.seg_ids,
                                      dplan.out_node, dplan.split, num_nodes=num_nodes, qp=qp,
                                      out=flat)
    else:
        res = attn_ops.aggregate_tiles_mh(
            rows.unsqueeze(1), dplan.gather_idx, dplan.edge_ids,
            edge_coeff.reshape(-1, 1).contiguous(), dplan.coeff, dplan.seg_ids, dplan.out_node,
            dplan.split, num_nodes=num_nodes, qp=qp,
            out=None if flat is None else flat.unsqueeze(1))
    return res.view((num_nodes,) + tuple(x.shape[1:]))


def segment_max_edge_tiles(
    scores: torch.Tensor, dplan: DeviceTilePlan, *, num_nodes: int
) -> torch.Tensor:
    """Destination-segment max of per-edge scores over one plan's tiles:
    f32[N(, H)], −inf for nodes this plan gives no edges.

    The max-shift pass of the segment softmax: scores scatter into tile
    layout through ``edge_ids`` (padding lanes read −inf) and reduce by
    each lane's destination node. A max does not depend on the order of its
    operands, so the scatter is the same run to run on the card too.
    """
    sc = tile_edge_coeff(dplan, scores, fill=float("-inf"))  # [T, E(, H)]
    node = torch.gather(dplan.out_node, 1, dplan.seg_ids.long()).reshape(-1).long()
    flat = sc.reshape((node.numel(),) + tuple(scores.shape[1:]))
    if flat.dim() == 2:
        node = node.unsqueeze(1).expand_as(flat)
    out = torch.full((num_nodes + 1,) + tuple(scores.shape[1:]), float("-inf"),
                     dtype=scores.dtype, device=scores.device)
    out.scatter_reduce_(0, node, flat, "amax")
    return out[:num_nodes]


def edge_segment_sum_tiles(
    values: torch.Tensor, dplan: DeviceTilePlan, *, num_nodes: int
) -> torch.Tensor:
    """Destination-segment sum of per-edge values over one plan's tiles:
    f32[N(, H)].

    The denominator pass of the segment softmax. The values are the per-head
    lane coefficients of the multi-head AGE over rows of ones (read through
    ``edge_ids``, padding lanes 0, static coeff one: ``1 · v`` is exact), so
    split nodes combine in tile order as in the aggregation, with no atomics.
    """
    v = values if values.dim() == 2 else values.unsqueeze(-1)
    h = v.shape[-1]
    ones = torch.ones((num_nodes, h, 1), dtype=values.dtype, device=values.device)
    out = attn_ops.aggregate_tiles_mh(
        ones, dplan.gather_idx, dplan.edge_ids, v.contiguous(), None, dplan.seg_ids,
        dplan.out_node, dplan.split, num_nodes=num_nodes,
    )
    return out.view((num_nodes,) + tuple(values.shape[1:]))


def aggregate_mixed_precision(
    x: torch.Tensor,
    plans: Dict[str, sched.EdgeTilePlan],
    *,
    num_nodes: int,
    qp: Optional[QuantParams] = None,
    device_plans: Optional[Dict[str, DeviceTilePlan]] = None,
    edge_coeff: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mixed-precision AGE: the float plan consumes fp32 embeddings; the int8
    plan consumes int8-quantized embeddings, passed to the kernels as codes
    with their ``QuantParams`` and dequantized before accumulate.

    The two streams write disjoint node sets into one zero-filled output:
    nothing is added. A row whose sum is -0.0 stays -0.0 where the sum
    ``zeros + float + int8`` gave +0.0; ``torch.equal`` and every comparison
    by value treat the two as equal. ``qp`` overrides the activation
    scale/zero-point (per-call min/max calibration otherwise) — the engine
    passes its per-plan static quant state here. ``device_plans`` supplies
    already-uploaded ``DeviceTilePlan`` mirrors keyed like ``plans``.
    ``edge_coeff`` is the runtime per-edge coefficient vector or ``[E, H]``
    matrix (graph edge space) both streams read through their ``edge_ids``.
    """
    for tag in plans:
        if tag not in ("float", "int8"):
            raise ValueError(f"unknown precision tag {tag!r}")
    device_plans = device_plans or {}

    def dplan(tag):
        return device_plans.get(tag) or to_device_plan(plans[tag], x.device)

    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    if "float" in plans:
        aggregate_edge_tiles(x, dplan("float"), num_nodes=num_nodes, edge_coeff=edge_coeff,
                             out=out)
    if "int8" in plans:
        if qp is None:
            qp = compute_scale_zp(x, symmetric=True)
        aggregate_edge_tiles(_int8_rows(x, qp), dplan("int8"), num_nodes=num_nodes,
                             edge_coeff=edge_coeff, qp=qp, out=out)
    return out


def _int8_rows(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """The int8 group's rows as codes. On the card, rows [N, D] whose D is
    not a multiple of 16 are written at a row stride rounded up to 16 bytes
    (the padding zero), so the walk gathers them in 16-byte chunks: at D 300
    that took 2.679 ms against 3.733 ms from contiguous rows (NVIDIA H100
    80GB HBM3, 700.00 W; chip_smoke.py)."""
    if x.device.type != "cuda" or x.dim() != 2 or x.shape[1] % 16 == 0:
        return quantize(x, qp)
    n, d = x.shape
    buf = torch.empty((n, -(-d // 16) * 16), dtype=torch.int8, device=x.device)
    buf[:, d:].zero_()
    return quantize(x, qp, out=buf[:, :d])
