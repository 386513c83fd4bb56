"""Wrappers of the multi-head GAT kernels: edge tiles in, per-head aggregates out.

``attend_tiles`` is the fused GAT layer: raw (pre-LeakyReLU) per-edge scores
and head-stacked embeddings in, softmax-weighted aggregates out.
``aggregate_tiles_mh`` is the multi-head analogue of ``ops.aggregate_tiles``
for per-edge, per-head coefficients. Per-edge operands stay in graph edge
space, ``[E_graph, H]``, and are read through the plan's ``edge_ids``
(-1 on padding lanes); the rows are f32 ``[N, H, dh]`` or int8 codes with
their ``QuantParams`` (dequantized inside the kernel). Both launch
``csrc/attn_agg.cu`` for CUDA tensors and run their plain versions
(``ref.py``) for CPU tensors, and both read the tiles with the plan's
``SplitMap``, and both write into a caller's ``out`` when given one. Heads
stay packed ``[N, H·dh]`` as the FTE wrote them. The walk's geometry is
``ops.walk_geometry``, re-exported here. Neither kernel has a backward:
under grad, an input that requires grad raises (``build.require_no_grad``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ops import (
    SplitMap,
    Walk,
    _check,
    _geometry,
    _output,
    _rows,
    walk_geometry,
)
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_mh_ref, attend_tiles_ref

__all__ = ["ATTENTION", "SEGMENT_AGG_MH", "Walk", "walk_geometry", "attend_tiles",
           "aggregate_tiles_mh"]

ATTENTION = "attention"
SEGMENT_AGG_MH = "segment_agg_mh"


def _check_tiles(x, gather_idx, edge_ids, values, coeff, seg_ids, out_node, split, num_nodes,
                 qp):
    """Devices, shapes and dtypes of one kernel call; returns (heads, dh,
    element bytes, scale pointer, zero-point pointer, row stride, Walk)."""
    if x.device.type != "cuda":
        raise ValueError(f"no GAT kernel for device {x.device}")
    h, dh, elem, scale, zero, ld = _rows(x, qp, num_nodes)
    t, e = gather_idx.shape
    s = out_node.shape[1]
    if values.dim() != 2 or values.shape[1] != h:
        raise ValueError(f"per-edge values must be [E, {h}] for {h} heads, "
                         f"got {tuple(values.shape)}")
    _check("values", values, x.device, torch.float32, tuple(values.shape))
    if coeff is not None:
        _check("coeff", coeff, x.device, torch.float32, (t, e))
    for name, ten, shape in (
        ("gather_idx", gather_idx, (t, e)),
        ("edge_ids", edge_ids, (t, e)),
        ("seg_ids", seg_ids, (t, e)),
        ("out_node", out_node, (t, s)),
        ("slot_of", split.slot_of, (t, s)),
        ("split_node", split.split_node, (split.split_node.shape[0],)),
        ("split_ptr", split.split_ptr, (split.split_node.shape[0] + 1,)),
    ):
        _check(name, ten, x.device, torch.int32, shape)
    return h, dh, elem, scale, zero, ld, _geometry(x, e, s, h, h * dh, elem, ld)


def _same_device(x: torch.Tensor, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"tile arrays on {t.device}, embeddings on {x.device}")


def attend_tiles(
    z: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    gather_idx: torch.Tensor,  # int32[T, E]
    edge_ids: torch.Tensor,  # int32[T, E] graph edge of each lane, -1 on padding
    scores: torch.Tensor,  # f32[E_graph, H] raw scores
    coeff: torch.Tensor,  # f32[T, E] static lane coeff
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,  # tensors on z's device
    *,
    num_nodes: int,
    leaky_slope: float,
    qp=None,  # QuantParams of int8 codes
    out: Optional[torch.Tensor] = None,  # f32[num_nodes, H, dh]
) -> torch.Tensor:
    """Fused GAT layer: softmax(LeakyReLU(scores)) aggregate, f32[N, H, dh],
    written into ``out`` for the plan's nodes (every other row left as it
    is; ``out`` None: zeros)."""
    _same_device(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split.slot_of)
    if z.device.type == "cpu":
        return attend_tiles_ref(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split,
                                num_nodes=num_nodes, leaky_slope=leaky_slope, qp=qp, out=out)
    build.require_no_grad(ATTENTION, z, scores, coeff, None if qp is None else qp.scale)
    h, dh, elem, scale, zero, ld, wk = _check_tiles(z, gather_idx, edge_ids, scores, coeff,
                                                    seg_ids, out_node, split, num_nodes, qp)
    t, e = gather_idx.shape
    out = _output(out, (num_nodes, h, dh), z.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=z.device)
    part_m = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    part_l = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    build.call(
        "ample_attention", z.device,
        z.data_ptr(), elem, scale, zero, ld, gather_idx.data_ptr(), edge_ids.data_ptr(),
        scores.data_ptr(), coeff.data_ptr(), seg_ids.data_ptr(), out_node.data_ptr(),
        split.slot_of.data_ptr(), split.split_ptr.data_ptr(), split.split_node.data_ptr(),
        part_a.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(),
        t, e, out_node.shape[1], h, dh, int(split.split_node.shape[0]), num_nodes,
        wk.chunk_bytes, wk.groups, wk.per_group, wk.lanes_per_stage, wk.threads,
        wk.smem_bytes, float(leaky_slope),
    )
    build.count_launch(ATTENTION)
    return out


def aggregate_tiles_mh(
    x: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    gather_idx: torch.Tensor,  # int32[T, E]
    edge_ids: torch.Tensor,  # int32[T, E] graph edge of each lane, -1 on padding
    edge_coeff: torch.Tensor,  # f32[E_graph, H] per-edge, per-head coefficients
    coeff: Optional[torch.Tensor],  # f32[T, E] static lane coeff; None: ones
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,
    *,
    num_nodes: int,
    qp=None,  # QuantParams of int8 codes
    out: Optional[torch.Tensor] = None,  # f32[num_nodes, H, dh]
) -> torch.Tensor:
    """Multi-head event-driven aggregation, lane weight ``coeff ·
    edge_coeff[edge_id, h]``: f32[num_nodes, H, dh], written into ``out`` as
    ``attend_tiles`` does."""
    _same_device(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node, split.slot_of)
    if x.device.type == "cpu":
        return aggregate_tiles_mh_ref(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids,
                                      out_node, split, num_nodes=num_nodes, qp=qp, out=out)
    build.require_no_grad(SEGMENT_AGG_MH, x, edge_coeff, coeff,
                          None if qp is None else qp.scale)
    h, dh, elem, scale, zero, ld, wk = _check_tiles(x, gather_idx, edge_ids, edge_coeff, coeff,
                                                    seg_ids, out_node, split, num_nodes, qp)
    t, e = gather_idx.shape
    out = _output(out, (num_nodes, h, dh), x.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=x.device)
    build.call(
        "ample_segment_agg_mh", x.device,
        x.data_ptr(), elem, scale, zero, ld, gather_idx.data_ptr(), edge_ids.data_ptr(),
        edge_coeff.data_ptr(), None if coeff is None else coeff.data_ptr(), seg_ids.data_ptr(),
        out_node.data_ptr(), split.slot_of.data_ptr(), split.split_ptr.data_ptr(),
        split.split_node.data_ptr(), part_a.data_ptr(), out.data_ptr(),
        t, e, out_node.shape[1], h, dh, int(split.split_node.shape[0]), num_nodes,
        wk.chunk_bytes, wk.groups, wk.per_group, wk.lanes_per_stage, wk.threads,
        wk.smem_bytes,
    )
    build.count_launch(SEGMENT_AGG_MH)
    return out
