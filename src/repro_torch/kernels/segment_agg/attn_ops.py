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
``SplitMap``. Heads stay packed ``[N, H·dh]`` as the FTE wrote them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ops import SplitMap, _check
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_mh_ref, attend_tiles_ref

__all__ = ["ATTENTION", "SEGMENT_AGG_MH", "Walk", "walk_geometry", "attend_tiles",
           "aggregate_tiles_mh"]

ATTENTION = "attention"
SEGMENT_AGG_MH = "segment_agg_mh"
_SMEM_BYTES = 232448  # shared memory a block may use on an H100 (opting in)
_MAX_THREADS = 512  # the kernel's launch bound
_BLOCK_BYTES = 112 * 1024  # shared memory of a block such that two fit on an SM
_MIN_LIVE = 0.9  # share of a block's threads that own a chunk of the row


class Walk(NamedTuple):
    """Launch geometry of ``heads_walk_kernel`` (``csrc/attn_agg.cu``).

    A block is ``groups`` lane groups of ``chunks`` threads: thread (g, c)
    loads the c-th ``chunk_bytes`` chunk of every row of group g's
    ``per_group`` consecutive lanes. Rows arrive through a two-stage ring of
    ``lanes_per_stage`` lanes per group and stage.
    """

    chunk_bytes: int
    chunks: int
    groups: int
    per_group: int
    lanes_per_stage: int
    threads: int
    smem_bytes: int

    @property
    def live_share(self) -> float:
        """Share of the block's threads that own a chunk (load slots in use)."""
        return self.groups * self.chunks / self.threads


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def walk_geometry(lanes: int, segs: int, heads: int, d: int, elem_bytes: int,
                  base: int = 0) -> Walk:
    """The walk for tiles of ``lanes`` lanes and ``segs`` segments over rows
    of ``d`` elements of ``elem_bytes`` bytes (4: f32, 1: int8 codes)
    starting at address ``base``.

    16-byte chunks where the rows allow them (``d`` a multiple of 4 floats or
    16 codes, a 16-byte aligned base), else 4- or 1-byte chunks. The fewest
    lane groups whose block is a whole number of warps, at least 256 threads
    and at least 90% live; failing that, the most live share. At most
    ``lanes // 8`` groups, so each walks a run of 8 lanes or more. A
    two-stage ring as deep as lets two blocks share an SM (112 KB a block)
    and leaves two steps a tile.
    """
    if elem_bytes == 4:
        chunk = 16 if d % 4 == 0 and base % 16 == 0 else 4
    else:
        chunk = (16 if d % 16 == 0 and base % 16 == 0
                 else 4 if d % 4 == 0 and base % 4 == 0 else 1)
    chunks = d * elem_bytes // chunk
    if chunks > _MAX_THREADS:
        raise ValueError(f"rows of {d} elements in {chunk}-byte chunks exceed the kernel's "
                         f"{_MAX_THREADS} threads")
    best, best_share = 1, 0.0
    for g in range(1, max(1, min(lanes // 8, _MAX_THREADS // chunks)) + 1):
        threads = -(-g * chunks // 32) * 32
        share = g * chunks / threads
        if share >= _MIN_LIVE and threads >= 256:
            best = g
            break
        if share > best_share:
            best, best_share = g, share
    per_group = -(-lanes // best)
    groups = -(-lanes // per_group)
    row_bytes = _align16(chunks * chunk)
    threads = -(-groups * chunks // 32) * 32
    meta = 4 * _align16(4 * lanes) + 2 * _align16(4 * segs) + _align16(4 * lanes * heads)
    fixed = 3 * meta + 2 * _align16(4 * segs * heads) + groups * d * 4
    stage = 2 * groups * row_bytes  # ring bytes per lane of a group
    # At least two ring steps a tile: the next tile's scores, staged with
    # the first, then land within this tile.
    k = max(1, min(per_group // 2, (_BLOCK_BYTES - fixed) // stage))
    smem = k * stage + fixed
    if smem > _SMEM_BYTES:
        raise ValueError(f"tiles of {lanes} lanes, {segs} segments and {heads} heads need "
                         f"{smem} bytes, more than the {_SMEM_BYTES} bytes of shared memory "
                         "a block may use")
    return Walk(chunk, chunks, groups, per_group, k, threads, smem)


def _rows(x: torch.Tensor, qp, num_nodes: int):
    """Check the rows (f32, or int8 codes with ``qp``); return
    (heads, dh, element bytes, scale pointer, zero-point pointer)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, dh], got {tuple(x.shape)}")
    n, h, dh = x.shape
    if qp is None:
        _check("x", x, x.device, torch.float32, (num_nodes, h, dh))
        return h, dh, 4, None, None
    _check("x", x, x.device, torch.int8, (num_nodes, h, dh))
    for name, t in (("scale", qp.scale), ("zero_point", qp.zero_point)):
        if t.device != x.device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"qp.{name} must be one f32 on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return h, dh, 1, qp.scale.data_ptr(), qp.zero_point.data_ptr()


def _check_tiles(x, gather_idx, edge_ids, values, coeff, seg_ids, out_node, split, num_nodes,
                 qp):
    """Devices, shapes and dtypes of one kernel call; returns (heads, dh,
    element bytes, scale pointer, zero-point pointer, Walk)."""
    if x.device.type != "cuda":
        raise ValueError(f"no GAT kernel for device {x.device}")
    h, dh, elem, scale, zero = _rows(x, qp, num_nodes)
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
    walk = walk_geometry(e, s, h, h * dh, elem, x.data_ptr())
    return h, dh, elem, scale, zero, walk


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
) -> torch.Tensor:
    """Fused GAT layer: softmax(LeakyReLU(scores)) aggregate, f32[N, H, dh]."""
    _same_device(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split.slot_of)
    if z.device.type == "cpu":
        return attend_tiles_ref(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split,
                                num_nodes=num_nodes, leaky_slope=leaky_slope, qp=qp)
    h, dh, elem, scale, zero, wk = _check_tiles(z, gather_idx, edge_ids, scores, coeff, seg_ids,
                                                out_node, split, num_nodes, qp)
    t, e = gather_idx.shape
    out = torch.zeros((num_nodes, h, dh), dtype=torch.float32, device=z.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=z.device)
    part_m = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    part_l = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    build.call(
        "ample_attention", z.device,
        z.data_ptr(), elem, scale, zero, gather_idx.data_ptr(), edge_ids.data_ptr(),
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
) -> torch.Tensor:
    """Multi-head event-driven aggregation, lane weight ``coeff ·
    edge_coeff[edge_id, h]``: f32[num_nodes, H, dh]."""
    _same_device(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node, split.slot_of)
    if x.device.type == "cpu":
        return aggregate_tiles_mh_ref(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids,
                                      out_node, split, num_nodes=num_nodes, qp=qp)
    h, dh, elem, scale, zero, wk = _check_tiles(x, gather_idx, edge_ids, edge_coeff, coeff,
                                                seg_ids, out_node, split, num_nodes, qp)
    t, e = gather_idx.shape
    out = torch.zeros((num_nodes, h, dh), dtype=torch.float32, device=x.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=x.device)
    build.call(
        "ample_segment_agg_mh", x.device,
        x.data_ptr(), elem, scale, zero, gather_idx.data_ptr(), edge_ids.data_ptr(),
        edge_coeff.data_ptr(), None if coeff is None else coeff.data_ptr(), seg_ids.data_ptr(),
        out_node.data_ptr(), split.slot_of.data_ptr(), split.split_ptr.data_ptr(),
        split.split_node.data_ptr(), part_a.data_ptr(), out.data_ptr(),
        t, e, out_node.shape[1], h, dh, int(split.split_node.shape[0]), num_nodes,
        wk.chunk_bytes, wk.groups, wk.per_group, wk.lanes_per_stage, wk.threads,
        wk.smem_bytes,
    )
    build.count_launch(SEGMENT_AGG_MH)
    return out
