"""Plain PyTorch version of the AGE kernel (``csrc/segment_agg.cu``).

The same function as the kernel, by the same route: per-tile segment sums,
written straight to the output for nodes that live in one tile and to compact
partial rows for split nodes, whose partials are then summed in tile order.
The CPU tests run it; on the card it is what the kernel is checked against.
"""
from __future__ import annotations

import torch

__all__ = ["aggregate_tiles_ref"]


def aggregate_tiles_ref(
    x: torch.Tensor,  # f32[N, D]
    gather_idx: torch.Tensor,  # int32[T, E]
    coeff: torch.Tensor,  # f32[T, E]
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split,  # ops.SplitMap over the same tiles
    *,
    num_nodes: int,
    tile_chunk: int = 1024,
) -> torch.Tensor:
    """f32[num_nodes, D]: Σ coeff·x[gather_idx] over each node's segments.

    Tiles are processed ``tile_chunk`` at a time, which bounds the gathered
    messages to ``tile_chunk · E · D`` floats.
    """
    t, _ = gather_idx.shape
    s = out_node.shape[1]
    d = x.shape[1]
    dev = x.device
    out = torch.zeros((num_nodes, d), dtype=x.dtype, device=dev)
    partial = torch.zeros((split.num_slots, d), dtype=x.dtype, device=dev)
    base = torch.arange(min(tile_chunk, t), device=dev).unsqueeze(1) * s
    for t0 in range(0, t, tile_chunk):
        t1 = min(t, t0 + tile_chunk)
        msg = x[gather_idx[t0:t1].long()] * coeff[t0:t1].unsqueeze(-1)
        dest = (base[: t1 - t0] + seg_ids[t0:t1]).reshape(-1)
        sums = torch.zeros(((t1 - t0) * s, d), dtype=x.dtype, device=dev)
        sums.index_add_(0, dest, msg.reshape(-1, d))
        node = out_node[t0:t1].reshape(-1).long()
        slot = split.slot_of[t0:t1].reshape(-1).long()
        direct = (node < num_nodes) & (slot < 0)
        out[node[direct]] = sums[direct]
        part = slot >= 0
        partial[slot[part]] = sums[part]
    ptr = split.split_ptr.long()
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros((count.numel(), d), dtype=x.dtype, device=dev)
    for k in range(int(count.max()) if count.numel() else 0):
        has = count > k
        acc[has] += partial[ptr[:-1][has] + k]
    out[split.split_node.long()] = acc
    return out
