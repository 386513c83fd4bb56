"""Wrappers of the multi-head GAT kernels: edge tiles in, per-head aggregates out.

``attend_tiles`` is the fused GAT layer: raw (pre-LeakyReLU) scores in tile
layout and head-stacked embeddings in, softmax-weighted aggregates out.
``aggregate_tiles_mh`` is the multi-head analogue of ``ops.aggregate_tiles``
for per-head lane coefficients. Both launch ``csrc/attn_agg.cu`` for CUDA
tensors and run their plain versions (``ref.py``) for CPU tensors, and both
read the tiles with the plan's ``SplitMap``. Heads stay packed
``[N, H·dh]`` as the FTE wrote them: there is no padding of ``dh``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ops import SplitMap, _check
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_mh_ref, attend_tiles_ref

__all__ = ["ATTENTION", "SEGMENT_AGG_MH", "attend_tiles", "aggregate_tiles_mh"]

ATTENTION = "attention"
SEGMENT_AGG_MH = "segment_agg_mh"
_SMEM_BYTES = 48 * 1024  # shared memory a block may use without opting in


def _same_device(x: torch.Tensor, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tile arrays on {t.device}, embeddings on {x.device}")


def _check_tiles(x, gather_idx, seg_ids, out_node, split, num_nodes, heads, smem_words):
    """Shapes, dtypes, devices and the shared-memory fit of one kernel call;
    returns (heads, dh)."""
    if x.device.type != "cuda":
        raise ValueError(f"no GAT kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, dh], got {tuple(x.shape)}")
    t, e = gather_idx.shape
    s = out_node.shape[1]
    n, h, dh = x.shape
    if h != heads:
        raise ValueError(f"x has {h} heads, the coefficients {heads}")
    _check("x", x, x.device, torch.float32, (num_nodes, h, dh))
    for name, ten, shape in (
        ("gather_idx", gather_idx, (t, e)),
        ("seg_ids", seg_ids, (t, e)),
        ("out_node", out_node, (t, s)),
        ("slot_of", split.slot_of, (t, s)),
        ("split_node", split.split_node, (split.split_node.shape[0],)),
        ("split_ptr", split.split_ptr, (split.split_node.shape[0] + 1,)),
    ):
        _check(name, ten, x.device, torch.int32, shape)
    if smem_words * 4 > _SMEM_BYTES:
        raise ValueError(
            f"tiles of {e} lanes, {s} segments and {h} heads exceed the kernel's "
            f"{_SMEM_BYTES} bytes of shared memory"
        )
    return h, dh


def attend_tiles(
    z: torch.Tensor,  # f32[N, H, dh]
    gather_idx: torch.Tensor,  # int32[T, E]
    scores_t: torch.Tensor,  # f32[T, E, H] raw scores, −inf on padding lanes
    coeff: torch.Tensor,  # f32[T, E] static lane coeff
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,  # tensors on z's device
    *,
    num_nodes: int,
    leaky_slope: float,
) -> torch.Tensor:
    """Fused GAT layer: softmax(LeakyReLU(scores)) aggregate, f32[N, H, dh]."""
    _same_device(z, gather_idx, scores_t, coeff, seg_ids, out_node, split.slot_of)
    if z.device.type == "cpu":
        return attend_tiles_ref(z, gather_idx, scores_t, coeff, seg_ids, out_node, split,
                                num_nodes=num_nodes, leaky_slope=leaky_slope)
    t, e = gather_idx.shape
    s = out_node.shape[1]
    heads = scores_t.shape[-1] if scores_t.dim() == 3 else -1
    h, dh = _check_tiles(z, gather_idx, seg_ids, out_node, split, num_nodes,
                                  heads, 2 * e + 2 * s + e * heads + s * heads)
    _check("scores_t", scores_t, z.device, torch.float32, (t, e, h))
    _check("coeff", coeff, z.device, torch.float32, (t, e))
    out = torch.zeros((num_nodes, h, dh), dtype=torch.float32, device=z.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=z.device)
    part_m = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    part_l = torch.empty((split.num_slots, h), dtype=torch.float32, device=z.device)
    build.call(
        "ample_attention", z.device,
        z.data_ptr(), gather_idx.data_ptr(), scores_t.data_ptr(), coeff.data_ptr(),
        seg_ids.data_ptr(), out_node.data_ptr(), split.slot_of.data_ptr(),
        split.split_ptr.data_ptr(), split.split_node.data_ptr(),
        part_a.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(),
        t, e, s, h, dh, int(split.split_node.shape[0]), num_nodes, float(leaky_slope),
    )
    build.count_launch(ATTENTION)
    return out


def aggregate_tiles_mh(
    x: torch.Tensor,  # f32[N, H, dh]
    gather_idx: torch.Tensor,  # int32[T, E]
    coeff: torch.Tensor,  # f32[T, E, H] per-head lane coefficients
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,
    *,
    num_nodes: int,
) -> torch.Tensor:
    """Multi-head event-driven aggregation: f32[num_nodes, H, dh]."""
    _same_device(x, gather_idx, coeff, seg_ids, out_node, split.slot_of)
    if x.device.type == "cpu":
        return aggregate_tiles_mh_ref(x, gather_idx, coeff, seg_ids, out_node, split,
                                      num_nodes=num_nodes)
    t, e = gather_idx.shape
    s = out_node.shape[1]
    heads = coeff.shape[-1] if coeff.dim() == 3 else -1
    h, dh = _check_tiles(x, gather_idx, seg_ids, out_node, split, num_nodes,
                                  heads, 2 * e + 2 * s + e * heads)
    _check("coeff", coeff, x.device, torch.float32, (t, e, h))
    out = torch.zeros((num_nodes, h, dh), dtype=torch.float32, device=x.device)
    part_a = torch.empty((split.num_slots, h, dh), dtype=torch.float32, device=x.device)
    build.call(
        "ample_segment_agg_mh", x.device,
        x.data_ptr(), gather_idx.data_ptr(), coeff.data_ptr(), seg_ids.data_ptr(),
        out_node.data_ptr(), split.slot_of.data_ptr(), split.split_ptr.data_ptr(),
        split.split_node.data_ptr(), part_a.data_ptr(), out.data_ptr(),
        t, e, s, h, dh, int(split.split_node.shape[0]), num_nodes,
    )
    build.count_launch(SEGMENT_AGG_MH)
    return out
