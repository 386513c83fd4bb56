"""Wrapper of the AGE kernel: edge tiles in, node aggregates out.

``aggregate_tiles`` launches ``csrc/segment_agg.cu`` for a CUDA tensor and
runs the plain version (``ref.py``) for a CPU tensor. Both read the tiles
together with a ``SplitMap``: which segments belong to nodes split across
tiles, computed once per plan on the host by ``split_segment_map``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref

__all__ = ["KERNEL", "SplitMap", "split_segment_map", "aggregate_tiles"]

KERNEL = "segment_agg"
_SMEM_BYTES = 48 * 1024  # static shared memory a block may use


class SplitMap(NamedTuple):
    """Where each tile segment's sum goes.

    slot_of:    int32[T, S] -1 when the segment's node occurs in this tile
                only (its sum is the node's row), else the segment's row in
                the compact partial buffer.
    split_ptr:  int32[P + 1] CSR offsets: split node i owns partial rows
                split_ptr[i]:split_ptr[i + 1], in tile order.
    split_node: int32[P] the split nodes, ascending.
    num_slots:  rows of the partial buffer (= split_ptr[-1]).
    """

    slot_of: object
    split_ptr: object
    split_node: object
    num_slots: int

    def to(self, device) -> "SplitMap":
        return SplitMap(
            *(torch.as_tensor(a, dtype=torch.int32, device=device)
              for a in (self.slot_of, self.split_ptr, self.split_node)),
            self.num_slots,
        )


def split_segment_map(
    out_node: np.ndarray, seg_ids: np.ndarray, num_nodes: int
) -> SplitMap:
    """Build the ``SplitMap`` of a tile plan (numpy, once per plan).

    Checks the plan invariants the kernel relies on: every tile's lanes are
    in non-decreasing segment order (a segment is one contiguous run), and
    ``out_node`` holds node ids below ``num_nodes`` or the sentinel
    ``num_nodes``.
    """
    out_node = np.asarray(out_node)
    seg_ids = np.asarray(seg_ids)
    if seg_ids.size and np.any(np.diff(seg_ids, axis=1) < 0):
        raise ValueError("tile lanes are not in segment order")
    flat = out_node.reshape(-1).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() > num_nodes):
        raise ValueError(f"out_node ids outside [0, {num_nodes}]")
    pos = np.nonzero(flat != num_nodes)[0]
    counts = np.bincount(flat[pos], minlength=num_nodes)
    split_pos = pos[counts[flat[pos]] > 1]
    split_pos = split_pos[np.argsort(flat[split_pos], kind="stable")]
    slot_of = np.full(flat.shape, -1, np.int32)
    slot_of[split_pos] = np.arange(split_pos.size, dtype=np.int32)
    split_node, first = np.unique(flat[split_pos], return_index=True)
    split_ptr = np.append(first, split_pos.size).astype(np.int32)
    return SplitMap(
        slot_of.reshape(out_node.shape),
        split_ptr,
        split_node.astype(np.int32),
        int(split_pos.size),
    )


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aggregate_tiles(
    x: torch.Tensor,  # f32[N, D]
    gather_idx: torch.Tensor,  # int32[T, E]
    coeff: torch.Tensor,  # f32[T, E]
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,  # tensors on x's device
    *,
    num_nodes: int,
) -> torch.Tensor:
    """Event-driven aggregation over edge tiles: f32[num_nodes, D]."""
    if x.device.type == "cpu":
        return aggregate_tiles_ref(
            x, gather_idx, coeff, seg_ids, out_node, split, num_nodes=num_nodes
        )
    if x.device.type != "cuda":
        raise ValueError(f"no AGE kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    t, e = gather_idx.shape
    s = out_node.shape[1]
    d = x.shape[1]
    _check("x", x, x.device, torch.float32, (num_nodes, d))
    for name, ten, dtype, shape in (
        ("gather_idx", gather_idx, torch.int32, (t, e)),
        ("coeff", coeff, torch.float32, (t, e)),
        ("seg_ids", seg_ids, torch.int32, (t, e)),
        ("out_node", out_node, torch.int32, (t, s)),
        ("slot_of", split.slot_of, torch.int32, (t, s)),
        ("split_node", split.split_node, torch.int32, (split.split_node.shape[0],)),
        ("split_ptr", split.split_ptr, torch.int32, (split.split_node.shape[0] + 1,)),
    ):
        _check(name, ten, x.device, dtype, shape)
    if (3 * e + 2 * s) * 4 > _SMEM_BYTES:
        raise ValueError(
            f"tiles of {e} lanes and {s} segments exceed the kernel's "
            f"{_SMEM_BYTES} bytes of shared memory"
        )
    out = torch.zeros((num_nodes, d), dtype=torch.float32, device=x.device)
    partial = torch.empty((split.num_slots, d), dtype=torch.float32, device=x.device)
    build.call(
        "ample_segment_agg", x.device,
        x.data_ptr(), gather_idx.data_ptr(), coeff.data_ptr(), seg_ids.data_ptr(),
        out_node.data_ptr(), split.slot_of.data_ptr(), split.split_ptr.data_ptr(),
        split.split_node.data_ptr(), partial.data_ptr(), out.data_ptr(),
        t, e, s, int(split.split_node.shape[0]), d, num_nodes,
    )
    build.count_launch(KERNEL)
    return out
