"""Wrapper of the AGE kernel: edge tiles in, node aggregates out.

``aggregate_tiles`` launches ``csrc/segment_agg.cu`` (the tile walk of
``csrc/tile_walk.cuh`` with one head, lane weights the plan's coeff) for a
CUDA tensor and runs the plain version (``ref.py``) for a CPU tensor. The rows
are f32 or int8 codes with their ``QuantParams``, which the walk dequantizes
in registers. Both read the tiles together with a ``SplitMap``: which
segments belong to nodes split across tiles, computed once per plan on the
host by ``split_segment_map``. ``walk_geometry`` gives the walk's launch
geometry, here and for the GAT kernels (``attn_ops.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref

__all__ = ["KERNEL", "SplitMap", "split_segment_map", "Walk", "walk_geometry",
           "aggregate_tiles"]

KERNEL = "segment_agg"
_SMEM_BYTES = 232448  # shared memory a block may use on an H100 (opting in)
_MAX_THREADS = 512  # the walk's launch bound
_BLOCK_BYTES = 112 * 1024  # shared memory of a block such that two fit on an SM
_MIN_LIVE = 0.9  # share of a block's threads that own a chunk of the row


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


class Walk(NamedTuple):
    """Launch geometry of ``heads_walk_kernel`` (``csrc/tile_walk.cuh``).

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
                  base: int = 0, ld: Optional[int] = None) -> Walk:
    """The walk for tiles of ``lanes`` lanes and ``segs`` segments over rows
    of ``d`` elements of ``elem_bytes`` bytes (4: f32, 1: int8 codes), ``ld``
    elements apart (default ``d``), starting at address ``base``.

    16-byte chunks where the rows allow them (a row stride and a base that
    are multiples of 16 bytes, and ``d`` a multiple of 4 floats or 16 codes;
    codes whose stride leaves room may take a last chunk that reads the row's
    padding, when ``d`` is a multiple of 4), else 4- or 1-byte chunks. The
    fewest lane groups whose block is a whole number of warps, at least 256
    threads and at least 90% live; failing that, the most live share. At
    most ``lanes // 8`` groups, so each walks a run of 8 lanes or more. A
    two-stage ring as deep as lets two blocks share an SM (112 KB a block)
    and leaves two steps a tile.
    """
    ld = d if ld is None else ld
    width, stride = d * elem_bytes, ld * elem_bytes

    def fits(chunk):
        if base % chunk or stride % chunk:
            return False
        if width % chunk == 0:
            return True
        return elem_bytes == 1 and d % 4 == 0 and -(-width // chunk) * chunk <= stride

    chunk = 16 if fits(16) else 4 if fits(4) else 1
    chunks = -(-width // chunk)
    padded = chunks * chunk // elem_bytes  # columns the chunks cover
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
    fixed = 3 * meta + 2 * _align16(4 * segs * heads) + groups * padded * 4
    stage = 2 * groups * row_bytes  # ring bytes per lane of a group
    # At least two ring steps a tile: the next tile's per-edge values,
    # staged with the first, then land within this tile.
    k = max(1, min(per_group // 2, (_BLOCK_BYTES - fixed) // stage))
    smem = k * stage + fixed
    if smem > _SMEM_BYTES:
        raise ValueError(f"tiles of {lanes} lanes, {segs} segments and {heads} heads need "
                         f"{smem} bytes, more than the {_SMEM_BYTES} bytes of shared memory "
                         "a block may use")
    return Walk(chunk, chunks, groups, per_group, k, threads, smem)


def _rows(x: torch.Tensor, qp, num_nodes: int):
    """Check the rows x [N, H, dh] (f32, or int8 codes with ``qp``) for the
    walk: each row's H·dh elements contiguous, rows ``ld`` >= H·dh elements
    apart. Returns (heads, dh, element bytes, scale pointer, zero-point
    pointer, ld)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, dh], got {tuple(x.shape)}")
    n, h, dh = x.shape
    dtype = torch.float32 if qp is None else torch.int8
    if x.dtype != dtype:
        raise TypeError(f"x must be {dtype}" + ("" if qp is None else " codes with their qp")
                        + f", got {x.dtype}")
    if n != num_nodes:
        raise ValueError(f"x must have {num_nodes} rows, got {n}")
    if x.stride(2) != 1 or (h > 1 and x.stride(1) != dh) or x.stride(0) < h * dh:
        raise ValueError(f"x must be contiguous within each row, got strides {x.stride()}")
    if qp is None:
        return h, dh, 4, None, None, x.stride(0)
    for name, t in (("scale", qp.scale), ("zero_point", qp.zero_point)):
        if t.device != x.device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"qp.{name} must be one f32 on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return h, dh, 1, qp.scale.data_ptr(), qp.zero_point.data_ptr(), x.stride(0)


def _geometry(x: torch.Tensor, lanes: int, segs: int, heads: int, d: int, elem: int,
              ld: int) -> Walk:
    """``walk_geometry`` for x; a last chunk that reads a row's padding must
    stay inside x's storage."""
    wk = walk_geometry(lanes, segs, heads, d, elem, x.data_ptr(), ld)
    end = (x.storage_offset() + (x.shape[0] - 1) * ld) * elem + wk.chunks * wk.chunk_bytes
    if x.shape[0] and end > x.untyped_storage().nbytes():
        raise ValueError("the last row's padding lies outside x's storage")
    return wk


def _output(out: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """The caller's ``out`` (checked), or zeros."""
    if out is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    _check("out", out, device, torch.float32, shape)
    return out


def aggregate_tiles(
    x: torch.Tensor,  # f32[N, D], or int8 codes with qp; rows may lie ld > D apart
    gather_idx: torch.Tensor,  # int32[T, E]
    coeff: torch.Tensor,  # f32[T, E]
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split: SplitMap,  # tensors on x's device
    *,
    num_nodes: int,
    qp=None,  # QuantParams of int8 codes
    out: Optional[torch.Tensor] = None,  # f32[num_nodes, D]
) -> torch.Tensor:
    """Event-driven aggregation over edge tiles: f32[num_nodes, D].

    Writes the rows of the plan's nodes into ``out`` and leaves every other
    row as it is (``out`` None: zeros), so precision groups with disjoint
    nodes share one output.
    """
    if x.device.type == "cpu":
        return aggregate_tiles_ref(x, gather_idx, coeff, seg_ids, out_node, split,
                                   num_nodes=num_nodes, qp=qp, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"no AGE kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    _, d, elem, scale, zero, ld = _rows(x.unsqueeze(1), qp, num_nodes)
    t, e = gather_idx.shape
    s = out_node.shape[1]
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
    wk = _geometry(x, e, s, 1, d, elem, ld)
    out = _output(out, (num_nodes, d), x.device)
    partial = torch.empty((split.num_slots, d), dtype=torch.float32, device=x.device)
    build.call(
        "ample_segment_agg", x.device,
        x.data_ptr(), elem, scale, zero, ld, gather_idx.data_ptr(), coeff.data_ptr(),
        seg_ids.data_ptr(), out_node.data_ptr(), split.slot_of.data_ptr(),
        split.split_ptr.data_ptr(), split.split_node.data_ptr(), partial.data_ptr(),
        out.data_ptr(), t, e, s, d, int(split.split_node.shape[0]), num_nodes,
        wk.chunk_bytes, wk.groups, wk.per_group, wk.lanes_per_stage, wk.threads, wk.smem_bytes,
    )
    build.count_launch(KERNEL)
    return out
