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
``ops.walk_geometry``, re-exported here.

Under grad both are autograd Functions, given the plan's ``TileGrad`` (the
in-edge CSR, the nodes the plan writes, the plan of the reversed edges).
The fused attention's forward also writes each node's log-sum-exp, and its
backward is ``attend_tiles_bwd`` (``csrc/attn_agg_bwd.cu``: α and the
scores' gradient ds per edge), then the multi-head walk on the transposed
plan with coefficients α (the rows' gradient). The multi-head AGE's backward
is the same kernel's coefficient mode (``edge_dot``: the coefficients'
gradient) and the walk on the transposed plan with the forward's
coefficients (the rows'). An int8 group's codes pass no gradient, and its
scale receives ``Σ(g ⊙ out) / scale``, as ``jax.grad`` of the reference's
jnp path gives. On a CPU tensor every step runs its plain version.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
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
from repro_torch.kernels.segment_agg.ref import (
    aggregate_tiles_mh_ref,
    attend_tiles_bwd_ref,
    attend_tiles_ref,
    edge_dot_ref,
)

__all__ = ["ATTENTION", "ATTENTION_BWD", "SEGMENT_AGG_MH", "TileGrad", "Walk",
           "walk_geometry", "attend_tiles", "aggregate_tiles_mh", "attend_tiles_bwd",
           "edge_dot", "row_items", "wants_grad"]

ATTENTION = "attention"
SEGMENT_AGG_MH = "segment_agg_mh"
ATTENTION_BWD = "attention_bwd"
_BWD_HEADS, _BWD_WIDTH = 8, 512  # csrc/attn_agg_bwd.cu: heads and elements a row at most
ITEM_EDGES = 64  # in-edges of a backward work item at most: a hub spans several


def row_items(indptr: np.ndarray, rows: np.ndarray, chunk: int = ITEM_EDGES) -> np.ndarray:
    """The backward's work items over the in-edges of ``rows`` (numpy, once
    per plan): int32[R, 3] of (destination, first edge, end edge), each run
    at most ``chunk`` edges of one row, rows with no in-edge left out."""
    rows = np.asarray(rows, np.int64)
    lo, hi = indptr[rows].astype(np.int64), indptr[rows + 1].astype(np.int64)
    count = -(-(hi - lo) // chunk)
    which = np.repeat(np.arange(rows.size), count)
    k = np.arange(which.size) - np.repeat(np.cumsum(count) - count, count)
    first = lo[which] + k * chunk
    return np.stack([rows[which], first, np.minimum(first + chunk, hi[which])],
                    axis=1).astype(np.int32)


class TileGrad(NamedTuple):
    """What the backward of one plan's GAT kernels reads besides the
    forward's tiles: the sources of the in-edge CSR whose positions the
    plan's edge ids are, the work items over the in-edges of the nodes the
    plan writes (``row_items``), the static coefficient of each edge, and
    the plan of the reversed edges (``scheduler.transpose_plan_graph``:
    lanes carrying forward edge ids), built on first use. All tensors on the
    forward's device."""

    indices: torch.Tensor  # int32[E_graph] source of each edge
    items: torch.Tensor  # int32[R, 3] destination, first edge, end edge
    coeff: Optional[torch.Tensor]  # f32[E_graph] static coefficient of each edge; None: ones
    transposed: Callable[[], object]  # -> the reversed edges' device plan


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


def wants_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None allowed) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _check_grad_call(name, grad, out, coeff, qp) -> None:
    """What a call under grad needs: its ``TileGrad``, its own output, no
    gradient for the static coefficients or a zero point."""
    if grad is None:
        raise ValueError(f"{name} under grad needs grad= (the plan's TileGrad)")
    if out is not None:
        raise ValueError(f"{name} under grad returns its own output; pass no out=")
    if coeff is not None and coeff.requires_grad:
        raise ValueError(f"{name}: no gradient for the static lane coefficients")
    if qp is not None and qp.zero_point.requires_grad:
        raise ValueError(f"{name}: no gradient for the zero point: calibrate symmetrically")


def _scale_grad(g, out, scale):
    """d Σ(g ⊙ out) / d scale for rows that are codes · scale: Σ(g ⊙ out) / scale."""
    return (g * out).sum().sum_to_size(scale.shape) / scale


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
    lse: Optional[torch.Tensor] = None,  # f32[num_nodes, H]
    grad: Optional[TileGrad] = None,
) -> torch.Tensor:
    """Fused GAT layer: softmax(LeakyReLU(scores)) aggregate, f32[N, H, dh],
    written into ``out`` for the plan's nodes (every other row left as it
    is; ``out`` None: zeros), and with ``lse`` each of those nodes'
    log-sum-exp. Under grad (``z``, ``scores`` or the codes' scale requires
    grad) an autograd Function that needs ``grad`` and writes no ``out``."""
    _same_device(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split.slot_of)
    tiles = (gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split)
    scale, zero = (None, None) if qp is None else (qp.scale, qp.zero_point)
    if wants_grad(z, scores, coeff, scale, zero):
        _check_grad_call("attend_tiles", grad, out, coeff, qp)
        return _AttendTiles.apply(z, scores, scale, tiles, grad, num_nodes, leaky_slope, qp)
    return _attend(z, tiles, num_nodes, leaky_slope, qp, out, lse)


def _attend(z, tiles, num_nodes, leaky_slope, qp, out, lse):
    gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split = tiles
    if z.device.type == "cpu":
        return attend_tiles_ref(z, gather_idx, edge_ids, scores, coeff, seg_ids, out_node, split,
                                num_nodes=num_nodes, leaky_slope=leaky_slope, qp=qp, out=out,
                                lse=lse)
    h, dh, elem, scale, zero, ld, wk = _check_tiles(z, gather_idx, edge_ids, scores, coeff,
                                                    seg_ids, out_node, split, num_nodes, qp)
    if lse is not None:
        _check("lse", lse, z.device, torch.float32, (num_nodes, h))
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
        part_a.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        None if lse is None else lse.data_ptr(), out.data_ptr(),
        t, e, out_node.shape[1], h, dh, int(split.split_node.shape[0]), num_nodes,
        wk.chunk_bytes, wk.groups, wk.per_group, wk.lanes_per_stage, wk.threads,
        wk.smem_bytes, float(leaky_slope),
    )
    build.count_launch(ATTENTION)
    return out


class _AttendTiles(torch.autograd.Function):
    """``attend_tiles`` with its log-sum-exp forward; ``attend_tiles_bwd``,
    then the multi-head walk on the transposed plan, backward."""

    @staticmethod
    def forward(ctx, z, scores, scale, tiles, grad, num_nodes, leaky_slope, qp):
        lse = torch.zeros((num_nodes, scores.shape[1]), dtype=torch.float32, device=z.device)
        out = _attend(z, tiles, num_nodes, leaky_slope, qp, None, lse)
        ctx.save_for_backward(z, scores, out, lse)
        ctx.grad, ctx.num_nodes, ctx.leaky_slope, ctx.qp = grad, num_nodes, leaky_slope, qp
        return out

    @staticmethod
    def backward(ctx, g):
        z, scores, out, lse = ctx.saved_tensors
        grad = ctx.grad
        g = g.contiguous()
        alpha, ds = attend_tiles_bwd(z, g, out, lse, scores, grad.indices, grad.items,
                                     leaky_slope=ctx.leaky_slope, coeff=grad.coeff, qp=ctx.qp)
        dz = dscale = None
        if ctx.needs_input_grad[0]:  # f32 rows: dz_j = Σ_i c·α_ij·g_i over the reversed edges
            tp = grad.transposed()
            dz = _aggregate_mh(g, tp.gather_idx, tp.edge_ids, alpha, tp.coeff, tp.seg_ids,
                               tp.out_node, tp.split, ctx.num_nodes, None, None, True)
        if ctx.needs_input_grad[2]:  # codes: round() passes the rows nothing
            dscale = _scale_grad(g, out, ctx.qp.scale)
        return dz, ds, dscale, None, None, None, None, None


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
    grad: Optional[TileGrad] = None,
    aligned: bool = False,
) -> torch.Tensor:
    """Multi-head event-driven aggregation, lane weight ``coeff ·
    edge_coeff[edge_id, h]``: f32[num_nodes, H, dh], written into ``out`` as
    ``attend_tiles`` does; under grad an autograd Function as it is.
    ``aligned``: the walk's lane groups start at segments, as the AGE's, so
    the card sums each segment in lane order, bitwise the plain version on
    the CPU (the backward's walks take it, on the same geometry: the AGE's
    small blocks took 6.596 ms for the Yelp dz walk against 5.964 on this
    one; NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py); otherwise a
    segment may cross groups and is summed in group order (within 1e-4),
    which keeps a hub's run from stalling a block."""
    _same_device(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node, split.slot_of)
    scale, zero = (None, None) if qp is None else (qp.scale, qp.zero_point)
    if wants_grad(x, edge_coeff, coeff, scale, zero):
        _check_grad_call("aggregate_tiles_mh", grad, out, coeff, qp)
        tiles = (gather_idx, edge_ids, coeff, seg_ids, out_node, split)
        return _AggregateTilesMH.apply(x, edge_coeff, scale, tiles, grad, num_nodes, qp,
                                       aligned)
    return _aggregate_mh(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node, split,
                         num_nodes, qp, out, aligned)


def _aggregate_mh(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node, split,
                  num_nodes, qp, out, aligned=False):
    if x.device.type == "cpu":
        return aggregate_tiles_mh_ref(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids,
                                      out_node, split, num_nodes=num_nodes, qp=qp, out=out)
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
        wk.smem_bytes, int(aligned),
    )
    build.count_launch(SEGMENT_AGG_MH)
    return out


class _AggregateTilesMH(torch.autograd.Function):
    """``aggregate_tiles_mh``; ``edge_dot`` (the coefficients) and the walk
    on the transposed plan (the rows) backward."""

    @staticmethod
    def forward(ctx, x, edge_coeff, scale, tiles, grad, num_nodes, qp, aligned):
        gather_idx, edge_ids, coeff, seg_ids, out_node, split = tiles
        out = _aggregate_mh(x, gather_idx, edge_ids, edge_coeff, coeff, seg_ids, out_node,
                            split, num_nodes, qp, None, aligned)
        # the output only for the scale's gradient: a float group's is not kept
        ctx.save_for_backward(x, edge_coeff, out if ctx.needs_input_grad[2] else None)
        ctx.grad, ctx.num_nodes, ctx.qp = grad, num_nodes, qp
        ctx.static = coeff is not None  # None: ones, in both directions
        return out

    @staticmethod
    def backward(ctx, g):
        x, edge_coeff, out = ctx.saved_tensors
        grad = ctx.grad
        g = g.contiguous()
        dx = dcoef = dscale = None
        if ctx.needs_input_grad[1]:
            dcoef = edge_dot(x, g, grad.indices, grad.items,
                             coeff=grad.coeff if ctx.static else None, qp=ctx.qp)
        if ctx.needs_input_grad[0]:
            tp = grad.transposed()
            dx = _aggregate_mh(g, tp.gather_idx, tp.edge_ids, edge_coeff,
                               tp.coeff if ctx.static else None, tp.seg_ids, tp.out_node,
                               tp.split, ctx.num_nodes, None, None, True)
        if ctx.needs_input_grad[2]:
            dscale = _scale_grad(g, out, ctx.qp.scale)
        return dx, dcoef, dscale, None, None, None, None, None


def _bwd_launch(attn, x, qp, g, out, lse, scores, coeff, indices, items, res_a, res_b,
                leaky_slope):
    """Check one call of ``csrc/attn_agg_bwd.cu`` and launch it."""
    n = x.shape[0]
    h, dh, elem, scale, zero, ld = _rows(x, qp, n)
    d = h * dh
    e = indices.shape[0]
    for name, t, dtype, shape in (
        ("g", g, torch.float32, (n, h, dh)),
        ("out", out, torch.float32, (n, h, dh)),
        ("lse", lse, torch.float32, (n, h)),
        ("scores", scores, torch.float32, (e, h)),
        ("coeff", coeff, torch.float32, (e,)),
        ("indices", indices, torch.int32, (e,)),
        ("items", items, torch.int32, (items.shape[0], 3)),
        ("res_a", res_a, torch.float32, (e, h)),
        ("res_b", res_b, torch.float32, (e, h)),
    ):
        if t is not None:
            _check(name, t, x.device, dtype, shape)
    vec4 = (d % 4 == 0 and ld % 4 == 0 and x.data_ptr() % (4 * elem) == 0
            and all(t is None or t.data_ptr() % 16 == 0 for t in (g, out)))
    chunk = 4 * elem if vec4 else elem
    if h > _BWD_HEADS or d > _BWD_WIDTH:
        raise ValueError(f"the GAT backward takes at most {_BWD_HEADS} heads and rows of "
                         f"{_BWD_WIDTH} elements, got {h} heads of {dh}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    build.call(
        "ample_attention_bwd", x.device,
        x.data_ptr(), elem, scale, zero, ld, g.data_ptr(), ptr(out), ptr(lse), ptr(scores),
        ptr(coeff), indices.data_ptr(), items.data_ptr(), int(items.shape[0]),
        res_a.data_ptr(), ptr(res_b), h, dh, chunk, int(attn), float(leaky_slope),
    )
    build.count_launch(ATTENTION_BWD)


def attend_tiles_bwd(
    z: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    g: torch.Tensor,  # f32[N, H, dh] gradient of the attention output
    out: torch.Tensor,  # f32[N, H, dh] the forward's output
    lse: torch.Tensor,  # f32[N, H] the forward's log-sum-exp
    scores: torch.Tensor,  # f32[E_graph, H] raw scores
    indices: torch.Tensor,  # int32[E_graph] sources, in-edge CSR order
    items: torch.Tensor,  # int32[R, 3] work items (``row_items``)
    *,
    leaky_slope: float,
    coeff: Optional[torch.Tensor] = None,  # f32[E_graph]; None: ones
    qp=None,
    alpha: Optional[torch.Tensor] = None,  # f32[E_graph, H]; None: zeros
    ds: Optional[torch.Tensor] = None,  # f32[E_graph, H]; None: zeros
):
    """The fused attention's per-edge backward over the edges of ``items``
    (``ref.attend_tiles_bwd_ref`` gives the formulas): (α, ds), each
    written for those edges only."""
    e, h = scores.shape
    if alpha is None:
        alpha = torch.zeros((e, h), dtype=torch.float32, device=g.device)
    if ds is None:
        ds = torch.zeros((e, h), dtype=torch.float32, device=g.device)
    if z.device.type == "cpu":
        return attend_tiles_bwd_ref(z, g, out, lse, scores, indices, items,
                                    leaky_slope=leaky_slope, coeff=coeff, qp=qp, alpha=alpha,
                                    ds=ds)
    _bwd_launch(True, z, qp, g, out, lse, scores, coeff, indices, items, alpha, ds, leaky_slope)
    return alpha, ds


def edge_dot(
    x: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    g: torch.Tensor,  # f32[N, H, dh] gradient of the aggregate
    indices: torch.Tensor,  # int32[E_graph]
    items: torch.Tensor,  # int32[R, 3]
    *,
    coeff: Optional[torch.Tensor] = None,  # f32[E_graph]; None: ones
    qp=None,
    out: Optional[torch.Tensor] = None,  # f32[E_graph, H]; None: zeros
) -> torch.Tensor:
    """The gradient of ``aggregate_tiles_mh``'s per-edge coefficients over
    the edges of ``items``: ``c · (g_i · x_j)`` per edge j → i and head."""
    if out is None:
        out = torch.zeros((indices.shape[0], g.shape[1]), dtype=torch.float32, device=g.device)
    if x.device.type == "cpu":
        return edge_dot_ref(x, g, indices, items, coeff=coeff, qp=qp, out=out)
    _bwd_launch(False, x, qp, g, None, None, None, coeff, indices, items, out, None, 0.0)
    return out
