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

``aggregate_autograd`` is the differentiable AGE of static-coefficient
plans, the same function on both devices. Its forward is the AGE on the
forward plans; its backward is the AGE on the transposed plan of the float
group (``scheduler.transpose_plan_graph``): for ``out = A x`` the gradient
is ``Aᵀ g``, a weighted segment sum over the reversed edges. The int8 group
gathers codes, whose ``round`` has zero derivative, so it passes ``x`` no
gradient and its scale ``Σ(g_I ⊙ out_I) / scale``, as the reference's jnp
path does under ``jax.grad``. With runtime coefficients each precision group
runs the multi-head kernel's autograd Function (``attn_ops``: the same
rules per group, and the coefficients' gradient from ``csrc/attn_agg_bwd.cu``),
given the group's ``attn_ops.TileGrad``; ``edge_scores`` gathers GAT's
per-node score halves onto the edges with a backward that sums them per
node on the forward and transposed plans, in a plan-static order.

``aggregate_bucket_plan`` and ``aggregate_padded_plan`` execute the baseline
schedules (degree buckets, double-buffered batches) in plain PyTorch, for the
comparison the paper makes; no kernel serves them, as none does in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
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
    "aggregate_autograd",
    "transposed_tile_plan",
    "plan_tile_grad",
    "aggregate_bucket_plan",
    "aggregate_padded_plan",
    "segment_max_edge_tiles",
    "edge_segment_sum_tiles",
    "edge_scores",
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


def to_device_plan(plan: sched.EdgeTilePlan, device, *, rows: Optional[int] = None
                   ) -> DeviceTilePlan:
    """Upload a tile plan; its split map is computed here, once per plan.
    ``rows``: the row count of what the plan gathers from (default the
    plan's ``num_nodes``)."""
    rows = plan.num_nodes if rows is None else rows
    if plan.gather_idx.size and (
        plan.gather_idx.min() < 0 or plan.gather_idx.max() >= max(rows, 1)
    ):
        raise ValueError(f"gather_idx outside [0, {rows})")
    split = seg_ops.split_segment_map(plan.out_node, plan.seg_ids, plan.num_nodes)

    def up(a, dtype):
        if not a.flags.writeable:  # a plan loaded with mmap_mode="r"
            a = np.array(a)
        return torch.as_tensor(a, dtype=dtype).to(device)

    return DeviceTilePlan(
        gather_idx=up(plan.gather_idx, torch.int32),
        coeff=up(plan.coeff, torch.float32),
        seg_ids=up(plan.seg_ids, torch.int32),
        out_node=up(plan.out_node, torch.int32),
        split=split.to(device),
        edge_ids=up(plan.edge_ids, torch.int32),
    )


def transposed_tile_plan(
    plan: sched.EdgeTilePlan, *, edges_per_tile: int, segments_per_tile: Optional[int],
    runtime: bool,
) -> sched.EdgeTilePlan:
    """The tile plan of ``plan``'s reversed edges (``scheduler.
    transpose_plan_graph``), the backward of an aggregation over ``plan``.
    Its lanes carry the forward's edge ids, so per-edge operands ``[E, …]``
    of the forward are read on it; a ``runtime`` plan keeps every real
    edge."""
    g, coeff, tags, eids = sched.transpose_plan_graph(plan, runtime=runtime)
    tp = sched.build_mixed_precision_plans(
        g, tags, edges_per_tile=edges_per_tile, segments_per_tile=segments_per_tile,
        coeff=coeff)["float"]
    lanes = tp.edge_ids
    fwd = eids[np.maximum(lanes, 0)] if eids.size else np.zeros_like(lanes)
    return dataclasses.replace(tp, edge_ids=np.where(lanes < 0, -1, fwd).astype(np.int32))


def plan_tile_grad(
    plan: sched.EdgeTilePlan, graph, indices: torch.Tensor,
    transposed: Callable[[], DeviceTilePlan],
) -> attn_ops.TileGrad:
    """What the backward of the GAT kernels on ``plan`` reads: ``graph``'s
    CSR sources ``indices`` (int32, on the device), the work items over the
    in-edges of the nodes the plan writes, each edge's static coefficient
    (None when all are 1, as in ``"runtime"`` plans) and ``transposed``,
    the reversed edges' device plan (called on first use)."""
    on = plan.out_node
    rows = np.unique(on[on < plan.num_nodes]).astype(np.int32)
    live = plan.edge_ids >= 0
    coeff = None
    if not np.all(plan.coeff[live] == 1.0):
        cf = np.zeros(graph.num_edges, np.float32)
        cf[plan.edge_ids[live]] = plan.coeff[live]
        coeff = torch.from_numpy(cf).to(indices.device)
    items = attn_ops.row_items(graph.indptr, rows)
    return attn_ops.TileGrad(indices, torch.from_numpy(items).to(indices.device), coeff,
                             transposed)


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
    grad: Optional[attn_ops.TileGrad] = None,
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
    it is; without, they go into zeros. Under grad, runtime coefficients
    need the plan's ``grad`` and take no ``out``.
    """
    if edge_coeff is not None and edge_coeff.dim() == 2:
        return attn_ops.aggregate_tiles_mh(
            x, dplan.gather_idx, dplan.edge_ids, edge_coeff.contiguous(), dplan.coeff,
            dplan.seg_ids, dplan.out_node, dplan.split, num_nodes=num_nodes, qp=qp, out=out,
            grad=grad)
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
            out=None if flat is None else flat.unsqueeze(1), grad=grad)
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
    values: torch.Tensor, dplan: DeviceTilePlan, *, num_nodes: int,
    grad: Optional[attn_ops.TileGrad] = None, aligned: bool = False,
) -> torch.Tensor:
    """Destination-segment sum of per-edge values over one plan's tiles:
    f32[N(, H)].

    The denominator pass of the segment softmax. The values are the per-head
    lane coefficients of the multi-head AGE over rows of ones (read through
    ``edge_ids``, padding lanes 0, static coeff one: ``1 · v`` is exact), so
    split nodes combine in tile order as in the aggregation, with no atomics.
    Under grad (values that require grad) it needs the plan's ``grad``;
    ``aligned`` sums each segment in lane order (``aggregate_tiles_mh``).
    """
    v = values if values.dim() == 2 else values.unsqueeze(-1)
    h = v.shape[-1]
    ones = torch.ones((num_nodes, h, 1), dtype=values.dtype, device=values.device)
    out = attn_ops.aggregate_tiles_mh(
        ones, dplan.gather_idx, dplan.edge_ids, v.contiguous(), None, dplan.seg_ids,
        dplan.out_node, dplan.split, num_nodes=num_nodes, grad=grad, aligned=aligned,
    )
    return out.view((num_nodes,) + tuple(values.shape[1:]))


def _segment_sums(values: torch.Tensor, plans, num_nodes: int) -> torch.Tensor:
    """``edge_segment_sum_tiles`` over plans with disjoint destinations, each
    segment in lane order, added in the order given."""
    total = None
    for p in plans:
        part = edge_segment_sum_tiles(values, p, num_nodes=num_nodes, aligned=True)
        total = part if total is None else total + part
    return total


class _EdgeScores(torch.autograd.Function):
    """``src_sc[src] + dst_sc[dst]`` forward; per-node sums of the edges'
    gradient on the transposed plans (sources) and the forward plans
    (destinations) backward."""

    @staticmethod
    def forward(ctx, src_sc, dst_sc, src, dst, plans, transposed, num_nodes):
        ctx.plans, ctx.transposed, ctx.num_nodes = plans, transposed, num_nodes
        return src_sc[src] + dst_sc[dst]

    @staticmethod
    def backward(ctx, ds):
        ds = ds.contiguous()
        d_src = d_dst = None
        if ctx.needs_input_grad[0]:
            d_src = _segment_sums(ds, [t() for t in ctx.transposed], ctx.num_nodes)
        if ctx.needs_input_grad[1]:
            d_dst = _segment_sums(ds, ctx.plans, ctx.num_nodes)
        return d_src, d_dst, None, None, None, None, None


def edge_scores(
    src_sc: torch.Tensor,  # f32[N(, H)] the source half of each node's score
    dst_sc: torch.Tensor,  # f32[N(, H)] the destination half
    src: torch.Tensor,  # int64[E] source of each edge
    dst: torch.Tensor,  # int64[E] destination of each edge
    dplans,  # device plans of the precision groups (disjoint destinations)
    transposed,  # one callable per group: its transposed device plan
    *,
    num_nodes: int,
) -> torch.Tensor:
    """GAT's raw per-edge scores ``src_sc[src] + dst_sc[dst]``: f32[E(, H)].

    Under grad the backward does not scatter-add with atomics, as indexing's
    would on the card: each node's gradient is its edges' sum by the
    multi-head walk, over the forward plans for ``dst_sc`` and over the
    transposed plans (lanes by source) for ``src_sc``, so two runs give the
    same bits. The forward is bitwise the plain indexing."""
    if attn_ops.wants_grad(src_sc, dst_sc):
        return _EdgeScores.apply(src_sc, dst_sc, src, dst, list(dplans), list(transposed),
                                 num_nodes)
    return src_sc[src] + dst_sc[dst]


def _device_buckets(buckets, device):
    """(gather_idx, coeff, node_ids) of each bucket as tensors on ``device``."""
    return [(torch.as_tensor(b.gather_idx, dtype=torch.int64, device=device),
             torch.as_tensor(b.coeff, dtype=torch.float32, device=device),
             torch.as_tensor(b.node_ids, dtype=torch.int64, device=device))
            for b in buckets]


def aggregate_bucket_plan(
    x: torch.Tensor, plan: sched.BucketPlan, *, op: str = "sum"
) -> torch.Tensor:
    """Degree-bucketed aggregation. op ∈ {sum, mean, max}.

    mean/GCN normalisation is normally folded into coeff; ``op='mean'`` here
    divides by the true lane count instead (used by GraphSAGE whose mean is
    over the *messages*, after φ). ``max`` masks padding lanes to -inf.
    Plain PyTorch on the device of ``x``, as the reference computes it in
    plain jnp (``repro/core/aggregation.py``).
    """
    n, d = plan.num_nodes, x.shape[1]
    fill = float("-inf") if op == "max" else 0.0
    out = torch.full((n + 1, d), fill, dtype=x.dtype, device=x.device)
    for gi, cf, ids in _device_buckets(plan.buckets, x.device):
        gathered = x[gi]  # [M, C, D]
        live = (cf != 0).unsqueeze(-1)
        if op == "max":
            red = torch.where(live, gathered, float("-inf")).amax(dim=1)
            out.scatter_reduce_(0, ids.unsqueeze(-1).expand(-1, d), red, "amax")
        elif op == "mean":
            cnt = (cf != 0).sum(dim=1, keepdim=True).clamp(min=1)
            out.index_add_(0, ids, (gathered * live).sum(dim=1) / cnt)
        else:
            out.index_add_(0, ids, (gathered * cf.unsqueeze(-1)).sum(dim=1))
    out = out[:n]
    if op == "max":
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out


def aggregate_padded_plan(x: torch.Tensor, plan: sched.PaddedPlan) -> torch.Tensor:
    """Double-buffer baseline: one padded batch at a time (distinct shapes per
    batch — the economics of static batching). Plain PyTorch on the device of
    ``x``; each call uploads the batches' arrays, as the reference does."""
    out = torch.zeros((plan.num_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    for gi, cf, ids in _device_buckets(plan.batches, x.device):
        out[ids] = (x[gi] * cf.unsqueeze(-1)).sum(dim=1)
    return out


def aggregate_mixed_precision(
    x: torch.Tensor,
    plans: Dict[str, sched.EdgeTilePlan],
    *,
    num_nodes: int,
    qp: Optional[QuantParams] = None,
    device_plans: Optional[Dict[str, DeviceTilePlan]] = None,
    edge_coeff: Optional[torch.Tensor] = None,
    grads: Optional[Dict[str, attn_ops.TileGrad]] = None,
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
    Under grad, runtime coefficients need each group's ``grads`` entry.
    """
    device_plans = device_plans or {}
    dplans = {tag: device_plans.get(tag) or to_device_plan(p, x.device)
              for tag, p in plans.items()}
    if "int8" in plans and qp is None:
        qp = compute_scale_zp(x, symmetric=True)
    return _aggregate_groups(x, dplans, num_nodes=num_nodes, qp=qp, edge_coeff=edge_coeff,
                             grads=grads)


def _aggregate_groups(
    x: torch.Tensor,
    dplans: Dict[str, DeviceTilePlan],
    *,
    num_nodes: int,
    qp: Optional[QuantParams],
    edge_coeff: Optional[torch.Tensor] = None,
    grads: Optional[Dict[str, attn_ops.TileGrad]] = None,
) -> torch.Tensor:
    """Each precision group's rows into one zero-filled output: the float
    group on ``x``, the int8 group on its codes under ``qp``. With
    ``grads`` (runtime coefficients under grad) each group's autograd
    Function returns its own output, and the groups' disjoint rows are
    added."""
    for tag in dplans:
        if tag not in ("float", "int8"):
            raise ValueError(f"unknown precision tag {tag!r}")
    if grads is not None:
        out = None
        for tag in ("float", "int8"):
            if tag in dplans:
                rows, rows_qp = (x, None) if tag == "float" else (_int8_rows(x, qp), qp)
                part = aggregate_edge_tiles(rows, dplans[tag], num_nodes=num_nodes,
                                            edge_coeff=edge_coeff, qp=rows_qp, grad=grads[tag])
                out = part if out is None else out + part
        return out
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    if "float" in dplans:
        aggregate_edge_tiles(x, dplans["float"], num_nodes=num_nodes, edge_coeff=edge_coeff,
                             out=out)
    if "int8" in dplans:
        aggregate_edge_tiles(_int8_rows(x, qp), dplans["int8"], num_nodes=num_nodes,
                             edge_coeff=edge_coeff, qp=qp, out=out)
    return out


class _AggregateTiles(torch.autograd.Function):
    """``_aggregate_groups`` forward; the AGE on the transposed plan backward."""

    @staticmethod
    def forward(ctx, x, scale, dplans, transposed, num_nodes, qp):
        out = _aggregate_groups(x, dplans, num_nodes=num_nodes, qp=qp)
        ctx.dplans, ctx.transposed, ctx.num_nodes = dplans, transposed, num_nodes
        ctx.x_shape = x.shape
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(out, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        gx = gscale = None
        if ctx.needs_input_grad[0]:
            if "float" in ctx.dplans:
                gx = aggregate_edge_tiles(g.contiguous(), ctx.transposed(),
                                          num_nodes=ctx.num_nodes)
            else:  # codes only: round() passes no gradient
                gx = torch.zeros(ctx.x_shape, dtype=torch.float32, device=g.device)
        if ctx.needs_input_grad[1]:
            # d out_I / d scale = out_I / scale: the int8 rows are (q - z) · scale.
            out, scale = ctx.saved_tensors
            on = ctx.dplans["int8"].out_node
            rows = torch.unique(on[on < ctx.num_nodes]).long()
            gscale = (g[rows] * out[rows]).sum_to_size(scale.shape) / scale
        return gx, gscale, None, None, None, None


def aggregate_autograd(
    x: torch.Tensor,
    device_plans: Dict[str, DeviceTilePlan],
    transposed: Callable[[], DeviceTilePlan],
    *,
    num_nodes: int,
    qp: Optional[QuantParams] = None,
) -> torch.Tensor:
    """The AGE over static-coefficient plans, with a backward.

    The forward is ``aggregate_mixed_precision`` on the uploaded
    ``device_plans`` (a float-only engine passes ``{"float": …}``), bitwise.
    ``transposed()`` returns the device plan of the float group's reversed
    edges (``scheduler.transpose_plan_graph``), called on the first backward;
    the backward runs the AGE on it, so on the card the gradient is the
    kernel again, with grad off. ``qp`` (needed with an int8 group) may carry a scale that
    requires grad: it receives ``Σ(g_I ⊙ out_I) / scale`` and autograd
    carries that on through its calibration. A zero point that requires grad
    is refused (the engine's calibration is symmetric).
    """
    if "int8" in device_plans and qp is None:
        raise ValueError("an int8 group needs its QuantParams")
    if qp is not None and qp.zero_point.requires_grad:
        raise ValueError("no gradient for the zero point: calibrate symmetrically")
    return _AggregateTiles.apply(x, None if qp is None else qp.scale, device_plans,
                                 transposed, num_nodes, qp)


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
