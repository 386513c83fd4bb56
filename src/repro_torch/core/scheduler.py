"""Event-driven execution planning — the host half of AMPLE's NID/nodeslots.

A copy of the reference planner (``repro/core/scheduler.py``) restricted to
what the mixed-precision serving path reads: the fingerprints that key the
serving caches, the event-driven ``EdgeTilePlan`` and the functions that
build it, and the per-precision split. It is numpy only, so the port and the reference emit
byte-identical tile arrays for the same graph (the parity tests check it);
``build_edge_tile_plan`` packs the reference's greedy loop's tiles with
array operations over the edge stream, with no loop over nodes.

* ``EdgeTilePlan`` — edges packed back-to-back into tiles of
  ``edges_per_tile`` lanes; a node whose degree exceeds the remaining lane
  budget of the current tile is *split across tiles* and its aggregate is
  assembled from the per-tile partials — the Feature Bank's partial-response
  mechanism (§3.3 of the paper).
* ``build_mixed_precision_plans`` partitions nodes by their Degree-Quant tag
  and emits one plan per precision group (§3.2).
* ``transpose_plan_graph`` reverses one plan's edges, the graph of its
  backward: the gradient of a weighted segment sum is the same sum over the
  transposed edges, each carrying its forward edge id (port only: the
  reference differentiates its jnp path).
* ``BucketPlan`` / ``PaddedPlan`` — the baselines the paper argues against:
  power-of-two degree buckets, and the double-buffered (HyGCN-style) fixed
  batches padded to their largest degree (``AmpleEngine.occupancy_report``
  and the ``aggregate_bucket_plan`` / ``aggregate_padded_plan`` executors).
* ``ChunkSchedule`` — the prefetcher's programming for out-of-core serving:
  the feature chunks each tile gathers and a locality order that permutes
  whole runs (``tile_runs``); ``pack_tiles_by_chunk`` rebuilds tile
  membership around chunks (``pack_segments`` packs the units).
* Sharded execution: ``partition_fingerprint`` and ``shard_plan_fingerprint``
  key the per-shard plan caches; ``split_plan_by_halo`` splits a shard's
  plan at run granularity into the tiles that read only owned rows and the
  tiles that read halo rows (the overlapped halo exchange).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = [
    "Bucket",
    "BucketPlan",
    "ChunkSchedule",
    "EdgeTilePlan",
    "PaddedPlan",
    "build_bucket_plan",
    "build_chunk_schedule",
    "build_edge_tile_plan",
    "build_mixed_precision_plans",
    "build_padded_plan",
    "concat_tile_plans",
    "graph_fingerprint",
    "pack_segments",
    "pack_tiles_by_chunk",
    "partition_fingerprint",
    "plan_fingerprint",
    "shard_plan_fingerprint",
    "size_class",
    "split_plan_by_halo",
    "tile_runs",
    "transpose_plan_graph",
    "union_bucket_fingerprint",
]


# ---------------------------------------------------------------------------
# Plan fingerprinting — the cache key of the serving layer
# ---------------------------------------------------------------------------


def graph_fingerprint(g: Graph) -> str:
    """Structure hash of a graph (topology only, not features).

    Two graphs with identical (num_nodes, indptr, indices) — hence identical
    CSR structure — hash identically, so a compiled ExecutionPlan for one is
    valid for the other. Edge weights and features are runtime inputs, not
    plan inputs, and are deliberately excluded.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(g.num_nodes).tobytes())
    h.update(np.ascontiguousarray(g.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.indices, dtype=np.int32).tobytes())
    return h.hexdigest()


def plan_fingerprint(g: Graph, *parts: str) -> str:
    """Fingerprint of (graph structure, planner configuration) pairs.

    ``parts`` are deterministic strings describing everything that shapes the
    compiled plan beyond topology: the EngineConfig repr, the coefficient
    modes, the arch. Same fingerprint ⇒ the planner would emit identical
    tiles, so the plan may be served from cache.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_fingerprint(g).encode())
    for p in parts:
        h.update(b"\x00")
        h.update(str(p).encode())
    return h.hexdigest()


def partition_fingerprint(g: Graph, part) -> str:
    """Hash of (graph structure, shard assignment, partitioner identity).

    ``part`` is a ``graphs.partition.Partition``. The hash covers the block
    boundaries, the node permutation (when the assignment is
    non-contiguous), and the partitioner ``kind`` string — including its
    parameters — so plan caches can never serve a plan compiled under a
    different partitioner that happened to emit the same boundaries.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_fingerprint(g).encode())
    h.update(b"\x00part:")
    h.update(np.ascontiguousarray(part.starts, dtype=np.int64).tobytes())
    h.update(b"\x00kind:")
    h.update(str(part.kind).encode())
    if part.order is not None:
        h.update(b"\x00order:")
        h.update(np.ascontiguousarray(part.order, dtype=np.int64).tobytes())
    return h.hexdigest()


def shard_plan_fingerprint(g: Graph, part, shard: int, *parts: str) -> str:
    """Fingerprint of one shard's compiled plan within a partitioned graph.

    Extends ``partition_fingerprint`` with the shard index and the planner
    configuration strings (EngineConfig repr, modes, arch …). This is the key
    the serving layer caches per-shard plans under: repeat traffic on the same
    (structure, partition) pair hits every shard independently.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(partition_fingerprint(g, part).encode())
    h.update(f"\x00shard:{int(shard)}".encode())
    for p in parts:
        h.update(b"\x00")
        h.update(str(p).encode())
    return h.hexdigest()


def size_class(
    num_nodes: int, num_edges: int, node_bucket: int, edge_bucket: int
) -> Tuple[int, int]:
    """Round a (nodes, edges) pair up to its padded size class.

    A bucket of 0 (or negative) leaves that dimension exact. Size classes are
    the continuous-batching analogue of AMPLE's fixed nodeslot count: padding
    a disjoint-union batch up to the class boundary trades a bounded amount
    of wasted lanes for device-call shapes that recur across different member
    mixes, so the device buffers and the plan cache both stop churning.
    """
    n = int(num_nodes)
    e = int(num_edges)
    if node_bucket > 0:
        n = max(((n + node_bucket - 1) // node_bucket) * node_bucket, node_bucket)
    if edge_bucket > 0:
        e = max(((e + edge_bucket - 1) // edge_bucket) * edge_bucket, edge_bucket)
    return n, e


def union_bucket_fingerprint(
    num_nodes: int,
    num_edges: int,
    node_bucket: int,
    edge_bucket: int,
    *parts: str,
) -> str:
    """Fingerprint of a padded union's **size class**, not its member mix.

    Two disjoint-union batches whose (nodes, edges) land in the same bucket —
    under the same planner configuration ``parts`` — hash identically, even
    when their member graphs differ. The serving layer keys its class-level
    cache on this, so warm size classes skip shape-dependent work (device
    uploads) however the admission window recomposed the batch;
    the member-level plan pieces carry the structure-exact identity.

    Granularity caveat: the class is keyed on the **total** edge count, while
    mixed-precision plans pad tiles per precision group — two mixes in one
    class whose float/int8 edge split straddles a tile-bucket boundary still
    get different tile counts. A warm class is therefore an upper bound on shape
    reuse under ``mixed_precision``; it is exact under the float policy.
    """
    n, e = size_class(num_nodes, num_edges, node_bucket, edge_bucket)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"class:{n}:{e}:{int(node_bucket)}:{int(edge_bucket)}".encode())
    for p in parts:
        h.update(b"\x00")
        h.update(str(p).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Event-driven schedule: edge tiles (compute ∝ number of edges)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeTilePlan:
    """Dense tile arrays consumed by the aggregation engine / AGE kernel.

    Shapes: T = num_tiles, E = edges_per_tile, S = segments_per_tile.

      gather_idx: int32[T, E]  source node id per lane (0 where invalid).
      coeff:      f32[T, E]    per-edge weight; 0 on invalid lanes, so it acts
                               as both the aggregation coefficient (GCN norm,
                               1/deg for mean, 1 for sum) and the lane mask.
      seg_ids:    int32[T, E]  local segment (nodeslot) within the tile.
      out_node:   int32[T, S]  global node each local segment accumulates into;
                               sentinel ``num_nodes`` for unused segments.
      node_ids:   int32[M]     nodes covered by this plan (plan may cover a
                               precision subset of the graph).
      edge_ids:   int32[T, E]  graph edge index (CSR position) per lane; -1 on
                               padding lanes. The runtime-coefficient
                               indirection: a per-edge vector computed at
                               request time (GAT attention) is scattered into
                               tile layout through this map, so plans stay
                               structure-keyed while coefficients change every
                               request.
    """

    gather_idx: np.ndarray
    coeff: np.ndarray
    seg_ids: np.ndarray
    out_node: np.ndarray
    node_ids: np.ndarray
    edge_ids: np.ndarray
    num_nodes: int  # of the full graph (scatter target row count)
    edges_per_tile: int
    segments_per_tile: int
    total_edges: int  # real (unpadded) edges covered

    @property
    def num_tiles(self) -> int:
        return int(self.gather_idx.shape[0])

    @property
    def lane_occupancy(self) -> float:
        """Fraction of gather lanes carrying a real edge (1.0 = no gaps)."""
        lanes = self.gather_idx.size
        return float(self.total_edges) / float(lanes) if lanes else 1.0


def build_edge_tile_plan(
    g: Graph,
    *,
    edges_per_tile: int = 256,
    segments_per_tile: Optional[int] = None,
    coeff: Optional[np.ndarray] = None,
    node_ids: Optional[np.ndarray] = None,
    sort_by_degree: bool = True,
) -> EdgeTilePlan:
    """Pack (a subset of) a graph's edges into dense tiles.

    Nodes are visited longest-first by default (LPT list scheduling — the same
    greedy order the event-driven NID induces, since long nodes start early and
    short nodes backfill slots). Packing is first-fit into the current tile;
    a node overflowing the tile is split (partial response). Segment budget per
    tile bounds the scatter fan-out.
    """
    if node_ids is None:
        node_ids = np.arange(g.num_nodes, dtype=np.int64)
    else:
        node_ids = np.asarray(node_ids, np.int64)
    deg = g.degrees
    if coeff is None:
        coeff = np.ones(g.num_edges, np.float32)
    if segments_per_tile is None:
        # A tile can hold up to one segment per lane (all degree-1 nodes), so a
        # full segment budget keeps lane occupancy ~1 regardless of degree mix;
        # callers with scatter-bandwidth concerns can lower it.
        segments_per_tile = edges_per_tile

    order = node_ids
    if sort_by_degree:
        order = node_ids[np.argsort(-deg[node_ids], kind="stable")]

    # The nodes with edges in visiting order, their edges back to back: one
    # lane stream that the tiles cut (zero-degree nodes contribute nothing;
    # their output rows stay 0).
    E, S = edges_per_tile, segments_per_tile
    nodes = order[deg[order] > 0]
    d = deg[nodes].astype(np.int64)
    ends = np.cumsum(d)
    total = int(ends[-1]) if ends.size else 0
    starts = _tile_starts(ends, total, E, S)
    nt = starts.size
    tile = np.repeat(np.arange(nt), np.diff(np.append(starts, total)))
    pos = np.arange(total)
    lane = pos - starts[tile]
    owner = np.repeat(np.arange(nodes.size), d)
    eid = np.asarray(g.indptr, np.int64)[nodes][owner] + (pos - (ends - d)[owner])
    # A segment opens at each node's first lane and again at the first lane
    # of each tile (a split node re-opens a fresh segment in the next tile).
    opens = lane == 0
    opens[1:] |= owner[1:] != owner[:-1]
    seg = np.cumsum(opens) - 1
    seg -= seg[starts[tile]]
    flat = tile * E + lane

    gather_idx = np.zeros(nt * E, np.int32)
    gather_idx[flat] = g.indices[eid]
    lane_coeff = np.zeros(nt * E, np.float32)
    lane_coeff[flat] = coeff[eid]
    seg_ids = np.full(nt * E, S - 1, np.int32)
    seg_ids[flat] = seg
    edge_ids = np.full(nt * E, -1, np.int32)
    edge_ids[flat] = eid
    out_node = np.full(nt * S, g.num_nodes, np.int32)
    out_node[tile[opens] * S + seg[opens]] = nodes[owner[opens]]

    return EdgeTilePlan(
        gather_idx=gather_idx.reshape(nt, E),
        coeff=lane_coeff.reshape(nt, E),
        seg_ids=seg_ids.reshape(nt, E),
        out_node=out_node.reshape(nt, S),
        node_ids=node_ids.astype(np.int32),
        edge_ids=edge_ids.reshape(nt, E),
        num_nodes=g.num_nodes,
        edges_per_tile=E,
        segments_per_tile=S,
        total_edges=total,
    )


def _tile_starts(ends: np.ndarray, total: int, E: int, S: int) -> np.ndarray:
    """First stream lane of each tile: a tile closes when its ``E`` lanes are
    full or when an ``S + 1``-th segment would open in it (node ``k``'s run
    of the stream ends at ``ends[k]``). One empty tile when there are no
    edges, which keeps shapes static."""
    if S >= E or total == 0:  # a segment holds a lane: only the lanes close a tile
        return np.arange(0, max(total, 1), E, dtype=np.int64)
    starts = []
    p = 0
    while p < total:
        starts.append(p)
        k = int(np.searchsorted(ends, p, side="right"))  # the node of lane p
        p = min(p + E, int(ends[k + S - 1]) if k + S - 1 < ends.size else total)
    return np.asarray(starts, np.int64)


def concat_tile_plans(
    plans: Sequence[EdgeTilePlan],
    node_offsets: Sequence[int],
    *,
    num_nodes: int,
    min_tiles: int = 0,
    edge_offsets: Optional[Sequence[int]] = None,
) -> EdgeTilePlan:
    """Stack member tile plans into one union plan by offsetting node ids.

    This is the incremental half of padded disjoint-union batching: each
    member graph's tiles were packed once (and cached) by
    ``build_edge_tile_plan``; composing a new batch is pure array relabelling
    — member ``k``'s gather/out indices shift by ``node_offsets[k]``, its
    segment sentinel (the member's node count) is remapped to the union
    sentinel ``num_nodes`` — so no planner runs however the admission window
    recomposes the batch. The cost is that each member's last, partially
    filled tile keeps its padding lanes (bounded by one tile per member).

    ``edge_offsets`` relabels each member's ``edge_ids`` into the union's
    edge index space (one offset per member: the cumulative edge count of
    the member *graphs* before it — not of the plans, which may cover a
    precision subset of their graph's edges). Valid lanes shift by the
    offset; padding lanes stay -1. Omitted, the union plan's ``edge_ids``
    are all -1: structurally complete but opted out of runtime
    coefficients (the historical behaviour).

    ``min_tiles`` pads the stacked plan with all-invalid tiles (coeff 0,
    sentinel segments, edge id -1) up to a tile-count bucket, giving
    recurring device shapes across batches in the same size class.
    """
    if not plans:
        raise ValueError("concat_tile_plans of no plans")
    if len(plans) != len(node_offsets):
        raise ValueError("one node offset per member plan required")
    if edge_offsets is not None and len(plans) != len(edge_offsets):
        raise ValueError("one edge offset per member plan required")
    E = plans[0].edges_per_tile
    S = plans[0].segments_per_tile
    for p in plans:
        if p.edges_per_tile != E or p.segments_per_tile != S:
            raise ValueError("member plans disagree on tile geometry")
    gather, coeff, segs, outs, node_ids, eids = [], [], [], [], [], []
    total_edges = 0
    for k, (p, off) in enumerate(zip(plans, node_offsets)):
        off = int(off)
        if off + p.num_nodes > num_nodes:
            raise ValueError(
                f"member plan spans nodes [{off}, {off + p.num_nodes}) beyond "
                f"union num_nodes {num_nodes}"
            )
        # Invalid lanes (coeff 0) keep whatever row they point at — offsetting
        # them too is safe and keeps this a single vectorised add.
        gather.append(p.gather_idx.astype(np.int64) + off)
        coeff.append(p.coeff)
        segs.append(p.seg_ids)
        outs.append(
            np.where(p.out_node == p.num_nodes, num_nodes, p.out_node + off)
        )
        node_ids.append(p.node_ids.astype(np.int64) + off)
        if edge_offsets is None:
            eids.append(np.full(p.edge_ids.shape, -1, np.int64))
        else:
            e_off = int(edge_offsets[k])
            eids.append(
                np.where(p.edge_ids < 0, -1, p.edge_ids.astype(np.int64) + e_off)
            )
        total_edges += p.total_edges
    n_tiles = sum(p.num_tiles for p in plans)
    if min_tiles > n_tiles:
        pad = min_tiles - n_tiles
        gather.append(np.zeros((pad, E), np.int64))
        coeff.append(np.zeros((pad, E), np.float32))
        segs.append(np.full((pad, E), S - 1, np.int32))
        outs.append(np.full((pad, S), num_nodes, np.int64))
        eids.append(np.full((pad, E), -1, np.int64))
    return EdgeTilePlan(
        gather_idx=np.concatenate(gather).astype(np.int32),
        coeff=np.concatenate(coeff),
        seg_ids=np.concatenate(segs).astype(np.int32),
        out_node=np.concatenate(outs).astype(np.int32),
        node_ids=np.concatenate(node_ids).astype(np.int32),
        edge_ids=np.concatenate(eids).astype(np.int32),
        num_nodes=num_nodes,
        edges_per_tile=E,
        segments_per_tile=S,
        total_edges=total_edges,
    )


# ---------------------------------------------------------------------------
# Degree buckets (power-of-two capacities)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bucket:
    capacity: int
    node_ids: np.ndarray  # int32[M]
    gather_idx: np.ndarray  # int32[M, capacity]
    coeff: np.ndarray  # f32[M, capacity] (0 on padding lanes)

    @property
    def num_nodes(self) -> int:
        return int(self.node_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    num_nodes: int

    @property
    def lane_occupancy(self) -> float:
        lanes = sum(b.gather_idx.size for b in self.buckets)
        edges = sum(int((b.coeff != 0).sum()) for b in self.buckets)
        return edges / lanes if lanes else 1.0


def build_bucket_plan(
    g: Graph,
    *,
    max_capacity: int = 1 << 14,
    coeff: Optional[np.ndarray] = None,
    node_ids: Optional[np.ndarray] = None,
) -> BucketPlan:
    """Group nodes into power-of-two-capacity degree buckets.

    A node of degree d lands in the bucket of capacity 2^⌈log2 d⌉ (≥ that
    degree); nodes above ``max_capacity`` are clamped into the top bucket and
    split across rows (rare hubs). Lane waste is < 2× by construction.
    """
    if node_ids is None:
        node_ids = np.arange(g.num_nodes, dtype=np.int64)
    else:
        node_ids = np.asarray(node_ids, np.int64)
    if coeff is None:
        coeff = np.ones(g.num_edges, np.float32)
    deg = g.degrees[node_ids]
    buckets: List[Bucket] = []
    active = node_ids[deg > 0]
    if active.size:
        adeg = g.degrees[active]
        caps = 1 << np.ceil(np.log2(adeg.clip(min=1))).astype(np.int64)
        caps = caps.clip(min=1, max=max_capacity)
        for cap in np.unique(caps):
            sel = active[caps == cap]
            rows: List[np.ndarray] = []
            cfr: List[np.ndarray] = []
            ids: List[int] = []
            for v in sel:
                lo, hi = int(g.indptr[v]), int(g.indptr[v + 1])
                nbrs, cfs = g.indices[lo:hi], coeff[lo:hi]
                for pos in range(0, hi - lo, int(cap)):
                    chunk = nbrs[pos : pos + int(cap)]
                    cchunk = cfs[pos : pos + int(cap)]
                    row = np.zeros(int(cap), np.int32)
                    crow = np.zeros(int(cap), np.float32)
                    row[: chunk.size] = chunk
                    crow[: cchunk.size] = cchunk
                    rows.append(row)
                    cfr.append(crow)
                    ids.append(int(v))
            buckets.append(
                Bucket(
                    capacity=int(cap),
                    node_ids=np.asarray(ids, np.int32),
                    gather_idx=np.stack(rows),
                    coeff=np.stack(cfr),
                )
            )
    return BucketPlan(buckets=tuple(buckets), num_nodes=g.num_nodes)


# ---------------------------------------------------------------------------
# Double-buffered baseline (HyGCN-style): fixed batches, max-degree padding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PaddedPlan:
    """Batches of ``batch_size`` nodeslots padded to the batch max degree."""

    batches: Tuple[Bucket, ...]  # reuse Bucket container (capacity = batch max)
    num_nodes: int
    batch_size: int

    @property
    def pipeline_gap_ratio(self) -> float:
        """Fraction of lane-cycles wasted waiting on the batch straggler."""
        lanes = sum(b.gather_idx.size for b in self.batches)
        edges = sum(int((b.coeff != 0).sum()) for b in self.batches)
        return 1.0 - (edges / lanes) if lanes else 0.0


def build_padded_plan(
    g: Graph,
    *,
    batch_size: int = 64,
    coeff: Optional[np.ndarray] = None,
    node_ids: Optional[np.ndarray] = None,
) -> PaddedPlan:
    """The double-buffering baseline: node order as given (no degree sort —
    HyGCN streams nodes in id order), each batch padded to its max degree."""
    if node_ids is None:
        node_ids = np.arange(g.num_nodes, dtype=np.int64)
    else:
        node_ids = np.asarray(node_ids, np.int64)
    if coeff is None:
        coeff = np.ones(g.num_edges, np.float32)
    batches: List[Bucket] = []
    for start in range(0, node_ids.size, batch_size):
        sel = node_ids[start : start + batch_size]
        cap = int(g.degrees[sel].max()) if sel.size else 1
        cap = max(cap, 1)
        gi = np.zeros((sel.size, cap), np.int32)
        cf = np.zeros((sel.size, cap), np.float32)
        for r, v in enumerate(sel):
            lo, hi = int(g.indptr[v]), int(g.indptr[v + 1])
            gi[r, : hi - lo] = g.indices[lo:hi]
            cf[r, : hi - lo] = coeff[lo:hi]
        batches.append(
            Bucket(
                capacity=cap,
                node_ids=sel.astype(np.int32),
                gather_idx=gi,
                coeff=cf,
            )
        )
    return PaddedPlan(
        batches=tuple(batches), num_nodes=g.num_nodes, batch_size=batch_size
    )


# ---------------------------------------------------------------------------
# Mixed precision: one plan per Degree-Quant precision group
# ---------------------------------------------------------------------------


def build_mixed_precision_plans(
    g: Graph,
    precision_tags: np.ndarray,
    *,
    edges_per_tile: int = 256,
    segments_per_tile: Optional[int] = None,
    coeff: Optional[np.ndarray] = None,
) -> Dict[str, EdgeTilePlan]:
    """Split nodes by precision tag and build an EdgeTilePlan per group.

    ``precision_tags``: array[N] of strings or small ints; conventionally
    ``"float"`` for Degree-Quant-protected nodes and ``"int8"`` for the rest
    (Table 2's Precision column). Empty groups are omitted.
    """
    precision_tags = np.asarray(precision_tags)
    plans: Dict[str, EdgeTilePlan] = {}
    for tag in np.unique(precision_tags):
        ids = np.nonzero(precision_tags == tag)[0]
        if ids.size == 0:
            continue
        plans[str(tag)] = build_edge_tile_plan(
            g,
            edges_per_tile=edges_per_tile,
            segments_per_tile=segments_per_tile,
            coeff=coeff,
            node_ids=ids,
        )
    return plans


def transpose_plan_graph(
    plan: EdgeTilePlan, *, runtime: bool = False
) -> Tuple[Graph, np.ndarray, np.ndarray, np.ndarray]:
    """The reversed edges of one plan: (graph, coeff, tags, edge_ids).

    The plan's live lanes are the edges ``src → dst`` of its group (``dst``
    in the group, ``src`` anywhere) with their coefficients. The result is
    the in-edge CSR ``Graph`` of the edges ``dst → src`` over all
    ``plan.num_nodes`` nodes (rows by ``src``, each row's sources by ``dst``,
    lanes of equal edges in plan order), the forward coefficients permuted
    onto it, tags that put every node in one group (``"float"``), and each
    reversed edge's forward graph edge id (the plan's ``edge_ids``), so that
    per-edge operands of the forward ``[E, …]`` are read on the transposed
    plan through them. ``build_mixed_precision_plans(graph, tags,
    coeff=coeff)`` then plans the backward: its aggregate of ``g`` is Aᵀ g
    for the forward's A. The coefficients are the forward edges' own, not
    ones recomputed on the reversed graph (whose degrees differ).

    Which lanes are live: for a static plan, lanes of coefficient 0 (padding,
    or an edge that adds nothing) are left out, as they move no gradient;
    for a ``runtime`` plan, whose coefficient is only a lane mask for values
    that arrive per call, every real edge (edge id >= 0) stays and only the
    padding goes.
    """
    n = plan.num_nodes
    dst = np.take_along_axis(plan.out_node, plan.seg_ids, axis=1)
    live = (dst < n) & ((plan.edge_ids >= 0) if runtime else (plan.coeff != 0))
    src = plan.gather_idx[live].astype(np.int64)
    dst = dst[live].astype(np.int64)
    coeff = plan.coeff[live]
    eids = plan.edge_ids[live]
    # by src, then dst; stable: equal edges keep plan order
    order = np.argsort(src * n + dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    g = Graph(indptr=indptr, indices=dst[order].astype(np.int32), num_nodes=n,
              name="transposed")
    return (g, np.ascontiguousarray(coeff[order], np.float32), np.full(n, "float"),
            np.ascontiguousarray(eids[order], np.int32))


# ---------------------------------------------------------------------------
# Chunk-access schedule — the prefetcher's programming (out-of-core serving)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """An EdgeTilePlan annotated with the feature chunks each tile gathers.

    This is the host-side programming of the prefetcher (§3.3): the feature
    matrix is split into ``chunk_rows``-row chunks, every tile is annotated
    with the sorted chunk ids its gather lanes touch (all lanes, including
    invalid coeff-0 lanes — those still read a row, and their ±0 products
    must reproduce bitwise), and tiles are emitted in an execution ``order``
    chosen to raise chunk reuse between consecutive tiles.

    ``order`` only ever permutes whole *runs* (see :func:`tile_runs`): a node
    split across tiles lands in consecutive tiles, so keeping runs intact
    preserves each output row's scatter-add order — the streamed executor is
    bitwise-identical to the in-memory scan however the runs are permuted.
    """

    chunk_rows: int
    num_chunks: int
    order: np.ndarray  # int64[T] tile execution order (permutes whole runs)
    tile_chunks: Tuple[np.ndarray, ...]  # per plan-tile sorted unique chunk ids
    runs: np.ndarray  # int64[R+1] run boundaries over plan tile indices
    # Precomputed per-lane (chunk, offset) split of every tile's gather
    # indices — plan-static, so warm streamed requests skip the divmod the
    # prefetcher used to redo per tile per request.
    lane_chunk: np.ndarray  # int32[T, E] gather_idx // chunk_rows
    lane_off: np.ndarray  # int32[T, E] gather_idx % chunk_rows

    @property
    def num_tiles(self) -> int:
        return int(self.order.shape[0])

    @property
    def num_runs(self) -> int:
        return int(self.runs.shape[0]) - 1

    @property
    def total_chunk_visits(self) -> int:
        """Σ over tiles of chunks touched — uploads if nothing were cached."""
        return int(sum(c.size for c in self.tile_chunks))

    def max_tile_chunks(self) -> int:
        """Largest single-tile working set (waves needed = ceil(this/slots))."""
        return int(max((c.size for c in self.tile_chunks), default=0))


def tile_runs(plan: EdgeTilePlan) -> np.ndarray:
    """Boundaries of split-chains: maximal spans of tiles sharing an out node.

    ``build_edge_tile_plan`` splits an overflowing node across *consecutive*
    tiles (the partial-response mechanism), so a run is the unit that may be
    reordered without perturbing any output row's accumulation order: within
    a run the split node's partial sums stay in tile order, and no node spans
    two runs. Returns int64[num_runs + 1] half-open boundaries.
    """
    T = plan.num_tiles
    bounds = [0]
    sentinel = plan.num_nodes
    for t in range(1, T):
        prev = plan.out_node[t - 1]
        cur = plan.out_node[t]
        prev_valid = prev[prev != sentinel]
        cur_valid = cur[cur != sentinel]
        if prev_valid.size and cur_valid.size and np.intersect1d(
            prev_valid, cur_valid, assume_unique=False
        ).size:
            continue  # a node spans the boundary: same run
        bounds.append(t)
    bounds.append(T)
    return np.asarray(bounds, np.int64)


def split_plan_by_halo(
    plan: EdgeTilePlan, num_owned: int
) -> Tuple[EdgeTilePlan, EdgeTilePlan]:
    """Split a shard-local tile plan into (interior, boundary) halves.

    *Interior* tiles gather only owned rows (local id < ``num_owned``);
    *boundary* tiles touch at least one halo source. The split is at **run**
    granularity (``tile_runs``): a node split across consecutive tiles stays
    within one run, so every output row's partial sums live entirely in one
    half and executing interior-then-boundary (the boundary scan continuing
    from the interior output buffer) reproduces the unsplit scan **bitwise**
    — the property the overlapped halo exchange relies on. The interior half
    can therefore run before the halo rows arrive (they may be zeros), which
    is what hides the exchange latency.

    Padding lanes (edge id −1 / coeff 0) gather row 0 and never force a run
    into the boundary half. Either half may be empty (0 tiles).
    """
    bounds = tile_runs(plan)
    real = plan.edge_ids >= 0
    touches_halo = np.any(real & (plan.gather_idx >= num_owned), axis=1)
    interior_tiles: list = []
    boundary_tiles: list = []
    for r in range(bounds.shape[0] - 1):
        t0, t1 = int(bounds[r]), int(bounds[r + 1])
        dest = boundary_tiles if np.any(touches_halo[t0:t1]) else interior_tiles
        dest.extend(range(t0, t1))

    def subset(tiles) -> EdgeTilePlan:
        idx = np.asarray(tiles, np.int64)
        return dataclasses.replace(
            plan,
            gather_idx=plan.gather_idx[idx],
            coeff=plan.coeff[idx],
            seg_ids=plan.seg_ids[idx],
            out_node=plan.out_node[idx],
            edge_ids=plan.edge_ids[idx],
            total_edges=int(np.sum(real[idx])) if idx.size else 0,
        )

    return subset(interior_tiles), subset(boundary_tiles)


def build_chunk_schedule(
    plan: EdgeTilePlan,
    chunk_rows: int,
    *,
    reorder: bool = True,
) -> ChunkSchedule:
    """Annotate a tile plan with chunk accesses and a locality-aware order.

    The reordering pass sorts *runs* by the median chunk id their tiles
    gather from — runs whose accesses centre on the same region of the
    feature matrix execute back-to-back, so a budget-bound chunk cache sees
    longer reuse chains (an O(T log T) clustering heuristic; Belady eviction
    in the prefetcher does the rest). ``reorder=False`` keeps plan order
    (useful as the control arm when measuring the reordering win).
    """
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    num_chunks = -(-max(plan.num_nodes, 1) // chunk_rows)
    gi = plan.gather_idx.astype(np.int64)
    lane_chunk = (gi // chunk_rows).astype(np.int32)
    lane_off = (gi % chunk_rows).astype(np.int32)
    tile_chunks = tuple(
        np.unique(lane_chunk[t]).astype(np.int64) for t in range(plan.num_tiles)
    )
    runs = tile_runs(plan)
    order = np.arange(plan.num_tiles, dtype=np.int64)
    if reorder and runs.size > 2:
        keys = []
        for r in range(runs.size - 1):
            lo, hi = int(runs[r]), int(runs[r + 1])
            touched = np.concatenate([tile_chunks[t] for t in range(lo, hi)])
            keys.append(float(np.median(touched)) if touched.size else 0.0)
        run_order = np.argsort(np.asarray(keys), kind="stable")
        order = np.concatenate(
            [np.arange(runs[r], runs[r + 1], dtype=np.int64) for r in run_order]
        )
    return ChunkSchedule(
        chunk_rows=int(chunk_rows),
        num_chunks=int(num_chunks),
        order=order,
        tile_chunks=tile_chunks,
        runs=runs,
        lane_chunk=lane_chunk,
        lane_off=lane_off,
    )


# ---------------------------------------------------------------------------
# Generic segment packing — reused by MoE token->expert dispatch
# ---------------------------------------------------------------------------


def pack_segments(
    lengths: Sequence[int], capacity: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """First-fit-decreasing packing of variable-length segments into tiles.

    Returns ``(tile_of_segment, offset_of_segment, num_tiles)`` where segment i
    occupies lanes ``[offset, offset+len)`` of its tile, possibly spanning
    multiple tiles when len > remaining capacity (partial response). Used by
    the MoE dispatcher to bound expert-capacity padding the same way the
    nodeslot scheduler bounds degree padding.
    """
    lengths = np.asarray(lengths, np.int64)
    order = np.argsort(-lengths, kind="stable")
    tile_of = np.zeros(lengths.size, np.int64)
    offset_of = np.zeros(lengths.size, np.int64)
    tile, lane = 0, 0
    for i in order:
        ln = int(lengths[i])
        if ln > capacity - lane:
            tile += 1
            lane = 0
        tile_of[i], offset_of[i] = tile, lane
        lane += ln
        while lane > capacity:  # segment longer than a whole tile: spill
            tile += 1
            lane -= capacity
    num_tiles = tile + (1 if lane > 0 else 0)
    return tile_of, offset_of, max(num_tiles, 1)


# ---------------------------------------------------------------------------
# Locality-aware tile packing — rebuild tile membership around feature chunks
# ---------------------------------------------------------------------------


def pack_tiles_by_chunk(plan: EdgeTilePlan, chunk_rows: int) -> EdgeTilePlan:
    """Repack a tile plan so co-tiled edges share source feature chunks.

    ``build_chunk_schedule(reorder=True)`` only permutes whole runs, so a hit
    rate ceiling remains: tile membership was fixed by degree order, and on
    graphs without neighborhood structure every tile touches most chunks.
    This pass rebuilds tile membership around the chunk axis instead. Each
    single-tile run is decomposed into its per-node segment spans (the unit
    that can move without perturbing any output row's accumulation order),
    units are bucketed by their mean source chunk and packed first-fit-
    decreasing (:func:`pack_segments`) into fresh tiles, and buckets are
    emitted in chunk order, so consecutive tiles draw from the same region of
    the feature matrix. Multi-tile runs (nodes split across tiles) are
    atomic: their tiles are copied verbatim and the block is ordered among
    the buckets by its mean touched chunk.

    Bitwise contract with the unpacked plan: every output row accumulates
    the same lane products in the same order. A unit's lanes move as one
    contiguous block (the intra-segment sum is unchanged); a tile that used
    all ``S`` segments carries its trailing padding lanes along with the
    last unit, because the in-memory scan folds their signed-zero products
    into that segment's partial sum; and fresh padding in packed tiles maps
    to the sentinel segment, whose partial sum the executor discards (its
    gather index points at a row the tile already reads, so padding never
    drags a foreign chunk into the tile's working set). Plans with
    ``segments_per_tile == 1`` have no sentinel segment to give fresh
    padding and are returned unchanged.
    """
    E, S = plan.edges_per_tile, plan.segments_per_tile
    T = plan.num_tiles
    if S < 2 or T <= 1 or chunk_rows <= 0:
        return plan
    sentinel = plan.num_nodes
    lane_chunk = plan.gather_idx.astype(np.int64) // chunk_rows
    valid = plan.edge_ids >= 0
    runs = tile_runs(plan)

    # blocks: (sort key, kind, payload). "verbatim" payload = (lo, hi) tile
    # span of a multi-tile run; "pack" payload = unit indices of one new tile.
    blocks: List[Tuple[float, str, object]] = []
    single: List[int] = []
    n_empty = 0  # all-padding tiles (union size-class filler): re-appended
    for r in range(runs.size - 1):
        lo, hi = int(runs[r]), int(runs[r + 1])
        if hi - lo > 1:
            v = valid[lo:hi]
            key = float(lane_chunk[lo:hi][v].mean()) if v.any() else 0.0
            blocks.append((key, "verbatim", (lo, hi)))
        elif bool((plan.out_node[lo] == sentinel).all()):
            n_empty += 1
        else:
            single.append(lo)

    # Per-segment lane spans of the single-tile runs, extracted in one flat
    # pass: a span starts where the segment id changes (or a tile begins).
    # Trailing padding lanes share segment id S-1, so when a tile used all S
    # segments they merge into the last real span automatically — exactly
    # the lanes whose products the in-memory scan folds into that segment.
    u_tile = u_start = u_len = u_out = u_key = np.zeros(0, np.int64)
    if single:
        single_arr = np.asarray(single, np.int64)
        K = single_arr.size
        s_flat = plan.seg_ids[single_arr].astype(np.int64).ravel()
        tid = np.repeat(np.arange(K, dtype=np.int64), E)
        is_start = np.ones(K * E, bool)
        is_start[1:] = (s_flat[1:] != s_flat[:-1]) | (tid[1:] != tid[:-1])
        starts = np.flatnonzero(is_start)
        lens = np.diff(np.append(starts, K * E))
        span_tile = single_arr[tid[starts]]
        span_seg = s_flat[starts]
        span_out = plan.out_node[span_tile, span_seg].astype(np.int64)
        ch_flat = lane_chunk[single_arr].ravel()
        v_flat = valid[single_arr].ravel()
        ch_sum = np.add.reduceat(np.where(v_flat, ch_flat, 0), starts)
        v_cnt = np.add.reduceat(v_flat.astype(np.int64), starts)
        real = span_out != sentinel  # pure-padding spans are dropped
        u_tile = span_tile[real]
        u_start = (starts - tid[starts] * E)[real]
        u_len = lens[real]
        u_out = span_out[real]
        u_key = ch_sum[real] // np.maximum(v_cnt[real], 1)

    # Bucket units by mean source chunk; FFD-pack each bucket into tiles.
    # A packed tile holds at most S-1 units so segment S-1 stays sentinel
    # (fresh padding must never pollute a real segment's sum).
    max_units = max(S - 1, 1)
    for ckey in np.unique(u_key):
        sel = np.flatnonzero(u_key == ckey)
        tile_of, _, ntiles = pack_segments(u_len[sel], E)
        groups: List[List[int]] = [[] for _ in range(ntiles)]
        for j, i in enumerate(sel):
            groups[int(tile_of[j])].append(int(i))
        if any(len(gr) > max_units for gr in groups):
            # Rare (more than S-1 units fit in E lanes): greedy longest-first
            # refill under both the lane and the segment budget.
            groups = []
            cur: List[int] = []
            lanes = 0
            for i in sel[np.argsort(-u_len[sel], kind="stable")]:
                ln = int(u_len[i])
                if cur and (lanes + ln > E or len(cur) >= max_units):
                    groups.append(cur)
                    cur, lanes = [], 0
                cur.append(int(i))
                lanes += ln
            if cur:
                groups.append(cur)
        for gr in groups:
            if gr:
                blocks.append((float(ckey), "pack", gr))
    blocks.sort(key=lambda b: b[0])

    n_pack = sum(1 for b in blocks if b[1] == "pack")
    n_verb = sum(b[2][1] - b[2][0] for b in blocks if b[1] == "verbatim")
    newT = max(n_pack + n_verb + n_empty, 1)
    new_g = np.zeros((newT, E), np.int32)
    new_c = np.zeros((newT, E), np.float32)
    new_s = np.full((newT, E), S - 1, np.int32)
    new_o = np.full((newT, S), sentinel, np.int32)
    new_e = np.full((newT, E), -1, np.int32)

    # Layout pass: verbatim blocks copy whole tiles; packed tiles record one
    # (unit -> destination lane/segment) placement each, copied flat below.
    p_unit: List[int] = []
    p_dst_tile: List[int] = []
    p_dst_off: List[int] = []
    p_seg: List[int] = []
    pack_fill: List[Tuple[int, int]] = []  # (tile, lanes used)
    dst = 0
    for _, kind, payload in blocks:
        if kind == "verbatim":
            lo, hi = payload  # type: ignore[misc]
            n = hi - lo
            new_g[dst : dst + n] = plan.gather_idx[lo:hi]
            new_c[dst : dst + n] = plan.coeff[lo:hi]
            new_s[dst : dst + n] = plan.seg_ids[lo:hi]
            new_o[dst : dst + n] = plan.out_node[lo:hi]
            new_e[dst : dst + n] = plan.edge_ids[lo:hi]
            dst += n
        else:
            off = 0
            for si, i in enumerate(payload):  # type: ignore[arg-type]
                p_unit.append(i)
                p_dst_tile.append(dst)
                p_dst_off.append(off)
                p_seg.append(si)
                off += int(u_len[i])
            pack_fill.append((dst, off))
            dst += 1

    if p_unit:
        idx = np.asarray(p_unit, np.int64)
        dt = np.asarray(p_dst_tile, np.int64)
        do = np.asarray(p_dst_off, np.int64)
        sg = np.asarray(p_seg, np.int64)
        lens = u_len[idx]
        total = int(lens.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        src = np.repeat(u_tile[idx] * E + u_start[idx], lens) + within
        dflat = np.repeat(dt * E + do, lens) + within
        new_g.ravel()[dflat] = plan.gather_idx.ravel()[src]
        new_c.ravel()[dflat] = plan.coeff.ravel()[src]
        new_e.ravel()[dflat] = plan.edge_ids.ravel()[src]
        new_s.ravel()[dflat] = np.repeat(sg, lens).astype(np.int32)
        new_o[dt, sg] = u_out[idx].astype(np.int32)
        for t, fill in pack_fill:
            if fill < E:
                new_g[t, fill:] = new_g[t, 0]

    return EdgeTilePlan(
        gather_idx=new_g,
        coeff=new_c,
        seg_ids=new_s,
        out_node=new_o,
        node_ids=plan.node_ids,
        edge_ids=new_e,
        num_nodes=plan.num_nodes,
        edges_per_tile=E,
        segments_per_tile=S,
        total_edges=plan.total_edges,
    )
