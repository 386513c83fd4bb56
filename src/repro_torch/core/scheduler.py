"""Event-driven execution planning — the host half of AMPLE's NID/nodeslots.

A copy of the reference planner (``repro/core/scheduler.py``) restricted to
what the mixed-precision serving path reads: the fingerprints that key the
serving caches, the event-driven ``EdgeTilePlan`` and the functions that
build it, and the per-precision split. It is numpy only, so the port and the reference emit
byte-identical tile arrays for the same graph (the parity tests check it).

* ``EdgeTilePlan`` — edges packed back-to-back into tiles of
  ``edges_per_tile`` lanes; a node whose degree exceeds the remaining lane
  budget of the current tile is *split across tiles* and its aggregate is
  assembled from the per-tile partials — the Feature Bank's partial-response
  mechanism (§3.3 of the paper).
* ``build_mixed_precision_plans`` partitions nodes by their Degree-Quant tag
  and emits one plan per precision group (§3.2).
* ``BucketPlan`` / ``PaddedPlan`` — the baselines the paper argues against:
  power-of-two degree buckets, and the double-buffered (HyGCN-style) fixed
  batches padded to their largest degree (``AmpleEngine.occupancy_report``
  and the ``aggregate_bucket_plan`` / ``aggregate_padded_plan`` executors).
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
    "EdgeTilePlan",
    "PaddedPlan",
    "build_bucket_plan",
    "build_edge_tile_plan",
    "build_mixed_precision_plans",
    "build_padded_plan",
    "concat_tile_plans",
    "graph_fingerprint",
    "plan_fingerprint",
    "size_class",
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

    E, S = edges_per_tile, segments_per_tile
    tiles_g: List[np.ndarray] = []  # per-tile gather idx
    tiles_c: List[np.ndarray] = []
    tiles_s: List[np.ndarray] = []
    tiles_o: List[np.ndarray] = []
    tiles_e: List[np.ndarray] = []  # per-tile edge ids (-1 padding)

    cur_g = np.zeros(E, np.int32)
    cur_c = np.zeros(E, np.float32)
    cur_s = np.full(E, S - 1, np.int32)
    cur_o = np.full(S, g.num_nodes, np.int32)
    cur_e = np.full(E, -1, np.int32)
    lane = 0
    seg = 0
    total_edges = 0

    def flush():
        nonlocal cur_g, cur_c, cur_s, cur_o, cur_e, lane, seg
        tiles_g.append(cur_g)
        tiles_c.append(cur_c)
        tiles_s.append(cur_s)
        tiles_o.append(cur_o)
        tiles_e.append(cur_e)
        cur_g = np.zeros(E, np.int32)
        cur_c = np.zeros(E, np.float32)
        cur_s = np.full(E, S - 1, np.int32)
        cur_o = np.full(S, g.num_nodes, np.int32)
        cur_e = np.full(E, -1, np.int32)
        lane = 0
        seg = 0

    for v in order:
        lo, hi = int(g.indptr[v]), int(g.indptr[v + 1])
        nbrs = g.indices[lo:hi]
        cfs = coeff[lo:hi]
        pos = 0
        d = hi - lo
        if d == 0:
            continue  # zero-degree nodes contribute nothing; output row stays 0
        total_edges += d
        while pos < d:
            if lane >= E or seg >= S:
                flush()
            take = min(d - pos, E - lane)
            cur_g[lane : lane + take] = nbrs[pos : pos + take]
            cur_c[lane : lane + take] = cfs[pos : pos + take]
            cur_s[lane : lane + take] = seg
            cur_e[lane : lane + take] = np.arange(lo + pos, lo + pos + take)
            cur_o[seg] = v
            lane += take
            pos += take
            seg += 1  # a split node re-opens a fresh segment in the next tile
    if lane > 0 or seg > 0:
        flush()
    if not tiles_g:  # empty graph: one all-padding tile keeps shapes static
        flush()

    return EdgeTilePlan(
        gather_idx=np.stack(tiles_g),
        coeff=np.stack(tiles_c),
        seg_ids=np.stack(tiles_s),
        out_node=np.stack(tiles_o),
        node_ids=node_ids.astype(np.int32),
        edge_ids=np.stack(tiles_e),
        num_nodes=g.num_nodes,
        edges_per_tile=E,
        segments_per_tile=S,
        total_edges=total_edges,
    )


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
