"""CSR graph structures — the substrate under AMPLE's scheduler.

A copy of the reference's ``repro/graphs/csr.py``: numpy only, so the port
builds byte-identical graphs without importing the JAX package.

Graphs are host-side objects (numpy) because the ExecutionPlan (the analogue of
AMPLE's Node Instruction Decoder programming) is built on the host before any
device computation, exactly as the paper's host programs nodeslots ahead of the
accelerator. Device-side code only ever sees the dense tile arrays the planner
emits.

Conventions
-----------
* ``indptr[i]:indptr[i+1]`` spans the *incoming* neighbour list of node ``i``
  (message sources ``j`` in Eq. 1 of the paper).
* ``indices`` holds the neighbour node ids, sorted per node for determinism.
* Self-loops are represented explicitly when a model requires them (GCN adds
  them; GIN uses an epsilon-weighted residual instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "add_self_loops",
    "from_edge_list",
    "disjoint_union",
    "gcn_norm_coeffs",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph in CSR form over incoming edges.

    Attributes:
      indptr:   int64[N+1]  CSR row pointers (row i = in-neighbours of node i).
      indices:  int32[E]    neighbour (source) node ids.
      num_nodes: N.
      features: optional float32[N, D] node feature matrix.
      edge_weights: optional float32[E] aligned with ``indices``.
      name: human-readable dataset name.
    """

    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int
    features: Optional[np.ndarray] = None
    edge_weights: Optional[np.ndarray] = None
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        """In-degree per node, int64[N]."""
        return np.diff(self.indptr)

    @property
    def mean_degree(self) -> float:
        return float(self.num_edges) / float(max(self.num_nodes, 1))

    @property
    def feature_dim(self) -> int:
        if self.features is None:
            raise ValueError("graph has no features attached")
        return int(self.features.shape[1])

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    def with_features(self, features: np.ndarray) -> "Graph":
        if features.shape[0] != self.num_nodes:
            raise ValueError(
                f"features rows {features.shape[0]} != num_nodes {self.num_nodes}"
            )
        return dataclasses.replace(self, features=np.asarray(features, np.float32))

    def dense_adjacency(self) -> np.ndarray:
        """float32[N, N] with A[i, j] = weight of edge j->i. Test-scale only."""
        if self.num_nodes > 20_000:
            raise ValueError("dense adjacency requested for a large graph")
        a = np.zeros((self.num_nodes, self.num_nodes), np.float32)
        w = (
            self.edge_weights
            if self.edge_weights is not None
            else np.ones(self.num_edges, np.float32)
        )
        for i in range(self.num_nodes):
            a[i, self.neighbors(i)] += w[self.indptr[i] : self.indptr[i + 1]]
        return a


def from_edge_list(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    undirected: bool = False,
    dedup: bool = True,
    name: str = "graph",
) -> Graph:
    """Build a CSR ``Graph`` from (src -> dst) edge arrays.

    Incoming-edge CSR: row ``i`` lists all ``src`` with an edge into ``i``.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if src.size and (src.min() < 0 or src.max() >= num_nodes):
        raise ValueError("src node id out of range")
    if dst.size and (dst.min() < 0 or dst.max() >= num_nodes):
        raise ValueError("dst node id out of range")
    if dedup and src.size:
        pair = dst * num_nodes + src
        _, keep = np.unique(pair, return_index=True)
        src, dst = src[keep], dst[keep]
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(
        indptr=indptr,
        indices=src.astype(np.int32),
        num_nodes=num_nodes,
        name=name,
    )


def add_self_loops(g: Graph) -> Graph:
    """Return a copy of ``g`` with a self edge on every node (idempotent)."""
    n = g.num_nodes
    rows = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    has_loop = np.zeros(n, bool)
    has_loop[rows[g.indices == rows]] = True if g.num_edges else False
    missing = np.nonzero(~has_loop)[0]
    if missing.size == 0:
        return g
    src = np.concatenate([g.indices.astype(np.int64), missing])
    dst = np.concatenate([rows, missing])
    out = from_edge_list(src, dst, n, dedup=True, name=g.name)
    if g.features is not None:
        out = out.with_features(g.features)
    return out


def disjoint_union(
    graphs: "list[Graph]",
    *,
    pad_num_nodes: Optional[int] = None,
    pad_num_edges: Optional[int] = None,
) -> Graph:
    """Block-diagonal union of independent graphs (no cross edges).

    Node ids of graph k are offset by the node counts of graphs 0..k-1, so
    CSR rows concatenate directly. Because every aggregation coefficient in
    this codebase depends only on per-node degree (sum/mean/GCN norm), any
    GNN layer over the union equals the per-graph layers stacked — this is
    what lets the serving engine batch independent small-graph requests into
    one padded device call. Features are concatenated when all graphs carry
    them; edge weights likewise.

    ``pad_num_nodes``/``pad_num_edges`` grow the union to a **size class**:
    padding nodes are appended after the real members (isolated, zero
    features), and padding edges — when requested — are self-edges spread
    over the padding nodes, so they can never influence a real node's
    aggregate. Padding a union to a node/edge bucket makes different member
    mixes share device-call shapes, which is what lets the continuous-
    batching serve path reuse device buffer shapes across ever-changing
    batch compositions. (That path pads *nodes* here and pads edge capacity
    at the tile level via ``assemble_union_plan`` — cheaper than planning
    fake edges; graph-level ``pad_num_edges`` is for callers that feed a
    shape-stable union straight into ``compile_plans`` without the
    member-piece machinery.)
    """
    if not graphs:
        raise ValueError("disjoint_union of no graphs")
    if len(graphs) == 1 and pad_num_nodes is None and pad_num_edges is None:
        return graphs[0]
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs])
    n_real = int(offsets[-1])
    e_real = sum(g.num_edges for g in graphs)
    n_total = n_real if pad_num_nodes is None else int(pad_num_nodes)
    e_total = e_real if pad_num_edges is None else int(pad_num_edges)
    if n_total < n_real:
        raise ValueError(f"pad_num_nodes {n_total} < union nodes {n_real}")
    if e_total < e_real:
        raise ValueError(f"pad_num_edges {e_total} < union edges {e_real}")
    n_pad, e_pad = n_total - n_real, e_total - e_real
    if e_pad > 0 and n_pad == 0:
        raise ValueError(
            "edge padding needs at least one padding node to attach self-edges "
            f"to (pad_num_nodes={n_total} leaves none)"
        )
    indptr = [np.asarray([0], np.int64)]
    indices = []
    edge_off = 0
    for g, off in zip(graphs, offsets):
        indptr.append(g.indptr[1:] + edge_off)
        indices.append(g.indices.astype(np.int64) + off)
        edge_off += g.num_edges
    if n_pad:
        # e_pad self-edges spread round-robin over the padding nodes; a
        # padding node's degree only ever shapes its own (discarded) row.
        per = np.full(n_pad, e_pad // n_pad, np.int64)
        per[: e_pad % n_pad] += 1
        pad_ids = np.arange(n_real, n_total, dtype=np.int64)
        indptr.append(edge_off + np.cumsum(per))
        indices.append(np.repeat(pad_ids, per))
    features = None
    if all(g.features is not None for g in graphs):
        features = np.concatenate([g.features for g in graphs], axis=0)
        if n_pad:
            features = np.concatenate(
                [features, np.zeros((n_pad, features.shape[1]), np.float32)], axis=0
            )
    edge_weights = None
    if all(g.edge_weights is not None for g in graphs):
        edge_weights = np.concatenate(
            [g.edge_weights for g in graphs] + [np.zeros(e_pad, np.float32)]
        )
    return Graph(
        indptr=np.concatenate(indptr),
        indices=np.concatenate(indices).astype(np.int32),
        num_nodes=n_total,
        features=features,
        edge_weights=edge_weights,
        name="+".join(dict.fromkeys(g.name for g in graphs)),
    )


def gcn_norm_coeffs(g: Graph) -> np.ndarray:
    """Per-edge GCN normalization 1/sqrt(d̂_j d̂_i) (Eq. 2), float32[E].

    ``d̂_i = 1 + in_degree(i)`` as in the paper (self-connection counted).
    Assumes self-loops have already been added when the model calls for them;
    the coefficient uses the paper's d̂ definition regardless, so the oracle
    and engine agree by construction.
    """
    deg_hat = (g.degrees.astype(np.float64)).clip(min=0) + 0.0
    # Paper: d̂_i = 1 + Σ_j e_{j,i}; with explicit self-loops the +1 is the loop
    # itself, so use raw in-degree here to avoid double counting.
    deg_hat = np.maximum(deg_hat, 1.0)
    inv_sqrt = 1.0 / np.sqrt(deg_hat)
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees)
    coeff = inv_sqrt[rows] * inv_sqrt[g.indices]
    return coeff.astype(np.float32)
