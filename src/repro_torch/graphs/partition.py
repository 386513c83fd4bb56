"""Graph partitioning for sharded GNN execution.

A copy of the reference's ``repro/graphs/partition.py``: numpy only, so the
port builds byte-identical partitions and shard subgraphs for the same graph
and seed without importing the JAX package.

Nodes are partitioned into per-shard blocks balanced by *edge count*
(aggregation work ∝ edges, the paper's central observation), one block per
data-parallel shard. Each shard owns its nodes' output rows; neighbour
embeddings crossing the cut are exchanged with an all-gather of boundary
("halo") nodes before aggregation — the distributed analogue of the Feature
Bank fetching remote neighbours.

Two partitioners:

* ``partition_by_edges`` — contiguous CSR ranges with near-equal edge counts.
  Zero bookkeeping (per-edge data slices directly onto shards), but blind to
  locality: on a graph whose communities are interleaved in node order it
  cuts nearly every edge.
* ``partition_min_cut`` — METIS-style multilevel refinement: greedy heavy-edge
  coarsening, an initial cut seeded from ``partition_by_edges``, then
  boundary-vertex refinement that moves nodes across the cut whenever it
  reduces cut edges without violating the edge-balance bound. Produces a
  *non-contiguous* assignment carried by ``Partition.order``.

The halo-exchange volume (``partition_halo_volume``) is the distributed
analogue of off-chip traffic; the min-cut partitioner exists purely to shrink
it while ``shard_edge_counts`` stays balanced.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = [
    "Partition",
    "ShardSubgraph",
    "partition_by_edges",
    "partition_min_cut",
    "make_partition",
    "halo_nodes",
    "shard_subgraph",
    "shard_edge_counts",
    "partition_cut_edges",
    "partition_halo_volume",
    "validate_partition",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Shard assignment of graph nodes, contiguous or permuted.

    ``starts`` are half-open block boundaries into the (implicit or explicit)
    node order: shard ``k`` owns positions ``[starts[k], starts[k+1])``.

    * ``order is None`` — the historical contiguous layout: shard ``k`` owns
      global node ids ``[starts[k], starts[k+1])`` directly, and per-edge data
      slices onto shards as contiguous CSR ranges.
    * ``order`` int64[N] — a node permutation; shard ``k`` owns global ids
      ``order[starts[k]:starts[k+1]]``. Invariant: each block is sorted
      ascending (canonical form — constructors enforce it), so local row
      ``i`` of a shard is its ``i``-th smallest owned node.

    ``kind`` names the partitioner (and its parameters) that produced this
    assignment; it is folded into ``partition_fingerprint`` so plan caches
    never collide across partitioners that happen to emit the same shapes.
    """

    starts: np.ndarray  # int64[num_shards + 1] block boundaries (positions)
    order: Optional[np.ndarray] = None  # int64[N] permutation; None = identity
    kind: str = "custom"

    @property
    def num_shards(self) -> int:
        return int(self.starts.shape[0]) - 1

    @property
    def contiguous(self) -> bool:
        return self.order is None

    @property
    def num_nodes(self) -> int:
        return int(self.starts[-1])

    def nodes(self, k: int) -> Tuple[int, int]:
        """Half-open *position* range of shard k (global ids iff contiguous)."""
        return int(self.starts[k]), int(self.starts[k + 1])

    def owned(self, k: int) -> np.ndarray:
        """Global node ids owned by shard k, sorted ascending."""
        lo, hi = self.nodes(k)
        if self.order is None:
            return np.arange(lo, hi, dtype=np.int64)
        return np.asarray(self.order[lo:hi], np.int64)

    @cached_property
    def _position(self) -> np.ndarray:
        """int64[N]: position of each global node in the concatenated order."""
        pos = np.empty(self.num_nodes, np.int64)
        pos[np.asarray(self.order, np.int64)] = np.arange(
            self.num_nodes, dtype=np.int64
        )
        return pos

    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        """Owning shard of each global node id, int32[...]."""
        nodes = np.asarray(nodes, np.int64)
        if self.order is None:
            return (
                np.searchsorted(self.starts, nodes, side="right") - 1
            ).astype(np.int32)
        return (
            np.searchsorted(self.starts, self._position[nodes], side="right") - 1
        ).astype(np.int32)

    def rank_of(self, nodes: np.ndarray) -> np.ndarray:
        """Local row index of each node within its owner's block, int64[...]."""
        nodes = np.asarray(nodes, np.int64)
        if self.order is None:
            owner = np.searchsorted(self.starts, nodes, side="right") - 1
            return nodes - self.starts[owner]
        pos = self._position[nodes]
        owner = np.searchsorted(self.starts, pos, side="right") - 1
        return pos - self.starts[owner]

    def shard_of(self, node: int) -> int:
        return int(self.owner_of(np.asarray([node]))[0])


def partition_by_edges(g: Graph, num_shards: int) -> Partition:
    """Contiguous ranges with near-equal edge counts (work balance).

    Work balance — not node balance — is what keeps data-parallel shards from
    straggling on skewed graphs; this is the cluster-level restatement of the
    paper's event-driven argument.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    cum = g.indptr  # cumulative edges by node boundary
    total = g.num_edges
    targets = (np.arange(1, num_shards) * total) / num_shards
    cuts = np.searchsorted(cum, targets, side="left")
    starts = np.concatenate([[0], cuts, [g.num_nodes]]).astype(np.int64)
    starts = np.maximum.accumulate(starts)  # keep monotone on degenerate graphs
    return Partition(starts=starts, kind="edges")


# ---------------------------------------------------------------------------
# Min-cut multilevel partitioner (METIS-style coarsen → seed → refine)
# ---------------------------------------------------------------------------


def _symmetric_edges(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected weighted edge list (a, b, w) with both directions present,
    duplicates coalesced and self-loops dropped."""
    dst = np.repeat(
        np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr)
    )
    src = np.asarray(g.indices, np.int64)
    a = np.concatenate([dst, src])
    b = np.concatenate([src, dst])
    keep = a != b
    a, b = a[keep], b[keep]
    if a.size == 0:
        return a, b, np.zeros(0, np.int64)
    key = a * g.num_nodes + b
    key, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, minlength=key.size).astype(np.int64)
    return key // g.num_nodes, key % g.num_nodes, w


def _heavy_edge_matching(
    n: int,
    a: np.ndarray,
    b: np.ndarray,
    w: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Greedy heavy-edge matching → coarse cluster id per vertex, int64[n]."""
    match = np.full(n, -1, np.int64)
    # adjacency in CSR-ish form over the symmetric edge list
    order_e = np.argsort(a, kind="stable")
    a_s, b_s, w_s = a[order_e], b[order_e], w[order_e]
    ptr = np.searchsorted(a_s, np.arange(n + 1))
    for u in rng.permutation(n):
        if match[u] >= 0:
            continue
        nbrs = b_s[ptr[u] : ptr[u + 1]]
        wts = w_s[ptr[u] : ptr[u + 1]]
        free = match[nbrs] < 0
        nbrs, wts = nbrs[free & (nbrs != u)], wts[free & (nbrs != u)]
        if nbrs.size == 0:
            match[u] = u
            continue
        # heaviest edge wins; ties break on the smallest neighbour id
        best = nbrs[np.lexsort((nbrs, -wts))][0]
        match[u] = best
        match[best] = u
    # pair (u, match[u]) -> one coarse id (the min of the pair)
    rep = np.minimum(np.arange(n, dtype=np.int64), match)
    _, coarse = np.unique(rep, return_inverse=True)
    return coarse.astype(np.int64)


def _coarsen_edges(
    coarse: np.ndarray,
    n_coarse: int,
    a: np.ndarray,
    b: np.ndarray,
    w: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ca, cb = coarse[a], coarse[b]
    keep = ca != cb
    ca, cb, w = ca[keep], cb[keep], w[keep]
    if ca.size == 0:
        return ca, cb, w
    key = ca * n_coarse + cb
    key_u, inv = np.unique(key, return_inverse=True)
    w_u = np.bincount(inv, weights=w.astype(np.float64), minlength=key_u.size)
    return key_u // n_coarse, key_u % n_coarse, w_u.astype(np.int64)


def _refine(
    assign: np.ndarray,
    vw: np.ndarray,
    a: np.ndarray,
    b: np.ndarray,
    w: np.ndarray,
    num_shards: int,
    cap: float,
    passes: int,
) -> np.ndarray:
    """Greedy boundary refinement: move vertices across the cut when it
    reduces cut weight and keeps every shard's vertex-weight load ≤ cap.

    One pass computes the full connectivity matrix conn[u, s] = Σ w of u's
    edges into shard s, ranks boundary vertices by best gain, and applies
    moves sequentially (loads updated live, connectivity stale within the
    pass — recomputed next pass). Deterministic: stable sorts, id tiebreaks.
    """
    n = assign.shape[0]
    load = np.bincount(assign, weights=vw.astype(np.float64), minlength=num_shards)
    for _ in range(passes):
        conn = np.bincount(
            a * num_shards + assign[b],
            weights=w.astype(np.float64),
            minlength=n * num_shards,
        ).reshape(n, num_shards)
        internal = conn[np.arange(n), assign]
        ext_best = conn.copy()
        ext_best[np.arange(n), assign] = -np.inf
        target = np.argmax(ext_best, axis=1)
        gain = ext_best[np.arange(n), target] - internal
        cand = np.nonzero(gain > 0)[0]
        if cand.size == 0:
            # cut is locally optimal; only balance repair could remain
            moved = _repair_balance(
                assign, vw, conn, load, num_shards, cap
            )
            if not moved:
                break
            continue
        cand = cand[np.lexsort((cand, -gain[cand]))]
        moved = 0
        for u in cand:
            s, t = int(assign[u]), int(target[u])
            if s == t:
                continue
            if load[t] + vw[u] > cap and load[t] + vw[u] >= load[s]:
                continue  # would overload the target beyond the source
            assign[u] = t
            load[s] -= vw[u]
            load[t] += vw[u]
            moved += 1
        moved += _repair_balance(assign, vw, conn, load, num_shards, cap)
        if moved == 0:
            break
    return assign


def _repair_balance(
    assign: np.ndarray,
    vw: np.ndarray,
    conn: np.ndarray,
    load: np.ndarray,
    num_shards: int,
    cap: float,
) -> int:
    """Move lowest-loss vertices out of overloaded shards. Returns #moves."""
    moved = 0
    for s in range(num_shards):
        guard = 0
        while load[s] > cap and guard < assign.shape[0]:
            members = np.nonzero(assign == s)[0]
            if members.size <= 1:
                break
            t = int(np.argmin(load))
            if t == s:
                break
            # prefer the member whose move loses the least cut weight
            loss = conn[members, s] - conn[members, t]
            u = int(members[np.lexsort((members, loss))][0])
            assign[u] = t
            load[s] -= vw[u]
            load[t] += vw[u]
            moved += 1
            guard += 1
    return moved


def partition_min_cut(
    g: Graph,
    num_shards: int,
    *,
    seed: int = 0,
    balance: float = 1.25,
    refine_passes: int = 8,
    coarsen_to: int = 0,
) -> Partition:
    """Halo-minimizing multilevel partition (coarsen → seed → uncoarsen+refine).

    Greedy heavy-edge matching coarsens the symmetrized graph until it has
    roughly ``max(coarsen_to, 32 * num_shards)`` vertices; the coarsest graph
    is seeded from ``partition_by_edges`` (projected through the coarsening
    maps), then each uncoarsening level runs ``refine_passes`` of boundary
    refinement under the edge-balance bound ``max shard edges ≤ balance ×
    ideal``. Deterministic in ``seed``. Falls back to ``partition_by_edges``
    for a single shard or an edgeless graph.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    n = g.num_nodes
    vw = np.diff(g.indptr).astype(np.int64)  # work = owned in-edges
    if num_shards == 1 or g.num_edges == 0 or n <= num_shards:
        base = partition_by_edges(g, num_shards)
        return Partition(
            starts=base.starts,
            order=None,
            kind=_min_cut_kind(seed, balance, refine_passes),
        )
    a, b, w = _symmetric_edges(g)
    rng = np.random.default_rng(seed)
    stop_at = max(coarsen_to or 0, 32 * num_shards)

    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    maps: List[np.ndarray] = []
    cur_vw, cur_a, cur_b, cur_w, cur_n = vw, a, b, w, n
    while cur_n > stop_at:
        coarse = _heavy_edge_matching(cur_n, cur_a, cur_b, cur_w, rng)
        n_coarse = int(coarse.max()) + 1 if coarse.size else 0
        if n_coarse >= cur_n or n_coarse == 0:
            break  # matching stalled (e.g. star graphs)
        levels.append((cur_vw, cur_a, cur_b, cur_w))
        maps.append(coarse)
        cur_vw = np.bincount(
            coarse, weights=cur_vw.astype(np.float64), minlength=n_coarse
        ).astype(np.int64)
        cur_a, cur_b, cur_w = _coarsen_edges(coarse, n_coarse, cur_a, cur_b, cur_w)
        cur_n = n_coarse

    # Seed: project the contiguous edge-balance cut onto the coarsest level
    # by weighted majority vote of each coarse vertex's fine members.
    seed_part = partition_by_edges(g, num_shards)
    fine_assign = (
        np.searchsorted(seed_part.starts, np.arange(n), side="right") - 1
    ).astype(np.int64)
    coarse_of_fine = np.arange(n, dtype=np.int64)
    for m in maps:
        coarse_of_fine = m[coarse_of_fine]
    votes = np.bincount(
        coarse_of_fine * num_shards + fine_assign,
        weights=vw.astype(np.float64),
        minlength=cur_n * num_shards,
    ).reshape(cur_n, num_shards)
    assign = np.argmax(votes, axis=1).astype(np.int64)

    cap = balance * vw.sum() / num_shards
    assign = _refine(
        assign, cur_vw, cur_a, cur_b, cur_w, num_shards, cap, refine_passes
    )
    for (lvl_vw, lvl_a, lvl_b, lvl_w), m in zip(
        reversed(levels), reversed(maps)
    ):
        assign = assign[m]  # project to the finer level
        assign = _refine(
            assign, lvl_vw, lvl_a, lvl_b, lvl_w, num_shards, cap, refine_passes
        )

    counts = np.bincount(assign, minlength=num_shards)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    order = np.argsort(assign, kind="stable").astype(np.int64)
    part = Partition(
        starts=starts,
        order=order,
        kind=_min_cut_kind(seed, balance, refine_passes),
    )
    if np.array_equal(order, np.arange(n)):
        # canonical contiguous form (keeps the fast paths on trivial graphs)
        part = Partition(starts=starts, order=None, kind=part.kind)
    return part


def _min_cut_kind(seed: int, balance: float, passes: int) -> str:
    return f"mincut(seed={int(seed)},balance={balance:g},passes={int(passes)})"


_MIN_CUT_NAMES = ("mincut", "min-cut", "min_cut", "metis")


def make_partition(
    g: Graph, num_shards: int, kind: str = "edges", **params
) -> Partition:
    """Partitioner dispatch: ``kind`` ∈ {"edges", "mincut"} (+ aliases).

    This is the one place the serving layer maps ``cfg.gnn_partitioner`` to an
    algorithm; params (seed/balance/refine_passes) pass through to
    ``partition_min_cut``. Params may also ride inline in the kind string —
    ``"mincut(seed=1,balance=1.1)"`` — which is how config-file and CLI
    strings (and ``Partition.kind`` fingerprint components) spell them.
    """
    name = (kind or "edges").strip().lower()
    if "(" in name and name.endswith(")"):
        name, _, arg_str = name.partition("(")
        name = name.strip()
        for item in filter(None, (s.strip() for s in arg_str[:-1].split(","))):
            pkey, _, pval = item.partition("=")
            pkey = {"passes": "refine_passes"}.get(pkey.strip(), pkey.strip())
            num = float(pval)
            params.setdefault(pkey, int(num) if num == int(num) and pkey != "balance" else num)
    if name in ("", "edges", "edge", "contiguous"):
        return partition_by_edges(g, num_shards)
    if name in _MIN_CUT_NAMES:
        return partition_min_cut(g, num_shards, **params)
    raise ValueError(
        f"unknown partitioner kind {kind!r}; expected 'edges' or 'mincut'"
    )


# ---------------------------------------------------------------------------
# Halo extraction and shard subgraphs
# ---------------------------------------------------------------------------


def _owned_edge_idx(g: Graph, owned: np.ndarray) -> np.ndarray:
    """Global CSR edge positions of all in-edges of ``owned`` rows, in local
    CSR order (row-major over owned nodes), int64[e_k]."""
    deg = (g.indptr[owned + 1] - g.indptr[owned]).astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    row_start = np.repeat(g.indptr[owned].astype(np.int64), deg)
    local_ptr = np.concatenate([[0], np.cumsum(deg)])[:-1]
    offset = np.arange(total, dtype=np.int64) - np.repeat(local_ptr, deg)
    return row_start + offset


def halo_nodes(g: Graph, part: Partition, k: int) -> np.ndarray:
    """Remote neighbour ids shard k must fetch before aggregating its nodes."""
    if part.contiguous:
        lo, hi = part.nodes(k)
        nbrs = g.indices[g.indptr[lo] : g.indptr[hi]]
        remote = nbrs[(nbrs < lo) | (nbrs >= hi)]
        return np.unique(remote)
    owned = part.owned(k)
    nbrs = g.indices[_owned_edge_idx(g, owned)].astype(np.int64)
    owned_mask = np.zeros(g.num_nodes, bool)
    owned_mask[owned] = True
    return np.unique(nbrs[~owned_mask[nbrs]])


def validate_partition(g: Graph, part: Partition) -> None:
    """Raise if ``part`` is not a disjoint cover of ``g``'s nodes (canonical
    form: contiguous ranges, or a permutation with sorted per-shard blocks)."""
    starts = np.asarray(part.starts, np.int64)
    if starts.ndim != 1 or starts.shape[0] < 2:
        raise ValueError("partition needs at least one shard (starts[K+1])")
    if starts[0] != 0 or starts[-1] != g.num_nodes:
        raise ValueError(
            f"partition must span [0, {g.num_nodes}), got [{starts[0]}, {starts[-1]})"
        )
    if np.any(np.diff(starts) < 0):
        raise ValueError("partition starts must be monotone non-decreasing")
    if part.order is not None:
        order = np.asarray(part.order, np.int64)
        if order.shape != (g.num_nodes,):
            raise ValueError(
                f"partition order must be a permutation of [{g.num_nodes}] "
                f"nodes, got shape {order.shape}"
            )
        seen = np.zeros(g.num_nodes, bool)
        seen[order] = True
        if not seen.all():
            raise ValueError("partition order must be a permutation (exact cover)")
        for k in range(part.num_shards):
            lo, hi = part.nodes(k)
            if np.any(np.diff(order[lo:hi]) <= 0):
                raise ValueError(
                    f"partition order block of shard {k} must be sorted "
                    f"ascending (canonical form)"
                )


def shard_edge_counts(g: Graph, part: Partition) -> np.ndarray:
    """Edges owned by each shard, int64[num_shards] — the work-balance metric."""
    if part.contiguous:
        starts = np.asarray(part.starts, np.int64)
        return np.diff(g.indptr[starts])
    deg = np.diff(g.indptr).astype(np.int64)
    return np.asarray(
        [int(deg[part.owned(k)].sum()) for k in range(part.num_shards)],
        np.int64,
    )


def partition_cut_edges(g: Graph, part: Partition) -> int:
    """Edges whose source lives on a different shard than their destination."""
    dst = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    src = np.asarray(g.indices, np.int64)
    return int(np.sum(part.owner_of(dst) != part.owner_of(src)))


def partition_halo_volume(g: Graph, part: Partition) -> int:
    """Σ_k |halo(k)| — rows exchanged per layer, the distributed off-chip
    traffic metric ``bench_sharded_serve`` tracks."""
    return sum(
        int(halo_nodes(g, part, k).size) for k in range(part.num_shards)
    )


@dataclasses.dataclass(frozen=True)
class ShardSubgraph:
    """One shard's slice of the global graph, re-indexed into local space.

    The local node space is ``[owned rows | halo rows]``: nodes ``[0,
    num_owned)`` are the shard's owned global ids in ascending order
    (``owned``), and nodes ``[num_owned, num_owned + halo.size)`` are the
    remote neighbours in ``halo`` order. Halo nodes have empty in-neighbour
    rows (they are gather *sources* only), so aggregation over ``graph``
    writes real values exactly into the owned rows — the property the sharded
    executor relies on when it keeps ``out[:num_owned]``.

    Per-edge data computed globally (aggregation coefficients, runtime
    attention scores) maps onto local edges via ``edge_range`` — the shard's
    half-open slice of the global CSR edge arrays when the partition is
    contiguous — or via ``edge_idx`` (int64[num_edges] global CSR positions
    in local edge order) when it is not. Exactly one of the two is set.
    """

    index: int
    lo: int  # position range within the partition order
    hi: int
    halo: np.ndarray  # int64[H] global ids, sorted unique
    local_ids: np.ndarray  # int64[num_owned + H] global id of each local row
    graph: Graph  # local-index subgraph (owned + halo nodes)
    edge_range: Optional[Tuple[int, int]]  # [e_lo, e_hi) into global edges
    edge_idx: Optional[np.ndarray] = None  # int64[num_edges] global positions

    @property
    def num_owned(self) -> int:
        return self.hi - self.lo

    @property
    def num_local(self) -> int:
        return int(self.local_ids.shape[0])

    @property
    def owned(self) -> np.ndarray:
        """Global ids of the owned rows, ascending (= local rows [0, num_owned))."""
        return self.local_ids[: self.num_owned]

    @property
    def num_edges(self) -> int:
        if self.edge_range is not None:
            return int(self.edge_range[1] - self.edge_range[0])
        return int(self.edge_idx.shape[0])

    def slice_edges(self, vec: np.ndarray) -> np.ndarray:
        """Slice a global per-edge array onto this shard's local edge order."""
        if self.edge_range is not None:
            e_lo, e_hi = self.edge_range
            return vec[e_lo:e_hi]
        return vec[self.edge_idx]


def shard_subgraph(g: Graph, part: Partition, k: int) -> ShardSubgraph:
    """Extract shard k's local subgraph (owned rows + halo sources).

    Edge order is preserved from the global CSR row-major over the shard's
    owned rows, so the local plan a scheduler builds over this subgraph
    aggregates exactly the same per-edge terms as the global plan restricted
    to the shard's nodes.
    """
    lo, hi = part.nodes(k)
    halo = halo_nodes(g, part, k)
    if part.contiguous:
        e_lo, e_hi = int(g.indptr[lo]), int(g.indptr[hi])
        src = g.indices[e_lo:e_hi].astype(np.int64)
        owned_n = hi - lo
        local = np.where(
            (src >= lo) & (src < hi), src - lo, owned_n + np.searchsorted(halo, src)
        )
        indptr_local = np.concatenate(
            [g.indptr[lo : hi + 1] - e_lo, np.full(halo.size, e_hi - e_lo, np.int64)]
        )
        owned_ids = np.arange(lo, hi, dtype=np.int64)
        edge_range: Optional[Tuple[int, int]] = (e_lo, e_hi)
        edge_idx = None
    else:
        owned_ids = part.owned(k)
        owned_n = owned_ids.shape[0]
        edge_idx = _owned_edge_idx(g, owned_ids)
        src = g.indices[edge_idx].astype(np.int64)
        owned_mask = np.zeros(g.num_nodes, bool)
        owned_mask[owned_ids] = True
        local = np.where(
            owned_mask[src],
            np.searchsorted(owned_ids, src),
            owned_n + np.searchsorted(halo, src),
        )
        deg = (g.indptr[owned_ids + 1] - g.indptr[owned_ids]).astype(np.int64)
        indptr_local = np.concatenate(
            [[0], np.cumsum(deg), np.full(halo.size, edge_idx.size, np.int64)]
        )
        edge_range = None
    local_g = Graph(
        indptr=indptr_local.astype(np.int64),
        indices=local.astype(np.int32),
        num_nodes=owned_n + int(halo.size),
        name=f"{g.name}/shard{k}",
    )
    local_ids = np.concatenate([owned_ids, halo])
    return ShardSubgraph(
        index=k,
        lo=lo,
        hi=hi,
        halo=halo,
        local_ids=local_ids,
        graph=local_g,
        edge_range=edge_range,
        edge_idx=edge_idx,
    )
