"""Sharded GNN layer execution: the host loop on one device, or a mesh.

The port of the reference's ``repro/distributed/graph_shard.py``.
``ShardedAmpleEngine`` executes a ``ShardedExecutionPlan``: each shard owns a
node block (contiguous and edge-balanced, or a min-cut assignment carried by
``Partition.order``); before aggregating, it fetches the rows of its remote
("halo") neighbours, the distributed analogue of AMPLE's Feature Bank
fetching off-chip rows, then runs its own event-driven mixed-precision
aggregation over its local subgraph and keeps exactly its owned output rows.
Per-node transformations (FTE) are row-parallel and stay global, on the
inherited ``transform``.

Per shard and precision group the card runs the AGE kernel
(``kernels/segment_agg``); runtime per-edge coefficients (GAT attention, the
softmax denominators) run the multi-head AGE (``kernels/segment_agg/
attn_ops.aggregate_tiles_mh``), each shard reading its slice of the global
per-edge matrix: ``edge_range`` when the partition is contiguous, the
``edge_idx`` gather when it is not.

Activation quantization uses the engine's *global* scale/zero-point
(calibrated over the full embedding matrix, as the unsharded engine does).
The matrix is quantized once per layer and each shard gathers its rows of
codes, which equal the codes of its gathered rows (``quantize`` is
elementwise); on the card the codes keep the 16-byte row stride
``aggregation._int8_rows`` gives them.

``halo_overlap`` splits each shard's plan into interior tiles (owned sources
only) and boundary tiles (``scheduler.split_plan_by_halo``, at run
granularity, so every output row's tiles sit in one half). The halo rows are
gathered while the interior half aggregates; then the boundary half writes
its rows into the same output, which the AGE allows (it writes only its
plan's rows). That is the unsplit scan, bitwise. The next shard's halo fetch
starts before the current shard's tiles, so a fetch also hides behind the
previous shard's aggregation (on Yelp-like graphs nearly every tile reads a
halo row and the interior halves are empty). On the card the gathers run on
a side stream and the main stream waits on a fetch's event before its
boundary half; ``halo_ms`` is the gather's time and ``halo_wait_ms`` the
main stream's stall at that wait, both from CUDA events. On the CPU the
gathers run on a worker thread and both are wall-clock, as in the
reference. Without overlap the halo rows are gathered on the main stream:
the wait is the whole fetch.

Training (grad on, an input that requires grad) takes another route through
the same kernels: each shard's local rows are gathered differentiably
(``_ShardRows``), its AGE runs through the engine's autograd on its own
plans (``aggregation.aggregate_autograd`` with the shard's transposed plan;
runtime coefficients through the multi-head Functions with the shard's
``TileGrad``), and the backward of the gather sums each global row's
gradient over the shards that hold a copy by the AGE on the halo-transpose
plan (``halo_transpose_plan``), in a plan-static order and without float
atomics, so two runs give the same bits on the card. The forward is the
serving forward, bitwise; the split schedule and the halo ledger are
serving's, and training runs the shards unsplit.

The mesh backend runs one process per shard over ``torch.distributed``, as
the reference's ``shard_map`` program runs one device per shard. ``mesh`` is
a 1-D ``DeviceMesh`` named ``("shard",)``; a rank serves shard
``mesh.get_local_rank("shard")``. Each rank pads its owned rows to ``p_max``
and one ``all_gather`` of those blocks over ``mesh.get_group("shard")`` is
the halo exchange (``MeshState`` says where each halo row lies in it). The
rank then runs its own shard's plans as the host loop runs them, on the same
local rows (the int8 group quantized at the engine's global scale, so the
codes are the host loop's), and its owned output rows are padded and
all-gathered again: every rank returns the whole ``[N, ...]`` result, bitwise
the host loop's. With ``halo_overlap`` the exchange runs asynchronously
while the interior half aggregates. Collectives use only the mesh's group:
the caller picks the backend and the device.

A mesh trains too. Every rank holds the whole replicated input and computes
the loss from replicated tensors, so every rank has the same upstream
gradient; each collective of the forward has its adjoint in the backward
(``_MeshRows``, ``_MeshGather``, ``_MeshScatter``, ``_MeshScale``). The local
rows' backward all-gathers the ranks' halo-row gradients (padded to
``h_max``); each rank runs the AGE on the halo-transpose plan over its own
owned rows' gradient and their halo copies (the plan's lanes re-pointed into
a compact buffer, every other lane at a zero row: a segment holds only its
own row's copies, so its sum is the host loop's) and all-gathers its owned
rows, so every rank gets the whole gradient. An owned-rows all-gather's
backward takes the rank's own rows of the gradient; a per-edge slice's
all-gathers the shards' edge gradients back into global edge order (an edge
lies in exactly one shard: nothing is summed). The int8 group's scale
gradient is summed over the shards in shard order in both backends
(``_ShardScale``, ``_MeshScale``). Training runs the shards unsplit on a mesh
as in the host loop, with or without ``halo_overlap``: every gradient is
bitwise the host loop's on every rank. A dead or stuck rank fails the step at
the group's timeout, as it fails a request.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.aggregation import (
    DeviceTilePlan,
    _aggregate_groups,
    _int8_rows,
    aggregate_autograd,
    aggregate_edge_tiles,
    edge_scores,
    edge_segment_sum_tiles,
    plan_tile_grad,
    segment_max_edge_tiles,
    to_device_plan,
    transposed_tile_plan,
)
from repro_torch.core.message_passing import (
    AmpleEngine,
    ShardedExecutionPlan,
    compile_sharded_plans,
)
from repro_torch.core.quantization import QuantParams, compute_scale_zp
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.memory.prefetcher import StreamedFeatures
from repro_torch.observe import trace as otrace

__all__ = [
    "HaloLedger", "MeshState", "ShardedAmpleEngine", "build_mesh_state", "make_sharded_engine",
    "mesh_aggregate", "sharded_aggregate",
]

_TAGS = ("float", "int8")
#: columns of the halo rows' gradient a mesh all-gathers at a time
_GRAD_COLUMNS = 128

# One worker is enough on the CPU: the host loop is serialized per shard.
_HALO_POOL: Optional[ThreadPoolExecutor] = None


def _halo_pool() -> ThreadPoolExecutor:
    global _HALO_POOL
    if _HALO_POOL is None:
        _HALO_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="halo")
    return _HALO_POOL


class HaloLedger:
    """Halo accounting of one sharded engine, read by the serving layer.

    ``halo_ms`` (the gathers of halo rows), ``halo_wait_ms`` (what the
    aggregation waited for them), ``halo_bytes`` (the bytes they moved: f32
    rows for the float group, int8 codes for the int8 group) and
    ``halo_exchanges`` (one per shard, layer and gather), plus
    ``split_exchanges`` (those that ran the split schedule). On the card the
    times are CUDA events, settled when the totals are read (after the
    request's synchronize); on the CPU they are wall-clock. On a mesh an
    aggregate is one exchange of every shard's halo rows (f32), as the
    reference counts it, and no time is kept.
    """

    KEYS = ("halo_ms", "halo_wait_ms", "halo_bytes", "halo_exchanges", "split_exchanges")

    def __init__(self):
        self._totals: Dict[str, float] = dict.fromkeys(self.KEYS, 0.0)
        self._pending: List[tuple] = []

    def note(self, fetch_ms: float, wait_ms: float, nbytes: int, split: bool) -> None:
        self._add(fetch_ms, wait_ms, nbytes, split)

    def note_events(self, fetch: Tuple, wait: Tuple, nbytes: int, split: bool) -> None:
        """Event pairs (start, end) of the gather and of the wait."""
        self._pending.append((fetch, wait, nbytes, split))

    def _add(self, fetch_ms, wait_ms, nbytes, split) -> None:
        t = self._totals
        t["halo_ms"] += fetch_ms
        t["halo_wait_ms"] += wait_ms
        t["halo_bytes"] += float(nbytes)
        t["halo_exchanges"] += 1.0
        t["split_exchanges"] += 1.0 if split else 0.0

    def totals(self) -> Dict[str, float]:
        pending, self._pending = self._pending, []
        for (f0, f1), (w0, w1), nbytes, split in pending:
            f1.synchronize()
            w1.synchronize()
            self._add(f0.elapsed_time(f1), w0.elapsed_time(w1), nbytes, split)
        return dict(self._totals)


# ---------------------------------------------------------------------------
# Per-shard device state, cached across requests
# ---------------------------------------------------------------------------


def _ids(a, device) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.int64, device=device)  # a copy: a may be a read-only map


def _shard_state_entry(state: Dict, sp, mode: str, device):
    """(owned ids, halo ids, plans, device plans) of one shard and mode."""
    key = ("host", sp.fingerprint, mode, str(device))
    entry = state.get(key)
    if entry is None:
        plans = sp.plan.mode_plans.get(mode)
        if plans is None:
            raise KeyError(
                f"shard {sp.shard.index} was compiled for modes {sp.plan.modes}, "
                f"not {mode!r}; recompile the sharded plan with this mode"
            )
        ids = sp.shard.local_ids
        entry = (
            _ids(ids[: sp.num_owned], device),
            _ids(ids[sp.num_owned:], device),
            plans,
            {tag: to_device_plan(p, device) for tag, p in plans.items()},
        )
        state[key] = entry
    return entry


def _local_edge_coeff(state: Dict, sp, edge_coeff: torch.Tensor) -> torch.Tensor:
    """This shard's slice of a global per-edge vector or ``[E, H]`` matrix:
    ``edge_range`` when contiguous, else the cached ``edge_idx`` gather."""
    if sp.shard.edge_range is not None:
        e_lo, e_hi = sp.shard.edge_range
        return edge_coeff[e_lo:e_hi]
    key = ("edge_idx", sp.fingerprint, str(edge_coeff.device))
    if key not in state:
        state[key] = _ids(sp.shard.edge_idx, edge_coeff.device)
    return edge_coeff[state[key]]


def _shard_split_entry(state: Dict, sp, mode: str, device):
    """The interior and boundary halves of each precision group's plan
    (empty halves omitted) with their device mirrors, each with its own
    split map. Built once per (shard, mode, device)."""
    key = ("split", sp.fingerprint, mode, str(device))
    entry = state.get(key)
    if entry is None:
        _, _, plans, _ = _shard_state_entry(state, sp, mode, device)
        d_int, d_bnd = {}, {}
        for tag, p in plans.items():
            p_int, p_bnd = sched.split_plan_by_halo(p, sp.num_owned)
            if p_int.num_tiles:
                d_int[tag] = to_device_plan(p_int, device)
            if p_bnd.num_tiles:
                d_bnd[tag] = to_device_plan(p_bnd, device)
        entry = (d_int, d_bnd)
        state[key] = entry
    return entry


def _unshuffle(state: Dict, splan: ShardedExecutionPlan, stacked: torch.Tensor) -> torch.Tensor:
    """Shard-block-ordered rows back to global node order: verbatim when the
    partition is contiguous, else through the cached inverse permutation."""
    part = splan.partition
    if part.order is None:
        return stacked
    key = ("inv_order", splan.partition_fp, str(stacked.device))
    if key not in state:
        state[key] = _ids(part._position, stacked.device)
    return stacked[state[key]]


def _row_base(rows: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """(the rows' storage as ``[N, ld]``, the row width ``d``) for rows that
    lie ``ld > d`` apart (the card's int8 codes); (rows, None) otherwise. A
    gather of the ``[N, ld]`` rows keeps the stride (and zero padding)."""
    if rows.dim() == 2 and rows.shape[0] and rows.stride(0) != rows.shape[1]:
        n, ld = rows.shape[0], rows.stride(0)
        return rows.as_strided((n, ld), (ld, 1)), rows.shape[1]
    return rows, None


class _LocalRows:
    """A shard's local rows ``[owned | halo]`` of one representation (f32
    rows or int8 codes), gathered into one buffer: owned rows first, halo
    rows by ``fetch`` (which may run on a side stream or a worker thread)."""

    def __init__(self, rows: torch.Tensor, n_local: int):
        self.src, self.d = _row_base(rows)
        self.buf = torch.empty((n_local,) + tuple(self.src.shape[1:]),
                               dtype=self.src.dtype, device=self.src.device)

    def gather_owned(self, owned_ids, n_owned: int) -> None:
        torch.index_select(self.src, 0, owned_ids, out=self.buf[:n_owned])

    def gather_halo(self, halo_ids, n_owned: int) -> int:
        torch.index_select(self.src, 0, halo_ids, out=self.buf[n_owned:])
        return self.buf[n_owned:].nbytes

    @property
    def rows(self) -> torch.Tensor:
        return self.buf if self.d is None else self.buf[:, : self.d]


def _side_stream(state: Dict, device) -> "torch.cuda.Stream":
    key = ("side", str(device))
    if key not in state:
        state[key] = torch.cuda.Stream(device)
    return state[key]


def _events(n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _aggregate_into(local: Dict[str, torch.Tensor], dplans, *, num_nodes: int, qp,
                    edge_coeff, out: torch.Tensor) -> None:
    """Each precision group's tiles into ``out``, on its local rows: f32
    rows for the float group, int8 codes under ``qp`` for the int8 group."""
    for tag in _TAGS:
        if tag in dplans:
            aggregate_edge_tiles(local[tag], dplans[tag], num_nodes=num_nodes,
                                 edge_coeff=edge_coeff, qp=qp if tag == "int8" else None,
                                 out=out)


class _ShardPass:
    """One shard's aggregation in one call: its local rows, its output and
    its halo fetch. ``start`` gathers the owned rows (on the calling stream
    or thread) and starts the halo fetch: inline when the shard runs
    unsplit, else on the side stream (card) or the worker thread (CPU);
    ``run`` aggregates the interior tiles, waits for the halo rows and
    aggregates the boundary tiles."""

    def __init__(self, sp, state, mode, x, codes, qp, edge_coeff, split):
        dev = x.device
        self.sp, self.qp, self.split = sp, qp, split
        self.owned_ids, self.halo_ids, plans, dplans = _shard_state_entry(state, sp, mode, dev)
        self.d_int, self.d_bnd = (_shard_split_entry(state, sp, mode, dev) if split
                                  else (dplans, {}))
        self.coeff = None if edge_coeff is None else _local_edge_coeff(state, sp, edge_coeff)
        n_local = sp.shard.num_local
        self.local = {tag: _LocalRows(codes if tag == "int8" else x, n_local) for tag in plans}
        self.out = torch.zeros((n_local,) + tuple(x.shape[1:]), dtype=torch.float32, device=dev)

    def _fetch(self) -> int:
        return sum(r.gather_halo(self.halo_ids, self.sp.num_owned) for r in self.local.values())

    def start(self, state, halo: HaloLedger) -> None:
        n_own = self.sp.num_owned
        for r in self.local.values():
            r.gather_owned(self.owned_ids, n_own)
        dev = self.out.device
        if not self.split:  # inline: the wait is the whole fetch
            if dev.type == "cuda":
                f0, f1 = _events(2)
                f0.record()
                nbytes = self._fetch()
                f1.record()
                halo.note_events((f0, f1), (f0, f1), nbytes, False)
            else:
                t0 = time.perf_counter()
                nbytes = self._fetch()
                ms = (time.perf_counter() - t0) * 1e3
                halo.note(ms, ms, nbytes, False)
        elif dev.type == "cuda":
            main, side = torch.cuda.current_stream(dev), _side_stream(state, dev)
            self.fetched = _events(2)
            side.wait_stream(main)  # the rows and the buffers are ready
            with torch.cuda.stream(side):
                self.fetched[0].record(side)
                self.nbytes = self._fetch()
                self.fetched[1].record(side)
            for r in self.local.values():
                r.src.record_stream(side)
                r.buf.record_stream(side)
        else:
            def timed_fetch():
                t0 = time.perf_counter()
                n = self._fetch()
                return n, t0, time.perf_counter()

            self.future = _halo_pool().submit(timed_fetch)

    def _aggregate(self, dplans) -> None:
        _aggregate_into({tag: r.rows for tag, r in self.local.items()}, dplans,
                        num_nodes=self.sp.shard.num_local, qp=self.qp, edge_coeff=self.coeff,
                        out=self.out)

    def run(self, halo: HaloLedger, trace_id: str) -> torch.Tensor:
        self._aggregate(self.d_int)
        if self.split and self.out.device.type == "cuda":
            main = torch.cuda.current_stream(self.out.device)
            w0, w1 = _events(2)
            w0.record(main)
            main.wait_event(self.fetched[1])
            w1.record(main)
            halo.note_events(tuple(self.fetched), (w0, w1), self.nbytes, True)
        elif self.split:
            w0 = time.perf_counter()
            nbytes, t0, t1 = self.future.result()
            w1 = time.perf_counter()
            rec = otrace.get_recorder()
            if rec.enabled:
                args = {"shard": self.sp.shard.index}
                rec.add_span("halo_gather", t0, t1, cat="halo", lane="halo",
                             trace_id=trace_id, args=args)
                rec.add_span("halo_wait", w0, w1, cat="halo", trace_id=trace_id, args=args)
            halo.note((t1 - t0) * 1e3, (w1 - w0) * 1e3, nbytes, True)
        self._aggregate(self.d_bnd)
        return self.out[: self.sp.num_owned]


# ---------------------------------------------------------------------------
# Training: the local rows under autograd
# ---------------------------------------------------------------------------


def halo_transpose_plan(splan: ShardedExecutionPlan, *, edges_per_tile: int,
                        segments_per_tile: Optional[int]) -> sched.EdgeTilePlan:
    """The plan that sums the shards' local rows back into global rows.

    Its sources are the *stacked* local rows, every shard's ``[owned |
    halo]`` block in shard order (``sum(num_local)`` rows); node ``v``'s
    segment holds the stacked positions of its copies, in stacked order:
    shard by shard, a shard's owned rows before its halo rows. The AGE over
    it (coefficient 1) is the gradient of the local-row gather: each global
    row's contributions summed in that plan-static order, one lane group a
    segment, with no atomics. Gather ids reach past ``num_nodes``: upload it
    with ``to_device_plan(plan, device, rows=<stacked rows>)``.
    """
    n = splan.num_nodes
    ids = np.concatenate([sp.shard.local_ids for sp in splan.shards]).astype(np.int64)
    order = np.argsort(ids, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=n), out=indptr[1:])
    g = Graph(indptr=indptr, indices=order.astype(np.int32), num_nodes=n,
              name="halo-transpose")
    return sched.build_edge_tile_plan(g, edges_per_tile=edges_per_tile,
                                      segments_per_tile=segments_per_tile)


class _ShardRows(torch.autograd.Function):
    """Each shard's local rows ``x[local_ids]`` (one output a shard)
    forward; backward, the shards' gradients stacked and summed into global
    rows by the AGE on the halo-transpose plan (``halo_transpose_plan``)."""

    @staticmethod
    def forward(ctx, x, ids, plan):
        ctx.plan, ctx.shape = plan, x.shape
        ctx.sizes = [int(i.numel()) for i in ids]
        return tuple(x.index_select(0, i) for i in ids)

    @staticmethod
    def backward(ctx, *grads):
        stacked = torch.cat([g.reshape(size, -1) for g, size in zip(grads, ctx.sizes)])
        gx = aggregate_edge_tiles(stacked.contiguous(), ctx.plan(), num_nodes=ctx.shape[0])
        return gx.view(ctx.shape), None, None


def _shard_order_sum(parts) -> torch.Tensor:
    """The shards' contributions to one gradient, added in shard order: the
    host loop and the mesh sum the int8 scale's gradient with this."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class _ShardScale(torch.autograd.Function):
    """The int8 group's scale handed to each of ``k`` shards (one output a
    shard); backward, the shards' gradients summed in shard order (a shard
    that has no int8 rows gives zeros)."""

    @staticmethod
    def forward(ctx, scale, k):
        return tuple(scale.clone() for _ in range(k))

    @staticmethod
    def backward(ctx, *grads):
        return _shard_order_sum(grads), None


def sharded_aggregate(
    x: torch.Tensor,
    splan: ShardedExecutionPlan,
    *,
    mode: str,
    qp: Optional[QuantParams] = None,
    device_state: Optional[Dict] = None,
    edge_coeff: Optional[torch.Tensor] = None,
    overlap: bool = False,
    halo: Optional[HaloLedger] = None,
    trace_id: str = "",
) -> torch.Tensor:
    """Aggregate ``x`` shard by shard; returns the full ``[N, …]`` result.

    Per shard: gather owned + halo rows into local index space, run the
    shard's event-driven plan per precision group into one zero-filled
    output, keep the owned rows. ``qp`` is the global activation scale/zp of
    the int8 group (calibrated over all of ``x`` when None). ``device_state``
    caches per-shard uploads across calls (the engine owns one).
    ``edge_coeff`` is a *global* runtime per-edge vector f32[E] or matrix
    f32[E, H] (with ``x`` f32[N, H, dh]); each shard reads its slice.
    ``overlap=True`` runs the split interior/boundary schedule (bitwise the
    unsplit one) wherever a shard has halo rows, and starts the next split
    shard's halo fetch before the current shard's tiles, so a fetch also
    hides behind the previous shard's aggregation; ``halo`` accumulates the
    accounting (``HaloLedger``).
    """
    state = device_state if device_state is not None else {}
    halo = halo if halo is not None else HaloLedger()
    codes = None
    if any("int8" in sp.plan.mode_plans.get(mode, {}) for sp in splan.shards):
        qp = qp if qp is not None else compute_scale_zp(x, symmetric=True)
        codes = _int8_rows(x, qp)  # quantized once for every shard
    shards = [sp for sp in splan.shards if sp.num_owned]

    def started(sp):
        p = _ShardPass(sp, state, mode, x, codes, qp, edge_coeff, overlap and sp.halo_size > 0)
        p.start(state, halo)
        return p

    parts = []
    nxt = started(shards[0]) if shards else None
    for i in range(len(shards)):
        cur, nxt = nxt, None
        if i + 1 < len(shards) and cur.split:  # prefetch behind this shard's tiles
            nxt = started(shards[i + 1])
        parts.append(cur.run(halo, trace_id))
        if nxt is None and i + 1 < len(shards):
            nxt = started(shards[i + 1])
    if not parts:
        return torch.zeros((x.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32,
                           device=x.device)
    return _unshuffle(state, splan, torch.cat(parts, dim=0))


# ---------------------------------------------------------------------------
# Mesh backend: one rank per shard, all-gather halo exchange
# ---------------------------------------------------------------------------


def _check_mesh(mesh, num_shards: int) -> None:
    """The reference's checks of a mesh: one ``("shard",)`` dimension, one
    rank per shard."""
    if tuple(mesh.mesh_dim_names or ()) != ("shard",):
        raise ValueError(f"mesh axes must be ('shard',), got {mesh.mesh_dim_names}")
    if mesh.size() != num_shards:
        raise ValueError(
            f"mesh has {mesh.size()} devices but the plan has {num_shards} shards")


@dataclasses.dataclass(frozen=True)
class MeshState:
    """Where each rank's rows lie in the all-gathered owned blocks.

    Rank ``k`` pads its owned rows to ``p_max`` (``pad_gather[k]``: the
    global row of each padded row, 0 on padding) and the all-gather stacks
    the blocks ``[K, p_max, ...]``. Shard ``k``'s ``i``-th halo row is row
    ``halo_idx[k, i]`` of rank ``halo_owner[k, i]``'s block, and global node
    ``v`` is row ``out_idx[v]`` of the stacked blocks viewed ``[K * p_max,
    ...]``. No tiles are padded: each rank runs its own shard's plans.
    """

    p_max: int  # padded owned rows per shard
    h_max: int  # most halo rows of a shard
    pad_gather: np.ndarray  # int64[K, p_max]
    halo_owner: np.ndarray  # int64[K, h_max]
    halo_idx: np.ndarray  # int64[K, h_max]
    out_idx: np.ndarray  # int64[N]

    def halo_rows(self, k: int, n: int) -> np.ndarray:
        """Shard ``k``'s ``n`` halo rows as rows of the stacked blocks."""
        return self.halo_owner[k, :n] * self.p_max + self.halo_idx[k, :n]


def build_mesh_state(splan: ShardedExecutionPlan) -> MeshState:
    """The reference's ``build_mesh_state`` (``repro/distributed/
    graph_shard.py:396``) without its stacked tiles."""
    part, k_all = splan.partition, splan.num_shards
    p_max = max((s.num_owned for s in splan.shards), default=1) or 1
    h_max = max((s.halo_size for s in splan.shards), default=0)
    pad_gather = np.zeros((k_all, p_max), np.int64)
    halo_owner = np.zeros((k_all, h_max), np.int64)
    halo_idx = np.zeros((k_all, h_max), np.int64)
    for k, sp in enumerate(splan.shards):
        pad_gather[k, : sp.num_owned] = sp.shard.owned
        if sp.halo_size:
            halo_owner[k, : sp.halo_size] = part.owner_of(sp.shard.halo)
            halo_idx[k, : sp.halo_size] = part.rank_of(sp.shard.halo)
    nodes = np.arange(splan.num_nodes, dtype=np.int64)
    out_idx = part.owner_of(nodes).astype(np.int64) * p_max + part.rank_of(nodes)
    return MeshState(p_max=p_max, h_max=h_max, pad_gather=pad_gather, halo_owner=halo_owner,
                     halo_idx=halo_idx, out_idx=out_idx)


class _MeshRank:
    """One rank's part of the mesh: its shard, its group and the device
    mirrors of ``MeshState`` it reads (its padded rows, its halo rows' place
    in the stacked blocks, every node's place)."""

    def __init__(self, mesh, splan: ShardedExecutionPlan, device):
        self.group = mesh.get_group("shard")
        self.rank = mesh.get_local_rank("shard")
        self.size = splan.num_shards
        self.sp = splan.shards[self.rank]
        self.splan, self.device = splan, device
        self.state = ms = build_mesh_state(splan)
        self.p_max = ms.p_max
        self.pad_ids = _ids(ms.pad_gather[self.rank], device)
        self.halo_ids = _ids(ms.halo_rows(self.rank, self.sp.halo_size), device)
        self.out_ids = _ids(ms.out_idx, device)
        #: every shard's halo rows: what one exchange moves, as the reference counts it
        self.halo_total = sum(s.halo_size for s in splan.shards)
        self._layouts: Dict[str, tuple] = {"rows": (self.p_max, self.out_ids,
                                                    _ids(self.sp.shard.owned, device))}

    def all_gather(self, block: torch.Tensor, async_op: bool = False):
        """(the ranks' ``[p_max, ...]`` blocks stacked ``[K * p_max, ...]``,
        the work handle when ``async_op``)."""
        out = torch.empty((self.size,) + tuple(block.shape), dtype=block.dtype,
                          device=block.device)
        work = torch.distributed.all_gather(list(out.unbind(0)), block.contiguous(),
                                            group=self.group, async_op=async_op)
        return out.view((-1,) + tuple(block.shape[1:])), work

    def gather_owned(self, owned: torch.Tensor) -> torch.Tensor:
        """Every shard's owned rows, all-gathered, in global node order."""
        return self.to_whole(owned, "rows")

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's local rows ``[owned | halo]`` of the replicated
        ``x``: the owned block padded to ``p_max`` and all-gathered (the halo
        exchange), the halo rows taken from it."""
        block = x.index_select(0, self.pad_ids)
        stacked, _ = self.all_gather(block)
        return torch.cat([block[: self.sp.num_owned], stacked.index_select(0, self.halo_ids)])

    # ------------------------------------------------------------- training
    def _layout(self, what: str):
        """(pad, the whole tensor's rows in the stacked blocks, this rank's
        rows of the whole tensor) of ``what``: "rows" (owned nodes) or
        "edges" (the shard's edges, in global edge order)."""
        if what not in self._layouts:  # "edges", built on first use
            pos = [np.arange(*s.shard.edge_range) if s.shard.edge_range is not None
                   else np.asarray(s.shard.edge_idx, np.int64) for s in self.splan.shards]
            e_max = max(p.size for p in pos) or 1
            where = np.full(self.splan.num_edges, -1, np.int64)
            for k, p in enumerate(pos):
                where[p] = k * e_max + np.arange(p.size)
            if (where < 0).any():
                raise ValueError("an edge lies in no shard: the mesh cannot train on this plan")
            self._layouts[what] = (e_max, _ids(where, self.device), _ids(pos[self.rank],
                                                                         self.device))
        return self._layouts[what]

    def to_whole(self, part: torch.Tensor, what: str) -> torch.Tensor:
        """Every rank's ``part`` (its owned rows, or its shard's edges),
        padded and all-gathered, in global order."""
        pad, where, _ = self._layout(what)
        block = part.new_zeros((pad,) + tuple(part.shape[1:]))
        block[: part.shape[0]] = part
        stacked, _ = self.all_gather(block)
        return stacked.index_select(0, where)

    def mine(self, whole: torch.Tensor, what: str) -> torch.Tensor:
        """This rank's part of a whole (replicated) tensor."""
        return whole.index_select(0, self._layout(what)[2])

    def _copies(self, plan: DeviceTilePlan):
        """(rows of the all-gathered halo blocks holding a copy of one of this
        rank's owned rows, the halo-transpose ``plan`` with its lanes
        re-pointed into the compact buffer ``[owned | those copies | one zero
        row]``, that buffer's row count). The tiles stay the plan's, so each
        of this rank's segments is summed as the host loop sums it; every
        other lane reads the zero row. Built on the first backward."""
        if "copies" not in self._layouts:
            ms, src, dst, off, first = self.state, [], [], 0, 0
            for k, s in enumerate(self.splan.shards):
                if k == self.rank:
                    first = off
                i = np.flatnonzero(ms.halo_owner[k, : s.halo_size] == self.rank)
                src.append(k * ms.h_max + i)
                dst.append(off + s.num_owned + i)
                off += s.shard.num_local
            dst = np.concatenate(dst)
            n_own, n_rows = self.sp.num_owned, self.sp.num_owned + dst.size + 1
            remap = np.full(off, n_rows - 1, np.int64)
            remap[first: first + n_own] = np.arange(n_own)
            remap[dst] = n_own + np.arange(dst.size)
            lanes = _ids(remap, plan.gather_idx.device)[plan.gather_idx.long()]
            self._layouts["copies"] = (_ids(np.concatenate(src), self.device),
                                       plan._replace(gather_idx=lanes.to(torch.int32)), n_rows)
        return self._layouts["copies"]

    def rows_grad(self, g: torch.Tensor, plan: DeviceTilePlan) -> torch.Tensor:
        """The whole gradient of the replicated rows from this rank's local
        rows' gradient ``g`` (``_MeshRows``' backward), bitwise the host
        loop's ``_ShardRows``: the ranks' halo-row gradients all-gathered
        (padded to ``h_max``, ``_GRAD_COLUMNS`` columns at a time, which
        bounds the gathered block: 1.1 GB at Yelp's 4 shards against 3.5 GB
        for a layer of 400); this rank's owned rows' gradient and the
        halo copies of them put in a compact buffer (``_copies``); the AGE
        on the halo-transpose ``plan`` re-pointed there; this rank's owned
        rows all-gathered."""
        n_own, h = self.sp.num_owned, self.sp.halo_size
        flat = g.reshape(g.shape[0], -1)
        src, lanes, n_rows = self._copies(plan)
        rows = flat.new_zeros((n_rows, flat.shape[1]))
        rows[:n_own] = flat[:n_own]
        for c0 in range(0, flat.shape[1], _GRAD_COLUMNS):  # bounds the gathered blocks
            cols = slice(c0, c0 + _GRAD_COLUMNS)
            block = flat.new_zeros((self.state.h_max, flat[:, cols].shape[1]))
            block[:h] = flat[n_own:, cols]
            halos, _ = self.all_gather(block)
            rows[n_own: n_rows - 1, cols] = halos.index_select(0, src)
            del halos, block
        gx = aggregate_edge_tiles(rows, lanes, num_nodes=self.splan.num_nodes)
        del rows
        whole = self.to_whole(self.mine(gx, "rows"), "rows")
        return whole.view((whole.shape[0],) + tuple(g.shape[1:]))


class _MeshRows(torch.autograd.Function):
    """This rank's local rows of the replicated ``x`` (``_MeshRank.
    local_rows``); backward, the whole gradient on every rank
    (``_MeshRank.rows_grad`` on the halo-transpose plan ``plan()``)."""

    @staticmethod
    def forward(ctx, x, rank, plan):
        ctx.rank, ctx.plan = rank, plan
        return rank.local_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rank.rows_grad(g.contiguous(), ctx.plan()), None, None


class _MeshGather(torch.autograd.Function):
    """This rank's part (``what``: its owned rows, or its shard's edges),
    all-gathered into the whole in global order; backward, the rank's part of
    the replicated gradient, with no communication."""

    @staticmethod
    def forward(ctx, part, rank, what):
        ctx.rank, ctx.what = rank, what
        return rank.to_whole(part, what)

    @staticmethod
    def backward(ctx, g):
        return ctx.rank.mine(g, ctx.what), None, None


class _MeshScatter(torch.autograd.Function):
    """This rank's part of a replicated tensor (``what`` as in
    ``_MeshGather``); backward, the ranks' parts of the gradient
    all-gathered into the whole."""

    @staticmethod
    def forward(ctx, whole, rank, what):
        ctx.rank, ctx.what = rank, what
        return rank.mine(whole, what)

    @staticmethod
    def backward(ctx, g):
        return ctx.rank.to_whole(g.contiguous(), ctx.what), None, None


class _MeshScale(torch.autograd.Function):
    """The int8 group's scale on this rank's shard; backward, the ranks'
    gradients all-gathered and summed in shard order (``_ShardScale``'s
    sum)."""

    @staticmethod
    def forward(ctx, scale, rank):
        ctx.rank = rank
        return scale.clone()

    @staticmethod
    def backward(ctx, g):
        stacked, _ = ctx.rank.all_gather(g.reshape(1))
        return _shard_order_sum(stacked.unbind(0)).view(g.shape), None


def _groups_into(rows: torch.Tensor, dplans, qp, **kw) -> None:
    """``_aggregate_into`` on ``rows`` and, for the int8 group, their codes."""
    _aggregate_into({tag: rows if tag == "float" else _int8_rows(rows, qp) for tag in dplans},
                    dplans, qp=qp, **kw)


def mesh_aggregate(
    x: torch.Tensor,
    splan: ShardedExecutionPlan,
    rank: _MeshRank,
    *,
    mode: str,
    qp: Optional[QuantParams],
    device_state: Dict,
    edge_coeff: Optional[torch.Tensor] = None,
    overlap: bool = False,
    halo: Optional[HaloLedger] = None,
) -> torch.Tensor:
    """This rank's shard of ``sharded_aggregate``; returns the whole ``[N,
    ...]`` result, bitwise the host loop's, on every rank.

    The owned block padded to ``p_max`` is all-gathered (the halo exchange);
    the local rows ``[owned | halo]`` come from it in the host loop's order.
    With ``overlap`` and halo rows, the gather runs asynchronously while the
    interior half aggregates on the owned rows (halo rows zero), then the
    boundary half runs into the same output."""
    sp, dev = rank.sp, x.device
    _, _, _, dplans = _shard_state_entry(device_state, sp, mode, dev)
    n_own, n_local, tail = sp.num_owned, sp.shard.num_local, tuple(x.shape[1:])
    split = overlap and sp.halo_size > 0
    coeff = None if edge_coeff is None else _local_edge_coeff(device_state, sp, edge_coeff)
    out = torch.zeros((n_local,) + tail, dtype=torch.float32, device=dev)
    kw = dict(qp=qp, num_nodes=n_local, edge_coeff=coeff, out=out)
    if split:
        block = x.index_select(0, rank.pad_ids)
        stacked, work = rank.all_gather(block, async_op=True)
        d_int, d_bnd = _shard_split_entry(device_state, sp, mode, dev)
        rows = torch.zeros((n_local,) + tail, dtype=x.dtype, device=dev)
        rows[:n_own] = block[:n_own]
        _groups_into(rows, d_int, **kw)
        work.wait()
        rows[n_own:] = stacked.index_select(0, rank.halo_ids)
        del block, stacked
        _groups_into(rows, d_bnd, **kw)
    else:
        _groups_into(rank.local_rows(x), dplans, **kw)
    if halo is not None:
        halo.note(0.0, 0.0, rank.halo_total * x.element_size() * int(np.prod(tail)), split)
    return rank.gather_owned(out[:n_own])


class ShardedAmpleEngine(AmpleEngine):
    """AmpleEngine over a partitioned graph: sharded AGE, row-parallel FTE.

    Drop-in for ``AmpleEngine`` wherever the model apply functions use it
    (``aggregate`` / ``transform`` / ``edge_softmax`` /
    ``attention_aggregate``), so gcn/gin/sage/gat run sharded unchanged:

        splan = compile_sharded_plans(g, cfg, num_shards=4, modes=("gcn",))
        eng = ShardedAmpleEngine(g, splan, halo_overlap=True)      # host loop
        eng = ShardedAmpleEngine(g, splan, mesh=mesh)              # one rank a shard

    Without ``mesh``, shards run as a host loop on the device of the
    embeddings. ``mesh`` is a 1-D ``("shard",)`` ``DeviceMesh`` with one rank
    per shard, on the device type of the embeddings; every rank builds the
    engine and calls it with the same inputs (the module's "mesh backend").
    The halo
    accounting accumulates in ``halo_stats`` (``HaloLedger``). Under grad
    ``aggregate``, ``edge_softmax``, ``attention_aggregate`` and
    ``edge_scores`` differentiate per shard (the module's "Training"), in
    the host loop and on a mesh alike; the plans their backward reads are
    built on the first backward and kept in ``_shard_state`` beside the
    serving uploads.
    """

    def __init__(
        self,
        g: Graph,
        plan: ShardedExecutionPlan,
        *,
        mesh=None,
        halo_overlap: bool = False,
    ):
        if plan.graph_fp != sched.graph_fingerprint(g):
            raise ValueError(
                f"sharded plan was compiled for a different graph structure "
                f"({plan.num_nodes} nodes, {plan.num_edges} edges vs "
                f"{g.num_nodes}, {g.num_edges}; fingerprints differ)"
            )
        if mesh is not None:
            _check_mesh(mesh, plan.num_shards)
        self.graph = g
        self.cfg = plan.cfg
        self.plan = plan
        self.sharded_plan = plan
        self.mesh = mesh
        self.halo_overlap = bool(halo_overlap)
        self.precision_tags = plan.precision_tags
        self.node_groups = dict(plan.node_groups)
        self._plans = {}
        self._init_runtime_state()
        self._shard_state: Dict = {}
        self.halo = HaloLedger()
        #: set per request by the serving layer so halo spans join the trace
        self.trace_id: str = ""

    @property
    def halo_stats(self) -> Dict[str, float]:
        """The halo totals so far (settles the card's pending events)."""
        return self.halo.totals()

    def plans(self, mode: str):
        raise NotImplementedError(
            "a sharded engine holds one plan per shard, not a global plan; "
            "use sharded_plan.shards[k].plan.mode_plans[mode]"
        )

    def _check_edge_ids(self, mode: str) -> None:
        for sp in self.sharded_plan.shards:
            self._require_edge_ids((mode, sp.shard.index), sp.plan.mode_plans.get(mode, {}))

    def _mesh_rank(self, device, training: bool = False) -> Optional[_MeshRank]:
        """This rank's ``_MeshRank`` on ``device`` (None without a mesh);
        raises on a device the mesh does not hold, and under grad
        (``training``) when a shard holds no rows or no edges (its rank
        would run other collectives than the others)."""
        if self.mesh is None:
            return None
        if training and any(not sp.num_owned or not sp.shard.num_edges
                            for sp in self.sharded_plan.shards):
            raise ValueError("a mesh trains only when every shard owns rows and edges")
        if self.mesh.device_type != device.type:
            raise ValueError(
                f"the mesh holds {self.mesh.device_type!r} devices but the rows lie on {device}")
        key = ("mesh", str(device))
        if key not in self._shard_state:
            self._shard_state[key] = _MeshRank(self.mesh, self.sharded_plan, device)
        return self._shard_state[key]

    # ----------------------------------------------------------------- AGE
    def aggregate(
        self,
        x: torch.Tensor,
        *,
        mode: str = "sum",
        edge_coeff: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if isinstance(x, StreamedFeatures):
            raise ValueError("a sharded engine serves in-memory features only")
        splan = self.sharded_plan
        if edge_coeff is not None:
            edge_coeff = torch.as_tensor(edge_coeff, dtype=torch.float32, device=x.device)
            e = self.graph.num_edges
            if not (tuple(edge_coeff.shape) == (e,)
                    or (edge_coeff.dim() == 2 and edge_coeff.shape[0] == e)):
                raise ValueError(
                    f"edge_coeff must be [{e}] or [{e}, H], got {tuple(edge_coeff.shape)}")
            if edge_coeff.dim() == 2 and (x.dim() != 3 or x.shape[1] != edge_coeff.shape[1]):
                raise ValueError(
                    f"multi-head edge_coeff {tuple(edge_coeff.shape)} needs x shaped "
                    f"[N, {edge_coeff.shape[1]}, dh], got {tuple(x.shape)}")
            self._check_edge_ids(mode)
        has_int8 = self.cfg.mixed_precision and any(
            "int8" in s.plan.mode_plans.get(mode, {}) for s in splan.shards)
        qp = self._activation_qp(lambda: x, "agg") if has_int8 else None
        grad = attn_ops.wants_grad(x, edge_coeff, None if qp is None else qp.scale)
        rank = self._mesh_rank(x.device, grad)
        if grad:
            return self._aggregate_grad(x, mode, qp, edge_coeff, rank)
        if rank is not None:
            return mesh_aggregate(x, splan, rank, mode=mode, qp=qp,
                                  device_state=self._shard_state, edge_coeff=edge_coeff,
                                  overlap=self.halo_overlap, halo=self.halo)
        return sharded_aggregate(
            x, splan, mode=mode, qp=qp, device_state=self._shard_state,
            edge_coeff=edge_coeff, overlap=self.halo_overlap, halo=self.halo,
            trace_id=self.trace_id,
        )

    # ------------------------------------------------ runtime coefficients
    def edge_softmax(self, scores: torch.Tensor, *, mode: str = "runtime") -> torch.Tensor:
        """Destination-segment softmax of per-edge scores, sharded: f32[E(, H)].

        Every destination node (and each of its in-edges) lives in one
        shard, so the segment-max and denominator passes run per shard over
        its local tiles (the denominators on the multi-head AGE) and the
        owned rows map back to global node order through the partition; the
        exp-shift and the normalisation run in global edge space. Under grad
        the shift is held constant and the denominators' pass runs the
        multi-head Function with each shard's ``TileGrad``, as in
        ``AmpleEngine.edge_softmax``. On a mesh each rank runs its own
        shard's passes and the per-node vectors are all-gathered as the
        owned rows of ``aggregate`` are; under grad through ``_MeshScatter``
        (the shard's edges) and ``_MeshGather`` (its owned rows).
        """
        scores = torch.as_tensor(scores, dtype=torch.float32)
        e = self.graph.num_edges
        if not (tuple(scores.shape) == (e,) or (scores.dim() == 2 and scores.shape[0] == e)):
            raise ValueError(f"scores must be [{e}] or [{e}, H], got {tuple(scores.shape)}")
        self._check_edge_ids(mode)
        splan, dev = self.sharded_plan, scores.device
        rank = self._mesh_rank(dev, attn_ops.wants_grad(scores))

        def shard_pass(sp, fn, local, init, grad):
            _, _, _, dplans = _shard_state_entry(self._shard_state, sp, mode, dev)
            n_local = sp.shard.num_local
            acc = torch.full((n_local,) + tuple(local.shape[1:]), init, device=dev)
            for tag, dp in dplans.items():
                kw = {"grad": self._shard_tile_grad(sp, mode, tag, dev)} if grad else {}
                res = fn(local, dp, num_nodes=n_local, **kw)
                acc = torch.maximum(acc, res) if init == float("-inf") else acc + res
            return acc[: sp.num_owned]

        def owned_pass(fn, vec, init, grad=False):
            if rank is not None and grad:
                local = _MeshScatter.apply(vec, rank, "edges")
                return _MeshGather.apply(shard_pass(rank.sp, fn, local, init, grad), rank, "rows")
            if rank is not None:  # this rank's shard, the owned rows all-gathered
                local = _local_edge_coeff(self._shard_state, rank.sp, vec)
                return rank.gather_owned(shard_pass(rank.sp, fn, local, init, grad))
            parts = [shard_pass(sp, fn, _local_edge_coeff(self._shard_state, sp, vec), init, grad)
                     for sp in splan.shards]
            return _unshuffle(self._shard_state, splan, torch.cat(parts, dim=0))

        node_max = owned_pass(segment_max_edge_tiles, scores.detach(), float("-inf"))
        node_max = torch.where(torch.isfinite(node_max), node_max, torch.zeros_like(node_max))
        _, dst = self.edge_endpoints(dev)
        ex = torch.exp(scores - node_max[dst])
        denom = owned_pass(edge_segment_sum_tiles, ex, 0.0, attn_ops.wants_grad(ex))
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        return ex / denom[dst]

    def attention_aggregate(
        self,
        scores: torch.Tensor,
        z: torch.Tensor,
        *,
        mode: str = "runtime",
        leaky_slope: float = 0.2,
    ) -> torch.Tensor:
        """Sharded GAT attention on raw scores f32[E, H] and z f32[N, H, dh].

        The decomposition the reference's sharded engine runs: LeakyReLU,
        the sharded ``edge_softmax``, then the sharded weighted aggregate
        through the multi-head AGE. The fused kernel stays the single-plan
        path: a shard's tiles index local node space.
        """
        z = torch.as_tensor(z, dtype=torch.float32)
        scores = torch.as_tensor(scores, dtype=torch.float32, device=z.device)
        e, n = self.graph.num_edges, self.graph.num_nodes
        if scores.dim() != 2 or scores.shape[0] != e:
            raise ValueError(f"scores must be [{e}, H], got {tuple(scores.shape)}")
        if z.dim() != 3 or z.shape[0] != n or z.shape[1] != scores.shape[1]:
            raise ValueError(f"z must be [{n}, {scores.shape[1]}, dh], got {tuple(z.shape)}")
        act = torch.where(scores >= 0, scores, leaky_slope * scores)
        alpha = self.edge_softmax(act, mode=mode)
        return self.aggregate(z, mode=mode, edge_coeff=alpha)

    def edge_scores(
        self, src_sc: torch.Tensor, dst_sc: torch.Tensor, *, mode: str = "runtime"
    ) -> torch.Tensor:
        """GAT's raw per-edge scores ``src_sc[src] + dst_sc[dst]``, sharded
        under grad: each shard gathers its local rows of both halves and runs
        ``aggregation.edge_scores`` on its own plans (every destination is an
        owned row of one shard: its sums are the shard's pass; a source's
        reach the halo rows of other shards too, which the halo-transpose
        plan adds up). The shards' edges are put back in global edge order;
        on a mesh each rank scores its own shard's edges and they are
        all-gathered (``_MeshRows``, ``_MeshGather``). Bitwise the plain
        indexing forward."""
        dev = src_sc.device
        grad = attn_ops.wants_grad(src_sc, dst_sc)
        rank = self._mesh_rank(dev, grad)
        if not grad:  # serving
            src, dst = self.edge_endpoints(dev)
            return src_sc[src] + dst_sc[dst]
        self._check_edge_ids(mode)

        def shard_scores(sp, s_loc, d_loc):
            _, _, plans, dplans = _shard_state_entry(self._shard_state, sp, mode, dev)
            lsrc, ldst = self._shard_endpoints(sp, dev)
            return edge_scores(
                s_loc, d_loc, lsrc, ldst, [dplans[t] for t in plans],
                [lambda t=t: self._shard_transposed(sp, mode, t, dev) for t in plans],
                num_nodes=sp.shard.num_local)

        if rank is not None:
            halves = [_MeshRows.apply(h, rank, lambda: self._halo_transpose(dev))
                      for h in (src_sc, dst_sc)]
            return _MeshGather.apply(shard_scores(rank.sp, *halves), rank, "edges")
        parts = [shard_scores(sp, s_loc, d_loc)
                 for sp, s_loc, d_loc in zip(self.sharded_plan.shards, self._local_rows(src_sc),
                                             self._local_rows(dst_sc))
                 if sp.shard.num_edges]
        return self._global_edges(torch.cat(parts, dim=0))

    # ------------------------------------------------------------- training
    def _aggregate_grad(self, x, mode, qp, edge_coeff, rank) -> torch.Tensor:
        """``aggregate`` under grad: per shard, the AGE's autograd over its
        local rows (``_shard_grad``), its owned rows kept. In the host loop
        the local rows come from ``_ShardRows``, on a mesh from ``_MeshRows``
        and the owned rows are all-gathered (``_MeshGather``). The int8
        group's scale gradient is summed over the shards in shard order
        (``_ShardScale``, ``_MeshScale``). The halo ledger (serving's
        accounting) is not fed."""
        splan, st, dev = self.sharded_plan, self._shard_state, x.device
        scale = None if qp is None or not qp.scale.requires_grad else qp.scale
        if rank is not None:
            sqp = qp if scale is None else QuantParams(_MeshScale.apply(scale, rank),
                                                       qp.zero_point)
            rows = _MeshRows.apply(x, rank, lambda: self._halo_transpose(dev))
            coeff = edge_coeff
            if edge_coeff is not None:
                coeff = (_MeshScatter.apply(edge_coeff, rank, "edges") if edge_coeff.requires_grad
                         else _local_edge_coeff(st, rank.sp, edge_coeff))
            out = self._shard_grad(rank.sp, rows, mode, sqp, coeff)
            return _MeshGather.apply(out[: rank.sp.num_owned], rank, "rows")
        sqps = ([qp] * splan.num_shards if scale is None else
                [QuantParams(s, qp.zero_point) for s in _ShardScale.apply(scale, splan.num_shards)])
        parts = []
        for sp, sqp, rows in zip(splan.shards, sqps, self._local_rows(x)):
            if not sp.num_owned:
                continue
            coeff = None if edge_coeff is None else _local_edge_coeff(st, sp, edge_coeff)
            parts.append(self._shard_grad(sp, rows, mode, sqp, coeff)[: sp.num_owned])
        return _unshuffle(st, splan, torch.cat(parts, dim=0))

    def _shard_grad(self, sp, rows, mode, qp, coeff) -> torch.Tensor:
        """Shard ``sp``'s aggregate under grad on its local rows: static
        coefficients through ``aggregate_autograd`` with its transposed
        plan, runtime ones (its slice ``coeff``) through each group's
        multi-head Function with its ``TileGrad``."""
        dev = rows.device
        _, _, _, dplans = _shard_state_entry(self._shard_state, sp, mode, dev)
        n_local = sp.shard.num_local
        if coeff is None:
            return aggregate_autograd(
                rows, dplans, lambda: self._shard_transposed(sp, mode, "float", dev),
                num_nodes=n_local, qp=qp)
        return _aggregate_groups(
            rows, dplans, num_nodes=n_local, qp=qp, edge_coeff=coeff,
            grads={t: self._shard_tile_grad(sp, mode, t, dev) for t in dplans})

    def _local_rows(self, x: torch.Tensor):
        """Each shard's local rows ``[owned | halo]`` of ``x``, differentiable
        (``_ShardRows``)."""
        dev, st = x.device, self._shard_state
        key = ("local_ids", str(dev))
        if key not in st:
            st[key] = [_ids(sp.shard.local_ids, dev) for sp in self.sharded_plan.shards]
        return _ShardRows.apply(x, st[key], lambda: self._halo_transpose(dev))

    def _halo_transpose(self, device) -> DeviceTilePlan:
        """The halo-transpose device plan, built on the first backward."""
        key, st = ("halo_transpose", str(device)), self._shard_state
        if key not in st:
            splan = self.sharded_plan
            plan = halo_transpose_plan(splan, edges_per_tile=self.cfg.edges_per_tile,
                                       segments_per_tile=self.cfg.segments_per_tile)
            st[key] = to_device_plan(plan, device,
                                     rows=sum(sp.shard.num_local for sp in splan.shards))
        return st[key]

    def _shard_transposed(self, sp, mode: str, tag: str, device):
        """Shard ``sp``'s transposed device plan of group ``tag``
        (``aggregation.transposed_tile_plan`` of its local plan), built on
        first use and cached per (shard, mode, tag, device)."""
        key, st = ("transposed", sp.fingerprint, mode, tag, str(device)), self._shard_state
        if key not in st:
            st[key] = to_device_plan(transposed_tile_plan(
                sp.plan.mode_plans[mode][tag], edges_per_tile=self.cfg.edges_per_tile,
                segments_per_tile=self.cfg.segments_per_tile, runtime=mode == "runtime"),
                device)
        return st[key]

    def _shard_tile_grad(self, sp, mode: str, tag: str, device) -> attn_ops.TileGrad:
        """Shard ``sp``'s ``TileGrad`` of group ``tag``: its local CSR's
        sources, work items over its owned destinations, its transposed
        plan."""
        key, st = ("tile_grad", sp.fingerprint, mode, tag, str(device)), self._shard_state
        if key not in st:
            lg = sp.shard.graph
            indices = torch.as_tensor(lg.indices, dtype=torch.int32).to(device)
            st[key] = plan_tile_grad(sp.plan.mode_plans[mode][tag], lg, indices,
                                     lambda: self._shard_transposed(sp, mode, tag, device))
        return st[key]

    def _shard_endpoints(self, sp, device):
        """(local src, local dst) of each of shard ``sp``'s edges, int64."""
        key, st = ("endpoints", sp.fingerprint, str(device)), self._shard_state
        if key not in st:
            lg = sp.shard.graph
            dst = np.repeat(np.arange(lg.num_nodes, dtype=np.int64), lg.degrees)
            st[key] = (_ids(lg.indices, device), _ids(dst, device))
        return st[key]

    def _global_edges(self, stacked: torch.Tensor) -> torch.Tensor:
        """The shards' local edges, stacked in shard order, back in global
        edge order (verbatim for a contiguous partition)."""
        key, st = ("edge_order", str(stacked.device)), self._shard_state
        if key not in st:
            pos = np.concatenate([
                np.arange(*sp.shard.edge_range) if sp.shard.edge_range is not None
                else sp.shard.edge_idx for sp in self.sharded_plan.shards if sp.shard.num_edges])
            st[key] = (None if np.array_equal(pos, np.arange(pos.size))
                       else _ids(np.argsort(pos, kind="stable"), stacked.device))
        inv = st[key]
        return stacked if inv is None else stacked[inv]

    # ------------------------------------------------------------- metrics
    def shard_report(self) -> Dict[str, object]:
        """Cluster-level lane economics: work balance + halo traffic."""
        splan = self.sharded_plan
        return {
            "num_shards": splan.num_shards,
            "partitioner": splan.partition.kind,
            "edge_balance": splan.edge_balance,
            "halo_total": splan.halo_total,
            "halo_per_shard": [s.halo_size for s in splan.shards],
            "edges_per_shard": [s.num_edges for s in splan.shards],
            "owned_per_shard": [s.num_owned for s in splan.shards],
        }


def make_sharded_engine(
    g: Graph,
    cfg=None,
    *,
    num_shards: Optional[int] = None,
    partition=None,
    partitioner: str = "edges",
    modes=("sum",),
    mesh=None,
    halo_overlap: bool = False,
) -> ShardedAmpleEngine:
    """Compile + wrap in one call (the non-serving convenience path)."""
    splan = compile_sharded_plans(
        g, cfg, num_shards=num_shards, partition=partition, partitioner=partitioner,
        modes=modes,
    )
    return ShardedAmpleEngine(g, splan, mesh=mesh, halo_overlap=halo_overlap)
