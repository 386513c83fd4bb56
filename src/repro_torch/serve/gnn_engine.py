"""Plan-cached GNN serving engine on one device.

The port of the reference's ``repro/serve/gnn_engine.py``. The expensive
part of serving a GNN request is the host-side planner (Degree-Quant tagging
+ edge-tile packing), not the device call, so
``GNNServeEngine`` treats the compiled ``ExecutionPlan`` as the cacheable
artifact:

  * requests are ``(graph, features)``; the engine keys an LRU cache on the
    graph's **structure fingerprint** + engine config + arch, so repeat
    traffic on the same graph skips plan compilation entirely;
  * independent small-graph requests are batched by ``infer_batch`` into one
    disjoint-union graph and served in a single device call — an exact union
    plan, or, with union buckets set, a union assembled from cached member
    plans and padded to a size class;
  * cached plans are bitwise-faithful: a warm request returns exactly the
    output a cold engine would produce for the same graph and features;
  * with a feature budget, a request whose feature matrix exceeds it keeps
    its features on the host (a page-locked ``memory.FeatureStore`` on the
    card) and streams them through the chunk prefetcher — bitwise the
    in-memory outputs, through the same kernels;
  * with ``num_shards`` > 1 (or a ``partition``) every served graph is
    partitioned ("edges" or "mincut") and runs through
    ``ShardedAmpleEngine``: one plan per shard, cached in a per-shard LRU
    below the assembled entry, halo rows exchanged per layer (overlapped
    with the interior tiles under ``halo_overlap``): as a host loop on one
    device, or over a ``mesh`` with one ``torch.distributed`` rank per shard;
  * ``save_plan_cache``/``load_plan_cache`` persist the cached plans
    (``checkpoint/plan_store.py``), so a restarted server serves its first
    request on a persisted structure as a cache hit;
  * ``stats`` is a live view over the process metrics registry
    (``observe.metrics``), and with the trace recorder enabled
    (``observe.trace.enable()``) every request records its ``queue``,
    ``plan``, ``execute`` (and, batched, ``scatter``) spans on the
    ``request_stamp`` clock under its ``trace_id``.

The engine runs on ``cuda`` unless it is given ``device="cpu"``, where the
kernels' plain versions run (for tests).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.degree_quant import inference_precision_tags
from repro_torch.core.message_passing import (
    AmpleEngine,
    EngineConfig,
    ExecutionPlan,
    ShardPlan,
    ShardedExecutionPlan,
    aggregation_coefficients,
    assemble_union_plan,
    compile_plans,
    compile_shard_plan,
    compile_sharded_plans,
    engine_precision_tags,
    shard_plan_key,
)
from repro_torch.core.scheduler import (
    plan_fingerprint,
    size_class,
    union_bucket_fingerprint,
)
from repro_torch.device import resolve_device
from repro_torch.distributed.graph_shard import ShardedAmpleEngine
from repro_torch.graphs.csr import Graph, disjoint_union
from repro_torch.graphs.partition import Partition, make_partition, validate_partition
from repro_torch.memory.feature_store import FeatureStore, default_chunk_rows
from repro_torch.memory.prefetcher import StreamedFeatures, StreamStats
from repro_torch.models.gnn import api as gnn_api
from repro_torch.observe import metrics as ometrics
from repro_torch.observe import trace as otrace

__all__ = ["GNNRequest", "GNNResponse", "GNNServeEngine", "request_stamp"]

# The reference engine's counters: shard_hits count per-shard plan-cache hits,
# warm_loads the plans load_plan_cache read, and the halo counters the halo
# exchanges of sharded requests (distributed.graph_shard.HaloLedger).
_STAT_KEYS = (
    "requests",
    "batches",
    "cache_hits",
    "cache_misses",
    "planner_calls",
    "evictions",
    "shard_hits",
    "warm_loads",
    "member_hits",
    "member_misses",
    "class_hits",
    "class_misses",
    "streamed_requests",
    "bytes_streamed",
    "chunk_hits",
    "chunk_misses",
    "prefetched_uploads",
    "stream_fallbacks",
    "stall_ms",
    "copy_ms",
    "halo_exchanges",
    "halo_bytes",
    "halo_ms",
    "halo_wait_ms",
)
_FLOAT_KEYS = ("stall_ms", "copy_ms", "halo_ms", "halo_wait_ms")


def request_stamp() -> float:
    """The serving stack's one lifecycle clock: ``time.perf_counter()``.

    Admission stamps (``GNNRequest.admitted_at``) and every duration
    (``plan_ms``/``run_ms``/``queue_ms``) come from this clock, so queue-wait
    arithmetic never mixes clocks.
    """
    return time.perf_counter()


@dataclasses.dataclass(frozen=True)
class GNNRequest:
    """One inference request: a graph, its node features, optional arch."""

    graph: Graph
    features: np.ndarray  # f32[N, D]
    arch: str = ""  # "" -> the engine config's arch
    admitted_at: float = 0.0  # request_stamp() at admission; 0 = unqueued
    trace_id: str = ""  # per-request correlation id of its trace spans


@dataclasses.dataclass(frozen=True)
class GNNResponse:
    outputs: np.ndarray  # f32[N, num_classes]
    cache_hit: bool
    fingerprint: str  # plan-cache key the request resolved to
    plan_ms: float  # host planning time (0.0 on a cache hit)
    run_ms: float  # device execution wall time of the WHOLE batch this
    # request rode in, fenced by a device synchronize (every member of one
    # union call reports the same number; see run_ms_per_member)
    num_shards: int = 1  # shards the plan executed over (1 = unsharded path)
    batch_size: int = 1  # members in the union device call that produced this
    queue_ms: float = 0.0  # admission -> execution-start wait (0.0 unqueued)
    # Out-of-core telemetry (all zero on the in-memory path). Like run_ms,
    # these describe the WHOLE device call: every member of one streamed
    # union batch reports the same bytes_streamed.
    streamed: bool = False  # features stayed on the host, chunk-streamed
    bytes_streamed: int = 0  # feature bytes moved host->device by the call
    chunk_hit_rate: float = 0.0  # chunk-cache hits / accesses
    prefetch_overlap: float = 0.0  # share of staged copy time not waited for
    stall_ms: float = 0.0  # wall time the stream waited for staged copies
    copy_ms: float = 0.0  # time of the staged copies themselves
    trace_id: str = ""  # correlation id of this request's trace spans ("" =
    # tracing disabled or no id assigned upstream)
    # Halo-exchange telemetry of sharded requests (zero elsewhere); like
    # run_ms it describes the whole device call. On the card the times are
    # CUDA events of the halo gathers and of the main stream's waits.
    halo_ms: float = 0.0  # time of the halo row gathers
    halo_bytes: int = 0  # bytes the halo gathers moved this call
    halo_overlap: float = 0.0  # share of halo_ms not waited for (1 - wait/halo)

    @property
    def run_ms_per_member(self) -> float:
        """Amortized device time per batch member (= run_ms when served solo)."""
        return self.run_ms / max(self.batch_size, 1)

    @property
    def bytes_streamed_per_member(self) -> float:
        """Amortized feature traffic per batch member (= bytes_streamed solo)."""
        return self.bytes_streamed / max(self.batch_size, 1)


class GNNServeEngine:
    """Serve ``(graph, features)`` requests with an LRU ``ExecutionPlan`` cache.

    Parameters
    ----------
    cfg: a ``family="gnn"`` ModelConfig (arch, dims, precision policy).
    params: model params (tensors, e.g. from ``gnn_api.params_from_numpy``);
        drawn from ``generator`` when omitted. Moved to ``device``.
    engine_cfg: EngineConfig override; derived from ``cfg`` by default.
    plan_cache_size: max distinct graph structures kept warm (LRU).
    num_shards: >1 partitions every served graph into this many shards and
        executes through ``ShardedAmpleEngine`` (halo exchange + one plan per
        shard); 1 is the single-plan path. Default ``cfg.gnn_num_shards``.
    partition: explicit ``Partition`` (validated per graph); implies the
        sharded path and fixes ``num_shards`` to its shard count.
    partitioner: "edges" (contiguous edge-balanced ranges) or "mincut"
        (halo-minimizing multilevel; params inline, e.g. "mincut(seed=1)")
        when no ``partition`` is given. Default ``cfg.gnn_partitioner``. Part
        of the plan-cache key.
    mesh: a 1-D ``("shard",)`` ``torch.distributed`` ``DeviceMesh`` with one
        rank per shard (``mesh.size() == num_shards``): each rank runs its own
        shard (``distributed/graph_shard.py``'s mesh backend) and every rank
        returns the whole output. Every rank builds this engine and serves
        the same requests in the same order; the caller sets up the process
        group, its backend and each rank's device. None runs the shards as a
        host loop on one device.
    halo_overlap: overlap each shard's halo exchange with its interior
        tiles (outputs bitwise the unsplit schedule's). Default
        ``cfg.gnn_halo_overlap``.
    union_node_bucket / union_edge_bucket: >0 switches batched serving to
        **padded union size classes**: member graphs are planned (and cached)
        individually, the union plan is assembled by index relabelling, and
        nodes/tiles are padded up to the bucket so different member mixes
        share device shapes. 0 keeps exact-shape union plans. Defaults come
        from ``cfg.gnn_union_node_bucket`` / ``cfg.gnn_union_edge_bucket``.
    feature_budget_bytes: >0 enables **out-of-core serving**: a request whose
        feature matrix exceeds the budget keeps its features on the host in a
        chunked ``memory.FeatureStore`` and the engine streams them through a
        budget-bound device chunk cache (reuse-distance eviction, staged
        prefetch) — outputs bitwise the in-memory path's. Requests that fit
        take the in-memory path. Default ``cfg.gnn_feature_budget_bytes``.
        Ignored, with a warning, on sharded engines, which serve in memory.
    feature_chunk_rows: rows per feature chunk (0 derives a size from the
        budget). Default ``cfg.gnn_feature_chunk_rows``.
    stream_packing: serve streamed requests through chunk-packed tile plans
        (``scheduler.pack_tiles_by_chunk``; bitwise-identical outputs).
        Default ``cfg.gnn_stream_packing``.
    stream_reorder: locality-reorder tile runs on the streamed path; False
        keeps plan order. Default ``cfg.gnn_stream_reorder``.
    stream_prefetch_depth: lookahead of the slot prefetch (tiles) and of the
        staging worker (copies); 0 streams synchronously.
    device: where requests run; ``cuda`` (the default) raises when there is
        no card. ``cpu`` runs the kernels' plain versions.
    generator: the ``torch.Generator`` params are drawn from (seed 0 when
        omitted).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params=None,
        *,
        engine_cfg: Optional[EngineConfig] = None,
        plan_cache_size: int = 32,
        num_shards: Optional[int] = None,
        partition: Optional[Partition] = None,
        partitioner: Optional[str] = None,
        mesh=None,
        halo_overlap: Optional[bool] = None,
        union_node_bucket: Optional[int] = None,
        union_edge_bucket: Optional[int] = None,
        feature_budget_bytes: Optional[int] = None,
        feature_chunk_rows: Optional[int] = None,
        stream_packing: Optional[bool] = None,
        stream_reorder: Optional[bool] = None,
        stream_prefetch_depth: int = 2,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        if cfg.family != "gnn":
            raise ValueError(f"GNNServeEngine needs a family='gnn' config, got {cfg.family!r}")
        num_shards = cfg.gnn_num_shards if num_shards is None else num_shards
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg if engine_cfg is not None else gnn_api.engine_config(cfg)
        if params is None:
            params = gnn_api.gnn_init(cfg, generator, device=self.device)
        self.params = _to_device(params, self.device)
        self.plan_cache_size = plan_cache_size
        self.partition = partition
        self.num_shards = partition.num_shards if partition is not None else num_shards
        if mesh is not None and mesh.size() != self.num_shards:
            raise ValueError(
                f"mesh has {mesh.size()} devices but num_shards={self.num_shards}; pass "
                f"--num-shards {mesh.size()} (or a mesh with one device per shard)")
        self.mesh = mesh
        self.partitioner = (cfg.gnn_partitioner if partitioner is None else partitioner) or "edges"
        self.halo_overlap = cfg.gnn_halo_overlap if halo_overlap is None else halo_overlap
        self.union_node_bucket = (
            cfg.gnn_union_node_bucket if union_node_bucket is None else union_node_bucket
        )
        self.union_edge_bucket = (
            cfg.gnn_union_edge_bucket if union_edge_bucket is None else union_edge_bucket
        )
        self.feature_budget_bytes = (
            cfg.gnn_feature_budget_bytes if feature_budget_bytes is None
            else feature_budget_bytes
        )
        self.feature_chunk_rows = (
            cfg.gnn_feature_chunk_rows if feature_chunk_rows is None else feature_chunk_rows
        )
        self.stream_packing = cfg.gnn_stream_packing if stream_packing is None else stream_packing
        self.stream_reorder = cfg.gnn_stream_reorder if stream_reorder is None else stream_reorder
        self.stream_prefetch_depth = max(int(stream_prefetch_depth), 0)
        if self.feature_budget_bytes > 0 and self.sharded:
            warnings.warn(
                "feature_budget_bytes is ignored on sharded engines: the "
                "streamed executors serve the single-device engine only; "
                "requests will run fully in-memory",
                stacklevel=2,
            )
        # fingerprint -> (prepared graph, plan, engine); OrderedDict as LRU.
        # The engine rides along so its device plans and weight-quant cache
        # survive across requests (params are fixed for this engine's life).
        # Sharded requests store (prepared, ShardedExecutionPlan,
        # ShardedAmpleEngine) under the same LRU.
        self._cache: "OrderedDict[str, Tuple[Graph, object, AmpleEngine]]" = OrderedDict()
        # Per-shard plan LRU, keyed on shard_plan_key (structure, partition,
        # shard index, planner config): a shard compiled for one request is
        # reusable by any later request on the same partitioned structure.
        self._shard_plans: "OrderedDict[str, ShardPlan]" = OrderedDict()
        self._shard_plan_ms: Dict[str, float] = {}  # shard fingerprint -> its compile ms
        # Member-plan pieces for the padded-union path, keyed on the member's
        # structure fingerprint: value = (prepared member graph, its solo
        # ExecutionPlan). A member planned for one batch mix is reusable by
        # every later mix containing it.
        self._member_plans: "OrderedDict[str, Tuple[Graph, ExecutionPlan]]" = OrderedDict()
        # Size classes already served (device shapes warm); statistics only.
        self._classes_seen: "OrderedDict[str, None]" = OrderedDict()
        # FeatureStore LRU for the out-of-core path, keyed on (feature array
        # identity, row count, chunk rows) with a strong ref held — id()
        # alone is unsound once the original is collected.
        self._stores: "OrderedDict[tuple, Tuple[object, FeatureStore]]" = OrderedDict()
        self._last_stream: Optional[StreamStats] = None  # of the most recent _run
        self._last_halo: Optional[Dict[str, float]] = None  # of the most recent _run
        # Registry-backed counters: engine.stats[...] and the registry's
        # dump read the same cells (ints stay ints, *_ms stay floats).
        self.instance = ometrics.next_instance("gnn_serve")
        self.stats: ometrics.StatsView = ometrics.StatsView(
            ometrics.get_registry(), "gnn_serve", {"engine": self.instance},
            keys=_STAT_KEYS, float_keys=_FLOAT_KEYS,
        )

    @property
    def sharded(self) -> bool:
        return self.num_shards > 1 or self.partition is not None

    @property
    def padded_unions(self) -> bool:
        """True when batched requests plan through padded union size classes
        (never on the sharded path, whose unions are planned exactly)."""
        return (self.union_node_bucket > 0 or self.union_edge_bucket > 0) and not self.sharded

    # ------------------------------------------------------------ plan cache
    def _cache_key(self, g: Graph, arch: str, members: Optional[Sequence[Graph]]) -> str:
        """Structure hash + engine config + arch — everything that shapes a plan.

        Keyed on the *raw* request graph so arch-specific preprocessing
        (GCN's self-loops) is part of the cached work, not repeated per hit.
        Batched unions also key on the member boundaries, since Degree-Quant
        tags are computed per member graph.
        """
        parts = [repr(self.engine_cfg), arch]
        if members is not None:
            parts.append("bounds:" + ",".join(str(m.num_nodes) for m in members))
        if self.sharded:
            if self.partition is not None:
                parts.append("starts:" + ",".join(str(int(s)) for s in self.partition.starts))
                parts.append(f"kind:{self.partition.kind}")
            else:
                parts.append(f"shards:{self.num_shards}")
                parts.append(f"partitioner:{self.partitioner}")
            if self.halo_overlap:
                # plan contents are identical, but the cached engine holds
                # split-plan device state: keep the entries distinct
                parts.append("halo_overlap")
        return plan_fingerprint(g, *parts)

    def _plan_for(
        self, g: Graph, arch: str, members: Optional[Sequence[Graph]] = None
    ) -> Tuple[Graph, ExecutionPlan, AmpleEngine, bool, float]:
        key = self._cache_key(g, arch, members)
        hit = key in self._cache
        plan_ms = 0.0
        if hit:
            self._cache.move_to_end(key)
            self.stats["cache_hits"] += 1
        else:
            self.stats["cache_misses"] += 1
            self.stats["planner_calls"] += 1
            cfg = dataclasses.replace(self.cfg, gnn_arch=arch)
            t0 = request_stamp()
            prepared = gnn_api.prepare_graph(cfg, g)
            tags = None
            if members is not None and self.engine_cfg.mixed_precision:
                # Tag each member independently: a small graph batched with a
                # hub-heavy one keeps its own Degree-Quant-protected nodes,
                # exactly as if served solo.
                tags = self._member_tags(cfg, members)
            plan = compile_plans(
                prepared, self.engine_cfg, modes=(gnn_api.agg_mode(cfg),),
                precision_tags=tags,
            )
            plan_ms = (request_stamp() - t0) * 1e3
            self._cache[key] = (prepared, plan, AmpleEngine(prepared, plan=plan))
            self._evict()
        prepared, plan, engine = self._cache[key]
        return prepared, plan, engine, hit, plan_ms

    def _evict(self) -> None:
        while len(self._cache) > self.plan_cache_size:
            self._cache.popitem(last=False)
            self.stats["evictions"] += 1

    def _member_tags(self, cfg, members: Sequence[Graph]) -> np.ndarray:
        """Per-member Degree-Quant tags for a batched disjoint union."""
        return np.concatenate([
            inference_precision_tags(
                gnn_api.prepare_graph(cfg, m), self.engine_cfg.dq
            )
            for m in members
        ])

    # ------------------------------------------ padded union size classes
    def _member_plan(self, cfg, m: Graph, arch: str) -> Tuple[Graph, ExecutionPlan]:
        """One member graph's (prepared graph, solo plan), LRU-cached."""
        key = plan_fingerprint(m, repr(self.engine_cfg), arch, "member")
        if key in self._member_plans:
            self._member_plans.move_to_end(key)
            self.stats["member_hits"] += 1
            return self._member_plans[key]
        self.stats["member_misses"] += 1
        self.stats["planner_calls"] += 1
        prepared = gnn_api.prepare_graph(cfg, m)
        plan = compile_plans(
            prepared,
            self.engine_cfg,
            modes=(gnn_api.agg_mode(cfg),),
            precision_tags=engine_precision_tags(prepared, self.engine_cfg),
        )
        self._member_plans[key] = (prepared, plan)
        while len(self._member_plans) > max(self.plan_cache_size * 8, 64):
            self._member_plans.popitem(last=False)
        return prepared, plan

    def _plan_for_padded(
        self, members: Sequence[Graph], arch: str
    ) -> Tuple[Graph, ExecutionPlan, AmpleEngine, bool, float]:
        """Size-class planning: cached member pieces → assembled padded union.

        ``cache_hit`` is True when neither the members nor the assembly
        needed the planner; ``plan_ms`` covers whatever planning + assembly
        this call actually paid.
        """
        cfg = dataclasses.replace(self.cfg, gnn_arch=arch)
        t0 = request_stamp()
        misses_before = self.stats["member_misses"]
        pieces = [self._member_plan(cfg, m, arch) for m in members]
        members_cold = self.stats["member_misses"] > misses_before
        n_real = sum(p.num_nodes for p, _ in pieces)
        e_real = sum(p.num_edges for p, _ in pieces)
        class_fp = union_bucket_fingerprint(
            n_real,
            e_real,
            self.union_node_bucket,
            self.union_edge_bucket,
            repr(self.engine_cfg),
            arch,
        )
        if class_fp in self._classes_seen:
            self._classes_seen.move_to_end(class_fp)
            self.stats["class_hits"] += 1
        else:
            self._classes_seen[class_fp] = None
            self.stats["class_misses"] += 1
            while len(self._classes_seen) > self.plan_cache_size * 8:
                self._classes_seen.popitem(last=False)

        h = hashlib.blake2b(digest_size=16)
        h.update(class_fp.encode())
        for _, mp in pieces:
            h.update(b"\x00")
            h.update(mp.fingerprint.encode())
        key = h.hexdigest()
        if key in self._cache:
            self._cache.move_to_end(key)
            self.stats["cache_hits"] += 1
            prepared, plan, engine = self._cache[key]
            plan_ms = (request_stamp() - t0) * 1e3 if members_cold else 0.0
            return prepared, plan, engine, not members_cold, plan_ms

        self.stats["cache_misses"] += 1
        n_class, _ = size_class(
            n_real, e_real, self.union_node_bucket, self.union_edge_bucket
        )
        union = disjoint_union([p for p, _ in pieces], pad_num_nodes=n_class)
        plan = assemble_union_plan(
            [mp for _, mp in pieces],
            union,
            cfg=self.engine_cfg,
            edge_bucket=self.union_edge_bucket,
        )
        engine = AmpleEngine(union, plan=plan)
        plan_ms = (request_stamp() - t0) * 1e3
        self._cache[key] = (union, plan, engine)
        self._evict()
        return union, plan, engine, False, plan_ms

    def _plan_for_sharded(
        self, g: Graph, arch: str, members: Optional[Sequence[Graph]] = None
    ) -> Tuple[Graph, ShardedExecutionPlan, ShardedAmpleEngine, bool, float]:
        """Sharded analogue of ``_plan_for``: per-shard plan-cache economics.

        The assembled (prepared graph, ShardedExecutionPlan, engine) triple is
        cached under the request key; below it every ShardPlan lives in a
        per-shard LRU, so only shards never seen before run the planner.
        ``cache_hit`` is True iff no shard needed compiling; ``plan_ms``
        counts planner time only (0.0 on a full hit).
        """
        key = self._cache_key(g, arch, members)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.stats["cache_hits"] += 1
            prepared, splan, engine = self._cache[key]
            return prepared, splan, engine, True, 0.0

        cfg = dataclasses.replace(self.cfg, gnn_arch=arch)
        prepared = gnn_api.prepare_graph(cfg, g)
        if self.partition is not None:
            validate_partition(prepared, self.partition)
            part = self.partition
        else:
            part = make_partition(prepared, self.num_shards, self.partitioner)
        modes = (gnn_api.agg_mode(cfg),)
        if members is not None and self.engine_cfg.mixed_precision:
            tags = self._member_tags(cfg, members)
        else:
            tags = engine_precision_tags(prepared, self.engine_cfg)

        plan_ms = 0.0
        warm: Dict[int, ShardPlan] = {}
        missing: List[int] = []
        for k in range(part.num_shards):
            skey = shard_plan_key(prepared, part, k, self.engine_cfg, modes=modes,
                                  precision_tags=tags)
            if skey in self._shard_plans:
                self._shard_plans.move_to_end(skey)
                warm[k] = self._shard_plans[skey]
                self.stats["shard_hits"] += 1
            else:
                missing.append(k)
        if missing:
            self.stats["planner_calls"] += len(missing)
            t0 = request_stamp()
            # Global O(E) coefficient work once per request, not per shard.
            mode_coeffs = {m: aggregation_coefficients(prepared, m) for m in modes}
            for k in missing:
                t_k = request_stamp()
                sp = compile_shard_plan(prepared, part, k, self.engine_cfg, modes=modes,
                                        precision_tags=tags, mode_coeffs=mode_coeffs)
                self._shard_plan_ms[sp.fingerprint] = (request_stamp() - t_k) * 1e3
                warm[k] = sp
                self._shard_plans[sp.fingerprint] = sp
            plan_ms = (request_stamp() - t0) * 1e3
            while len(self._shard_plans) > self.plan_cache_size * max(self.num_shards, 1):
                self._shard_plan_ms.pop(self._shard_plans.popitem(last=False)[0], None)
        splan = compile_sharded_plans(prepared, self.engine_cfg, partition=part, modes=modes,
                                      precision_tags=tags, shard_plans=warm)
        engine = ShardedAmpleEngine(prepared, splan, mesh=self.mesh,
                                    halo_overlap=self.halo_overlap)
        hit = not missing
        self.stats["cache_hits" if hit else "cache_misses"] += 1
        self._cache[key] = (prepared, splan, engine)
        self._evict()
        return prepared, splan, engine, hit, plan_ms

    # -------------------------------------------------------------- serving
    def _arch(self, requested: str) -> str:
        if requested and requested != self.cfg.gnn_arch:
            raise ValueError(
                f"this engine holds {self.cfg.gnn_arch!r} params; route "
                f"{requested!r} requests to an engine configured for that arch"
            )
        return requested or self.cfg.gnn_arch

    def _validate_request(self, graph: Graph, features) -> np.ndarray:
        """Admission-time input checks with actionable errors."""
        if graph.num_nodes == 0:
            raise ValueError(
                "cannot serve a zero-node graph; drop empty members before "
                "submission"
            )
        f = np.asarray(features, np.float32)
        if f.ndim != 2:
            raise ValueError(
                f"features must be 2-D [num_nodes, feature_dim], got shape "
                f"{tuple(f.shape)}"
            )
        if f.shape[0] != graph.num_nodes:
            raise ValueError(
                f"features have {f.shape[0]} rows but graph {graph.name!r} has "
                f"{graph.num_nodes} nodes"
            )
        want = self.cfg.gnn_layer_dims[0]
        if f.shape[1] != want:
            raise ValueError(
                f"features have {f.shape[1]} columns but {self.cfg.name} "
                f"expects {want} (cfg.d_model)"
            )
        return f

    def _plan_for_batch(
        self, members: Sequence[Graph], arch: str
    ) -> Tuple[Graph, ExecutionPlan, AmpleEngine, bool, float]:
        """Plan-assembly step for a disjoint-union batch: padded engines
        assemble cached member pieces into a size-class plan; sharded
        engines plan the exact union per shard; the default engine compiles
        the exact union (with per-member Degree-Quant tags)."""
        if self.padded_unions:
            return self._plan_for_padded(members, arch)
        union = disjoint_union(list(members))
        if self.sharded:
            return self._plan_for_sharded(union, arch, members)
        return self._plan_for(union, arch, members)

    @staticmethod
    def _pad_features(features: np.ndarray, num_nodes: int) -> np.ndarray:
        """Zero rows up to the size-class node count (no-op when exact)."""
        if num_nodes <= features.shape[0]:
            return features
        return np.concatenate(
            [features,
             np.zeros((num_nodes - features.shape[0], features.shape[1]),
                      np.float32)],
            axis=0,
        )

    # ------------------------------------------------- out-of-core streaming
    def _stream_eligible(self, engine: AmpleEngine, features: np.ndarray) -> bool:
        """Stream iff a budget is set, the matrix exceeds it, and the plan
        runs on the single-device engine. On the card the streamed path
        launches the same kernels as the in-memory one (the AGE is bitwise
        its plain version), so streamed == in-memory holds there too."""
        return (
            self.feature_budget_bytes > 0
            and type(engine) is AmpleEngine
            and features.nbytes > self.feature_budget_bytes
        )

    def _feature_stream(
        self, features: np.ndarray, *, cache_store: bool = True, store_key=None
    ) -> StreamedFeatures:
        """Wrap ``features`` in a StreamedFeatures handle (store LRU-cached).

        Repeat traffic holding the same feature array skips the store build
        (chunking, int8 quantization and, on the card, page-locking) exactly
        like repeat structures skip the planner. ``store_key`` is the
        caller-held object the cache identity hangs on when ``features`` is
        derived per call — the padded-union path pads a fresh copy each
        request, so keying on the *original* matrix (plus the padded row
        count) is what lets warm padded requests hit. ``cache_store=False``
        builds an ephemeral store: the batch path concatenates a fresh union
        matrix per call, which could never hit again.
        """
        rows = self.feature_chunk_rows or default_chunk_rows(
            features.shape[0], features.shape[1], self.feature_budget_bytes
        )

        def build():
            return FeatureStore.from_array(
                features, chunk_rows=rows, pin_memory=self.device.type == "cuda")

        if not cache_store:
            store = build()
        else:
            key_obj = store_key if store_key is not None else features
            key = (id(key_obj), features.shape[0], rows)
            entry = self._stores.get(key)
            if entry is None or entry[0] is not key_obj:
                self._stores[key] = (key_obj, build())
                while len(self._stores) > 4:
                    self._stores.popitem(last=False)
            else:
                self._stores.move_to_end(key)
            store = self._stores[key][1]
        return StreamedFeatures(
            store,
            self.feature_budget_bytes,
            prefetch_depth=self.stream_prefetch_depth,
            reorder=self.stream_reorder,
            packing=self.stream_packing,
            device=self.device,
        )

    def _run(
        self,
        arch: str,
        prepared: Graph,
        engine: AmpleEngine,
        features: np.ndarray,
        *,
        cache_store: bool = True,
        store_key=None,
        trace_id: str = "",
    ) -> Tuple[np.ndarray, float]:
        """Execution step: one device call over an assembled plan.

        ``run_ms`` spans the feature upload (or stream), the forward and a
        device synchronize, on the ``request_stamp`` clock; the ``execute``
        span records the same stamps. When the feature matrix exceeds
        ``feature_budget_bytes`` the features stay on the host and stream
        chunk-wise — the same outputs, bit for bit; telemetry lands in
        ``stats`` and on the response. ``cache_store``/``store_key`` as in
        ``_feature_stream``.
        """
        cfg = dataclasses.replace(self.cfg, gnn_arch=arch)
        self._last_stream = None
        self._last_halo = None
        halo_before = None
        if isinstance(engine, ShardedAmpleEngine):
            engine.trace_id = trace_id  # halo spans join this request's trace
            halo_before = engine.halo_stats
        t0 = request_stamp()
        if self._stream_eligible(engine, features):
            x = self._feature_stream(features, cache_store=cache_store, store_key=store_key)
            x.trace_id = trace_id  # the prefetcher stamps its spans with it
            self._last_stream = x.stats
        else:
            x = torch.from_numpy(features).to(self.device)
        y, _ = gnn_api.gnn_forward(
            self.params, cfg, {"graph": prepared, "features": x, "engine": engine}
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = request_stamp()
        rec = otrace.get_recorder()
        if rec.enabled:
            rec.add_span(
                "execute", t0, t1, cat="serve", trace_id=trace_id,
                args={"arch": arch, "streamed": self._last_stream is not None},
            )
        s = self._last_stream
        if s is not None:
            self.stats["bytes_streamed"] += s.bytes_streamed
            self.stats["chunk_hits"] += s.chunk_hits
            self.stats["chunk_misses"] += s.chunk_misses
            self.stats["prefetched_uploads"] += s.prefetched
            self.stats["stream_fallbacks"] += s.fallbacks
            self.stats["stall_ms"] += s.stall_ms
            self.stats["copy_ms"] += s.copy_ms
        if halo_before is not None:
            # This call's halo traffic: the delta of the engine's totals (the
            # engine is shared across cached requests).
            after = engine.halo_stats
            delta = {k: after[k] - halo_before[k] for k in after}
            if delta["halo_exchanges"] > 0:
                self._last_halo = delta
                self.stats["halo_exchanges"] += int(delta["halo_exchanges"])
                self.stats["halo_bytes"] += int(delta["halo_bytes"])
                self.stats["halo_ms"] += delta["halo_ms"]
                self.stats["halo_wait_ms"] += delta["halo_wait_ms"]
        return y.cpu().numpy(), (t1 - t0) * 1e3

    def _stream_fields(self) -> Dict[str, object]:
        """Response fields describing the most recent ``_run``'s streaming."""
        s = self._last_stream
        if s is None:
            return {}
        return {
            "streamed": True,
            "bytes_streamed": s.bytes_streamed,
            "chunk_hit_rate": s.hit_rate,
            "prefetch_overlap": s.prefetch_overlap,
            "stall_ms": s.stall_ms,
            "copy_ms": s.copy_ms,
        }

    def _halo_fields(self) -> Dict[str, object]:
        """Response fields describing the most recent ``_run``'s halo traffic:
        ``halo_overlap`` is the share of halo time not waited for
        (``1 - halo_wait_ms / halo_ms``, in [0, 1])."""
        h = self._last_halo
        if h is None:
            return {}
        return {
            "halo_ms": h["halo_ms"],
            "halo_bytes": int(h["halo_bytes"]),
            "halo_overlap": _overlap(h["halo_wait_ms"], h["halo_ms"]),
        }

    @staticmethod
    def _queue_ms(admitted_at: float, exec_start: float) -> float:
        """Admission→execution wait; 0.0 for requests that never queued."""
        if admitted_at <= 0.0:
            return 0.0
        return max(exec_start - admitted_at, 0.0) * 1e3

    @torch.no_grad()
    def infer(
        self,
        graph: Graph,
        features,
        *,
        arch: str = "",
        admitted_at: float = 0.0,
        trace_id: str = "",
    ) -> GNNResponse:
        """Serve one request; plans come from the LRU cache when warm.

        With padded unions enabled the request is served as a batch of one —
        its member plan piece then pre-warms every future batch containing
        this structure. With the trace recorder enabled, the request's spans
        carry ``trace_id`` (a new id when it is "").

        Serving runs under ``torch.no_grad()``, so parameters that require
        grad serve too. Not ``inference_mode``: a training call on the same
        engine may save the cached plans and node groups for backward.
        """
        arch = self._arch(arch)
        # The store-cache identity is the caller's object: validation may
        # convert, and padding copies — keying on either derived array would
        # rebuild the store on every warm request.
        original = features
        features = self._validate_request(graph, features)
        rec = otrace.get_recorder()
        if rec.enabled and not trace_id:
            trace_id = otrace.new_trace_id()
        exec_start = request_stamp()
        queue_ms = self._queue_ms(admitted_at, exec_start)
        if rec.enabled and admitted_at > 0.0:
            rec.add_span("queue", admitted_at, exec_start, cat="serve", trace_id=trace_id)
        if self.padded_unions:
            prepared, plan, engine, hit, plan_ms = self._plan_for_padded([graph], arch)
            features = self._pad_features(features, prepared.num_nodes)
        elif self.sharded:
            prepared, plan, engine, hit, plan_ms = self._plan_for_sharded(graph, arch)
        else:
            prepared, plan, engine, hit, plan_ms = self._plan_for(graph, arch)
        if rec.enabled:
            rec.add_span(
                "plan", exec_start, request_stamp(), cat="serve", trace_id=trace_id,
                args={"cache_hit": hit, "plan_ms": plan_ms},
            )
        y, run_ms = self._run(
            arch, prepared, engine, features, store_key=original, trace_id=trace_id
        )
        self.stats["requests"] += 1
        if self._last_stream is not None:
            self.stats["streamed_requests"] += 1
        return GNNResponse(
            outputs=y[: graph.num_nodes],
            cache_hit=hit,
            fingerprint=plan.fingerprint,
            plan_ms=plan_ms,
            run_ms=run_ms,
            num_shards=getattr(plan, "num_shards", 1),
            queue_ms=queue_ms,
            trace_id=trace_id,
            **self._stream_fields(),
            **self._halo_fields(),
        )

    @torch.no_grad()
    def infer_batch(self, requests: Sequence[GNNRequest]) -> List[GNNResponse]:
        """Batch independent small-graph requests into one device call.

        All requests must target this engine's arch. The disjoint union is
        block-diagonal and every aggregation coefficient depends only on
        per-node degree, so in float precision the union forward equals the
        per-request forwards stacked; outputs are split back by node counts.
        Under the mixed policy, Degree-Quant tags are computed per member
        graph, while int8 activation scale/zero-point remain batch-wide.
        """
        if not requests:
            return []
        arch = self._arch(requests[0].arch)
        for r in requests[1:]:
            self._arch(r.arch)
        feats = [self._validate_request(r.graph, r.features) for r in requests]
        rec = otrace.get_recorder()
        exec_start = request_stamp()
        queue_waits = [self._queue_ms(r.admitted_at, exec_start) for r in requests]
        batch_tid = requests[0].trace_id
        if rec.enabled:
            if not batch_tid:
                batch_tid = otrace.new_trace_id()
            # Per-member queue spans carry each request's own id; the
            # window-level plan/execute/scatter spans carry the lead member's.
            for r in requests:
                if r.admitted_at > 0.0:
                    rec.add_span("queue", r.admitted_at, exec_start, cat="serve",
                                 trace_id=r.trace_id or batch_tid)
        members = [r.graph for r in requests]
        prepared, plan, engine, hit, plan_ms = self._plan_for_batch(members, arch)
        if rec.enabled:
            rec.add_span(
                "plan", exec_start, request_stamp(), cat="serve", trace_id=batch_tid,
                args={"cache_hit": hit, "plan_ms": plan_ms, "batch": len(requests)},
            )
        features = self._pad_features(np.concatenate(feats, axis=0), prepared.num_nodes)
        y, run_ms = self._run(
            arch, prepared, engine, features, cache_store=False, trace_id=batch_tid
        )
        # Counted only on success, so a failed-and-requeued continuous-batching
        # window does not double-count when it retries.
        self.stats["requests"] += len(requests)
        if self._last_stream is not None:
            self.stats["streamed_requests"] += len(requests)
        self.stats["batches"] += 1
        out: List[GNNResponse] = []
        start = 0
        stream_fields = {**self._stream_fields(), **self._halo_fields()}
        scatter_t0 = request_stamp()
        for r, q_ms in zip(requests, queue_waits):
            stop = start + r.graph.num_nodes
            out.append(
                GNNResponse(
                    outputs=y[start:stop],
                    cache_hit=hit,
                    fingerprint=plan.fingerprint,
                    plan_ms=plan_ms,
                    run_ms=run_ms,
                    num_shards=getattr(plan, "num_shards", 1),
                    batch_size=len(requests),
                    queue_ms=q_ms,
                    trace_id=r.trace_id or batch_tid,
                    **stream_fields,
                )
            )
            start = stop
        if rec.enabled:
            rec.add_span(
                "scatter", scatter_t0, request_stamp(), cat="serve", trace_id=batch_tid,
                args={"batch": len(requests)},
            )
        return out

    # --------------------------------------------------------- persistence
    def save_plan_cache(self, directory: str) -> List[str]:
        """Persist every cached plan (npz via ``checkpoint.plan_store``).

        One file per cache entry, named by the serve-cache key; the prepared
        graph structure rides along so ``load_plan_cache`` can rebuild the
        execution engine without re-running arch preprocessing. The member
        plans of the padded-union path are saved too (``member_key``): an
        assembled plan is a warm hit only when its members are.
        """
        from repro_torch.checkpoint.plan_store import save_plan

        os.makedirs(directory, exist_ok=True)
        paths = []
        entries = [(key, "serve_key", prepared, plan)
                   for key, (prepared, plan, _) in self._cache.items()]
        entries += [(key, "member_key", prepared, plan)
                    for key, (prepared, plan) in self._member_plans.items()]
        for key, kind, prepared, plan in entries:
            path = os.path.join(directory, f"{key}.plan.npz")
            save_plan(path, plan, graph=prepared, extra={kind: key})
            paths.append(path)
        return paths

    def load_plan_cache(self, directory: str) -> int:
        """Warm the plan cache from ``save_plan_cache`` output; returns count.

        A restarted server calls this instead of paying the planner again:
        the first request on a persisted structure reports ``cache_hit=True``
        with ``plan_ms == 0.0``, exactly like in-memory repeat traffic.
        Entries whose file lacks a serve (or member) key or graph are
        skipped; the count is of serve entries. On a mesh each rank loads the
        whole file (the host loop's format) and uploads only its own shard's
        device plans, at its first request.
        """
        from repro_torch.checkpoint.plan_store import load_plan

        if not os.path.isdir(directory):
            return 0
        loaded = 0
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".plan.npz"):
                continue
            rec = load_plan(os.path.join(directory, name))
            key = rec.extra.get("serve_key")
            if rec.graph is None:
                continue
            if "member_key" in rec.extra:
                self._member_plans[rec.extra["member_key"]] = (rec.graph, rec.plan)
                continue
            if key is None:
                continue
            if isinstance(rec.plan, ShardedExecutionPlan):
                engine: AmpleEngine = ShardedAmpleEngine(
                    rec.graph, rec.plan, mesh=self.mesh, halo_overlap=self.halo_overlap)
                for sp in rec.plan.shards:
                    self._shard_plans[sp.fingerprint] = sp
            else:
                engine = AmpleEngine(rec.graph, plan=rec.plan)
            self._cache[key] = (rec.graph, rec.plan, engine)
            loaded += 1
        self._evict()
        self.stats["warm_loads"] += loaded
        return loaded

    # ------------------------------------------------------------- metrics
    def cache_info(self) -> Dict[str, float]:
        """Plan-cache size and capacity, the ``stats`` counters and derived
        rates over every request this engine served (0.0 when none):
        ``chunk_hit_rate``, ``prefetch_overlap`` (``1 - stall_ms /
        copy_ms``) and ``halo_overlap`` (``1 - halo_wait_ms / halo_ms``)."""
        accesses = self.stats["chunk_hits"] + self.stats["chunk_misses"]
        return {
            "size": len(self._cache),
            "capacity": self.plan_cache_size,
            **self.stats,
            "chunk_hit_rate": self.stats["chunk_hits"] / accesses if accesses else 0.0,
            "prefetch_overlap": _overlap(self.stats["stall_ms"], self.stats["copy_ms"]),
            "halo_overlap": _overlap(self.stats["halo_wait_ms"], self.stats["halo_ms"]),
        }

    def shard_report(self) -> Optional[Dict[str, object]]:
        """Shard economics (edge balance, halo volume, each shard's compile
        ms where this engine compiled it, else None) of the most recently
        planned sharded request; None when nothing sharded is cached."""
        for _, splan, engine in reversed(list(self._cache.values())):
            if isinstance(engine, ShardedAmpleEngine):
                return dict(engine.shard_report(), plan_ms_per_shard=[
                    self._shard_plan_ms.get(s.fingerprint) for s in splan.shards])
        return None


def _overlap(waited_ms: float, total_ms: float) -> float:
    """Share of ``total_ms`` not waited for, in [0, 1] (0.0 when nothing ran)."""
    return min(max(1.0 - waited_ms / total_ms, 0.0), 1.0) if total_ms > 0.0 else 0.0


def _to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    return params.to(device)
