"""Plan-cached GNN serving engine on one device.

The port of the reference's ``repro/serve/gnn_engine.py`` for the unsharded,
in-memory path. The expensive part of serving a GNN request is the host-side
planner (Degree-Quant tagging + edge-tile packing), not the device call, so
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
    output a cold engine would produce for the same graph and features.

The engine runs on ``cuda`` unless it is given ``device="cpu"``, where the
kernels' plain versions run (for tests).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
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
    assemble_union_plan,
    compile_plans,
    engine_precision_tags,
)
from repro_torch.core.scheduler import (
    plan_fingerprint,
    size_class,
    union_bucket_fingerprint,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, disjoint_union
from repro_torch.models.gnn import api as gnn_api

__all__ = ["GNNRequest", "GNNResponse", "GNNServeEngine", "request_stamp"]

_STAT_KEYS = (
    "requests",
    "batches",
    "cache_hits",
    "cache_misses",
    "planner_calls",
    "evictions",
    "member_hits",
    "member_misses",
    "class_hits",
    "class_misses",
)


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


@dataclasses.dataclass(frozen=True)
class GNNResponse:
    outputs: np.ndarray  # f32[N, num_classes]
    cache_hit: bool
    fingerprint: str  # plan-cache key the request resolved to
    plan_ms: float  # host planning time (0.0 on a cache hit)
    run_ms: float  # device execution wall time of the WHOLE batch this
    # request rode in, fenced by a device synchronize (every member of one
    # union call reports the same number; see run_ms_per_member)
    batch_size: int = 1  # members in the union device call that produced this
    queue_ms: float = 0.0  # admission -> execution-start wait (0.0 unqueued)

    @property
    def run_ms_per_member(self) -> float:
        """Amortized device time per batch member (= run_ms when served solo)."""
        return self.run_ms / max(self.batch_size, 1)


class GNNServeEngine:
    """Serve ``(graph, features)`` requests with an LRU ``ExecutionPlan`` cache.

    Parameters
    ----------
    cfg: a ``family="gnn"`` ModelConfig (arch, dims, precision policy).
    params: model params (tensors, e.g. from ``gnn_api.params_from_numpy``);
        drawn from ``generator`` when omitted. Moved to ``device``.
    engine_cfg: EngineConfig override; derived from ``cfg`` by default.
    plan_cache_size: max distinct graph structures kept warm (LRU).
    union_node_bucket / union_edge_bucket: >0 switches batched serving to
        **padded union size classes**: member graphs are planned (and cached)
        individually, the union plan is assembled by index relabelling, and
        nodes/tiles are padded up to the bucket so different member mixes
        share device shapes. 0 keeps exact-shape union plans. Defaults come
        from ``cfg.gnn_union_node_bucket`` / ``cfg.gnn_union_edge_bucket``.
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
        union_node_bucket: Optional[int] = None,
        union_edge_bucket: Optional[int] = None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        if cfg.family != "gnn":
            raise ValueError(f"GNNServeEngine needs a family='gnn' config, got {cfg.family!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg if engine_cfg is not None else gnn_api.engine_config(cfg)
        if params is None:
            params = gnn_api.gnn_init(cfg, generator, device=self.device)
        self.params = _to_device(params, self.device)
        self.plan_cache_size = plan_cache_size
        self.union_node_bucket = (
            cfg.gnn_union_node_bucket if union_node_bucket is None else union_node_bucket
        )
        self.union_edge_bucket = (
            cfg.gnn_union_edge_bucket if union_edge_bucket is None else union_edge_bucket
        )
        # fingerprint -> (prepared graph, plan, engine); OrderedDict as LRU.
        # The engine rides along so its device plans and weight-quant cache
        # survive across requests (params are fixed for this engine's life).
        self._cache: "OrderedDict[str, Tuple[Graph, ExecutionPlan, AmpleEngine]]" = OrderedDict()
        # Member-plan pieces for the padded-union path, keyed on the member's
        # structure fingerprint: value = (prepared member graph, its solo
        # ExecutionPlan). A member planned for one batch mix is reusable by
        # every later mix containing it.
        self._member_plans: "OrderedDict[str, Tuple[Graph, ExecutionPlan]]" = OrderedDict()
        # Size classes already served (device shapes warm); statistics only.
        self._classes_seen: "OrderedDict[str, None]" = OrderedDict()
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}

    @property
    def padded_unions(self) -> bool:
        """True when batched requests plan through padded union size classes."""
        return self.union_node_bucket > 0 or self.union_edge_bucket > 0

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
        assemble cached member pieces into a size-class plan; the default
        engine compiles the exact union (with per-member Degree-Quant tags)."""
        if self.padded_unions:
            return self._plan_for_padded(members, arch)
        return self._plan_for(disjoint_union(list(members)), arch, members)

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

    def _run(
        self, arch: str, prepared: Graph, engine: AmpleEngine, features: np.ndarray
    ) -> Tuple[np.ndarray, float]:
        """Execution step: one device call over an assembled plan.

        ``run_ms`` spans the feature upload, the forward and a device
        synchronize, on the ``request_stamp`` clock.
        """
        cfg = dataclasses.replace(self.cfg, gnn_arch=arch)
        t0 = request_stamp()
        x = torch.from_numpy(features).to(self.device)
        y, _ = gnn_api.gnn_forward(
            self.params, cfg, {"graph": prepared, "features": x, "engine": engine}
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        run_ms = (request_stamp() - t0) * 1e3
        return y.cpu().numpy(), run_ms

    @staticmethod
    def _queue_ms(admitted_at: float, exec_start: float) -> float:
        """Admission→execution wait; 0.0 for requests that never queued."""
        if admitted_at <= 0.0:
            return 0.0
        return max(exec_start - admitted_at, 0.0) * 1e3

    def infer(
        self, graph: Graph, features, *, arch: str = "", admitted_at: float = 0.0
    ) -> GNNResponse:
        """Serve one request; plans come from the LRU cache when warm.

        With padded unions enabled the request is served as a batch of one —
        its member plan piece then pre-warms every future batch containing
        this structure.
        """
        arch = self._arch(arch)
        features = self._validate_request(graph, features)
        queue_ms = self._queue_ms(admitted_at, request_stamp())
        if self.padded_unions:
            prepared, plan, engine, hit, plan_ms = self._plan_for_padded([graph], arch)
            features = self._pad_features(features, prepared.num_nodes)
        else:
            prepared, plan, engine, hit, plan_ms = self._plan_for(graph, arch)
        y, run_ms = self._run(arch, prepared, engine, features)
        self.stats["requests"] += 1
        return GNNResponse(
            outputs=y[: graph.num_nodes],
            cache_hit=hit,
            fingerprint=plan.fingerprint,
            plan_ms=plan_ms,
            run_ms=run_ms,
            queue_ms=queue_ms,
        )

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
        exec_start = request_stamp()
        queue_waits = [self._queue_ms(r.admitted_at, exec_start) for r in requests]
        members = [r.graph for r in requests]
        prepared, plan, engine, hit, plan_ms = self._plan_for_batch(members, arch)
        features = self._pad_features(np.concatenate(feats, axis=0), prepared.num_nodes)
        y, run_ms = self._run(arch, prepared, engine, features)
        self.stats["requests"] += len(requests)
        self.stats["batches"] += 1
        out: List[GNNResponse] = []
        start = 0
        for r, q_ms in zip(requests, queue_waits):
            stop = start + r.graph.num_nodes
            out.append(
                GNNResponse(
                    outputs=y[start:stop],
                    cache_hit=hit,
                    fingerprint=plan.fingerprint,
                    plan_ms=plan_ms,
                    run_ms=run_ms,
                    batch_size=len(requests),
                    queue_ms=q_ms,
                )
            )
            start = stop
        return out

    # ------------------------------------------------------------- metrics
    def cache_info(self) -> Dict[str, int]:
        """Plan-cache size and capacity plus the ``stats`` counters."""
        return {"size": len(self._cache), "capacity": self.plan_cache_size, **self.stats}


def _to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    return params.to(device)
