"""The AMPLE engine facade: graph in → event-driven mixed-precision layer out.

``AmpleEngine`` is the software equivalent of the accelerator's top level
(Figure 1): it owns the planner outputs (NID programming), the precision tags
(Degree-Quant), the aggregation coefficients per model (AGE configuration) and
the weight quantization cache (Weight Bank), and exposes the ``aggregate`` /
``transform`` pair the GNN models call per layer.

Message-passing semantics follow Eq. 1:
    x_i' = γ(x_i, A_{j∈N(i)} φ(x_i, x_j, e_ij))
with φ folded into per-edge coefficients for GCN/GIN (φ = c_ij · x_j) and a
dense pre-projection for GraphSAGE (φ = σ(W3 x_j + b)).

``aggregate`` and ``transform`` also take a ``memory.StreamedFeatures``
handle in place of a dense matrix: the features stay on the host and stream
through the chunk prefetcher (``memory/prefetcher.py``) under its device
budget, bitwise the dense path, through the same kernels on the card.

The planning half (``compile_plans``, ``assemble_union_plan`` and, for a
partitioned graph, ``compile_sharded_plans``: one plan per shard over its
local subgraph, tags and coefficients computed once globally) is host-side
numpy, as in the reference (``repro/core/message_passing.py``); the engine runs
on whatever device its inputs live on, through the kernels on a CUDA device
and their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.aggregation import (
    DeviceTilePlan,
    aggregate_autograd,
    aggregate_edge_tiles,
    aggregate_mixed_precision,
    edge_scores,
    edge_segment_sum_tiles,
    plan_tile_grad,
    segment_max_edge_tiles,
    to_device_plan,
    transposed_tile_plan,
)
from repro_torch.core.degree_quant import DegreeQuantConfig, inference_precision_tags
from repro_torch.core.quantization import (
    QuantParams,
    compute_scale_zp,
    quantize,
    quantize_per_channel,
)
from repro_torch.core.transformation import (
    transform_dense,
    transform_mixed_precision,
)
from repro_torch.graphs.csr import Graph, gcn_norm_coeffs
from repro_torch.graphs.partition import (
    Partition,
    ShardSubgraph,
    make_partition,
    shard_subgraph,
    validate_partition,
)
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.memory.prefetcher import (
    StreamedFeatures,
    _host_fte_qp,
    aggregate_streamed,
    make_device_tile_stream,
    stream_slots,
    transform_streamed,
)
from repro_torch.observe import trace as otrace

__all__ = [
    "EngineConfig",
    "ExecutionPlan",
    "ShardPlan",
    "ShardedExecutionPlan",
    "compile_plans",
    "compile_shard_plan",
    "compile_sharded_plans",
    "assemble_union_plan",
    "shard_plan_key",
    "aggregation_coefficients",
    "engine_precision_tags",
    "AmpleEngine",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    edges_per_tile: int = 256
    segments_per_tile: Optional[int] = None
    mixed_precision: bool = True
    dq: DegreeQuantConfig = dataclasses.field(default_factory=DegreeQuantConfig)


def aggregation_coefficients(g: Graph, mode: str) -> np.ndarray:
    """Per-edge coefficients folding the aggregation function into the plan.

      * "sum"     — coeff 1 (GIN)
      * "mean"    — coeff 1/deg(i) (GraphSAGE)
      * "gcn"     — coeff 1/√(d̂_i d̂_j) (GCN; self-loops must already be present)
      * "runtime" — coeff 1 as a pure lane mask: the real per-edge values
        arrive at request time (GAT attention) and are scattered through the
        plan's ``edge_ids`` indirection, multiplying the static 1s — so the
        compiled plan stays structure-keyed while coefficients change every
        request.
    """
    if mode in ("sum", "runtime"):
        return np.ones(g.num_edges, np.float32)
    if mode == "mean":
        deg = np.maximum(g.degrees, 1).astype(np.float32)
        return (1.0 / np.repeat(deg, g.degrees)).astype(np.float32)
    if mode == "gcn":
        return gcn_norm_coeffs(g)
    raise ValueError(f"unknown aggregation mode {mode!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionPlan:
    """The compiled, graph-specific half of the engine — NID programming.

    Everything the planner derives from (graph structure, EngineConfig) lives
    here: the Degree-Quant precision tags, the per-precision node groups the
    FTE partitions over, and one mixed-precision tile-plan set per aggregation
    coefficient mode. It holds no device state and no weight caches, so it is a
    pure host-side artifact: hashable by fingerprint, safe to share across
    engines, and the unit the serving layer caches (a plan compiled for one
    request is bitwise-valid for every later request on the same structure).
    """

    fingerprint: str
    graph_fp: str  # structure hash of the graph the plan was compiled for
    num_nodes: int
    num_edges: int
    cfg: EngineConfig
    precision_tags: np.ndarray  # str[N]
    node_groups: Mapping[str, np.ndarray]  # tag -> node ids
    mode_plans: Mapping[str, Mapping[str, sched.EdgeTilePlan]]  # mode -> tag -> plan

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def __eq__(self, other) -> bool:
        return isinstance(other, ExecutionPlan) and other.fingerprint == self.fingerprint

    @property
    def modes(self) -> Tuple[str, ...]:
        return tuple(sorted(self.mode_plans))


def engine_precision_tags(g: Graph, cfg: EngineConfig) -> np.ndarray:
    """The precision tags the planner would assign under ``cfg`` (str[N])."""
    if cfg.mixed_precision:
        return inference_precision_tags(g, cfg.dq)
    return np.full(g.num_nodes, "float", dtype=object).astype(str)


def compile_plans(
    g: Graph,
    cfg: Optional[EngineConfig] = None,
    *,
    modes: Sequence[str] = ("sum",),
    precision_tags: Optional[np.ndarray] = None,
    coeffs: Optional[Mapping[str, np.ndarray]] = None,
) -> ExecutionPlan:
    """Compile a graph into a reusable ExecutionPlan (the expensive host step).

    This is the pure planning half of what ``AmpleEngine.__init__`` + lazy
    ``plans(mode)`` used to do: Degree-Quant tagging plus one edge-tile plan
    set per requested coefficient mode. The result is immutable and keyed by
    ``fingerprint`` = hash(structure, cfg, modes) — identical fingerprints
    mean the planner would emit identical tiles.

    ``precision_tags`` overrides the Degree-Quant tagging (str[N]); the
    serving engine uses this to tag batched disjoint-union graphs per member
    graph rather than union-wide. ``coeffs`` overrides the per-edge
    aggregation coefficients per mode (f32[E] aligned with ``g.indices``);
    shard-local plans pass slices of globally computed coefficients here,
    since e.g. GCN normalisation needs the *global* degree of halo sources.
    Overridden tags/coeffs are folded into the fingerprint.
    """
    cfg = cfg if cfg is not None else EngineConfig()
    if precision_tags is None:
        tags = engine_precision_tags(g, cfg)
        tag_part = ""
    else:
        tags = np.asarray(precision_tags)
        if tags.shape != (g.num_nodes,):
            raise ValueError(
                f"precision_tags must be [{g.num_nodes}], got {tags.shape}"
            )
        tag_part = "tags:" + hashlib.blake2b(
            np.asarray(tags, dtype="U8").tobytes(), digest_size=16
        ).hexdigest()
    groups = {
        tag: np.nonzero(tags == tag)[0] for tag in np.unique(tags)
    }

    def mode_coeff(mode: str) -> np.ndarray:
        if coeffs is not None and mode in coeffs:
            c = np.asarray(coeffs[mode], np.float32)
            if c.shape != (g.num_edges,):
                raise ValueError(f"coeffs[{mode!r}] must be [{g.num_edges}], got {c.shape}")
            return c
        return aggregation_coefficients(g, mode)

    mode_plans = {
        mode: sched.build_mixed_precision_plans(
            g,
            tags,
            edges_per_tile=cfg.edges_per_tile,
            segments_per_tile=cfg.segments_per_tile,
            coeff=mode_coeff(mode),
        )
        for mode in dict.fromkeys(modes)  # dedupe, keep order
    }
    coeff_part = ""
    if coeffs is not None:
        h = hashlib.blake2b(digest_size=16)
        for mode in sorted(set(coeffs) & set(dict.fromkeys(modes))):
            h.update(mode.encode())
            h.update(np.ascontiguousarray(coeffs[mode], np.float32).tobytes())
        coeff_part = "coeffs:" + h.hexdigest()
    graph_fp = sched.graph_fingerprint(g)
    fp = sched.plan_fingerprint(
        g,
        repr(cfg),
        *sorted(dict.fromkeys(modes)),
        *((tag_part,) if tag_part else ()),
        *((coeff_part,) if coeff_part else ()),
    )
    return ExecutionPlan(
        fingerprint=fp,
        graph_fp=graph_fp,
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        cfg=cfg,
        precision_tags=tags,
        node_groups=groups,
        mode_plans=mode_plans,
    )


def assemble_union_plan(
    member_plans: Sequence[ExecutionPlan],
    union: Graph,
    *,
    cfg: Optional[EngineConfig] = None,
    edge_bucket: int = 0,
) -> ExecutionPlan:
    """Compose per-member ExecutionPlans into one padded disjoint-union plan.

    The incremental counterpart of ``compile_plans``: each member graph was
    planned once (Degree-Quant tags + edge tiles, both exactly as if served
    solo) and the union plan is assembled by index relabelling
    (``scheduler.concat_tile_plans``) — O(E) array copies, no planner. The
    admission loop of the continuous-batching engine leans on this: a new
    batch composition over known member structures costs assembly, not
    planning.

    ``union`` is the (possibly node-padded) disjoint union of the members'
    *prepared* graphs, in member order; padding nodes beyond the members are
    isolated, carry no plan tiles, and are excluded from the transform node
    groups, so their rows stay exactly zero through every layer — batch-wide
    int8 activation scales never see them. ``edge_bucket`` rounds each
    per-(mode, tag) tile stack up to the size-class tile count so device
    shapes recur across member mixes.
    """
    if not member_plans:
        raise ValueError("assemble_union_plan of no member plans")
    cfg = cfg if cfg is not None else member_plans[0].cfg
    for p in member_plans:
        if p.cfg != cfg:
            raise ValueError("member plans were compiled under a different EngineConfig")
    modes = member_plans[0].modes
    for p in member_plans[1:]:
        if p.modes != modes:
            raise ValueError("member plans disagree on aggregation modes")
    offsets = np.cumsum([0] + [p.num_nodes for p in member_plans])
    edge_offsets = np.cumsum([0] + [p.num_edges for p in member_plans])
    n_real = int(offsets[-1])
    if n_real > union.num_nodes:
        raise ValueError(
            f"member plans cover {n_real} nodes but union has {union.num_nodes}"
        )
    n_pad = union.num_nodes - n_real

    tags = np.concatenate(
        [np.asarray(p.precision_tags, dtype="U8") for p in member_plans]
        + ([np.full(n_pad, "pad", dtype="U8")] if n_pad else [])
    )
    # Padding nodes belong to no precision group: the FTE streams skip their
    # rows (they stay 0), so batch-wide activation calibration matches the
    # unpadded union's exactly.
    groups = {
        tag: np.nonzero(tags == tag)[0]
        for tag in np.unique(tags)
        if tag != "pad"
    }

    mode_plans: Dict[str, Dict[str, sched.EdgeTilePlan]] = {}
    for mode in modes:
        per_tag: Dict[str, sched.EdgeTilePlan] = {}
        tag_names = sorted(
            {t for p in member_plans for t in p.mode_plans[mode]}
        )
        for tag in tag_names:
            pieces = [
                (p.mode_plans[mode][tag], offsets[i], edge_offsets[i])
                for i, p in enumerate(member_plans)
                if tag in p.mode_plans[mode]
            ]
            min_tiles = 0
            if edge_bucket > 0:
                ept = pieces[0][0].edges_per_tile
                real = sum(pl.total_edges for pl, _, _ in pieces)
                _, e_class = sched.size_class(0, real, 0, edge_bucket)
                min_tiles = -(-e_class // ept)
            per_tag[tag] = sched.concat_tile_plans(
                [pl for pl, _, _ in pieces],
                [off for _, off, _ in pieces],
                num_nodes=union.num_nodes,
                min_tiles=min_tiles,
                # Member edges occupy contiguous slices of the union's edge
                # array (members precede padding self-edges), so the member
                # graphs' cumulative edge counts relabel edge_ids into union
                # edge space — a request-time coefficient vector over the
                # union then scatters correctly through the assembled plan.
                edge_offsets=[eoff for _, _, eoff in pieces],
            )
        mode_plans[mode] = per_tag

    graph_fp = sched.graph_fingerprint(union)
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_fp.encode())
    h.update(f"\x00assembled:{edge_bucket}".encode())
    for p in member_plans:
        h.update(b"\x00")
        h.update(p.fingerprint.encode())
    return ExecutionPlan(
        fingerprint=h.hexdigest(),
        graph_fp=graph_fp,
        num_nodes=union.num_nodes,
        num_edges=union.num_edges,
        cfg=cfg,
        precision_tags=tags,
        node_groups=groups,
        mode_plans=mode_plans,
    )


# ---------------------------------------------------------------------------
# Partition-aware planning: one ExecutionPlan per edge-balanced shard
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardPlan:
    """One shard's compiled slice of a ``ShardedExecutionPlan``.

    ``plan`` is a full ExecutionPlan over the shard's *local* subgraph
    (owned rows first, halo sources appended — see
    ``graphs.partition.shard_subgraph``), so every property of the single-graph
    plan (hashability, persistence, bitwise-valid reuse) holds per shard.
    ``fingerprint`` is the global identity — hash(structure, partition
    boundaries, shard index, planner config) via
    ``scheduler.shard_plan_fingerprint`` — and is what the serving layer keys
    its per-shard LRU on.
    """

    fingerprint: str
    shard: ShardSubgraph
    plan: ExecutionPlan  # over shard.graph, in local index space

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardPlan) and other.fingerprint == self.fingerprint

    @property
    def num_owned(self) -> int:
        return self.shard.num_owned

    @property
    def halo_size(self) -> int:
        return int(self.shard.halo.size)

    @property
    def num_edges(self) -> int:
        return self.shard.num_edges


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedExecutionPlan:
    """A partitioned graph's execution plan: one ShardPlan per shard.

    The distributed analogue of ``ExecutionPlan``: Degree-Quant tags are
    computed once on the global graph (a node's precision must not depend on
    which shard owns it), aggregation coefficients likewise (halo sources need
    their global degree), and each shard gets its own edge-tile plan over its
    local subgraph plus a precomputed halo gather map. Pure host-side and
    hashable by fingerprint, so the serving layer caches it — and each member
    ShardPlan independently — exactly like the single-graph plan.
    """

    fingerprint: str
    graph_fp: str
    partition_fp: str
    partition: Partition
    num_nodes: int
    num_edges: int
    cfg: EngineConfig
    precision_tags: np.ndarray  # str[N] — global tags
    node_groups: Mapping[str, np.ndarray]  # tag -> global node ids
    shards: Tuple[ShardPlan, ...]

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ShardedExecutionPlan)
            and other.fingerprint == self.fingerprint
        )

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def modes(self) -> Tuple[str, ...]:
        return self.shards[0].plan.modes if self.shards else ()

    @property
    def halo_total(self) -> int:
        """Rows crossing the cut per layer — the halo-exchange volume metric."""
        return sum(s.halo_size for s in self.shards)

    @property
    def edge_balance(self) -> float:
        """max shard edges / ideal edges-per-shard (1.0 = perfectly balanced)."""
        if not self.shards or self.num_edges == 0:
            return 1.0
        ideal = self.num_edges / self.num_shards
        return max(s.num_edges for s in self.shards) / ideal


def shard_plan_key(
    g: Graph,
    part: Partition,
    k: int,
    cfg: EngineConfig,
    *,
    modes: Sequence[str],
    precision_tags: np.ndarray,
) -> str:
    """The fingerprint ``compile_shard_plan`` would stamp on shard ``k``.

    Separated out so a serving cache can probe its per-shard LRU *before*
    deciding which shards actually need the planner.
    """
    tag_part = "tags:" + hashlib.blake2b(
        np.asarray(precision_tags, dtype="U8").tobytes(), digest_size=16
    ).hexdigest()
    return sched.shard_plan_fingerprint(
        g,
        part,
        k,
        repr(cfg),
        *sorted(dict.fromkeys(modes)),
        tag_part,
    )


def compile_shard_plan(
    g: Graph,
    part: Partition,
    k: int,
    cfg: Optional[EngineConfig] = None,
    *,
    modes: Sequence[str] = ("sum",),
    precision_tags: Optional[np.ndarray] = None,
    mode_coeffs: Optional[Mapping[str, np.ndarray]] = None,
) -> ShardPlan:
    """Compile shard ``k`` of a partitioned graph independently.

    ``precision_tags``/``mode_coeffs`` are *global* (length N / E); pass them
    when compiling several shards so tagging and coefficient work runs once —
    omitted, they are derived here (correct, just repeated per shard).
    The returned ShardPlan is exactly what ``compile_sharded_plans`` would
    have produced for this shard, so a serving cache can mix shards compiled
    together and separately.
    """
    cfg = cfg if cfg is not None else EngineConfig()
    if precision_tags is None:
        precision_tags = engine_precision_tags(g, cfg)
    tags = np.asarray(precision_tags)
    if tags.shape != (g.num_nodes,):
        raise ValueError(f"precision_tags must be [{g.num_nodes}], got {tags.shape}")
    if mode_coeffs is None:
        mode_coeffs = {m: aggregation_coefficients(g, m) for m in dict.fromkeys(modes)}
    sub = shard_subgraph(g, part, k)
    local_coeffs = {
        m: sub.slice_edges(np.asarray(c)) for m, c in mode_coeffs.items()
    }
    local_tags = tags[sub.local_ids]
    plan = compile_plans(
        sub.graph,
        cfg,
        modes=modes,
        precision_tags=local_tags,
        coeffs=local_coeffs,
    )
    fp = shard_plan_key(g, part, k, cfg, modes=modes, precision_tags=tags)
    return ShardPlan(fingerprint=fp, shard=sub, plan=plan)


def compile_sharded_plans(
    g: Graph,
    cfg: Optional[EngineConfig] = None,
    *,
    num_shards: Optional[int] = None,
    partition: Optional[Partition] = None,
    partitioner: str = "edges",
    modes: Sequence[str] = ("sum",),
    precision_tags: Optional[np.ndarray] = None,
    shard_plans: Optional[Mapping[int, ShardPlan]] = None,
) -> ShardedExecutionPlan:
    """Partition-aware planning pipeline: Partition in, sharded plan out.

    Give either an explicit ``partition`` (validated against ``g``) or
    ``num_shards`` — then ``partitioner`` selects the algorithm ("edges" =
    contiguous edge-balanced cut, "mincut" = halo-minimizing multilevel
    refinement; see ``graphs.partition.make_partition``). The partitioner
    identity is folded into ``partition_fp`` so plans never collide across
    partitioners. Degree-Quant tags and per-mode coefficients are computed
    once globally, then each shard is compiled over its local subgraph.
    ``shard_plans`` supplies already-compiled shards by index (the serving
    layer's per-shard cache hits); only missing shards run the planner.
    """
    cfg = cfg if cfg is not None else EngineConfig()
    if partition is None:
        if num_shards is None:
            raise ValueError("pass either partition or num_shards")
        partition = make_partition(g, num_shards, partitioner)
    else:
        validate_partition(g, partition)
        if num_shards is not None and partition.num_shards != num_shards:
            raise ValueError(
                f"partition has {partition.num_shards} shards, asked for {num_shards}"
            )
    if precision_tags is None:
        tags = engine_precision_tags(g, cfg)
    else:
        tags = np.asarray(precision_tags)
        if tags.shape != (g.num_nodes,):
            raise ValueError(f"precision_tags must be [{g.num_nodes}], got {tags.shape}")
    shard_plans = shard_plans or {}
    mode_coeffs = None
    if any(k not in shard_plans for k in range(partition.num_shards)):
        # Global per-edge coefficient work runs once, and only when some
        # shard actually needs the planner (all-warm assembly skips it).
        mode_coeffs = {m: aggregation_coefficients(g, m) for m in dict.fromkeys(modes)}
    shards = tuple(
        shard_plans[k]
        if k in shard_plans
        else compile_shard_plan(
            g,
            partition,
            k,
            cfg,
            modes=modes,
            precision_tags=tags,
            mode_coeffs=mode_coeffs,
        )
        for k in range(partition.num_shards)
    )
    groups = {tag: np.nonzero(tags == tag)[0] for tag in np.unique(tags)}
    partition_fp = sched.partition_fingerprint(g, partition)
    h = hashlib.blake2b(digest_size=16)
    h.update(partition_fp.encode())
    for s in shards:
        h.update(b"\x00")
        h.update(s.fingerprint.encode())
    return ShardedExecutionPlan(
        fingerprint=h.hexdigest(),
        graph_fp=sched.graph_fingerprint(g),
        partition_fp=partition_fp,
        partition=partition,
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        cfg=cfg,
        precision_tags=tags,
        node_groups=groups,
        shards=shards,
    )


class AmpleEngine:
    """Thin per-graph execution wrapper around an ``ExecutionPlan``.

    The engine owns only transient device-facing state (device plans, the
    weight-quant cache, static activation quant state); all planning lives
    in the plan. Construct either way:

      * ``AmpleEngine(g, cfg)`` — compiles tags up front, tile plans lazily
        per aggregation mode, or
      * ``AmpleEngine(g, plan=plan)`` — reuses a cached ``compile_plans``
        artifact and skips the planner entirely.

    It runs on the device of the embeddings it is given: device plans and
    node groups are uploaded once per device and cached. ``aggregate``,
    ``edge_softmax``, ``attention_aggregate``, ``edge_scores`` and
    ``transform`` are differentiable: the backward of an aggregation runs
    the kernels on each group's transposed plan, built on the first backward
    and kept beside the device plans (engine state only: it is in neither
    the ``ExecutionPlan``, its fingerprint nor a saved plan file). No cache
    of the engine keeps an autograd graph.
    """

    def __init__(
        self,
        g: Graph,
        cfg: Optional[EngineConfig] = None,
        *,
        plan: Optional[ExecutionPlan] = None,
    ):
        if plan is not None:
            if plan.graph_fp != sched.graph_fingerprint(g):
                raise ValueError(
                    f"plan was compiled for a different graph structure "
                    f"({plan.num_nodes} nodes, {plan.num_edges} edges vs "
                    f"{g.num_nodes}, {g.num_edges}; fingerprints differ)"
                )
            if cfg is not None and cfg != plan.cfg:
                raise ValueError("cfg disagrees with plan.cfg; pass one or the other")
            cfg = plan.cfg
        else:
            cfg = cfg if cfg is not None else EngineConfig()
            plan = compile_plans(g, cfg, modes=())
        self.graph = g
        self.cfg = cfg
        self.plan = plan
        self.precision_tags = plan.precision_tags
        self.node_groups: Dict[str, np.ndarray] = dict(plan.node_groups)
        self._plans: Dict[str, Mapping[str, sched.EdgeTilePlan]] = dict(plan.mode_plans)
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        """The per-engine caches, shared with ``ShardedAmpleEngine``."""
        # id(w) -> (w, w_q, qp, packed). The weight itself is held alongside
        # its quantized copy: a cache keyed on id() alone is unsound once the
        # original is garbage collected (CPython recycles ids), so the strong
        # ref both pins the id and lets us verify the hit is really for w.
        # Bounded LRU: a loop feeding ever-fresh weights must not grow engine
        # memory without limit.
        self._wq_cache: "OrderedDict[int, tuple]" = OrderedDict()
        # (mode, device) -> tag -> DeviceTilePlan; device -> tag -> node ids.
        self._dplan_cache: Dict[Tuple[str, str], Dict[str, DeviceTilePlan]] = {}
        # (mode, tag) -> the group's transposed plan (the backward of
        # aggregate); (mode, tag, device) -> its upload.
        self._tplans: Dict[Tuple[str, str], sched.EdgeTilePlan] = {}
        self._tplan_cache: Dict[Tuple[str, str, str], DeviceTilePlan] = {}
        # (mode, tag, device) -> what the GAT kernels' backward reads
        # (attn_ops.TileGrad); device -> the CSR's sources as int32.
        self._tgrad_cache: Dict[Tuple[str, str, str], attn_ops.TileGrad] = {}
        self._indices_cache: Dict[str, torch.Tensor] = {}
        self._group_cache: Dict[str, Dict[str, torch.Tensor]] = {}
        # device -> (src, dst) node id per edge; modes whose edge ids were checked.
        self._endpoint_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._eids_checked: set = set()
        # Static per-plan activation quantization state (serving): calibrated
        # once per call-site slot and reused on warm requests — see
        # begin_forward().
        self._act_qp: Dict[tuple, QuantParams] = {}
        self._forward_active = False
        self._agg_slot = 0
        self._fte_slot = 0
        # (plan, schedule) pairs for the out-of-core path, keyed on
        # (mode, tag, chunk_rows, reorder, packing) — per-plan-static. The
        # plan is the one the stream executes: the packed variant when
        # packing is on, the compiled plan otherwise.
        self._chunk_schedules: Dict[tuple, tuple] = {}
        # DeviceTileStreams (the stream's program and its device arrays),
        # keyed like _chunk_schedules plus (stream, slots, depth, device): a
        # warm streamed request re-uploads zero plan bytes.
        self._stream_tiles: Dict[tuple, object] = {}

    _WQ_CACHE_CAP = 64  # weights per engine; LRU-evicted beyond this

    # ------------------------------------------------- static quant state
    def begin_forward(self) -> None:
        """Mark the start of one model forward pass over this engine.

        Activation quantization parameters (int8 scale/zero-point for the AGE
        gather stream and the FTE int8 matmul) are keyed by call-site slot
        within a forward: the first forward calibrates them from its
        activations and later forwards reuse that static state — warm plan-
        cache hits skip ``compute_scale_zp`` entirely, and repeat requests
        with identical features are bitwise-identical to the cold request.
        Callers that never invoke this (direct engine use) keep per-call
        dynamic calibration. A calibration that is part of an autograd graph
        (training) is not cached: the slot stays empty for eager serving.
        """
        self._forward_active = True
        self._agg_slot = 0
        self._fte_slot = 0

    def _activation_qp(
        self,
        values_fn: Optional[Callable[[], torch.Tensor]],
        kind: str,
        *,
        make_qp: Optional[Callable[[], QuantParams]] = None,
    ) -> QuantParams:
        """Scale/zp for one quantized call site (lazy: warm slots skip the calc).

        ``make_qp`` overrides the cold calibration source — the streamed
        paths pass a host-side factory (bitwise-equal to the device
        reduction) so the same slot protocol serves dense and streamed
        forwards; a warm slot cached by either path feeds both.
        """
        calibrate = (
            make_qp if make_qp is not None
            else lambda: compute_scale_zp(values_fn(), symmetric=True)
        )
        if not self._forward_active:
            return calibrate()
        if kind == "agg":
            slot = ("agg", self._agg_slot)
            self._agg_slot += 1
        else:
            slot = ("fte", self._fte_slot)
            self._fte_slot += 1
        if slot not in self._act_qp:
            qp = calibrate()
            if qp.scale.requires_grad:
                return qp
            self._act_qp[slot] = qp
        return self._act_qp[slot]

    def _device_plans(
        self, mode: str, plans: Mapping[str, sched.EdgeTilePlan], device: torch.device
    ) -> Dict[str, DeviceTilePlan]:
        """Cached device uploads (with split maps) of one mode's tile plans."""
        key = (mode, str(device))
        if key not in self._dplan_cache:
            self._dplan_cache[key] = {
                tag: to_device_plan(p, device) for tag, p in plans.items()
            }
        return self._dplan_cache[key]

    def _transposed_plan(self, mode: str, tag: str, device: torch.device) -> DeviceTilePlan:
        """The device plan of group ``tag``'s reversed edges (the backward of
        ``aggregate`` and the attention, ``aggregation.transposed_tile_plan``),
        planned once per (mode, tag) with the engine's tile sizes and
        uploaded once per device."""
        key = (mode, tag, str(device))
        if key not in self._tplan_cache:
            if (mode, tag) not in self._tplans:
                self._tplans[(mode, tag)] = transposed_tile_plan(
                    self.plans(mode)[tag], edges_per_tile=self.cfg.edges_per_tile,
                    segments_per_tile=self.cfg.segments_per_tile, runtime=mode == "runtime")
            self._tplan_cache[key] = to_device_plan(self._tplans[(mode, tag)], device)
        return self._tplan_cache[key]

    def _tile_grad(self, mode: str, tag: str, device: torch.device) -> attn_ops.TileGrad:
        """What the backward of the GAT kernels on group ``tag``'s plan reads
        (``aggregation.plan_tile_grad``), built on first use."""
        key = (mode, tag, str(device))
        if key not in self._tgrad_cache:
            dev_key = str(device)
            if dev_key not in self._indices_cache:
                self._indices_cache[dev_key] = torch.as_tensor(
                    self.graph.indices, dtype=torch.int32).to(device)
            self._tgrad_cache[key] = plan_tile_grad(
                self.plans(mode)[tag], self.graph, self._indices_cache[dev_key],
                lambda: self._transposed_plan(mode, tag, device))
        return self._tgrad_cache[key]

    def _tile_grads(self, mode: str, device: torch.device) -> Dict[str, attn_ops.TileGrad]:
        return {tag: self._tile_grad(mode, tag, device) for tag in self.plans(mode)}

    def _require_edge_ids(self, mode: str, plans: Mapping[str, sched.EdgeTilePlan]) -> None:
        """Refuse runtime coefficients on plans without live edge ids.

        Every real edge must own exactly one live lane; a plan whose lanes
        sit at -1 would silently zero every coefficient scattered through it.
        """
        if mode in self._eids_checked:
            return
        for tag, p in plans.items():
            if int((p.edge_ids >= 0).sum()) != p.total_edges:
                raise ValueError(
                    f"plan for mode {mode!r} tag {tag!r} carries edge-id "
                    "indirection for only part of its edges; recompile the "
                    "plan to use edge_coeff / edge_softmax"
                )
        self._eids_checked.add(mode)

    def _device_groups(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """Cached device copies of the precision groups' node ids."""
        key = str(device)
        if key not in self._group_cache:
            self._group_cache[key] = {
                tag: torch.as_tensor(ids, dtype=torch.int64).to(device)
                for tag, ids in self.node_groups.items()
            }
        return self._group_cache[key]

    # ---------------------------------------------------------------- plans
    def plans(self, mode: str) -> Mapping[str, sched.EdgeTilePlan]:
        if mode not in self._plans:  # lazy extension beyond the compiled modes
            self._plans[mode] = sched.build_mixed_precision_plans(
                self.graph,
                self.precision_tags,
                edges_per_tile=self.cfg.edges_per_tile,
                segments_per_tile=self.cfg.segments_per_tile,
                coeff=aggregation_coefficients(self.graph, mode),
            )
        return self._plans[mode]

    # ------------------------------------------------- out-of-core streaming
    def _stream_plan_schedule(self, mode: str, tag: str, sf: StreamedFeatures):
        """(plan, schedule) the streamed path executes (per-plan-static).

        ``sf.packing`` swaps in the chunk-packed variant of the compiled
        plan (``scheduler.pack_tiles_by_chunk``, bitwise-equal outputs) with
        plan-order execution; unpacked plans keep the ``sf.reorder`` run
        permutation.
        """
        key = (mode, tag, sf.store.chunk_rows, sf.reorder, sf.packing)
        if key not in self._chunk_schedules:
            plan = self.plans(mode)[tag]
            if sf.packing:
                plan = sched.pack_tiles_by_chunk(plan, sf.store.chunk_rows)
                schedule = sched.build_chunk_schedule(plan, sf.store.chunk_rows, reorder=False)
            else:
                schedule = sched.build_chunk_schedule(
                    plan, sf.store.chunk_rows, reorder=sf.reorder)
            self._chunk_schedules[key] = (plan, schedule)
        return self._chunk_schedules[key]

    def _stream_tiles_for(self, mode: str, tag: str, stream: str, sf: StreamedFeatures):
        """One stream's program and device arrays (plan-static): built, and
        charged to ``instr_bytes``, once per (mode, tag, chunking, stream,
        slots, depth, device) — warm streamed requests move feature bytes
        only."""
        plan, schedule = self._stream_plan_schedule(mode, tag, sf)
        slots = stream_slots(sf.store, stream, sf.budget_bytes, schedule.num_chunks)
        key = (mode, tag, sf.store.chunk_rows, sf.reorder, sf.packing, stream, slots,
               max(sf.prefetch_depth, 0), str(sf.device))
        if key not in self._stream_tiles:
            ts = make_device_tile_stream(
                plan, schedule, store=sf.store, stream=stream, budget_bytes=sf.budget_bytes,
                prefetch_depth=sf.prefetch_depth, device=sf.device)
            self._stream_tiles[key] = ts
            sf.stats.instr_bytes += ts.nbytes  # the cold upload, charged once
        return self._stream_tiles[key]

    def _check_store(self, sf: StreamedFeatures) -> None:
        if sf.store.num_rows != self.graph.num_nodes:
            raise ValueError(
                f"feature store has {sf.store.num_rows} rows but graph has "
                f"{self.graph.num_nodes} nodes"
            )

    def _aggregate_streamed(self, sf: StreamedFeatures, mode: str) -> torch.Tensor:
        self._check_store(sf)
        mixed = self.cfg.mixed_precision
        pairs = {tag: self._stream_plan_schedule(mode, tag, sf) for tag in self.plans(mode)}
        streams = {tag: "i8" if mixed and tag == "int8" else "f32" for tag in pairs}
        tiles = {(tag, st): self._stream_tiles_for(mode, tag, st, sf)
                 for tag, st in streams.items()}
        qp = None
        if mixed and "int8" in pairs:
            qp = self._activation_qp(None, "agg", make_qp=sf.agg_qp)
        with otrace.get_recorder().span(f"layer:aggregate:{mode}", cat="engine",
                                        trace_id=sf.trace_id):
            return aggregate_streamed(
                sf,
                {tag: p for tag, (p, _) in pairs.items()},
                {tag: s for tag, (_, s) in pairs.items()},
                num_nodes=self.graph.num_nodes,
                mixed=mixed,
                qp=qp,
                tiles=tiles,
            )

    def _transform_streamed(
        self,
        sf: StreamedFeatures,
        w: torch.Tensor,
        b: Optional[torch.Tensor],
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]],
    ) -> torch.Tensor:
        self._check_store(sf)
        if not self.cfg.mixed_precision:
            # A float-policy FTE over the full matrix cannot be row-blocked
            # bitwise (f32 matmul blocking reassociates), so the store is
            # materialized — counted in telemetry, never silent.
            sf.stats.fallbacks += 1
            sf.stats.fallback_bytes += sf.nbytes
            dense = torch.from_numpy(sf.store.dense()).to(sf.device)
            return transform_dense(dense, w, b, activation)
        _, w_qp, w_packed = self._weight_q(w)
        a_qp = None
        ids = self.node_groups.get("int8")
        if self._forward_active and ids is not None and ids.size:
            a_qp = self._activation_qp(
                None, "fte",
                make_qp=lambda: _host_fte_qp(sf.store.amax_rows(ids), sf.device))
        return transform_streamed(
            sf, self.node_groups, w, b, activation, w_qp=w_qp, w_packed=w_packed, a_qp=a_qp,
        )

    # ----------------------------------------------------------------- AGE
    def aggregate(
        self,
        x: torch.Tensor,
        *,
        mode: str = "sum",
        edge_coeff: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Event-driven mixed-precision aggregation of node embeddings.

        ``x`` may be a ``memory.StreamedFeatures`` handle instead of a dense
        matrix: aggregation then runs chunk-streamed through the prefetcher
        under its feature budget, bitwise-identical to the dense path.

        ``edge_coeff`` is a runtime per-edge coefficient vector (f32[E] in
        this graph's edge space), read through the plan's ``edge_ids`` and
        multiplied with the static coefficients. The
        plan stays structure-keyed, so serving caches are untouched by
        per-request coefficients. Multi-head: ``edge_coeff`` f32[E, H] with
        ``x`` f32[N, H, dh] aggregates all heads in one tile pass.

        Under grad, static-coefficient modes run ``aggregate_autograd``: the
        same forward, and a backward through the AGE on the transposed plan.
        Runtime coefficients run each precision group's multi-head kernel
        as its autograd Function: the coefficients' gradient from
        ``csrc/attn_agg_bwd.cu``, the rows' from the walk on the group's
        transposed plan (the forward's values; the groups' disjoint rows are
        added rather than written into one buffer). ``ShardedAmpleEngine``
        does the same per shard; streamed features carry no gradient.
        """
        if isinstance(x, StreamedFeatures):
            if edge_coeff is not None:
                raise ValueError(
                    "runtime edge coefficients require dense embeddings; the "
                    "streamed aggregation path serves static-coefficient "
                    "plans only (attention models stream through transform())"
                )
            return self._aggregate_streamed(x, mode)
        plans = self.plans(mode)
        if edge_coeff is not None:
            edge_coeff = torch.as_tensor(edge_coeff, dtype=torch.float32, device=x.device)
            e = self.graph.num_edges
            if not (
                tuple(edge_coeff.shape) == (e,)
                or (edge_coeff.dim() == 2 and edge_coeff.shape[0] == e)
            ):
                raise ValueError(
                    f"edge_coeff must be [{e}] or [{e}, H], got {tuple(edge_coeff.shape)}"
                )
            if edge_coeff.dim() == 2 and (x.dim() != 3 or x.shape[1] != edge_coeff.shape[1]):
                raise ValueError(
                    f"multi-head edge_coeff {tuple(edge_coeff.shape)} needs x shaped "
                    f"[N, {edge_coeff.shape[1]}, dh], got {tuple(x.shape)}"
                )
            self._require_edge_ids(mode, plans)
        dplans = self._device_plans(mode, plans, x.device)
        qp = None
        if self.cfg.mixed_precision and "int8" in plans:
            qp = self._activation_qp(lambda: x, "agg")
        wants_grad = attn_ops.wants_grad(x, edge_coeff, None if qp is None else qp.scale)
        if edge_coeff is None and wants_grad:
            return aggregate_autograd(
                x, dplans, lambda: self._transposed_plan(mode, "float", x.device),
                num_nodes=self.graph.num_nodes, qp=qp)
        grads = self._tile_grads(mode, x.device) if wants_grad else None
        if self.cfg.mixed_precision:
            return aggregate_mixed_precision(
                x,
                plans,
                num_nodes=self.graph.num_nodes,
                qp=qp,
                device_plans=dplans,
                edge_coeff=edge_coeff,
                grads=grads,
            )
        return aggregate_edge_tiles(
            x, dplans["float"], num_nodes=self.graph.num_nodes, edge_coeff=edge_coeff,
            grad=None if grads is None else grads["float"])

    # ------------------------------------------------ runtime coefficients
    def edge_endpoints(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) node id per edge, int64[E] each on ``device`` — cached
        structural arrays (dst follows from the CSR row layout)."""
        key = str(device)
        if key not in self._endpoint_cache:
            g = self.graph
            dst = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees)
            self._endpoint_cache[key] = (
                torch.as_tensor(g.indices, dtype=torch.int64).to(device),
                torch.from_numpy(dst).to(device),
            )
        return self._endpoint_cache[key]

    def edge_softmax(self, scores: torch.Tensor, *, mode: str = "runtime") -> torch.Tensor:
        """Destination-segment softmax of per-edge scores: f32[E(, H)].

        Runs over the same event-driven tiles as aggregation, per precision
        group (the groups cover disjoint destination sets): a segment-max
        pass gives the per-node shift, scores are exp-shifted in edge space,
        and a segment-sum pass (the multi-head AGE kernel on the card)
        accumulates the denominators. Nodes with no in-edges in the plan get
        max 0 and denominator 1, so the result is finite everywhere. Nothing
        here sums floats with atomics, so it is the same run to run.

        Under grad the shift is held constant (softmax does not depend on
        it, so its exact derivative is 0) and the denominators' pass is the
        multi-head kernel's autograd Function; the gather of the
        denominators onto the edges differentiates through indexing.
        """
        scores = torch.as_tensor(scores, dtype=torch.float32)
        e = self.graph.num_edges
        if not (
            tuple(scores.shape) == (e,) or (scores.dim() == 2 and scores.shape[0] == e)
        ):
            raise ValueError(f"scores must be [{e}] or [{e}, H], got {tuple(scores.shape)}")
        plans = self.plans(mode)
        self._require_edge_ids(mode, plans)
        dplans = self._device_plans(mode, plans, scores.device)
        grads = self._tile_grads(mode, scores.device) if attn_ops.wants_grad(scores) else {}
        n = self.graph.num_nodes
        rest = tuple(scores.shape[1:])
        node_max = torch.full((n,) + rest, float("-inf"), device=scores.device)
        for dp in dplans.values():
            node_max = torch.maximum(node_max,
                                     segment_max_edge_tiles(scores.detach(), dp, num_nodes=n))
        node_max = torch.where(torch.isfinite(node_max), node_max, torch.zeros_like(node_max))
        _, dst = self.edge_endpoints(scores.device)
        ex = torch.exp(scores - node_max[dst])
        denom = torch.zeros((n,) + rest, device=scores.device)
        for tag, dp in dplans.items():
            denom = denom + edge_segment_sum_tiles(ex, dp, num_nodes=n, grad=grads.get(tag))
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
        """One GAT layer's attention: softmax(LeakyReLU(scores)) aggregate.

        ``scores`` are the RAW per-edge logits f32[E, H]; ``z`` the
        head-stacked projected embeddings f32[N, H, dh]. Returns
        f32[N, H, dh]. Each precision group runs the fused attention kernel
        (LeakyReLU → tile-local segment max → exp → segment sum → weighted
        aggregate in one tile pass, combined across tiles by a log-sum-exp
        rescale), which reads the scores through the plan's ``edge_ids``: the
        float group on ``z``, the int8 group on ``z``'s int8 codes, dequantized
        inside the kernel. Precision groups cover disjoint
        destination nodes, so per-group softmax is exact. ``edge_softmax``
        plus ``aggregate(edge_coeff=…)`` is the same layer in two passes.

        Under grad each group's kernel is ``attn_ops.attend_tiles``'s
        autograd Function: the forward also writes each node's log-sum-exp,
        the backward runs ``csrc/attn_agg_bwd.cu`` (α and the scores'
        gradient per edge) and, for the float group's rows, the multi-head
        walk on its transposed plan; the int8 group's codes pass no gradient
        and its scale receives ``Σ(g_I ⊙ out_I) / scale``. The groups' outputs
        are then added (disjoint rows) rather than written into one buffer.
        """
        if isinstance(z, StreamedFeatures):
            raise ValueError(
                "attention requires dense embeddings; streamed features "
                "cannot carry the per-edge softmax (compute z densely or "
                "lift the feature budget)"
            )
        z = torch.as_tensor(z, dtype=torch.float32)
        scores = torch.as_tensor(scores, dtype=torch.float32, device=z.device)
        e, n = self.graph.num_edges, self.graph.num_nodes
        if scores.dim() != 2 or scores.shape[0] != e:
            raise ValueError(f"scores must be [{e}, H], got {tuple(scores.shape)}")
        h = scores.shape[1]
        if z.dim() != 3 or z.shape[0] != n or z.shape[1] != h:
            raise ValueError(f"z must be [{n}, {h}, dh], got {tuple(z.shape)}")
        plans = self.plans(mode)
        self._require_edge_ids(mode, plans)
        dplans = self._device_plans(mode, plans, z.device)
        qp = None
        if self.cfg.mixed_precision and "int8" in plans:
            qp = self._activation_qp(lambda: z, "agg")
        scores = scores.contiguous()
        grads = (self._tile_grads(mode, z.device)
                 if attn_ops.wants_grad(z, scores, None if qp is None else qp.scale) else None)
        # the groups write their disjoint node rows into one output (under
        # grad: each its own, added)
        out = None if grads is not None else torch.zeros_like(z)
        total = out
        for tag, dp in dplans.items():
            x, x_qp = z, None
            if tag == "int8" and self.cfg.mixed_precision:
                x, x_qp = quantize(z, qp), qp
            part = attn_ops.attend_tiles(
                x, dp.gather_idx, dp.edge_ids, scores, dp.coeff, dp.seg_ids, dp.out_node,
                dp.split, num_nodes=n, leaky_slope=leaky_slope, qp=x_qp, out=out,
                grad=None if grads is None else grads[tag],
            )
            if grads is not None:
                total = part if total is None else total + part
        return total

    def edge_scores(
        self, src_sc: torch.Tensor, dst_sc: torch.Tensor, *, mode: str = "runtime"
    ) -> torch.Tensor:
        """GAT's raw per-edge scores ``src_sc[src] + dst_sc[dst]``:
        f32[E(, H)] from the per-node halves f32[N(, H)]. Under grad the
        backward sums each node's edges on ``mode``'s forward plans
        (``dst_sc``) and transposed plans (``src_sc``) by the multi-head
        walk, with no atomics (``aggregation.edge_scores``)."""
        dev = src_sc.device
        src, dst = self.edge_endpoints(dev)
        if not attn_ops.wants_grad(src_sc, dst_sc):  # serving, sharded engines included
            return src_sc[src] + dst_sc[dst]
        plans = self.plans(mode)
        dplans = self._device_plans(mode, plans, dev)
        return edge_scores(
            src_sc, dst_sc, src, dst, [dplans[t] for t in plans],
            [lambda t=t: self._transposed_plan(mode, t, dev) for t in plans],
            num_nodes=self.graph.num_nodes)

    # ----------------------------------------------------------------- FTE
    def _weight_q(self, w: torch.Tensor):
        """Per-weight quantization cache → (w_q, w_qp, w_packed).

        ``w_packed`` is the load-time relayout of ``w_q`` into the layout the
        int8 matmul kernel reads (``kernels/quant_matmul/repack.py``), built
        once per weight, so every warm transform hands the kernel its layout
        with no per-call transpose.
        """
        if w.requires_grad and torch.is_grad_enabled():  # keep no graph in the cache
            w_q, w_qp = quantize_per_channel(w, axis=-1)
            return w_q, w_qp, qm_ops.repack_weight(w_q)
        key = id(w)
        entry = self._wq_cache.get(key)
        if entry is None or entry[0] is not w:
            w_q, w_qp = quantize_per_channel(w, axis=-1)
            entry = (w, w_q, w_qp, qm_ops.repack_weight(w_q))
            self._wq_cache[key] = entry
            while len(self._wq_cache) > self._WQ_CACHE_CAP:
                self._wq_cache.popitem(last=False)
        else:
            self._wq_cache.move_to_end(key)
        return entry[1], entry[2], entry[3]

    def transform(
        self,
        h: torch.Tensor,
        w: torch.Tensor,
        b: Optional[torch.Tensor] = None,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Mixed-precision transformation of aggregated embeddings.

        Accepts a ``memory.StreamedFeatures`` handle for ``h``: the int8
        group then streams chunk by chunk (1-byte rows, exact int32 matmul)
        and the float-protected block is gathered once — bitwise the dense
        mixed path (GraphSAGE's φ and GAT's projection over stored features).
        """
        if isinstance(h, StreamedFeatures):
            return self._transform_streamed(h, w, b, activation)
        if not self.cfg.mixed_precision:
            return transform_dense(h, w, b, activation)
        w_q, w_qp, w_packed = self._weight_q(w)
        groups = self._device_groups(h.device)
        a_qp = None
        ids = groups.get("int8")
        if self._forward_active and ids is not None and ids.numel():
            a_qp = self._activation_qp(lambda: h[ids], "fte")
        return transform_mixed_precision(
            h,
            groups,
            w,
            b,
            activation,
            w_q=w_q,
            w_qp=w_qp,
            a_qp=a_qp,
            w_packed=w_packed,
        )

    # ------------------------------------------------------------- metrics
    def occupancy_report(self) -> Dict[str, float]:
        """Lane economics vs the double-buffered baseline (same graph)."""
        plan = sched.build_edge_tile_plan(
            self.graph, edges_per_tile=self.cfg.edges_per_tile
        )
        padded = sched.build_padded_plan(self.graph, batch_size=64)
        return {
            "event_driven_lane_occupancy": plan.lane_occupancy,
            "double_buffer_pipeline_gap_ratio": padded.pipeline_gap_ratio,
            "float_node_ratio": float(
                (self.precision_tags == "float").mean() if self.graph.num_nodes else 0
            ),
        }
