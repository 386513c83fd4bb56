"""GNN model registry — the family="gnn" model API of the port.

Every arch registers an ``ArchSpec`` with three uniform, config-driven entry
points, as in the reference (``repro/models/gnn/api.py``), and the shapes of
its params:

    init(cfg, generator, device)       -> params
    apply(cfg, params, engine, x)      -> node outputs (through AmpleEngine)
    reference(cfg, params, g, x)       -> dense float oracle (test-scale)
    param_shapes(cfg)                  -> the params tree, a shape per leaf

Layer dims, aggregation mode and precision policy all come from
``ModelConfig``. Params are plain dicts of tensors; they live on the device
the caller chose, and the engine follows the device of its inputs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.message_passing import AmpleEngine, EngineConfig
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, add_self_loops
from repro_torch.memory.prefetcher import StreamedFeatures

__all__ = [
    "ArchSpec",
    "register_arch",
    "get_arch",
    "list_archs",
    "agg_mode",
    "engine_config",
    "prepare_graph",
    "make_engine",
    "gnn_init",
    "params_from_numpy",
    "gnn_apply",
    "gnn_reference",
    "gnn_forward",
]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """A registered GNN architecture: uniform entry points + plan needs."""

    name: str
    init: Callable[[ModelConfig, torch.Generator, torch.device], Dict]
    apply: Callable[[ModelConfig, Dict, AmpleEngine, torch.Tensor], torch.Tensor]
    reference: Callable[[ModelConfig, Dict, Graph, torch.Tensor], torch.Tensor]
    param_shapes: Callable[[ModelConfig], Dict]
    default_agg: str  # aggregation coefficient mode when cfg.gnn_agg == ""
    needs_self_loops: bool = False  # GCN's ∪{i} term is an explicit edge


_ARCHS: Dict[str, ArchSpec] = {}

_ARCH_MODULES = ["gcn", "gin", "sage", "gat"]


def register_arch(
    name: str,
    *,
    init,
    apply,
    reference,
    param_shapes,
    default_agg: str,
    needs_self_loops: bool = False,
) -> ArchSpec:
    spec = ArchSpec(
        name=name,
        init=init,
        apply=apply,
        reference=reference,
        param_shapes=param_shapes,
        default_agg=default_agg,
        needs_self_loops=needs_self_loops,
    )
    _ARCHS[name] = spec
    return spec


def _ensure_loaded() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.models.gnn.{m}")


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _ARCHS:
        raise KeyError(f"unknown GNN arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_ARCHS))


# ------------------------------------------------------------- config glue
def agg_mode(cfg: ModelConfig) -> str:
    """The aggregation coefficient mode this config's plans are built with."""
    return cfg.gnn_agg or get_arch(cfg.gnn_arch).default_agg


def engine_config(cfg: ModelConfig) -> EngineConfig:
    """Map the ModelConfig precision/tiling policy onto an EngineConfig."""
    if cfg.gnn_precision not in ("mixed", "float"):
        raise ValueError(f"unknown gnn_precision {cfg.gnn_precision!r}")
    return EngineConfig(
        edges_per_tile=cfg.gnn_edges_per_tile,
        mixed_precision=cfg.gnn_precision == "mixed",
    )


def prepare_graph(cfg: ModelConfig, g: Graph) -> Graph:
    """Arch-specific structural preprocessing (idempotent)."""
    if get_arch(cfg.gnn_arch).needs_self_loops:
        return add_self_loops(g)
    return g


def make_engine(
    cfg: ModelConfig,
    prepared: Graph,
    *,
    num_shards: Optional[int] = None,
    partition=None,
    partitioner: Optional[str] = None,
    mesh=None,
    halo_overlap: Optional[bool] = None,
) -> AmpleEngine:
    """Build the execution engine ``cfg`` calls for over a *prepared* graph.

    ``gnn_num_shards`` (or the explicit ``num_shards``/``partition``
    overrides) selects between the single-plan ``AmpleEngine`` and the
    partition-aware ``ShardedAmpleEngine``; the arch apply functions take
    either. ``gnn_partitioner`` picks the splitting algorithm ("edges"
    contiguous / "mincut" halo-minimizing) and ``gnn_halo_overlap`` the
    overlapped halo exchange; the keyword arguments override the config
    fields. ``mesh`` (a 1-D ``("shard",)`` ``DeviceMesh``, one rank per
    shard) runs each rank's shard and returns the whole output on every
    rank; without it the shards run as a host loop on one device.
    """
    shards = cfg.gnn_num_shards if num_shards is None else num_shards
    if partition is None and shards <= 1 and mesh is None:
        return AmpleEngine(prepared, engine_config(cfg))
    from repro_torch.distributed.graph_shard import make_sharded_engine

    return make_sharded_engine(
        prepared,
        engine_config(cfg),
        num_shards=None if partition is not None else shards,
        partition=partition,
        partitioner=(cfg.gnn_partitioner if partitioner is None else partitioner) or "edges",
        modes=(agg_mode(cfg),),
        mesh=mesh,
        halo_overlap=cfg.gnn_halo_overlap if halo_overlap is None else halo_overlap,
    )


# --------------------------------------------------- uniform entry points
def gnn_init(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    device="cuda",
) -> Dict:
    """Random params for ``cfg`` from ``generator`` (seed 0 when omitted)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return get_arch(cfg.gnn_arch).init(cfg, gen, dev)


def _shapes(node):
    if isinstance(node, dict):
        return {k: _shapes(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_shapes(v) for v in node]
    return tuple(node.shape)


def params_from_numpy(cfg: ModelConfig, tree, *, device="cuda"):
    """The reference's params (the same tree with numpy leaves, e.g.
    ``{"layers": [{"w": ndarray}, …]}`` for GCN; GIN's ``eps`` is a 0-d leaf)
    as f32 tensors on ``device``, checked against the arch's ``param_shapes``.

    With it, the port and the reference compute the same model.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, np.float32)).to(dev)

    params = conv(tree)
    want, got = get_arch(cfg.gnn_arch).param_shapes(cfg), _shapes(params)
    if got != want:
        raise ValueError(f"{cfg.name} weights must be {want}, got {got}")
    return params


def _params_device(params) -> torch.device:
    node = params
    while isinstance(node, (dict, list, tuple)):
        node = next(iter(node.values())) if isinstance(node, dict) else node[0]
    return node.device


def gnn_apply(cfg: ModelConfig, params: Dict, engine: AmpleEngine, x) -> torch.Tensor:
    """Run ``cfg``'s arch through ``engine`` on the params' device
    (streamed handles pass through)."""
    if not isinstance(x, StreamedFeatures):
        x = torch.as_tensor(x, dtype=torch.float32, device=_params_device(params))
    return get_arch(cfg.gnn_arch).apply(cfg, params, engine, x)


def gnn_reference(cfg: ModelConfig, params: Dict, g: Graph, x) -> torch.Tensor:
    """Dense-adjacency float oracle on the *prepared* graph (test-scale)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=_params_device(params))
    return get_arch(cfg.gnn_arch).reference(cfg, params, prepare_graph(cfg, g), x)


def gnn_forward(
    params: Dict, cfg: ModelConfig, batch: Dict
) -> Tuple[torch.Tensor, torch.Tensor]:
    """model_forward body for family="gnn".

    ``batch`` carries ``graph`` (a CSR Graph) and ``features`` f32[N, D];
    callers holding a compiled engine (the serving path) pass it as
    ``batch["engine"]`` to skip plan compilation. ``features`` may also be a
    ``memory.StreamedFeatures`` handle — the out-of-core path: the feature
    matrix stays on the host and the engine streams it chunk-wise under the
    handle's budget. Returns ``(logits, aux)`` with logits
    f32[N, num_classes] on the params' device.
    """
    feats = batch["features"]
    x = feats if isinstance(feats, StreamedFeatures) else torch.as_tensor(
        feats, dtype=torch.float32, device=_params_device(params))
    engine = batch.get("engine")
    n = engine.graph.num_nodes if engine is not None else batch["graph"].num_nodes
    want = cfg.gnn_layer_dims[0]
    if x.ndim != 2 or tuple(x.shape) != (n, want):
        raise ValueError(
            f"features must be [{n}, {want}] for {cfg.name} on this graph "
            f"(num_nodes={n}, cfg.d_model={want}), got {tuple(x.shape)}"
        )
    if engine is None:
        engine = make_engine(cfg, prepare_graph(cfg, batch["graph"]))
    engine.begin_forward()
    y = gnn_apply(cfg, params, engine, x)
    return y, torch.zeros((), dtype=torch.float32, device=y.device)
