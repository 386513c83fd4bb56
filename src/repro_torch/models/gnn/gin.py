"""GIN (Xu et al.) on the AMPLE engine — Eq. 3 of the paper.

    x_i' = MLP( (1 + ε) · x_i  +  Σ_{j ∈ N(i)} x_j )

Aggregation: plain sum, no normalisation; residual on the aggregation side
(Table 3) — the (1+ε)x_i term. The MLP (2 layers, ReLU) is the γ transform and
runs through the engine's mixed-precision FTE one linear at a time, so a
layer quantizes two FTE call sites (one activation-quantization slot each).

The first layer's input may be out-of-core ``StreamedFeatures``: the
aggregate streams through the engine and the residual through
``scale_add_streamed``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.message_passing import AmpleEngine
from repro_torch.graphs.csr import Graph
from repro_torch.memory.prefetcher import StreamedFeatures, scale_add_streamed
from repro_torch.models.gnn import api
from repro_torch.models.gnn.layers import mlp_init

__all__ = ["init", "apply", "reference", "param_shapes"]


def param_shapes(cfg: ModelConfig) -> Dict:
    """A 0-d ``eps`` and one 2-layer MLP per GNN layer:
    [d_in -> d_out -> d_out], each linear with a bias."""
    dims = cfg.gnn_layer_dims
    return {
        "eps": (),
        "layers": [
            {"layers": [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)},
                        {"w": (dims[i + 1], dims[i + 1]), "b": (dims[i + 1],)}]}
            for i in range(len(dims) - 1)
        ],
    }


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    """ε starts at 0, as the reference's init has it."""
    dims = cfg.gnn_layer_dims
    return {
        "eps": torch.zeros((), dtype=torch.float32, device=device),
        "layers": [mlp_init(generator, [dims[i], dims[i + 1], dims[i + 1]], device)
                   for i in range(len(dims) - 1)],
    }


def _mlp_through_engine(engine: AmpleEngine, mlp: Dict, h: torch.Tensor) -> torch.Tensor:
    n = len(mlp["layers"])
    for i, lyr in enumerate(mlp["layers"]):
        h = engine.transform(
            h, lyr["w"], lyr.get("b"), activation=torch.relu if i < n - 1 else None
        )
    return h


def apply(
    cfg: ModelConfig, params: Dict, engine: AmpleEngine, x: torch.Tensor
) -> torch.Tensor:
    mode = api.agg_mode(cfg)
    n = len(params["layers"])
    for i, mlp in enumerate(params["layers"]):
        m = engine.aggregate(x, mode=mode)
        if isinstance(x, StreamedFeatures):  # out-of-core first layer
            h = scale_add_streamed(x, 1.0 + params["eps"], m)
        else:
            h = (1.0 + params["eps"]) * x + m  # aggregation-side residual
        x = _mlp_through_engine(engine, mlp, h)
        if i < n - 1:
            x = torch.relu(x)
    return x


def reference(
    cfg: ModelConfig, params: Dict, g: Graph, x: torch.Tensor
) -> torch.Tensor:
    """Dense-adjacency float oracle (test-scale only)."""
    a = torch.as_tensor(g.dense_adjacency()).to(x.device)
    n = len(params["layers"])
    for i, mlp in enumerate(params["layers"]):
        h = (1.0 + params["eps"]) * x + a @ x
        for k, lyr in enumerate(mlp["layers"]):
            h = h @ lyr["w"] + lyr["b"]
            if k < len(mlp["layers"]) - 1:
                h = torch.relu(h)
        x = torch.relu(h) if i < n - 1 else h
    return x


api.register_arch(
    "gin",
    init=init,
    apply=apply,
    reference=reference,
    param_shapes=param_shapes,
    default_agg="sum",
)
