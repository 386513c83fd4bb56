"""GraphSAGE (Hamilton et al.) on the AMPLE engine — Eq. 4 of the paper.

    x_i' = W1 x_i + W2 · mean_{j ∈ N(i)} σ(W3 x_j + b)

φ is a dense projection applied to *all* nodes once (every node is someone's
neighbour), the mean runs through the event-driven AGE with 1/deg
coefficients, and γ adds the W1 transformation-side residual (Table 3). A
layer quantizes three FTE call sites, in the order φ, W1, W2, with the
aggregation's slot between φ and W1.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.message_passing import AmpleEngine
from repro_torch.graphs.csr import Graph
from repro_torch.models.gnn import api
from repro_torch.models.gnn.layers import linear_init

__all__ = ["init", "apply", "reference", "param_shapes"]


def param_shapes(cfg: ModelConfig) -> Dict:
    """Per layer: W1, W2 [d_in, d_out] without bias, W3 [d_in, d_in] + b."""
    dims = cfg.gnn_layer_dims
    return {"layers": [
        {"w1": {"w": (dims[i], dims[i + 1])}, "w2": {"w": (dims[i], dims[i + 1])},
         "w3": {"w": (dims[i], dims[i]), "b": (dims[i],)}}
        for i in range(len(dims) - 1)
    ]}


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    dims = cfg.gnn_layer_dims
    return {"layers": [
        {"w1": linear_init(generator, dims[i], dims[i + 1], device, bias=False),
         "w2": linear_init(generator, dims[i], dims[i + 1], device, bias=False),
         "w3": linear_init(generator, dims[i], dims[i], device, bias=True)}
        for i in range(len(dims) - 1)
    ]}


def apply(
    cfg: ModelConfig, params: Dict, engine: AmpleEngine, x: torch.Tensor
) -> torch.Tensor:
    mode = api.agg_mode(cfg)
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        msgs = engine.transform(x, lyr["w3"]["w"], lyr["w3"]["b"], torch.relu)  # φ
        m = engine.aggregate(msgs, mode=mode)  # A
        x = engine.transform(x, lyr["w1"]["w"]) + engine.transform(m, lyr["w2"]["w"])
        if i < n - 1:
            x = torch.relu(x)
    return x


def reference(
    cfg: ModelConfig, params: Dict, g: Graph, x: torch.Tensor
) -> torch.Tensor:
    """Dense-adjacency float oracle (test-scale only)."""
    a = g.dense_adjacency()
    deg = np.maximum(a.sum(axis=1, keepdims=True), 1.0)
    a_mean = torch.as_tensor(a / deg).to(x.device)
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        msgs = torch.relu(x @ lyr["w3"]["w"] + lyr["w3"]["b"])
        m = a_mean @ msgs
        x = x @ lyr["w1"]["w"] + m @ lyr["w2"]["w"]
        if i < n - 1:
            x = torch.relu(x)
    return x


api.register_arch(
    "sage",
    init=init,
    apply=apply,
    reference=reference,
    param_shapes=param_shapes,
    default_agg="mean",
)
