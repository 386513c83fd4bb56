"""GCN (Kipf & Welling) on the AMPLE engine — Eq. 2 of the paper.

    x_i' = W ( Σ_{j ∈ N(i) ∪ {i}}  e_ji / √(d̂_j d̂_i) · x_j )

Aggregation: sum with GCN normalisation coefficients (folded into the plan);
no residual; normalisation on the aggregation side (Table 3). The graph must
carry explicit self-loops so the ∪{i} term is an edge — the registry's
``needs_self_loops`` flag makes ``prepare_graph`` add them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.message_passing import AmpleEngine
from repro_torch.graphs.csr import Graph, gcn_norm_coeffs
from repro_torch.models.gnn import api
from repro_torch.models.gnn.layers import glorot

__all__ = ["init", "apply", "reference", "param_shapes"]


def param_shapes(cfg: ModelConfig) -> Dict:
    """One weight per layer (Eq. 2 has no bias)."""
    dims = cfg.gnn_layer_dims
    return {"layers": [{"w": (dims[i], dims[i + 1])} for i in range(len(dims) - 1)]}


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {"layers": [{"w": glorot(generator, lyr["w"], device)}
                       for lyr in param_shapes(cfg)["layers"]]}


def apply(
    cfg: ModelConfig, params: Dict, engine: AmpleEngine, x: torch.Tensor
) -> torch.Tensor:
    mode = api.agg_mode(cfg)
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        m = engine.aggregate(x, mode=mode)
        x = engine.transform(
            m, lyr["w"], activation=torch.relu if i < n - 1 else None
        )
    return x


def reference(
    cfg: ModelConfig, params: Dict, g: Graph, x: torch.Tensor
) -> torch.Tensor:
    """Dense-adjacency float oracle (test-scale only)."""
    if g.num_nodes > 20_000:
        raise ValueError("dense adjacency requested for a large graph")
    coeff = gcn_norm_coeffs(g)
    rows = np.repeat(np.arange(g.num_nodes), g.degrees)
    a_norm = np.zeros((g.num_nodes, g.num_nodes), np.float32)
    a_norm[rows, g.indices] = coeff
    a = torch.as_tensor(a_norm).to(x.device)
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        x = (a @ x) @ lyr["w"]
        if i < n - 1:
            x = torch.relu(x)
    return x


api.register_arch(
    "gcn",
    init=init,
    apply=apply,
    reference=reference,
    param_shapes=param_shapes,
    default_agg="gcn",
    needs_self_loops=True,
)
