"""GAT (Veličković et al.) on the AMPLE engine — runtime edge coefficients.

    e_ij   = LeakyReLU( a_src · (W x_j)  +  a_dst · (W x_i) )
    α_ij   = softmax_{j ∈ N(i) ∪ {i}} e_ij          (per destination segment)
    x_i'   = ‖_h  Σ_{j}  α_ij · W_h x_j             (concat heads; mean on the
                                                     output layer)

The aggregation coefficient is not a structural constant: α depends on the
node features, per layer, per request. The engine therefore compiles plans in
``"runtime"`` mode (static coeff 1 as a pure lane mask) and the kernel reads the
raw per-edge scores through the plan's ``edge_ids`` at request time, so plans
and size classes stay structure-keyed as for GCN. Each layer runs the
fused attention kernel once per precision group
(``AmpleEngine.attention_aggregate``); the projection W reuses the engine's
mixed-precision FTE, so Degree-Quant tags carry over unchanged. Attention
scores and coefficients stay f32.

Self-loops are explicit edges (∪{i} above), added by ``prepare_graph`` via the
registry's ``needs_self_loops`` flag, as for GCN.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.message_passing import AmpleEngine
from repro_torch.graphs.csr import Graph
from repro_torch.models.gnn import api
from repro_torch.models.gnn.layers import glorot

__all__ = ["init", "apply", "reference", "param_shapes", "LEAKY_SLOPE"]

LEAKY_SLOPE = 0.2  # the paper's LeakyReLU negative slope


def _leaky(e: torch.Tensor) -> torch.Tensor:
    return torch.where(e >= 0, e, LEAKY_SLOPE * e)


def _heads(cfg: ModelConfig) -> int:
    """Every layer runs cfg.gnn_heads heads: hidden layers concatenate the
    head outputs, the output layer averages them."""
    return max(int(cfg.gnn_heads), 1)


def _head_dim(cfg: ModelConfig, layer: int) -> int:
    dims = cfg.gnn_layer_dims
    d_out = dims[layer + 1]
    h = _heads(cfg)
    if layer < len(dims) - 2:  # hidden layer: heads concatenate
        if d_out % h != 0:
            raise ValueError(
                f"layer {layer} output width {d_out} is not divisible by "
                f"gnn_heads={h} (hidden layers concatenate head outputs)"
            )
        return d_out // h
    return d_out  # output layer: every head spans the full width, then mean


def param_shapes(cfg: ModelConfig) -> Dict:
    """Per layer: one projection per head (packed [d_in, H·dh]) plus the
    split attention vectors a_src/a_dst [H, dh] (no bias, like GCN)."""
    dims = cfg.gnn_layer_dims
    h = _heads(cfg)
    return {"layers": [
        {"w": (dims[i], h * _head_dim(cfg, i)), "a_src": (h, _head_dim(cfg, i)),
         "a_dst": (h, _head_dim(cfg, i))}
        for i in range(len(dims) - 1)
    ]}


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {"layers": [{k: glorot(generator, shape, device) for k, shape in lyr.items()}
                       for lyr in param_shapes(cfg)["layers"]]}


def apply(
    cfg: ModelConfig, params: Dict, engine: AmpleEngine, x: torch.Tensor
) -> torch.Tensor:
    mode = api.agg_mode(cfg)
    src, dst = engine.edge_endpoints(x.device)
    n_layers = len(params["layers"])
    num_nodes = engine.graph.num_nodes
    h = _heads(cfg)
    for i, lyr in enumerate(params["layers"]):
        dh = _head_dim(cfg, i)
        z = engine.transform(x, lyr["w"])  # [N, H·dh], one FTE for all heads
        zh = z.reshape(num_nodes, h, dh)
        src_sc = torch.einsum("nhd,hd->nh", zh, lyr["a_src"])
        dst_sc = torch.einsum("nhd,hd->nh", zh, lyr["a_dst"])
        scores = src_sc[src] + dst_sc[dst]  # raw [E, H]
        out = engine.attention_aggregate(scores, zh, mode=mode, leaky_slope=LEAKY_SLOPE)
        if i < n_layers - 1:
            x = F.elu(out.reshape(num_nodes, h * dh))
        else:
            x = out.sum(dim=1) / float(h)
    return x


def reference(
    cfg: ModelConfig, params: Dict, g: Graph, x: torch.Tensor
) -> torch.Tensor:
    """Dense-adjacency float oracle: masked softmax attention (test-scale)."""
    mask = torch.as_tensor(g.dense_adjacency() > 0).to(x.device)  # row i = in-nbrs of i
    n_layers = len(params["layers"])
    num_nodes = g.num_nodes
    h = _heads(cfg)
    for i, lyr in enumerate(params["layers"]):
        dh = _head_dim(cfg, i)
        zh = (x @ lyr["w"]).reshape(num_nodes, h, dh)
        src_sc = torch.einsum("nhd,hd->nh", zh, lyr["a_src"])
        dst_sc = torch.einsum("nhd,hd->nh", zh, lyr["a_dst"])
        outs = []
        for head in range(h):
            # e[i, j] = leaky(a_src·z_j + a_dst·z_i) over edges j -> i
            e = _leaky(src_sc[None, :, head] + dst_sc[:, None, head])
            e = torch.where(mask, e, float("-inf"))
            m = e.max(dim=1, keepdim=True).values
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            ex = torch.where(mask, torch.exp(e - m), torch.zeros_like(e))
            denom = ex.sum(dim=1, keepdim=True)
            alpha = ex / torch.where(denom > 0, denom, torch.ones_like(denom))
            outs.append(alpha @ zh[:, head, :])
        if i < n_layers - 1:
            x = F.elu(torch.cat(outs, dim=-1))
        else:
            x = sum(outs) / float(h)
    return x


api.register_arch(
    "gat",
    init=init,
    apply=apply,
    reference=reference,
    param_shapes=param_shapes,
    default_agg="runtime",
    needs_self_loops=True,
)
