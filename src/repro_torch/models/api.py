"""Family-agnostic model API: init / forward / prefill / decode by config.

The reference's ``repro/models/api.py``, dispatched on ``cfg.family``:

  * the token families the port serves (``dense``, ``moe``, ``hybrid``,
    ``ssm``) route to the LM stack (``models/lm/transformer.py``); batches
    carry ``tokens`` [B, S]; ``model_forward`` returns (logits, aux), aux
    being the MoE layers' summed load-balancing loss;
  * ``family="gnn"`` routes to the arch registry in ``models/gnn/api.py``;
    batches carry ``graph`` + ``features``. GNN inference has no token
    cache, so prefill/decode reject GNN configs.

VLM and enc-dec configs raise ``NotImplementedError`` naming their ROADMAP
item. ``params_from_numpy`` carries the reference's params (numpy leaves)
into the port, for either family, each leaf in its own dtype (a MoE
router stays f32 in a bf16 model).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.gnn import api as gnn_api
from repro_torch.models.lm import transformer

__all__ = [
    "model_init",
    "model_forward",
    "model_prefill",
    "model_init_cache",
    "model_decode_step",
    "param_shapes",
    "params_from_numpy",
    "params_to",
]


def _is_gnn(cfg: ModelConfig) -> bool:
    return cfg.family == "gnn"


def _no_token_cache(cfg: ModelConfig, entry: str):
    raise TypeError(
        f"{entry} is undefined for family='gnn' ({cfg.name}): GNN inference "
        "has no token cache; use model_forward with {'graph', 'features'} or "
        "serve.gnn_engine.GNNServeEngine for cached-plan serving"
    )


def model_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
               device="cuda"):
    """Random params for ``cfg`` on ``device`` from ``generator`` (seed 0 on
    ``device`` when omitted)."""
    dev = resolve_device(device)
    if _is_gnn(cfg):
        return gnn_api.gnn_init(cfg, generator, device=dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    return transformer.init_lm(cfg, gen, dev)


def model_forward(params, cfg: ModelConfig, batch: Dict):
    if _is_gnn(cfg):
        return gnn_api.gnn_forward(params, cfg, batch)
    return transformer.forward(params, cfg, batch)


def model_prefill(params, cfg: ModelConfig, batch: Dict, max_len: int):
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_prefill")
    return transformer.prefill(params, cfg, batch, max_len)


def model_init_cache(cfg: ModelConfig, params, batch: Dict, max_len: int):
    """Empty decode cache for ``batch["tokens"]``'s batch size."""
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_init_cache")
    b = batch["tokens"].shape[0]
    return transformer.init_cache(cfg, b, max_len, device=params["embed"].device)


def model_decode_step(params, cfg: ModelConfig, batch: Dict, cache, cache_len: int):
    if _is_gnn(cfg):
        _no_token_cache(cfg, "model_decode_step")
    return transformer.decode_step(params, cfg, batch, cache, cache_len)


def param_shapes(cfg: ModelConfig):
    """The params tree of ``cfg`` with a shape tuple per leaf."""
    if _is_gnn(cfg):
        return gnn_api.get_arch(cfg.gnn_arch).param_shapes(cfg)
    return transformer.param_shapes(cfg)


def _leaf(arr, dev: torch.device) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype. A bf16 leaf (numpy's
    ``ml_dtypes`` bfloat16, as a JAX array converts) is reinterpreted bit for
    bit through int16, never routed through f32."""
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)


def params_from_numpy(cfg: ModelConfig, tree, *, device="cuda"):
    """The reference's params (the same tree with numpy leaves) on ``device``,
    checked against ``param_shapes(cfg)``. GNN trees become f32 (the GNN
    API's own ``params_from_numpy``); LM trees keep each leaf's dtype."""
    if _is_gnn(cfg):
        return gnn_api.params_from_numpy(cfg, tree, device=device)
    dev = resolve_device(device)
    params = _tree(tree, lambda a: _leaf(a, dev))
    got = _tree(params, lambda t: tuple(t.shape))
    want = param_shapes(cfg)
    if got != want:
        raise ValueError(f"{cfg.name} weights must be {want}, got {got}")
    return params


def params_to(params, device):
    """A copy of a params tree (either family) on ``device``."""
    return _tree(params, lambda t: t.to(device))
