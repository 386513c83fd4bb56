"""Feed-forward variants: SwiGLU (llama/qwen), squared-ReLU (nemotron), GELU.

The reference's ``repro/models/lm/mlp.py``; the matmuls run in the weights'
dtype, as there.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(make, d_model: int, d_ff: int, kind: str, *, bias: bool = False,
             dtype=torch.bfloat16) -> Dict:
    """He-normal weights and zero biases, in the model dtype (``make``: a
    parameter maker of ``transformer.py``)."""
    if kind == "swiglu":
        p = {
            "w_gate": make.normal((d_model, d_ff), d_model**-0.5, dtype),
            "w_up": make.normal((d_model, d_ff), d_model**-0.5, dtype),
            "w_down": make.normal((d_ff, d_model), d_ff**-0.5, dtype),
        }
    elif kind in ("relu2", "gelu"):
        p = {
            "w_in": make.normal((d_model, d_ff), d_model**-0.5, dtype),
            "w_out": make.normal((d_ff, d_model), d_ff**-0.5, dtype),
        }
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    if bias:
        if kind == "swiglu":
            p["b_gate"] = make.zeros((d_ff,), dtype)
            p["b_up"] = make.zeros((d_ff,), dtype)
        else:
            p["b_in"] = make.zeros((d_ff,), dtype)
        p["b_down"] = make.zeros((d_model,), dtype)
    return p


def _bias(params: Dict, name: str, h: torch.Tensor) -> torch.Tensor:
    return h + params[name] if name in params else h


def mlp_apply(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        gate = _bias(params, "b_gate", x @ params["w_gate"])
        up = _bias(params, "b_up", x @ params["w_up"])
        h = F.silu(gate) * up
        return _bias(params, "b_down", h @ params["w_down"])
    h = _bias(params, "b_in", x @ params["w_in"])
    if kind == "relu2":
        h = torch.square(F.relu(h))  # nemotron squared-ReLU
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return _bias(params, "b_down", h @ params["w_out"])
