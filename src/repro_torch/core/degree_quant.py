"""Degree-Quant (Tailor et al. 2020) — node-granularity precision assignment.

The inference half of the reference's ``repro/core/degree_quant.py``: each
node is tagged ``float`` (protected) or ``int8`` by degree, and Table 4's "DQ
ratio" is the resulting float fraction. The QAT-time stochastic protection
waits for the training slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = [
    "DegreeQuantConfig",
    "inference_precision_tags",
]


@dataclasses.dataclass(frozen=True)
class DegreeQuantConfig:
    p_min: float = 0.0  # protection probability of the min-degree node
    p_max: float = 0.1  # protection probability of the max-degree node
    float_ratio: float = 0.03  # inference-time protected fraction (Table 4 <3%)


def inference_precision_tags(
    g: Graph, cfg: DegreeQuantConfig, *, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Deterministic inference tags: the top ``float_ratio`` fraction of nodes
    by degree are protected (``"float"``); the rest run ``"int8"``.

    This is the deployment-time reading of Degree-Quant the accelerator
    consumes (Table 2's Precision column): protection correlates with degree,
    and the protected ratio matches Table 4.
    """
    n = g.num_nodes
    k = int(round(cfg.float_ratio * n))
    k = min(max(k, 1 if n else 0), n)
    tags = np.full(n, "int8", dtype=object)
    if k:
        deg = g.degrees
        if rng is not None:
            # tie-break hubs stochastically so equal-degree nodes rotate
            jitter = rng.random(n) * 0.5
        else:
            jitter = np.zeros(n)
        top = np.argsort(-(deg + jitter), kind="stable")[:k]
        tags[top] = "float"
    return tags.astype(str)
