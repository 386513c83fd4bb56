"""Degree-Quant (Tailor et al. 2020) — node-granularity precision assignment.

A numpy copy of the reference's ``repro/core/degree_quant.py``, so its arrays
are bitwise the reference's. The paper uses Degree-Quant twice:
* offline, to tag each node ``float`` (protected) or ``int8`` — Table 4's "DQ
  ratio" is the resulting float fraction;
* during QAT, to stochastically protect nodes (Bernoulli with degree-
  interpolated probability) so the quantization error that concentrates in
  high-degree aggregations does not corrupt training.

Both modes live here, plus Eq. 6's resource-to-nodeslot allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = [
    "DegreeQuantConfig",
    "protection_probabilities",
    "sample_protection_mask",
    "inference_precision_tags",
    "allocate_nodeslots",
]


@dataclasses.dataclass(frozen=True)
class DegreeQuantConfig:
    p_min: float = 0.0  # protection probability of the min-degree node
    p_max: float = 0.1  # protection probability of the max-degree node
    float_ratio: float = 0.03  # inference-time protected fraction (Table 4 <3%)


def protection_probabilities(g: Graph, cfg: DegreeQuantConfig) -> np.ndarray:
    """Per-node Bernoulli protection probability, interpolated in degree.

    The paper interpolates within [p_min, p_max], assigning the limits to the
    graph's min/max neighbour counts. Interpolation is done on *rank-normalised
    log degree* — heavy-tailed degree distributions would otherwise map almost
    every node to p_min.
    """
    deg = g.degrees.astype(np.float64)
    logd = np.log1p(deg)
    lo, hi = logd.min(), logd.max()
    t = np.zeros_like(logd) if hi <= lo else (logd - lo) / (hi - lo)
    return (cfg.p_min + t * (cfg.p_max - cfg.p_min)).astype(np.float32)


def sample_protection_mask(
    g: Graph, cfg: DegreeQuantConfig, rng: np.random.Generator
) -> np.ndarray:
    """QAT-time stochastic mask: True = protected (float) this step."""
    p = protection_probabilities(g, cfg)
    return rng.random(g.num_nodes) < p


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


def allocate_nodeslots(
    resource_budget: Mapping[str, Mapping[str, float]],
    cost_per_slot: Mapping[str, Mapping[str, float]],
) -> Dict[str, int]:
    """Eq. 6: N_p = ceil( min_r  R_p^{max,r} / C_p^r ).

    ``resource_budget[p][r]`` is the budget of resource type r (LUT/FF/BRAM/
    DSP) granted to precision group p; ``cost_per_slot[p][r]`` the per-nodeslot
    cost of that resource in a single-precision synthesis. Returns nodeslot
    count per precision.
    """
    slots: Dict[str, int] = {}
    for p, budget in resource_budget.items():
        costs = cost_per_slot[p]
        ratios = [
            budget[r] / costs[r] for r in budget if r in costs and costs[r] > 0
        ]
        if not ratios:
            raise ValueError(f"no overlapping resource types for precision {p!r}")
        slots[p] = max(1, int(np.ceil(min(ratios))))
    return slots
