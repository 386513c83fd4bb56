"""Discrete-event simulator of the AMPLE accelerator (Alveo U280 @ 200 MHz).

A numpy copy of the reference's ``repro/core/simulator.py``: the same model,
constants and arithmetic, so both give equal results field for field.

No FPGA exists in this environment, so the paper's *evaluation* (Table 5 /
Figure 4 latencies) is reproduced with a cycle-level discrete-event model of
the microarchitecture in Section 3:

* **Nodeslots (NID)** — ``num_nodeslots`` independent slots; a slot is
  reprogrammed by the host the moment its node completes (event-driven flow).
  The double-buffered baseline mode instead batches ``num_nodeslots`` nodes
  and waits for the slowest before refilling (HyGCN-style), which reproduces
  the pipeline-gap penalty the paper argues against.
* **Mixed precision** — slots are split between float and int8 pools per the
  Degree-Quant tags (Eq. 6; the paper found 1 float slot usually suffices).
  int8 nodes move 1-byte features and aggregate twice as wide.
* **Prefetcher / Feature Bank** — each slot's Fetch Tag streams neighbour
  embeddings from HBM through one of 32 banks (round-robin groups). The
  **partial response** mechanism starts aggregation after the first
  ``fetch_tag_capacity`` neighbours; the remainder streams concurrently.
* **AGE / FTE** — aggregation consumes ``agg_lanes`` feature elements/cycle
  per slot; transformation is a shared 32×32 systolic array processing nodes
  FIFO after aggregation.

Constants are microarchitectural estimates (the paper publishes none); the
calibration test checks the simulated Table 5 latencies land within a small
factor of the published numbers and — more importantly — that the *speedup
structure* (event-driven ≫ double-buffered on skewed graphs; gap widening
with degree variance) reproduces.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = ["SimConfig", "SimResult", "simulate", "simulate_dataset"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    clock_hz: float = 200e6
    num_nodeslots: int = 64
    float_slots: int = 1  # Eq. 6 outcome: one float slot usually suffices
    hbm_banks: int = 32
    hbm_bank_bytes_per_cycle: float = 32.0  # 64b DDR @2x clock ≈ 32 B/cycle/bank
    fetch_tag_capacity: int = 64  # neighbours buffered before partial response
    agg_lanes: int = 16  # feature elements/cycle/slot (VPU-like)
    fte_macs: int = 32 * 32  # systolic array MACs/cycle (shared)
    instr_overhead_cycles: int = 32  # NID programming + interrupt per node
    event_driven: bool = True  # False = double-buffered baseline
    # Prefetcher lookahead (§3.3): with depth P, a slot's next fetch is
    # issued up to P × (its previous node's aggregation time) before the
    # slot frees, hiding HBM latency behind the running aggregation. 0
    # reproduces the historical no-lookahead timing exactly; the measured
    # counterpart is the out-of-core chunk cache's prefetch_depth
    # (memory/prefetcher.py).
    prefetch_depth: int = 0


@dataclasses.dataclass
class SimResult:
    cycles: float
    latency_ms: float
    nodes_per_ms: float
    slot_busy_frac: float
    fetch_stall_frac: float
    fte_queue_peak: int


def _node_cycles(
    deg: int, feat: int, out_feat: int, is_float: bool, cfg: SimConfig
) -> Tuple[float, float, float]:
    """(fetch_cycles, agg_cycles, fte_cycles) for one node."""
    bytes_per_el = 4 if is_float else 1
    fetch_bytes = deg * feat * bytes_per_el
    fetch = fetch_bytes / cfg.hbm_bank_bytes_per_cycle  # one bank granted
    lanes = cfg.agg_lanes * (1 if is_float else 2)  # int8 packs 2x lanes
    agg = deg * feat / lanes
    fte = feat * out_feat / cfg.fte_macs / (1 if is_float else 2)
    return fetch, agg, fte


def simulate(
    g: Graph,
    *,
    feature_dim: Optional[int] = None,
    out_dim: Optional[int] = None,
    float_mask: Optional[np.ndarray] = None,
    cfg: SimConfig = SimConfig(),
) -> SimResult:
    """Simulate one GNN layer (aggregate + transform) over every node."""
    n = g.num_nodes
    feat = feature_dim or (g.features.shape[1] if g.features is not None else 64)
    out = out_dim or feat
    deg = g.degrees
    if float_mask is None:
        float_mask = np.zeros(n, bool)

    # Precompute per-node phase durations (cycles) — vectorized.
    bytes_per_el = np.where(float_mask, 4.0, 1.0)
    lanes = cfg.agg_lanes * np.where(float_mask, 1.0, 2.0)
    fetch_c = deg * feat * bytes_per_el / cfg.hbm_bank_bytes_per_cycle
    agg_c = deg * feat / lanes
    fte_c = feat * out / cfg.fte_macs / np.where(float_mask, 1.0, 2.0)

    # Event-driven: slots free independently. We model each slot's timeline
    # with a heap of (free_time, slot); HBM banks arbitrate via per-bank
    # next-free times (round-robin assignment); the FTE is a single FIFO
    # server. Partial response: aggregation may start after the first
    # `fetch_tag_capacity` neighbours have landed; the tail of the fetch and
    # the aggregation then proceed in parallel (aggregation rate-limited by
    # whichever is slower).
    if cfg.event_driven:
        order = np.argsort(-deg, kind="stable")  # host issues longest-first (LPT)
    else:
        order = np.arange(n)  # static pipeline streams nodes in id order
    slots = [(0.0, s) for s in range(cfg.num_nodeslots)]
    heapq.heapify(slots)
    bank_free = np.zeros(cfg.hbm_banks)
    fte_free = 0.0
    busy = 0.0
    fetch_stall = 0.0
    fte_queue_peak = 0
    fte_inflight: List[float] = []
    t_end = 0.0

    if cfg.event_driven:
        prev_agg = np.zeros(cfg.num_nodeslots)  # last agg duration per slot
        for idx, v in enumerate(order):
            free_t, slot = heapq.heappop(slots)
            start = free_t + cfg.instr_overhead_cycles
            bank = slot % cfg.hbm_banks
            # Prefetch lookahead: the slot's fetch may be issued while its
            # previous node was still aggregating (depth × that duration).
            lookahead = cfg.prefetch_depth * prev_agg[slot]
            fstart = max(start - lookahead, bank_free[bank])
            # partial response: agg starts when the first chunk has landed
            first_chunk = fetch_c[v] * min(
                1.0, cfg.fetch_tag_capacity / max(int(deg[v]), 1)
            )
            agg_start = max(start, fstart + first_chunk)
            # stall = slot cycles spent waiting on data (bank grant + first
            # chunk arrival); the prefetcher's whole purpose is shrinking it.
            fetch_stall += agg_start - start
            agg_end = max(agg_start + agg_c[v], fstart + fetch_c[v])
            bank_free[bank] = fstart + fetch_c[v]
            prev_agg[slot] = agg_c[v]
            fte_start = max(agg_end, fte_free)
            fte_end = fte_start + fte_c[v]
            fte_free = fte_end
            while fte_inflight and fte_inflight[0] <= agg_end:
                heapq.heappop(fte_inflight)
            heapq.heappush(fte_inflight, fte_end)
            fte_queue_peak = max(fte_queue_peak, len(fte_inflight))
            heapq.heappush(slots, (agg_end, slot))  # slot frees after AGE
            busy += agg_end - start
            t_end = max(t_end, fte_end)
    else:
        # Double-buffered baseline: fill all slots, wait for the SLOWEST
        # aggregation in the batch before refilling (no slot recycling).
        t = 0.0
        for b0 in range(0, n, cfg.num_nodeslots):
            batch = order[b0 : b0 + cfg.num_nodeslots]
            batch_end = t
            for j, v in enumerate(batch):
                bank = j % cfg.hbm_banks
                fstart = max(t + cfg.instr_overhead_cycles, bank_free[bank])
                first_chunk = fetch_c[v] * min(
                    1.0, cfg.fetch_tag_capacity / max(int(deg[v]), 1)
                )
                agg_end = max(fstart + first_chunk + agg_c[v], fstart + fetch_c[v])
                bank_free[bank] = fstart + fetch_c[v]
                fte_start = max(agg_end, fte_free)
                fte_free = fte_start + fte_c[v]
                busy += agg_end - t
                batch_end = max(batch_end, agg_end)
            t = batch_end  # pipeline gap: everyone waits for the straggler
            t_end = max(t_end, fte_free)

    total_slot_time = t_end * cfg.num_nodeslots
    cycles = t_end
    return SimResult(
        cycles=cycles,
        latency_ms=cycles / cfg.clock_hz * 1e3,
        nodes_per_ms=n / (cycles / cfg.clock_hz * 1e3),
        slot_busy_frac=busy / max(total_slot_time, 1.0),
        fetch_stall_frac=fetch_stall / max(total_slot_time, 1.0),
        fte_queue_peak=fte_queue_peak,
    )


def simulate_dataset(
    name: str,
    *,
    model: str = "gcn",
    cfg: SimConfig = SimConfig(),
    seed: int = 0,
    max_nodes: Optional[int] = None,
) -> Dict[str, float]:
    """Table-5 style record for one dataset (layer dims from Table 4)."""
    from repro_torch.core.degree_quant import DegreeQuantConfig, inference_precision_tags
    from repro_torch.graphs.datasets import PAPER_DATASETS, make_dataset

    spec = PAPER_DATASETS[name]
    g = make_dataset(name, seed=seed, with_features=False, max_nodes=max_nodes)
    tags = inference_precision_tags(
        g, DegreeQuantConfig(float_ratio=spec.dq_float_ratio)
    )
    fmask = tags == "float"
    hidden = 16 if model == "gcn" else 64
    res = simulate(
        g, feature_dim=spec.feature_dim, out_dim=hidden, float_mask=fmask, cfg=cfg
    )
    scale = spec.num_nodes / g.num_nodes  # if size-reduced, extrapolate
    return {
        "dataset": name,
        "nodes": spec.num_nodes,
        "latency_ms": res.latency_ms * scale,
        "nodes_per_ms": res.nodes_per_ms,
        "slot_busy_frac": res.slot_busy_frac,
        "event_driven": cfg.event_driven,
    }
