"""Elastic scaling + straggler policy: what happens when hosts die mid-run.

The reference's ``repro/distributed/elastic.py``, standard library only, copied
as it is (the port imports nothing of the reference).

On a 1000+-node deployment, node failure is routine. The recovery contract:

1. Health layer marks hosts dead (out of scope — injected here as a mask).
2. ``elastic_plan`` maps the surviving chip count onto the largest valid
   (data × model) mesh that preserves the model-parallel degree (TP cannot
   shrink without resharding weights *math*; DP can shrink freely) and
   recomputes the per-shard batch so the GLOBAL batch (and thus the training
   trajectory) is preserved exactly via gradient accumulation.
3. Checkpoint restore re-device_puts leaves against the new mesh
   (checkpoint/checkpoint.py stores unsharded leaves precisely for this).

Straggler mitigation is configuration, not code, at this layer: DP spans the
pod axis, so a slow host delays only its gradient contribution; with
``drop_stragglers`` the all-reduce group is rebuilt without hosts whose last
heartbeat exceeds the deadline (gradient contribution of a dropped shard is
replayed next step via the data pipeline's deterministic (seed, step)
contract). For *irregular* workloads (the paper's GNN case), the event-driven
ExecutionPlan is itself the straggler mitigation — work is balanced by edge
count, not node count (graphs/partition.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["ElasticPlan", "elastic_plan", "rebalance_batch"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_parallel: int  # surviving DP degree
    model_parallel: int  # unchanged TP degree
    per_shard_batch: int  # examples per DP shard per micro-step
    grad_accum: int  # micro-steps to preserve the global batch
    dropped_hosts: Tuple[int, ...]
    global_batch: int

    @property
    def chips_used(self) -> int:
        return self.data_parallel * self.model_parallel


def elastic_plan(
    *,
    alive_chips: int,
    model_parallel: int,
    global_batch: int,
    max_per_shard_batch: int = 64,
    dropped_hosts: Tuple[int, ...] = (),
) -> ElasticPlan:
    """Largest valid mesh ≤ alive_chips with TP preserved, batch preserved.

    Raises if fewer than one TP group survives (the job cannot continue and
    must wait for repair — checkpoint restore handles the rest).
    """
    if alive_chips < model_parallel:
        raise RuntimeError(
            f"only {alive_chips} chips alive < one model-parallel group "
            f"({model_parallel}); cannot continue"
        )
    dp_max = alive_chips // model_parallel
    # exact-batch guarantee: use the LARGEST dp ≤ dp_max that divides the
    # global batch (surplus DP groups idle — preserving the training
    # trajectory beats using every chip with a changed batch)
    dp = max(d for d in range(1, dp_max + 1) if global_batch % d == 0)
    micro = global_batch // dp  # examples per shard per step, to be split
    per_shard = max(
        d for d in range(1, min(max_per_shard_batch, micro) + 1) if micro % d == 0
    )
    accum = micro // per_shard
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        per_shard_batch=per_shard,
        grad_accum=accum,
        dropped_hosts=tuple(dropped_hosts),
        global_batch=global_batch,
    )


def rebalance_batch(
    global_batch: int, shard_weights: List[float]
) -> List[int]:
    """Weighted batch split (straggler-aware DP): faster shards get more.

    Largest-remainder apportionment: exact sum, monotone in weight — used when
    heterogeneous hosts (or partially-degraded ones) should keep contributing
    rather than being dropped.
    """
    total_w = sum(shard_weights)
    if total_w <= 0:
        raise ValueError("all shard weights are zero")
    quotas = [global_batch * w / total_w for w in shard_weights]
    base = [int(q) for q in quotas]
    rem = global_batch - sum(base)
    order = sorted(
        range(len(quotas)), key=lambda i: quotas[i] - base[i], reverse=True
    )
    for i in order[:rem]:
        base[i] += 1
    return base
