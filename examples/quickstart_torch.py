"""Quickstart: config-driven, event-driven mixed-precision GNN inference, in the PyTorch port.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--nodes 600]

The port of ``examples/quickstart.py``, section for section: resolve a
``family="gnn"`` ModelConfig from the registry, initialise and run it through
``model_init`` / ``model_forward`` (the batch carries ``graph`` +
``features``), compare against the dense float oracle, then serve repeat
traffic through the plan-cached ``GNNServeEngine`` (unsharded, over 4 shards,
out of core), continuous batching, two tenants, GAT's runtime coefficients,
and the trace and metrics of a request. It runs on the card by default,
through the port's CUDA kernels; ``--device cpu`` runs their plain versions.
The reference's section on ``gnn_use_kernel`` has no counterpart: the port
always runs the fused GAT kernel on the card and its plain version on the
CPU. Weights come from ``torch.Generator`` seeds, so the numbers are the
port's own, not the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.message_passing import AmpleEngine, compile_plans
from repro_torch.device import resolve_device
from repro_torch.graphs.datasets import make_dataset
from repro_torch.models.api import model_forward, model_init
from repro_torch.models.gnn import api as gnn_api
from repro_torch.observe import metrics as ometrics
from repro_torch.observe import trace as otrace
from repro_torch.serve.async_gnn import AsyncGNNEngine
from repro_torch.serve.gnn_engine import GNNServeEngine
from repro_torch.serve.tenancy import TenantRouter


def run(*, device="cuda", nodes: Optional[int] = None,
        trace_dir: Optional[str] = None) -> Dict[str, float]:
    """The tour on ``device`` over synthetic cora (``nodes`` caps it); prints
    each section and returns its key numbers."""
    dev = resolve_device(device)
    res: Dict[str, float] = {}

    # 1. A graph with Cora's published statistics (Table 4) and the paper's
    #    GCN as a registry config (arch, dims, precision policy).
    cfg = dataclasses.replace(get_config("ample-gcn", reduced=True), d_model=24)
    g = make_dataset("cora", max_nodes=nodes, max_feature_dim=cfg.d_model, seed=0)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"mean degree {g.mean_degree:.1f}, features {g.feature_dim}; device {dev}")
    print(f"config: {cfg.name} arch={cfg.gnn_arch} dims={cfg.gnn_layer_dims} "
          f"precision={cfg.gnn_precision}")

    # 2. compile_plans is the host-side planner (NID programming): the
    #    event-driven nodeslot schedule + Degree-Quant precision tags.
    prepared = gnn_api.prepare_graph(cfg, g)  # GCN: explicit self-loops
    plan = compile_plans(prepared, gnn_api.engine_config(cfg), modes=(gnn_api.agg_mode(cfg),))
    eng = AmpleEngine(prepared, plan=plan)
    rep = eng.occupancy_report()
    print(f"event-driven lane occupancy:  {rep['event_driven_lane_occupancy']:.3f}")
    print(f"double-buffer pipeline gaps:  {rep['double_buffer_pipeline_gap_ratio']:.3f}")
    print(f"float-protected nodes:        {rep['float_node_ratio']:.1%} (Table 4: 2.1%)")

    # 3. The family-agnostic model API: the same entry points as the LMs.
    params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.from_numpy(g.features).to(dev)
    with torch.no_grad():
        y, _ = model_forward(params, cfg, {"graph": g, "features": x, "engine": eng})
        yref = gnn_api.gnn_reference(cfg, params, g, x)
    res["oracle_rel_err"] = float((y - yref).abs().max() / (yref.abs().max() + 1e-9))
    res["oracle_agreement"] = float((y.argmax(-1) == yref.argmax(-1)).float().mean())
    print(f"vs float oracle: max rel err {res['oracle_rel_err']:.4f}, "
          f"argmax agreement {res['oracle_agreement']:.1%}")

    # 4. Serving: the plan is the cacheable artifact; repeat traffic on the
    #    same structure skips the planner.
    serve = GNNServeEngine(cfg, params, device=dev)
    cold = serve.infer(g, g.features)
    warm = serve.infer(g, g.features)
    res["warm_equals_cold"] = float(np.array_equal(cold.outputs, warm.outputs))
    print(f"serve cold: plan {cold.plan_ms:.1f} ms + run {cold.run_ms:.1f} ms "
          f"(cache_hit={cold.cache_hit})")
    print(f"serve warm: plan {warm.plan_ms:.1f} ms + run {warm.run_ms:.1f} ms "
          f"(cache_hit={warm.cache_hit}, planner_calls={serve.stats['planner_calls']})")

    # 5. Partition-aware serving: 4 edge-balanced shards, one plan each, with
    #    halo rows gathered per layer (the cluster-level Feature Bank).
    sharded = GNNServeEngine(cfg, params, num_shards=4, device=dev)
    s_cold = sharded.infer(g, g.features)
    s_warm = sharded.infer(g, g.features)
    srep = sharded.shard_report()
    res["sharded_drift"] = float(np.abs(s_warm.outputs - warm.outputs).max())
    print(f"sharded x{s_cold.num_shards}: plan {s_cold.plan_ms:.1f} ms cold, "
          f"cache_hit={s_warm.cache_hit} warm; edge_balance={srep['edge_balance']:.3f}, "
          f"halo {srep['halo_total']} rows/layer, "
          f"max |sharded - unsharded| = {res['sharded_drift']:.2e}")

    # 6. Continuous batching: requests admitted into micro-batch unions,
    #    padded to size classes so changing mixes reuse member plans.
    async_eng = AsyncGNNEngine(
        GNNServeEngine(cfg, params, union_node_bucket=512, union_edge_bucket=4096,
                       device=dev),
        window=3,
    )
    pool = [make_dataset("cora", max_nodes=n, max_feature_dim=cfg.d_model, seed=s)
            for n, s in [(150, 1), (120, 2), (180, 3), (90, 4)]]
    for wave in range(3):
        for s in pool[wave % 2::2] + [pool[wave]]:
            async_eng.submit(s, s.features)
        async_eng.step()
    async_eng.drain()
    info = async_eng.cache_info()
    lookups = info["member_hits"] + info["member_misses"]
    res["member_hit_rate"] = info["member_hits"] / max(lookups, 1)
    print(f"continuous batching: {info['completed']} requests in {info['steps']} "
          f"micro-batches; member-plan hit rate {res['member_hit_rate']:.2f} "
          f"(planner ran {info['planner_calls']}x for {lookups} member slots)")

    # 7. Out-of-core serving: features stay in host memory and stream
    #    through a budget-bound device cache, bitwise the in-memory path.
    budget = g.features.nbytes // 4
    ooc = GNNServeEngine(cfg, params, feature_budget_bytes=budget, device=dev)
    r = ooc.infer(g, g.features)
    res["outofcore_bitwise"] = float(np.array_equal(r.outputs, warm.outputs))
    print(f"out-of-core (budget {budget >> 10}KB of {g.features.nbytes >> 10}KB): "
          f"streamed={r.streamed}, {r.bytes_streamed >> 10}KB moved, chunk hit rate "
          f"{r.chunk_hit_rate:.2f}, bitwise == in-memory: {bool(res['outofcore_bitwise'])}")
    print(f"  async staging: prefetch_overlap={r.prefetch_overlap:.2f} "
          f"(stall {r.stall_ms:.1f}ms of {r.copy_ms:.1f}ms copies)")

    # 8. Runtime edge coefficients: GAT through the same serving stack; the
    #    plan cache stays structure-keyed, so warm GAT traffic skips the
    #    planner as GCN's does.
    gat_cfg = dataclasses.replace(get_config("ample-gat", reduced=True), d_model=cfg.d_model)
    gat = GNNServeEngine(gat_cfg, device=dev, generator=torch.Generator().manual_seed(0))
    g_cold = gat.infer(g, g.features)
    g_warm = gat.infer(g, g.features)
    res["gat_warm_equals_cold"] = float(np.array_equal(g_cold.outputs, g_warm.outputs))
    print(f"gat ({gat_cfg.gnn_heads} heads, runtime coeffs): cold plan "
          f"{g_cold.plan_ms:.1f} ms, warm plan {g_warm.plan_ms:.1f} ms "
          f"(cache_hit={g_warm.cache_hit}, planner_calls={gat.stats['planner_calls']}, "
          f"bitwise warm repeat: {bool(res['gat_warm_equals_cold'])})")

    # 9. Multi-tenant serving: per-tenant queues, token buckets and
    #    deficit-weighted round robin in front of the async engine.
    router = TenantRouter(async_eng)
    router.add_tenant("gold", weight=4.0, priority=1, slo_ms=2_000.0)
    router.add_tenant("batch", weight=1.0)
    small = [make_dataset("cora", max_nodes=n, max_feature_dim=cfg.d_model, seed=n)
             for n in (40, 60, 80)]
    for s in small * 2:
        router.submit("batch", s, s.features)
    vip = router.submit("gold", small[0], small[0].features)
    vip.result()
    router.drain()
    snap = router.snapshot()["tenants"]
    for name in ("gold", "batch"):
        t = snap[name]
        print(f"tenant {name}: done={t['completed']} p99={t['latency_ms']['p99']:.1f} ms "
              f"queue_p99={t['queue_wait_ms']['p99']:.1f} ms "
              f"slo_hit_rate={t['slo_hit_rate']:.2f}")
    res["tenant_completed"] = float(sum(snap[n]["completed"] for n in ("gold", "batch")))

    # 10. Observability: request tracing (off by default, free when off) and
    #     the metrics registry the engines' stats live in.
    rec = otrace.enable()
    try:
        traced = ooc.infer(g, g.features)
        with tempfile.TemporaryDirectory() as tmp:
            path = rec.export(os.path.join(trace_dir or tmp, "trace.json"))
            mine = [s for s in rec.spans() if s.trace_id == traced.trace_id]
            copy_ms = sum(s.dur_ms for s in mine if s.name.startswith("copy:"))
            print(f"trace: {len(rec.spans())} spans -> {os.path.basename(path)} "
                  f"(request {traced.trace_id}: {len(mine)} spans, copy spans "
                  f"{copy_ms:.1f}ms vs reported {traced.copy_ms:.1f}ms)")
        res["trace_spans"] = float(len(mine))
    finally:
        otrace.disable()
    text = ometrics.get_registry().prometheus_text()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("gnn_serve_requests") and ooc.instance in ln)
    print(f"metrics: {len(text.splitlines())} exposition lines, e.g. {line}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=None, help="cap on cora's nodes (all: 2,708)")
    args = ap.parse_args()
    run(device=args.device, nodes=args.nodes)


if __name__ == "__main__":
    main()
