"""Serving launcher: one CLI over both serve engines, dispatched on family.

The reference's ``repro/launch/serve.py``, flag for flag, plus ``--device``
(``cuda`` by default, as ``launch/train.py``). Params and prompts are drawn
from explicit ``torch.Generator``\\ s (seed 0 and seed 1).

Token families: batched prefill + greedy decode through ``ServeEngine``.

    python -m repro_torch.launch.serve --arch smollm-360m --tokens 32

family="gnn": the plan-cached ``GNNServeEngine``; serves the same graph
twice or more to show cold-plan against cache-hit latency, then a batched
small-graph mix.

    python -m repro_torch.launch.serve --arch ample-gcn --requests 4

With ``--continuous-batching`` the small-graph stream also flows through the
event-driven ``AsyncGNNEngine``: requests are admitted into micro-batch
unions as they arrive, padded to size classes (``--node-bucket`` /
``--edge-bucket``), with the admission window set by ``--window``.

``--feature-budget-mb`` caps the device bytes granted to node features:
requests whose feature matrix exceeds the budget are served out of core,
bitwise the in-memory outputs.

    python -m repro_torch.launch.serve --arch ample-gcn --nodes 20000 --feature-budget-mb 1

``--tenants`` switches to the multi-tenant front (``serve/tenancy``): each
``name[:weight[:priority[:rate_rps]]]`` entry registers a tenant, and
admission is deficit-weighted round robin with priority classes.

    python -m repro_torch.launch.serve --arch ample-gcn --tenants gold:4:1,batch:1:0 --slo-ms 100

``main(argv)`` returns what it served (for the tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import model_init
from repro_torch.serve.engine import ServeEngine

__all__ = ["main", "serve_lm", "serve_gnn", "serve_gnn_continuous", "serve_gnn_tenants"]


def _gen(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg, args) -> dict:
    dev = resolve_device(args.device)
    params = model_init(cfg, _gen(0, dev), device=dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.tokens, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=_gen(1, dev), device=dev)
    _sync(dev)
    t0 = time.time()
    out = eng.generate(prompts, max_new_tokens=args.tokens)
    _sync(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} new_tokens={args.tokens}")
    print(f"throughput: {args.batch * args.tokens / dt:.1f} tok/s "
          f"({dev.type}, {'reduced' if cfg.reduced else 'full'} cfg)")
    print("sample:", out[0, : args.prompt_len + 8].tolist())
    return {"tokens": out, "seconds": dt}


def _engine_kwargs(args) -> dict:
    return dict(device=args.device, generator=torch.Generator().manual_seed(0))


def serve_gnn(cfg, args) -> dict:
    from repro_torch.graphs import make_dataset
    from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine

    budget = int(args.feature_budget_mb * (1 << 20)) if args.feature_budget_mb > 0 else 0
    eng = GNNServeEngine(
        cfg,
        num_shards=args.num_shards,
        partitioner=args.partitioner or None,
        halo_overlap=True if args.halo_overlap else None,
        feature_budget_bytes=budget or None,
        stream_packing=True if args.stream_packing else None,
        stream_reorder=False if args.no_stream_reorder else None,
        **_engine_kwargs(args),
    )
    g = make_dataset(args.dataset, max_nodes=args.nodes, max_feature_dim=cfg.d_model, seed=0)
    x = g.features
    print(
        f"arch={cfg.name} graph={g.name} nodes={g.num_nodes} edges={g.num_edges} "
        f"shards={args.num_shards}"
        + (f" feature_budget={budget / (1 << 20):.2f}MB "
           f"(features {x.nbytes / (1 << 20):.2f}MB)" if budget else "")
    )

    # Repeat traffic on one graph: the second request skips the planner
    # (per shard, when the engine is sharded).
    responses = []
    for i in range(max(args.requests, 2)):
        r = eng.infer(g, x)
        responses.append(r)
        tag = "hit " if r.cache_hit else "cold"
        stream = (
            f"  streamed {r.bytes_streamed >> 10}KB hit={r.chunk_hit_rate:.2f}"
            f" overlap={r.prefetch_overlap:.2f} stall={r.stall_ms:.1f}ms"
            if r.streamed else ""
        )
        halo = (
            f"  halo {r.halo_bytes >> 10}KB {r.halo_ms:.1f}ms overlap={r.halo_overlap:.2f}"
            if r.halo_bytes else ""
        )
        print(
            f"request {i}: plan[{tag}] {r.plan_ms:7.1f} ms  run {r.run_ms:6.1f} ms  "
            f"out {r.outputs.shape}  shards={r.num_shards}{stream}{halo}"
        )

    if eng.sharded:
        # Work balance and halo-exchange volume across the shards.
        rep = eng.shard_report()
        print(f"shard balance: partitioner={rep['partitioner']} "
              f"edge_balance={rep['edge_balance']:.3f} edges_per_shard={rep['edges_per_shard']}")
        print(f"halo exchange: total={rep['halo_total']} rows/layer "
              f"per_shard={rep['halo_per_shard']}")

    # A batch of independent small graphs in one padded device call.
    small = [
        make_dataset(args.dataset, max_nodes=args.nodes // 4, max_feature_dim=cfg.d_model, seed=s)
        for s in range(1, 4)
    ]
    reqs = [GNNRequest(graph=s, features=s.features) for s in small]
    t0 = time.time()
    outs = eng.infer_batch(reqs)
    dt = (time.time() - t0) * 1e3
    n = sum(s.num_nodes for s in small)
    print(f"batched {len(reqs)} graphs ({n} nodes) in one call: {dt:.1f} ms")

    result = {"engine": eng, "graph": g, "responses": responses, "batch": outs}
    if args.continuous_batching:
        result["continuous"] = serve_gnn_continuous(cfg, args)
    print("cache:", eng.cache_info())
    return result


def serve_gnn_continuous(cfg, args) -> dict:
    """Event-driven continuous batching over a varying small-graph mix."""
    from repro_torch.graphs import make_dataset
    from repro_torch.serve.async_gnn import AsyncGNNEngine

    node_bucket = cfg.gnn_union_node_bucket if args.node_bucket < 0 else args.node_bucket
    edge_bucket = cfg.gnn_union_edge_bucket if args.edge_bucket < 0 else args.edge_bucket
    if args.num_shards > 1:
        # Padded size classes apply to the single-device path only: sharded
        # unions are planned exactly (see GNNServeEngine.padded_unions).
        node_bucket = edge_bucket = 0
    elif args.node_bucket < 0 and node_bucket == 0:
        # Reduced configs ship without buckets; size one to this workload so
        # the padded classes show (pass --node-bucket 0 for exact shapes).
        node_bucket = max(args.nodes // 2, 64)
        edge_bucket = 4 * node_bucket if edge_bucket == 0 else edge_bucket
    async_eng = AsyncGNNEngine(
        cfg,
        window=args.window or None,
        window_timeout_ms=args.window_timeout_ms if args.window_timeout_ms >= 0 else None,
        num_shards=args.num_shards,
        union_node_bucket=node_bucket,
        union_edge_bucket=edge_bucket,
        **_engine_kwargs(args),
    )
    pool = [
        make_dataset(args.dataset, max_nodes=args.nodes // 4, max_feature_dim=cfg.d_model, seed=s)
        for s in range(1, 7)
    ]
    # Offered load: 4 varying mixes of the pool arrive back to back; the
    # admission loop recomposes micro-batches while member plans stay cached.
    t0 = time.time()
    tickets = []
    for wave in range(4):
        for g in pool[wave % 3 :: 2]:
            tickets.append(async_eng.submit(g, g.features))
        async_eng.step()  # slots recycle: completed members return now
    async_eng.drain()
    dt = time.time() - t0
    info = async_eng.cache_info()
    lookups = info["member_hits"] + info["member_misses"]
    mode = (
        f"node_bucket={node_bucket}, edge_bucket={edge_bucket}"
        if async_eng.engine.padded_unions
        else ("sharded exact unions" if async_eng.engine.sharded else "exact unions")
    )
    print(
        f"continuous batching: {info['completed']} requests in {info['steps']} micro-batches, "
        f"{info['completed'] / dt:.1f} req/s (window={async_eng.window}, {mode})"
    )
    econ = f"planner_calls={info['planner_calls']}"
    if async_eng.window_timeout_ms > 0:
        econ += (f", held_windows={info['held_windows']}, "
                 f"deadline_closes={info['deadline_closes']}")
    if async_eng.engine.padded_unions:
        econ = (
            f"member-plan hit rate {info['member_hits'] / max(lookups, 1):.2f}, "
            f"size-class hits {info['class_hits']}"
            f"/{info['class_hits'] + info['class_misses']}, " + econ
        )
    print(f"plan economics: {econ}")
    return {"engine": async_eng, "tickets": tickets, "info": info}


def _parse_tenants(spec: str):
    """Parse ``name[:weight[:priority[:rate_rps]]]`` entries, comma-separated."""
    tenants = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        if len(parts) > 4:
            raise SystemExit(
                f"--tenants entry {entry!r}: want name[:weight[:priority[:rate_rps]]]")
        name = parts[0]
        weight = float(parts[1]) if len(parts) > 1 else 1.0
        priority = int(parts[2]) if len(parts) > 2 else 0
        rate = float(parts[3]) if len(parts) > 3 else 0.0
        tenants.append((name, weight, priority, rate))
    if not tenants:
        raise SystemExit("--tenants: no tenant entries parsed")
    return tenants


def serve_gnn_tenants(cfg, args) -> dict:
    """Multi-tenant serving front: DWRR admission and per-tenant telemetry."""
    from repro_torch.graphs import make_dataset
    from repro_torch.serve.tenancy import RateLimitExceeded, TenantRouter

    tenants = _parse_tenants(args.tenants)
    top_priority = max(p for _, _, p, _ in tenants)
    router = TenantRouter(
        cfg, window=args.window or None, hold_ms=max(args.window_timeout_ms, 0.0),
        **_engine_kwargs(args),
    )
    for name, weight, priority, rate in tenants:
        router.add_tenant(
            name, weight=weight, priority=priority, rate_rps=rate,
            # The SLO is scored for the top class(es): the tenants the
            # priority and preemption knobs exist to protect.
            slo_ms=args.slo_ms if priority == top_priority else 0.0,
        )
    print(
        f"arch={cfg.name} tenants="
        + ", ".join(f"{n}(w={w:g},prio={p}" + (f",rate={r:g}rps" if r else "") + ")"
                    for n, w, p, r in tenants)
        + f" window={router.window} slo_ms={args.slo_ms:g}"
    )
    pool = [
        make_dataset(args.dataset, max_nodes=args.nodes // 4, max_feature_dim=cfg.d_model, seed=s)
        for s in range(1, 7)
    ]
    # Offered load: round-robin waves across tenants; lower-priority tenants
    # flood (the whole pool a wave), higher classes trickle one request.
    rejected = 0
    t0 = time.time()
    for wave in range(4):
        for name, _w, priority, _r in tenants:
            picks = [pool[wave % len(pool)]] if priority == top_priority else pool
            for g in picks:
                try:
                    router.submit(name, g, g.features)
                except RateLimitExceeded:
                    rejected += 1
        router.step()
    router.drain()
    dt = time.time() - t0
    stats = router.stats
    print(
        f"served {stats['completed']} requests in {stats['windows']} windows "
        f"({stats['completed'] / dt:.1f} req/s); rejected={rejected} "
        f"preempted={stats['preempted']}"
    )
    snap = router.snapshot()["tenants"]
    total_nodes = max(sum(s["completed_nodes"] for s in snap.values()), 1)
    for name in sorted(snap):
        s = snap[name]
        lat, qw = s["latency_ms"], s["queue_wait_ms"]
        slo = (f" slo_hit={s['slo_hit_rate']:.2f}"
               if s["slo_hits"] + s["slo_violations"] else "")
        print(
            f"  {name:>10}: done={s['completed']:3d} "
            f"p50={lat['p50']:7.1f}ms p99={lat['p99']:7.1f}ms "
            f"queue_p99={qw['p99']:7.1f}ms "
            f"node_share={s['completed_nodes'] / total_nodes:.2f}"
            f"{slo} rejected={s['rejected']} preempted={s['preempted']}"
        )
    return {"router": router, "rejected": rejected}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # token-family knobs
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    # gnn-family knobs
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--nodes", type=int, default=800)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--num-shards", type=int, default=1,
                    help="partition the served graph into this many edge-balanced shards "
                         "(1 = single-plan path)")
    ap.add_argument("--partitioner", default="",
                    help="sharded-path partitioner: 'edges' (contiguous edge-balanced "
                         "ranges) or 'mincut' (halo-minimizing multilevel; params inline, "
                         "e.g. 'mincut(seed=1)'). Empty = cfg.gnn_partitioner")
    ap.add_argument("--halo-overlap", action="store_true",
                    help="sharded path: overlap each shard's halo exchange with its "
                         "interior-tile aggregation (outputs stay bitwise-identical; "
                         "responses report halo_overlap)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="serve the small-graph stream through the event-driven "
                         "AsyncGNNEngine admission queue")
    ap.add_argument("--window", type=int, default=0,
                    help="continuous-batching admission window (0 = cfg.gnn_batch_window)")
    ap.add_argument("--window-timeout-ms", type=float, default=-1,
                    help="latency-aware window close: hold a partially filled admission "
                         "window open until its oldest request has waited this long "
                         "(-1 = cfg.gnn_window_timeout_ms, 0 = admit immediately)")
    ap.add_argument("--node-bucket", type=int, default=-1,
                    help="pad union batches to this node size class "
                         "(-1 = cfg.gnn_union_node_bucket, 0 = exact shapes)")
    ap.add_argument("--edge-bucket", type=int, default=-1,
                    help="pad union tile stacks to this edge size class "
                         "(-1 = cfg.gnn_union_edge_bucket, 0 = exact shapes)")
    ap.add_argument("--tenants", default="",
                    help="multi-tenant serving front: comma-separated "
                         "name[:weight[:priority[:rate_rps]]] specs, e.g. gold:4:1,batch:1:0; "
                         "admission becomes deficit-weighted round robin across per-tenant "
                         "queues with priority classes (empty = single-tenant FIFO paths)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="latency SLO target scored for the highest-priority tenants in "
                         "--tenants mode (telemetry reports the hit rate; nothing is "
                         "enforced)")
    ap.add_argument("--feature-budget-mb", type=float, default=0,
                    help="out-of-core serving: device feature budget in MB; requests whose "
                         "feature matrix exceeds it stream chunk-wise from the host feature "
                         "store (0 = cfg default / off). Outputs are bitwise the in-memory "
                         "path's.")
    ap.add_argument("--stream-packing", action="store_true",
                    help="streamed path: rebuild tile membership around source chunks "
                         "(scheduler.pack_tiles_by_chunk) instead of only reordering runs")
    ap.add_argument("--no-stream-reorder", action="store_true",
                    help="streamed path: keep plan tile order (the control arm for the "
                         "locality reorder pass)")
    ap.add_argument("--trace-out", default="",
                    help="record request-lifecycle spans and write a Chrome-trace-event "
                         "JSON here (load it in Perfetto or chrome://tracing); empty = "
                         "tracing disabled, the zero-overhead default")
    ap.add_argument("--metrics-dump", default="",
                    help="after serving, dump the unified metrics registry in Prometheus "
                         "text exposition format to this path ('-' = stdout)")
    args = ap.parse_args(argv)

    from repro_torch.observe import metrics as ometrics, trace as otrace

    if args.trace_out:
        otrace.enable()
    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.family == "gnn" and args.tenants:
        result = serve_gnn_tenants(cfg, args)
    elif cfg.family == "gnn":
        result = serve_gnn(cfg, args)
    else:
        result = serve_lm(cfg, args)
    if args.trace_out:
        rec = otrace.get_recorder()
        rec.export(args.trace_out)
        print(f"trace: {len(rec.spans())} spans -> {args.trace_out} "
              f"(dropped={rec.dropped}); open in https://ui.perfetto.dev")
        otrace.disable()
    if args.metrics_dump:
        text = ometrics.get_registry().prometheus_text()
        if args.metrics_dump == "-":
            print(text, end="")
        else:
            with open(args.metrics_dump, "w") as f:
                f.write(text)
            print(f"metrics: registry dump -> {args.metrics_dump}")
    return result


if __name__ == "__main__":
    main()
