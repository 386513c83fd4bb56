"""Mesh test cases of the port: one gloo rank per shard, in processes of their own.

``run_ranks`` writes nothing but starts ``world`` processes of this file
(``python _torch_mesh_cases.py <rank> <world> <dir>``), each with one CPU
thread. Each rank joins a gloo group through a ``file://`` store in ``dir``
(no TCP port, so test files may run in parallel), builds the 1-D
``("shard",)`` ``DeviceMesh``, runs every case of ``dir/inputs.pt`` through
the port's mesh backend and saves what it got to ``dir/rank<k>.pt``. The
group's timeout and the parent's deadline end the ranks of a dead or
deadlocked collective: ``run_ranks`` kills every rank and raises, so a test
fails instead of hanging the suite.

``run_case`` runs one case on a mesh, or with ``mesh=None`` through the host
loop, which the tests compare bit for bit. Nothing here imports JAX or the
reference package: the ranks import only the port.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4


# --------------------------------------------------------------- the cases
def _splan(case, modes):
    from repro_torch.core.message_passing import compile_sharded_plans

    return compile_sharded_plans(case["graph"], case["engine_cfg"], partition=case["partition"],
                                 modes=modes)


def run_case(case, mesh):
    """Outputs of one case: a dict of arrays and numbers."""
    from repro_torch.distributed.graph_shard import ShardedAmpleEngine
    from repro_torch.models.gnn import api as gnn_api

    kind = case["kind"]
    overlap = case.get("overlap", False)
    if kind == "gnn":  # the arch's forward on its prepared graph
        cfg = case["cfg"]
        eng = ShardedAmpleEngine(case["graph"], _splan(case, (gnn_api.agg_mode(cfg),)),
                                 mesh=mesh, halo_overlap=overlap)
        y = gnn_api.gnn_apply(cfg, case["params"], eng, torch.from_numpy(case["x"]))
        return dict(y=y.numpy(), **eng.halo_stats)
    if kind == "coeff":  # a raw f32[E] runtime coefficient
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("runtime",)), mesh=mesh,
                                 halo_overlap=overlap)
        y = eng.aggregate(torch.from_numpy(case["x"]), mode="runtime",
                          edge_coeff=torch.from_numpy(case["coeff"]))
        return dict(y=y.numpy(), **eng.halo_stats)
    if kind == "train":  # the arch's loss under grad: the output, every gradient
        cfg = case["cfg"]
        eng = ShardedAmpleEngine(case["graph"], _splan(case, (gnn_api.agg_mode(cfg),)),
                                 mesh=mesh, halo_overlap=overlap)
        params = _tree_map(lambda t: t.detach().clone().requires_grad_(), case["params"])
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = gnn_api.gnn_apply(cfg, params, eng, x)
        return _grads(y, [x] + _leaves(params), case["r"], case.get("die_before_backward"))
    if kind == "train-coeff":  # a raw f32[E] runtime coefficient and the rows under grad
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("runtime",)), mesh=mesh,
                                 halo_overlap=overlap)
        x = torch.from_numpy(case["x"]).requires_grad_()
        coeff = torch.from_numpy(case["coeff"]).requires_grad_()
        y = eng.aggregate(x, mode="runtime", edge_coeff=coeff)
        return _grads(y, [x, coeff], case["r"])
    if kind == "train-scale":  # the int8 group's scale as a leaf: its gradient, and the rows'
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("sum",)), mesh=mesh,
                                 halo_overlap=overlap)
        from repro_torch.core.quantization import compute_scale_zp

        x = torch.from_numpy(case["x"]).requires_grad_()
        qp = compute_scale_zp(x.detach(), symmetric=True)
        scale = qp.scale.clone().requires_grad_()
        eng._activation_qp = lambda *a, **kw: type(qp)(scale, qp.zero_point)
        y = eng.aggregate(x, mode="sum")
        return _grads(y, [x, scale], case["r"])
    if kind == "front":
        return _front(case, mesh)
    if kind == "serve":  # GNNServeEngine: cold, warm (after a plan cache load)
        from repro_torch.serve.gnn_engine import GNNServeEngine

        srv = GNNServeEngine(case["cfg"], case["params"], num_shards=WORLD,
                             partitioner=case["partitioner"], halo_overlap=overlap, mesh=mesh,
                             device="cpu")
        loaded = srv.load_plan_cache(case["plan_dir"]) if case.get("plan_dir") else 0
        rs = [srv.infer(case["graph"], case["x"]) for _ in range(2)]
        return dict(y=[r.outputs for r in rs], cache_hit=[r.cache_hit for r in rs],
                    plan_ms=[r.plan_ms for r in rs], halo_bytes=[r.halo_bytes for r in rs],
                    num_shards=[r.num_shards for r in rs], loaded=loaded,
                    planner_calls=srv.stats["planner_calls"])
    raise ValueError(f"unknown case kind {kind!r}")


def _front(case, mesh):
    """A request stream through ``AsyncGNNEngine`` or a two-tenant
    ``TenantRouter`` (``case["front"]``) over a sharded GNNServeEngine, on a
    mesh or (``mesh`` None) the host loop: ``case["runs"]`` drains of the
    same stream (cold, then warm). On the mesh, rank ``case["late"]``
    submits from a thread, ``delay_s`` apart, while it drains; with
    ``case["stop"]`` it submits only the first ``stop`` requests (a stuck
    follower), and the rest after the drain. Each run: the windows served
    (node counts of their members), each request's output or error, the
    router's ``window_log``."""
    import threading

    from repro_torch.serve.async_gnn import AsyncGNNEngine
    from repro_torch.serve.gnn_engine import GNNServeEngine
    from repro_torch.serve.tenancy.router import TenantRouter

    srv = GNNServeEngine(case["cfg"], case["params"], num_shards=WORLD, partitioner="edges",
                         mesh=mesh, device="cpu")
    windows, infer_batch = [], srv.infer_batch

    def logged(requests):
        windows.append([r.graph.num_nodes for r in requests])
        return infer_batch(requests)

    srv.infer_batch = logged
    front = AsyncGNNEngine(srv, window=case["window"])
    if case["front"] == "router":
        front = TenantRouter(front)
        front.add_tenant("gold", weight=2.0, priority=1)
        front.add_tenant("batch", weight=1.0)
    rank = 0 if mesh is None else mesh.get_local_rank("shard")
    late = mesh is not None and rank == case.get("late")
    stop = case.get("stop") if late else None
    requests = case["requests"]

    def submit(items, tickets, delay=0.0):
        for i, (tenant, g, x) in items:
            time.sleep(delay)
            tickets[i] = (front.submit(tenant, g, x) if case["front"] == "router"
                          else front.submit(g, x))

    def outcome(t):
        return type(t.error).__name__ if t.error is not None else t.response.outputs

    runs = []
    for _ in range(case["runs"]):
        del windows[:]
        tickets = {}
        items = list(enumerate(requests))[:stop]
        if late:
            th = threading.Thread(target=submit, args=(items, tickets, case["delay_s"]))
            th.start()
        else:
            submit(items, tickets)
        if case.get("fault") == rank:
            time.sleep(3600)
        front.drain()
        if late:
            th.join()
        submit(list(enumerate(requests))[len(items):], tickets)  # a stuck rank's rest
        runs.append(dict(windows=list(windows),
                         results=[outcome(tickets[i]) for i in range(len(requests))],
                         done=[tickets[i].done for i in range(len(requests))],
                         window_log=list(getattr(front, "window_log", []))))
    return dict(runs=runs, stats=dict(front.stats))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    """The tensors of a params tree, keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _grads(y, inputs, r, die=False):
    """The output and the gradients of ``sum(y * r)`` (None: unused);
    ``die``: the process exits before the backward."""
    loss = (y * torch.from_numpy(r)).sum()
    if die:
        os._exit(3)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return dict(y=y.detach().numpy(), grads=[None if g is None else g.numpy() for g in grads])


# ------------------------------------------------------------- the parent
def run_ranks(directory: str, *, deadline_s: float = 120.0, world: int = WORLD):
    """Start the ranks on ``directory/inputs.pt``; return each rank's outputs.

    Raises if a rank exits non-zero (the others are killed at once) or the
    deadline passes (every rank is killed)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               directory], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    t_end = time.monotonic() + deadline_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} failed: {procs[bad[0]].communicate()[0]}")
            if time.monotonic() > t_end:
                raise TimeoutError(f"the ranks passed their {deadline_s:.0f} s deadline")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} failed: {procs[bad[0]].communicate()[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------- a rank
def rank_main(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    fault = spec.get("fault", {})
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=spec.get("timeout_s", 60)))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shard",))
    if fault.get(rank) == "die":
        raise SystemExit(3)
    if fault.get(rank) == "hang":
        time.sleep(3600)
    for c in spec["cases"]:  # a fault inside a case: rank k dies in backward, or hangs in a window
        if fault.get(rank) == "die-backward":
            c["die_before_backward"] = True
        if fault.get(rank) == "hang-window":
            c["fault"] = rank
    out = {c["name"]: run_case(c, mesh) for c in spec["cases"]}
    out["_rank"] = mesh.get_local_rank("shard")
    out["_backend"] = dist.get_backend(mesh.get_group("shard"))
    out["_foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
