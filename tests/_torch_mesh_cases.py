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
    out = {c["name"]: run_case(c, mesh) for c in spec["cases"]}
    out["_rank"] = mesh.get_local_rank("shard")
    out["_backend"] = dist.get_backend(mesh.get_group("shard"))
    out["_foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
