"""The port's mesh backend of the sharded GNN engine, in 4 gloo ranks on the CPU.

One module fixture writes every case's inputs, starts 4 rank processes once
(``_torch_mesh_cases.run_ranks``: one CPU thread each, a ``file://`` store,
a group timeout and a deadline) and reads back what each rank returned; the
parametrised tests compare. Citeseer-sized graphs and REDUCED widths, as the
reference's mesh tests (``tests/test_distributed.py:133-244``): gcn, gin and
sage (mixed) under ``edges`` and ``mincut``, with and without
``halo_overlap``; a raw f32[E] runtime coefficient and GAT with 2 heads. The
mesh output must be bitwise the port's host loop on every rank; the host
loop is held against the reference's at ``tests/test_torch_sharded.py``'s
tolerances. The serving engine on a mesh: warm == cold, and a plan cache a
host-loop engine saved loads as a hit. Training on a mesh: every gradient
(the params, the input, a runtime coefficient, the int8 scale) bitwise the
host loop's (which ``tests/test_torch_train_sharded.py`` holds against the
reference's ``jax.grad``) and the same on every rank. The fronts on a mesh:
rank 0's windows on every rank, one rank's submissions late, bitwise the
same fronts over the host loop, each tenant's order kept, warm == cold, and
a stuck follower failing its windows on every rank. The refusals need no
process group.
"""
from __future__ import annotations

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from _torch_parity import assert_mixed_close, cfg_pair, params_pair
from repro.core import message_passing as ref_mp
from repro.distributed import graph_shard as ref_shard
from repro.graphs import datasets as ref_ds
from repro.graphs import partition as ref_part
from repro.models.gnn import api as ref_api
from repro_torch.core import message_passing as port_mp
from repro_torch.distributed.graph_shard import ShardedAmpleEngine, build_mesh_state
from repro_torch.graphs import datasets as port_ds
from repro_torch.graphs import partition as port_part
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.gnn_engine import GNNServeEngine

KINDS = ["edges", "mincut"]
ARCHS = ["gcn", "gin", "sage"]
GNN_KW = dict(d_model=20, d_ff=12, vocab_size=6, gnn_precision="mixed", gnn_edges_per_tile=64)
GAT_KW = dict(d_model=24, d_ff=16, vocab_size=8, gnn_precision="mixed", gnn_edges_per_tile=64,
              gnn_heads=2)


def _graphs(nodes, seed, dim):
    kw = dict(max_nodes=nodes, max_feature_dim=dim, seed=seed)
    return ref_ds.make_dataset("citeseer", **kw), port_ds.make_dataset("citeseer", **kw)


def _models():
    """name -> (reference cfg, port cfg, reference params, port params, raw graphs)."""
    out = {}
    for arch in ARCHS + ["gat"]:
        rcfg, pcfg = cfg_pair(arch, **(GAT_KW if arch == "gat" else GNN_KW))
        graphs = _graphs(150, 3, 24) if arch == "gat" else _graphs(180, 4, 20)
        out[arch] = (rcfg, pcfg, *params_pair(rcfg, pcfg, seed=0), graphs)
    return out


def _case_list(models, plan_dir):
    """Every case the ranks run (and the host loop runs in this process)."""
    out = []
    for arch in ARCHS + ["gat"]:
        _, pcfg, _, pp, (_, pg) = models[arch]
        prepared = port_api.prepare_graph(pcfg, pg)
        for kind in KINDS:
            part = port_part.make_partition(prepared, cases.WORLD, kind)
            base = dict(graph=prepared, engine_cfg=port_api.engine_config(pcfg), partition=part,
                        x=pg.features)
            r = np.random.default_rng(5).standard_normal(
                (prepared.num_nodes, pcfg.gnn_layer_dims[-1])).astype(np.float32)
            rx = np.random.default_rng(6).standard_normal(pg.features.shape).astype(np.float32)
            for overlap in (False, True):
                out.append(dict(base, name=f"gnn-{arch}-{kind}-{overlap}", kind="gnn", cfg=pcfg,
                                params=pp, overlap=overlap))
                # training runs unsplit: the host loop's overlap=False gradients hold both
                out.append(dict(base, name=f"train-{arch}-{kind}-{overlap}", kind="train",
                                cfg=pcfg, params=pp, overlap=overlap, r=r, host=not overlap))
            if arch == "gat":
                coeff = np.random.default_rng(0).standard_normal(prepared.num_edges).astype(
                    np.float32)
                for overlap in (False, True):
                    out.append(dict(base, name=f"coeff-{kind}-{overlap}", kind="coeff",
                                    coeff=coeff, overlap=overlap))
                out.append(dict(base, name=f"train-coeff-{kind}", kind="train-coeff",
                                coeff=coeff, r=rx))
            if arch == "gcn":
                out.append(dict(base, name=f"train-scale-{kind}", kind="train-scale", r=rx))
    for arch, overlap, warm in (("gcn", False, False), ("gcn", True, True),
                                ("gat", True, False)):
        _, pcfg, _, pp, (_, pg) = models[arch]
        out.append(dict(name=f"serve-{arch}-{overlap}-{warm}", kind="serve", cfg=pcfg, params=pp,
                        graph=pg, x=pg.features, partitioner="edges", overlap=overlap,
                        plan_dir=plan_dir if warm else None))
    _, pcfg, _, pp, _ = models["gcn"]
    front = dict(kind="front", cfg=pcfg, params=pp, requests=_front_requests(), window=2,
                 delay_s=0.05, late=LATE)
    out += [dict(front, name="front-async", front="async", runs=2),
            dict(front, name="front-router", front="router", runs=2),
            dict(front, name="front-stuck", front="async", stop=STOP, runs=1, host=False)]
    return out


LATE, STOP = 3, 3  # the rank whose submissions come late; a stuck rank submits this many


def _front_requests():
    """Six small graphs of distinct sizes, two tenants (gold every third)."""
    out = []
    for i, n in enumerate((40, 46, 52, 58, 64, 70)):
        g = port_ds.make_dataset("citeseer", max_nodes=n, max_feature_dim=GNN_KW["d_model"],
                                 seed=10 + i)
        out.append(("gold" if i % 3 == 0 else "batch", g, g.features))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(cases by name, each rank's outputs, the host loop's outputs)."""
    d = str(tmp_path_factory.mktemp("mesh"))
    models = _models()
    plan_dir = os.path.join(d, "plans")
    _, pcfg, _, pp, (_, pg) = models["gcn"]
    host_srv = GNNServeEngine(pcfg, pp, num_shards=cases.WORLD, partitioner="edges",
                              device="cpu")
    host_serve = host_srv.infer(pg, pg.features).outputs
    host_srv.save_plan_cache(plan_dir)
    case_list = _case_list(models, plan_dir)
    torch.save({"cases": case_list, "timeout_s": 60}, os.path.join(d, "inputs.pt"))
    ranks = cases.run_ranks(d, deadline_s=150.0)
    host = {c["name"]: cases.run_case(c, None) for c in case_list if c.get("host", True)}
    return {c["name"]: c for c in case_list}, ranks, host, models, host_serve


def _rank_outputs(ranks, name):
    outs = [r[name]["y"] for r in ranks]
    for other in outs[1:]:  # every rank returns the same bits
        assert np.array_equal(outs[0], other)
    return outs[0]


# ------------------------------------------------------------- the outputs
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + ["gat"])
def test_mesh_forward_is_bitwise_the_host_loop(mesh_run, arch, kind, overlap):
    _, ranks, host, _, _ = mesh_run
    name = f"gnn-{arch}-{kind}-{overlap}"
    y = _rank_outputs(ranks, name)
    want = host[name]
    assert y.dtype == np.float32 and y.shape == want["y"].shape and np.isfinite(y).all()
    assert np.array_equal(y, want["y"])
    for r in ranks:  # one exchange an aggregate, every shard's halo rows counted
        assert r[name]["halo_bytes"] > 0 and r[name]["halo_ms"] == 0.0
        assert r[name]["split_exchanges"] == (r[name]["halo_exchanges"] if overlap else 0.0)
    assert ranks[0][name]["halo_bytes"] == ranks[3][name]["halo_bytes"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_runtime_coefficient_is_bitwise_the_host_loop(mesh_run, kind, overlap):
    _, ranks, host, _, _ = mesh_run
    name = f"coeff-{kind}-{overlap}"
    assert np.array_equal(_rank_outputs(ranks, name), host[name]["y"])
    assert all(r[name]["halo_bytes"] > 0 and r[name]["halo_exchanges"] == 1.0 for r in ranks)
    # the reference's count: every shard's halo rows, f32, once
    c = mesh_run[0][name]
    splan = port_mp.compile_sharded_plans(c["graph"], c["engine_cfg"], partition=c["partition"],
                                          modes=("runtime",))
    assert ranks[0][name]["halo_bytes"] == splan.halo_total * 4 * c["x"].shape[1]


@pytest.mark.parametrize("arch,kind", [("gcn", "edges"), ("gat", "mincut")])
def test_port_host_loop_matches_the_reference(mesh_run, arch, kind):
    """The host loop the mesh is held to, against the reference's host loop
    on the same graph, partition and params (mixed tolerance): the static
    path under one partitioner, the runtime one under the other. The
    reference compiles ~15 s of XLA a case; ``tests/test_torch_sharded.py``
    holds every arch under both partitioners."""
    _, _, host, models, _ = mesh_run
    rcfg, _, rp, _, (rg, _) = models[arch]
    prepared = ref_api.prepare_graph(rcfg, rg)
    splan = ref_mp.compile_sharded_plans(
        prepared, ref_api.engine_config(rcfg),
        partition=ref_part.make_partition(prepared, cases.WORLD, kind),
        modes=(ref_api.agg_mode(rcfg),))
    want = np.asarray(ref_api.gnn_apply(rcfg, rp, ref_shard.ShardedAmpleEngine(prepared, splan),
                                        jnp.asarray(rg.features)))
    assert_mixed_close(host[f"gnn-{arch}-{kind}-False"]["y"], want)


def test_mesh_serving_warm_equals_cold_and_the_host_loop(mesh_run):
    _, ranks, _, _, host_serve = mesh_run
    for name in ("serve-gcn-False-False", "serve-gat-True-False"):
        for r in ranks:
            got = r[name]
            assert got["cache_hit"] == [False, True] and got["plan_ms"][1] == 0.0
            assert np.array_equal(got["y"][0], got["y"][1])
            assert got["num_shards"] == [4, 4] and got["halo_bytes"][0] > 0
        assert all(np.array_equal(r[name]["y"][0], ranks[0][name]["y"][0]) for r in ranks)
    assert np.array_equal(ranks[0]["serve-gcn-False-False"]["y"][0], host_serve)


def test_mesh_serving_loads_a_host_loop_plan_cache_as_a_hit(mesh_run):
    """A plan cache saved by a host-loop engine (edges, unsplit) loads into a
    mesh engine with the overlapped exchange: its first request is a hit,
    plans nothing, and is bitwise the host loop's output."""
    _, ranks, _, _, host_serve = mesh_run
    for r in ranks:
        got = r["serve-gcn-True-True"]
        assert got["loaded"] == 1 and got["planner_calls"] == 0
        assert got["cache_hit"] == [True, True] and got["plan_ms"] == [0.0, 0.0]
        assert all(np.array_equal(y, host_serve) for y in got["y"])


# ------------------------------------------------------------- training
def _same_grads(ranks, name, want):
    """Every rank's output and gradients bitwise ``want``'s (None where
    an input got none)."""
    for r in ranks:
        got = r[name]
        assert np.array_equal(got["y"], want["y"])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype and np.isfinite(g).all() and np.array_equal(g, w)
    assert any(w is not None and np.abs(w).max() > 0 for w in want["grads"])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + ["gat"])
def test_mesh_training_is_bitwise_the_host_loop(mesh_run, arch, kind, overlap):
    """The arch's loss under grad on a mesh: the input's and every
    parameter's gradient bitwise the host loop's on every rank (a mixed
    engine: the int8 group's scale gradient rides in the input's)."""
    _, ranks, host, _, _ = mesh_run
    _same_grads(ranks, f"train-{arch}-{kind}-{overlap}", host[f"train-{arch}-{kind}-False"])


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_runtime_coefficient_gradient_is_bitwise_the_host_loop(mesh_run, kind):
    """A raw f32[E] runtime coefficient that requires grad: its gradient
    (each shard's edges all-gathered into global edge order) and the
    rows'."""
    _, ranks, host, _, _ = mesh_run
    _same_grads(ranks, f"train-coeff-{kind}", host[f"train-coeff-{kind}"])


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_int8_scale_gradient_is_bitwise_the_host_loop(mesh_run, kind):
    """The int8 group's scale as a leaf: the shards' contributions
    all-gathered and summed in shard order, as the host loop sums them."""
    _, ranks, host, _, _ = mesh_run
    name = f"train-scale-{kind}"
    _same_grads(ranks, name, host[name])
    assert host[name]["grads"][1].shape == () and host[name]["grads"][1] != 0


# ------------------------------------------------------------- the fronts
def _same_runs(ranks, name, want):
    for r in ranks:
        for got, w in zip(r[name]["runs"], want["runs"]):
            assert got["windows"] == w["windows"] and got["window_log"] == w["window_log"]
            assert all(got["done"]) and len(got["results"]) == len(w["results"])
            for a, b in zip(got["results"], w["results"]):
                assert isinstance(a, np.ndarray) and np.array_equal(a, b)


@pytest.mark.parametrize("front", ["async", "router"])
def test_mesh_fronts_run_rank_0s_windows_bitwise_the_host_loop(mesh_run, front):
    """Rank 3's submissions arrive late, from a thread: every rank runs rank
    0's windows, bitwise the same front over the host loop (async is sync:
    the host loop's infer_batch of each window); a second drain of the stream
    (warm) is bitwise the first (cold)."""
    _, ranks, host, _, _ = mesh_run
    name = f"front-{front}"
    _same_runs(ranks, name, host[name])
    for r in ranks:
        cold, warm = r[name]["runs"]
        assert all(np.array_equal(a, b) for a, b in zip(cold["results"], warm["results"]))
    assert all(r[name]["stats"] == ranks[0][name]["stats"] for r in ranks[1:]
               if front == "router")


def test_mesh_router_keeps_each_tenants_order(mesh_run):
    _, ranks, _, _, _ = mesh_run
    log = ranks[0]["front-router"]["runs"][0]["window_log"]
    assert sum(len(w) for w in log) == 6 and log[0][0] == ("gold", 0)
    for tenant in ("gold", "batch"):
        seqs = [seq for w in log for t, seq in w if t == tenant]
        assert seqs == sorted(seqs)


def test_a_stuck_follower_fails_its_windows_on_every_rank(mesh_run):
    """Rank 3 submits only the first 3 requests before it drains: the
    windows holding the others fail on every rank after the follower's wait
    (a timeout there, another rank's failure elsewhere); the windows before
    them run. The missing requests, submitted after the drain, complete at
    once with the window's error."""
    _, ranks, _, _, _ = mesh_run
    for r in ranks:
        run = r["front-stuck"]["runs"][0]
        failed = "TimeoutError" if r["_rank"] == LATE else "RuntimeError"
        assert run["windows"] == [[40, 46]] and all(run["done"])
        assert all(isinstance(x, np.ndarray) for x in run["results"][:2])
        assert run["results"][2:] == [failed] * 4
        assert r["front-stuck"]["stats"]["window_failures"] == 2


def test_ranks_are_one_per_shard_over_gloo_and_import_only_the_port(mesh_run):
    _, ranks, _, _, _ = mesh_run
    assert [r["_rank"] for r in ranks] == list(range(cases.WORLD))
    assert all(r["_backend"] == "gloo" and r["_foreign"] == [] for r in ranks)


# ------------------------------------------------------------ no hang
@pytest.mark.parametrize("fault", ["die", "hang", "die-backward", "hang-window"])
def test_a_dead_or_stuck_rank_fails_within_the_deadline(tmp_path, fault):
    """Rank 2 exits, or sleeps past every collective, before a request,
    between a training step's forward and backward ("die-backward": the
    others wait in the backward's all-gathers), or before it follows rank
    0's window ("hang-window": the others wait in the window's broadcast).
    ``run_ranks`` kills them all and raises."""
    pcfg, pp = (cfg_pair("gcn", **GNN_KW)[1],
                params_pair(*cfg_pair("gcn", **GNN_KW), seed=0)[1])
    _, pg = _graphs(60, 1, 20)
    prepared = port_api.prepare_graph(pcfg, pg)
    base = dict(graph=prepared, engine_cfg=port_api.engine_config(pcfg),
                partition=port_part.make_partition(prepared, cases.WORLD, "edges"), x=pg.features)
    case = {
        "die-backward": dict(base, name="train", kind="train", cfg=pcfg, params=pp,
                             r=np.ones((prepared.num_nodes, pcfg.gnn_layer_dims[-1]), np.float32)),
        "hang-window": dict(name="front", kind="front", cfg=pcfg, params=pp, front="async",
                            requests=[("gold", pg, pg.features)] * 2, window=2, runs=1),
    }.get(fault, dict(base, name="gnn", kind="coeff", coeff=np.ones(prepared.num_edges, np.float32)))
    torch.save({"cases": [case], "timeout_s": 2, "fault": {2: fault}},
               os.path.join(tmp_path, "inputs.pt"))
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        cases.run_ranks(str(tmp_path), deadline_s=20.0)
    assert time.monotonic() - t0 < 30.0


# ------------------------------------------------------------ the state
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_state_places_every_halo_and_owned_row(kind):
    _, pg = _graphs(180, 4, 20)
    part = port_part.make_partition(pg, cases.WORLD, kind)
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          partition=part, modes=("sum",))
    ms = build_mesh_state(splan)
    assert ms.p_max == max(sp.num_owned for sp in splan.shards)
    assert ms.h_max == max(sp.halo_size for sp in splan.shards)
    stacked = ms.pad_gather.reshape(-1)  # the global row of each stacked row
    for k, sp in enumerate(splan.shards):
        assert np.array_equal(ms.pad_gather[k, : sp.num_owned], sp.shard.owned)
        assert np.array_equal(stacked[ms.halo_rows(k, sp.halo_size)], sp.shard.halo)
    assert np.array_equal(stacked[ms.out_idx], np.arange(pg.num_nodes))


# ------------------------------------------------------------ refusals
class _Mesh:
    """What the engine reads of a ``DeviceMesh`` before any collective."""

    def __init__(self, names=("shard",), size=4, device_type="cpu"):
        self.mesh_dim_names, self._size, self.device_type = names, size, device_type

    def size(self):
        return self._size


@pytest.fixture(scope="module")
def gcn_small():
    _, pcfg = cfg_pair("gcn", **GNN_KW)
    _, pg = _graphs(120, 2, 20)
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          num_shards=4, modes=("sum", "runtime"))
    return pcfg, pg, splan


@pytest.mark.parametrize("make", [
    lambda pcfg, pg, splan: ShardedAmpleEngine(pg, splan, mesh=_Mesh(names=("x",))),
    lambda pcfg, pg, splan: port_api.make_engine(pcfg, pg, num_shards=4, mesh=_Mesh(names=None)),
], ids=["engine", "make_engine"])
def test_mesh_needs_one_shard_dimension(gcn_small, make):
    with pytest.raises(ValueError, match=r"mesh axes must be \('shard',\)"):
        make(*gcn_small)


def test_mesh_needs_one_rank_per_shard(gcn_small):
    pcfg, pg, splan = gcn_small
    with pytest.raises(ValueError, match="mesh has 2 devices but the plan has 4 shards"):
        ShardedAmpleEngine(pg, splan, mesh=_Mesh(size=2))
    with pytest.raises(ValueError, match="num_shards=4; pass --num-shards 3"):
        GNNServeEngine(pcfg, num_shards=4, mesh=_Mesh(size=3), device="cpu")


def test_mesh_refuses_rows_on_another_device(gcn_small):
    _, pg, splan = gcn_small
    eng = ShardedAmpleEngine(pg, splan, mesh=_Mesh(device_type="cuda"))
    with torch.no_grad(), pytest.raises(ValueError, match="mesh holds 'cuda' devices"):
        eng.aggregate(torch.randn(pg.num_nodes, 3), mode="sum")


