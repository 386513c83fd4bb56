"""Plan persistence in the port: round trips, memory maps, reference files.

``checkpoint/plan_store.py`` keeps the reference's file format, so a plan
either package wrote loads in the other with bitwise arrays; a restarted
``GNNServeEngine`` warmed from disk serves its first request as a cache hit,
bitwise the original engine's output.
"""
from __future__ import annotations

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cfg_pair, params_pair
from repro.checkpoint import plan_store as ref_store
from repro.core import message_passing as ref_mp
from repro.distributed.graph_shard import ShardedAmpleEngine as RefShardedEngine
from repro.graphs import datasets as ref_ds
from repro.graphs import partition as ref_part
from repro_torch.checkpoint import plan_store
from repro_torch.checkpoint.plan_store import _PLAN_ARRAYS, load_plan, save_plan
from repro_torch.core.message_passing import EngineConfig, compile_plans, compile_sharded_plans
from repro_torch.distributed.graph_shard import ShardedAmpleEngine
from repro_torch.graphs import datasets as port_ds
from repro_torch.graphs.partition import make_partition
from repro_torch.serve.gnn_engine import GNNServeEngine


@pytest.fixture(scope="module")
def graphs():
    kw = dict(max_nodes=160, max_feature_dim=20, seed=2)
    return ref_ds.make_dataset("cora", **kw), port_ds.make_dataset("cora", **kw)


def _same_plan(a, b):
    """Two ExecutionPlans (either package) with bitwise tags and tiles."""
    assert (a.fingerprint, a.graph_fp, a.num_nodes, a.num_edges) == (
        b.fingerprint, b.graph_fp, b.num_nodes, b.num_edges)
    np.testing.assert_array_equal(np.asarray(a.precision_tags), np.asarray(b.precision_tags))
    assert sorted(a.mode_plans) == sorted(b.mode_plans)
    for mode, tags in a.mode_plans.items():
        assert sorted(tags) == sorted(b.mode_plans[mode])
        for tag, p in tags.items():
            q = b.mode_plans[mode][tag]
            for name in _PLAN_ARRAYS:
                x, y = np.asarray(getattr(p, name)), np.asarray(getattr(q, name))
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            for name in ("num_nodes", "edges_per_tile", "segments_per_tile", "total_edges"):
                assert getattr(p, name) == getattr(q, name)


def _same_sharded(a, b):
    assert (a.fingerprint, a.partition_fp, a.partition.kind) == (
        b.fingerprint, b.partition_fp, b.partition.kind)
    np.testing.assert_array_equal(a.partition.starts, b.partition.starts)
    assert (a.partition.order is None) == (b.partition.order is None)
    if a.partition.order is not None:
        np.testing.assert_array_equal(a.partition.order, b.partition.order)
    for s, t in zip(a.shards, b.shards, strict=True):
        assert s.fingerprint == t.fingerprint and s.shard.edge_range == t.shard.edge_range
        for name in ("halo", "local_ids"):
            np.testing.assert_array_equal(getattr(s.shard, name), getattr(t.shard, name))
        if s.shard.edge_idx is not None:
            np.testing.assert_array_equal(s.shard.edge_idx, t.shard.edge_idx)
        _same_plan(s.plan, t.plan)


def test_unsharded_round_trip(graphs, tmp_path):
    _, pg = graphs
    cfg = EngineConfig(edges_per_tile=64)
    plan = compile_plans(pg, cfg, modes=("gcn", "sum"))
    path = save_plan(str(tmp_path / "p.npz"), plan, graph=pg, extra={"k": "v"})
    rec = load_plan(path)
    assert rec.plan == plan and rec.plan.cfg == cfg and rec.extra == {"k": "v"}
    np.testing.assert_array_equal(rec.graph.indptr, pg.indptr)
    np.testing.assert_array_equal(rec.graph.indices, pg.indices)
    _same_plan(rec.plan, plan)
    with zipfile.ZipFile(path) as zf:  # pickle-free: plain .npy members
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
    np.load(path, allow_pickle=False).close()


@pytest.mark.parametrize("kind", ["edges", "mincut(seed=4)"])
def test_sharded_round_trip_executes_bitwise(graphs, tmp_path, kind):
    """partition_kind, order and edge_idx survive; the loaded plan serves
    the original's output bit for bit, split halo schedule included."""
    _, pg = graphs
    splan = compile_sharded_plans(pg, EngineConfig(edges_per_tile=64),
                                  partition=make_partition(pg, 3, kind), modes=("sum",))
    rec = load_plan(save_plan(str(tmp_path / "s.npz"), splan, graph=pg))
    assert rec.plan == splan
    _same_sharded(rec.plan, splan)
    x = torch.from_numpy(pg.features)
    for overlap in (False, True):
        a = ShardedAmpleEngine(pg, splan, halo_overlap=overlap).aggregate(x, mode="sum")
        b = ShardedAmpleEngine(rec.graph, rec.plan, halo_overlap=overlap).aggregate(x, mode="sum")
        assert torch.equal(a, b)


def test_mmap_round_trip_is_read_only(graphs, tmp_path):
    _, pg = graphs
    plan = compile_plans(pg, EngineConfig(edges_per_tile=64), modes=("gcn",))
    path = save_plan(str(tmp_path / "m.npz"), plan, graph=pg)
    rec = load_plan(path, mmap_mode="r")
    assert rec.plan == plan
    for tags in rec.plan.mode_plans.values():
        for p in tags.values():
            for name in _PLAN_ARRAYS:
                arr = getattr(p, name)
                assert not arr.flags.owndata and not arr.flags.writeable  # a view of the map
                with pytest.raises(ValueError):
                    arr[...] = 0
    _same_plan(load_plan(path, mmap_mode="r").plan, plan)
    splan = compile_sharded_plans(pg, EngineConfig(edges_per_tile=64), num_shards=2,
                                  partitioner="mincut", modes=("sum",))
    srec = load_plan(save_plan(str(tmp_path / "ms.npz"), splan, graph=pg), mmap_mode="r")
    _same_sharded(srec.plan, splan)
    x = torch.from_numpy(pg.features)
    assert torch.equal(ShardedAmpleEngine(pg, splan).aggregate(x, mode="sum"),
                       ShardedAmpleEngine(srec.graph, srec.plan).aggregate(x, mode="sum"))
    with pytest.raises(ValueError, match="mmap_mode"):
        load_plan(path, mmap_mode="r+")


@pytest.mark.parametrize("kind", [None, "edges", "mincut"])
def test_reference_files_load_bitwise(graphs, tmp_path, kind):
    """A file the reference wrote (its header carries ``use_kernel``) loads
    in the port with bitwise arrays, and the other way round; the loaded
    sharded plan aggregates as the reference's does."""
    rg, pg = graphs
    rcfg = ref_mp.EngineConfig(edges_per_tile=64, use_kernel=False)
    if kind is None:
        rplan = ref_mp.compile_plans(rg, rcfg, modes=("gcn", "runtime"))
    else:
        rplan = ref_mp.compile_sharded_plans(rg, rcfg, partition=ref_part.make_partition(
            rg, 3, kind), modes=("gcn",))
    path = ref_store.save_plan(str(tmp_path / "ref.npz"), rplan, graph=rg, extra={"k": 1})
    rec = load_plan(path)
    assert rec.extra == {"k": 1} and rec.plan.cfg == EngineConfig(edges_per_tile=64)
    np.testing.assert_array_equal(rec.graph.indices, rg.indices)
    (_same_plan if kind is None else _same_sharded)(rec.plan, rplan)
    back = ref_store.load_plan(save_plan(str(tmp_path / "port.npz"), rec.plan, graph=rec.graph))
    (_same_plan if kind is None else _same_sharded)(back.plan, rplan)
    if kind is not None:
        xr = jnp.asarray(rg.features)
        want = np.asarray(RefShardedEngine(rg, rplan).aggregate(xr, mode="gcn"))
        got = ShardedAmpleEngine(rec.graph, rec.plan).aggregate(
            torch.from_numpy(pg.features), mode="gcn")
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_unknown_engine_config_fields_are_refused(graphs, tmp_path):
    _, pg = graphs
    path = save_plan(str(tmp_path / "p.npz"), compile_plans(pg, EngineConfig(), modes=("sum",)))
    with np.load(path, allow_pickle=False) as z:
        arrays = dict(z)
    header = json.loads(arrays["header"].tobytes().decode("utf-8"))
    header["cfg"]["tile_order"] = "hilbert"
    arrays["header"] = np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="tile_order"):
        load_plan(bad)
    assert plan_store._DROPPED_CFG_FIELDS == ("use_kernel",)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_serve_engine_warm_start_from_disk(graphs, tmp_path, num_shards):
    """A restarted engine warms its cache from disk: its first request is a
    cache hit with plan_ms 0.0, bitwise the original engine's output."""
    _, pg = graphs
    rcfg, pcfg = cfg_pair("gcn", d_model=20, d_ff=12, vocab_size=6, gnn_edges_per_tile=64)
    _, pp = params_pair(rcfg, pcfg, seed=0)
    a = GNNServeEngine(pcfg, pp, num_shards=num_shards, partitioner="mincut", device="cpu")
    cold = a.infer(pg, pg.features)
    assert not cold.cache_hit
    assert len(a.save_plan_cache(str(tmp_path))) == 1
    b = GNNServeEngine(pcfg, pp, num_shards=num_shards, partitioner="mincut", device="cpu")
    assert b.load_plan_cache(str(tmp_path)) == 1
    assert b.stats["warm_loads"] == 1
    warm = b.infer(pg, pg.features)
    assert warm.cache_hit and warm.plan_ms == 0.0 and warm.num_shards == num_shards
    assert b.stats["planner_calls"] == 0
    np.testing.assert_array_equal(cold.outputs, warm.outputs)
    assert GNNServeEngine(pcfg, pp, device="cpu").load_plan_cache(str(tmp_path / "none")) == 0
