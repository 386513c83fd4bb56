"""Sharded GNN serving in the port against the reference's sharded engine.

The same cora-sized graph (160 nodes, 20 features, 64-lane tiles, as in
``tests/test_sharded_engine.py``) and the same parameters go through the
reference's ``ShardedAmpleEngine`` and the port's, on the CPU (the port runs
its kernels' plain versions). Mixed-precision outputs are held at the
cross-implementation tolerance (``tests/test_gnn_models.py:66-80``); what
the port must reproduce exactly (the single-plan path at one shard, warm
requests, the overlapped halo schedule) is held bitwise.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_mixed_close, cfg_pair, params_pair
from repro.core import message_passing as ref_mp
from repro.core.quantization import compute_scale_zp as ref_scale_zp
from repro.distributed import graph_shard as ref_shard
from repro.graphs import datasets as ref_ds
from repro.graphs import partition as ref_part
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefEngine
from repro_torch.core import message_passing as port_mp
from repro_torch.core.quantization import compute_scale_zp
from repro_torch.distributed.graph_shard import ShardedAmpleEngine, sharded_aggregate
from repro_torch.graphs import datasets as port_ds
from repro_torch.graphs import partition as port_part
from repro_torch.models.api import model_forward
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.async_gnn import AsyncGNNEngine
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine
from repro_torch.serve.tenancy.router import TenantRouter

ARCHS = ["gcn", "gin", "sage", "gat"]


def _cfgs(arch, precision="mixed"):
    return cfg_pair(arch, d_model=20, d_ff=12, vocab_size=6, gnn_precision=precision,
                    gnn_edges_per_tile=64)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(max_nodes=160, max_feature_dim=20, seed=2)
    return ref_ds.make_dataset("cora", **kw), port_ds.make_dataset("cora", **kw)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference params, port params)."""
    out = {}
    for arch in ARCHS:
        rcfg, pcfg = _cfgs(arch)
        out[arch] = (rcfg, pcfg, *params_pair(rcfg, pcfg, seed=0))
    return out


@pytest.fixture(scope="module")
def ref_outputs(graphs, models):
    """(arch, num_shards, partitioner) -> the reference's outputs (computed once)."""
    rg, _ = graphs
    cache = {}

    def get(arch, k, partitioner="edges"):
        key = (arch, k, partitioner)
        if key not in cache:
            rcfg, _, rp, _ = models[arch]
            eng = RefEngine(rcfg, rp, num_shards=k, partitioner=partitioner)
            cache[key] = eng.infer(rg, rg.features).outputs
        return cache[key]

    return get


def _port(models, arch, **kw):
    _, pcfg, _, pp = models[arch]
    return GNNServeEngine(pcfg, pp, device="cpu", **kw)


# ------------------------------------------------- serving against the reference
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_reference_and_unsharded(graphs, models, ref_outputs, arch, k):
    _, pg = graphs
    r = _port(models, arch, num_shards=k).infer(pg, pg.features)
    assert r.num_shards == k
    assert r.outputs.shape == (pg.num_nodes, 6) and np.isfinite(r.outputs).all()
    assert_mixed_close(r.outputs, ref_outputs(arch, k))
    unsharded = _port(models, arch).infer(pg, pg.features)
    assert_mixed_close(r.outputs, unsharded.outputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_mincut_serving_matches_reference_and_unsharded(graphs, models, ref_outputs, arch):
    _, pg = graphs
    eng = _port(models, arch, num_shards=4, partitioner="mincut")
    r = eng.infer(pg, pg.features)
    assert r.num_shards == 4
    assert_mixed_close(r.outputs, ref_outputs(arch, 4, "mincut"))
    assert_mixed_close(r.outputs, _port(models, arch).infer(pg, pg.features).outputs)
    rep = eng.shard_report()
    assert rep["partitioner"].startswith("mincut(") and rep["num_shards"] == 4
    assert sum(rep["owned_per_shard"]) == pg.num_nodes


@pytest.mark.parametrize("mode", ["gcn", "sum"])
@pytest.mark.parametrize("kind", ["edges", "mincut"])
def test_sharded_aggregate_matches_reference(graphs, mode, kind):
    """The sharded AGE at one global scale: within the f32 tolerance of the
    reference's host loop, for contiguous and permuted partitions."""
    rg, pg = graphs
    rs = ref_mp.compile_sharded_plans(rg, ref_mp.EngineConfig(edges_per_tile=64),
                                      partition=ref_part.make_partition(rg, 3, kind),
                                      modes=(mode,))
    ps = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                       partition=port_part.make_partition(pg, 3, kind),
                                       modes=(mode,))
    xr = jnp.asarray(rg.features)
    want = np.asarray(ref_shard.sharded_aggregate(xr, rs, mode=mode,
                                                  qp=ref_scale_zp(xr, symmetric=True)))
    x = torch.from_numpy(pg.features)
    got = sharded_aggregate(x, ps, mode=mode, qp=compute_scale_zp(x, symmetric=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # without a qp the global one is calibrated: the same result
    assert torch.equal(sharded_aggregate(x, ps, mode=mode), got)


@pytest.mark.parametrize("kind", ["edges", "mincut"])
def test_sharded_edge_softmax_and_attention_match_reference(graphs, kind):
    """Per-shard max and denominator passes map owned rows back through the
    partition; scores reach each shard through edge_range or edge_idx."""
    rg, pg = graphs
    rs = ref_mp.compile_sharded_plans(rg, ref_mp.EngineConfig(edges_per_tile=64),
                                      partition=ref_part.make_partition(rg, 4, kind),
                                      modes=("runtime",))
    ps = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                       partition=port_part.make_partition(pg, 4, kind),
                                       modes=("runtime",))
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((pg.num_edges, 2)).astype(np.float32)
    z = rng.standard_normal((pg.num_nodes, 2, 6)).astype(np.float32)
    reng, peng = ref_shard.ShardedAmpleEngine(rg, rs), ShardedAmpleEngine(pg, ps)
    want = np.asarray(reng.edge_softmax(jnp.asarray(scores)))
    got = peng.edge_softmax(torch.from_numpy(scores))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    want = np.asarray(reng.attention_aggregate(jnp.asarray(scores), jnp.asarray(z)))
    got = peng.attention_aggregate(torch.from_numpy(scores), torch.from_numpy(z))
    assert_mixed_close(got.numpy(), want)
    unsharded = port_mp.AmpleEngine(pg, port_mp.EngineConfig(edges_per_tile=64))
    assert_mixed_close(got.numpy(), unsharded.attention_aggregate(
        torch.from_numpy(scores), torch.from_numpy(z)).numpy())


# -------------------------------------------------------- the serving contract
def test_num_shards_one_is_the_single_plan_path(graphs, models):
    _, pg = graphs
    base, eng = _port(models, "gcn"), _port(models, "gcn", num_shards=1)
    assert not eng.sharded
    r, ref = eng.infer(pg, pg.features), base.infer(pg, pg.features)
    np.testing.assert_array_equal(r.outputs, ref.outputs)
    assert r.fingerprint == ref.fingerprint and r.num_shards == 1
    (_, _, engine), = list(eng._cache.values())
    assert not isinstance(engine, ShardedAmpleEngine)


def test_sharded_plan_cache_hit_bitwise(graphs, models):
    _, pg = graphs
    eng = _port(models, "gin", num_shards=3)
    r1, r2 = eng.infer(pg, pg.features), eng.infer(pg, pg.features)
    assert not r1.cache_hit and r2.cache_hit
    assert r1.plan_ms > 0.0 and r2.plan_ms == 0.0
    assert r1.fingerprint == r2.fingerprint
    np.testing.assert_array_equal(r1.outputs, r2.outputs)
    assert eng.stats["planner_calls"] == 3  # one per shard, once ever
    assert eng.shard_report()["num_shards"] == 3
    assert _port(models, "gin").shard_report() is None
    # the per-shard LRU outlives the assembled entry
    eng._cache.clear()
    r3 = eng.infer(pg, pg.features)
    assert eng.stats["planner_calls"] == 3 and eng.stats["shard_hits"] == 3
    assert r3.cache_hit and r3.plan_ms == 0.0
    np.testing.assert_array_equal(r3.outputs, r1.outputs)


@pytest.mark.parametrize("kind", ["edges", "mincut"])
def test_halo_overlap_is_bitwise_the_unsplit_schedule(graphs, kind):
    """The interior half, then the boundary half into the same output: the
    unsplit scan bit for bit, on static and on per-edge coefficients."""
    _, pg = graphs
    part = port_part.make_partition(pg, 3, kind)
    x = torch.from_numpy(pg.features)
    for mode in ("gcn", "runtime"):
        splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=16),
                                              partition=part, modes=(mode,))
        plain = ShardedAmpleEngine(pg, splan)
        split = ShardedAmpleEngine(pg, splan, halo_overlap=True)
        if mode == "gcn":
            a, b = plain.aggregate(x, mode=mode), split.aggregate(x, mode=mode)
        else:
            coeff = torch.rand((pg.num_edges, 2), generator=torch.Generator().manual_seed(0))
            z = x[:, :12].reshape(-1, 2, 6).contiguous()
            a = plain.aggregate(z, mode=mode, edge_coeff=coeff)
            b = split.aggregate(z, mode=mode, edge_coeff=coeff)
        assert torch.equal(a, b)
        stats = split.halo_stats
        assert stats["split_exchanges"] == stats["halo_exchanges"] == 3
        assert stats["halo_bytes"] > 0 and stats["halo_ms"] >= 0.0
        assert plain.halo_stats["split_exchanges"] == 0


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_halo_overlap_serving_and_response_fields(graphs, models, arch):
    _, pg = graphs
    base = _port(models, arch).infer(pg, pg.features)
    unsplit = _port(models, arch, num_shards=2, partitioner="mincut").infer(pg, pg.features)
    eng = _port(models, arch, num_shards=2, partitioner="mincut", halo_overlap=True)
    r = eng.infer(pg, pg.features)
    np.testing.assert_array_equal(r.outputs, unsplit.outputs)
    assert_mixed_close(r.outputs, base.outputs)
    assert r.halo_bytes > 0 and r.halo_ms >= 0.0 and 0.0 <= r.halo_overlap <= 1.0
    assert unsplit.halo_bytes == r.halo_bytes and unsplit.halo_overlap == 0.0
    info = eng.cache_info()
    assert info["halo_exchanges"] > 0 and info["halo_bytes"] >= r.halo_bytes
    assert 0.0 <= info["halo_overlap"] <= 1.0
    assert base.halo_bytes == 0 and base.halo_overlap == 0.0 and base.num_shards == 1


def test_sharded_batch_matches_individual_and_reference(graphs, models):
    """Float precision, where batching is exact (mixed batches share int8
    activation scales batch-wide)."""
    rg, pg = graphs
    rcfg, pcfg = _cfgs("sage", precision="float")
    rp, pp = params_pair(rcfg, pcfg, seed=3)
    kw = dict(max_nodes=70, max_feature_dim=20, seed=9)
    rg2, pg2 = ref_ds.make_dataset("cora", **kw), port_ds.make_dataset("cora", **kw)
    eng = GNNServeEngine(pcfg, pp, num_shards=2, device="cpu")
    reqs = [GNNRequest(graph=g, features=g.features) for g in (pg, pg2)]
    first, second = eng.infer_batch(reqs), eng.infer_batch(reqs)
    assert not first[0].cache_hit and second[0].cache_hit
    assert first[0].num_shards == 2
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.outputs, b.outputs)
    solo = GNNServeEngine(pcfg, pp, device="cpu")
    for g, r in zip((pg, pg2), first):
        np.testing.assert_allclose(r.outputs, solo.infer(g, g.features).outputs,
                                   atol=1e-4, rtol=1e-4)
    ref = RefEngine(rcfg, rp, num_shards=2).infer_batch(
        [RefRequest(graph=g, features=g.features) for g in (rg, rg2)])
    for a, b in zip(first, ref):
        np.testing.assert_allclose(a.outputs, b.outputs, atol=5e-4, rtol=1e-3)


def test_explicit_partition_knob(graphs, models):
    _, pg = graphs
    _, pcfg, _, _ = models["gcn"]
    prepared = port_api.prepare_graph(pcfg, pg)
    eng = _port(models, "gcn", partition=port_part.partition_by_edges(prepared, 2))
    assert eng.num_shards == 2 and eng.sharded
    assert_mixed_close(eng.infer(pg, pg.features).outputs,
                       _port(models, "gcn").infer(pg, pg.features).outputs)
    bad = _port(models, "gcn", partition=port_part.Partition(
        starts=np.asarray([0, 10, prepared.num_nodes - 1])))
    with pytest.raises(ValueError, match="span"):
        bad.infer(pg, pg.features)


def test_partitioner_cache_keys_distinct(graphs, models):
    _, pg = graphs
    ra = _port(models, "gcn", num_shards=2).infer(pg, pg.features)
    rb = _port(models, "gcn", num_shards=2, partitioner="mincut").infer(pg, pg.features)
    assert ra.fingerprint != rb.fingerprint
    assert_mixed_close(ra.outputs, rb.outputs)


class _Mesh:
    """What the engines read of a ``DeviceMesh`` when they are built."""

    def __init__(self, names=("shard",), size=2):
        self.mesh_dim_names, self._size, self.device_type = names, size, "cpu"

    def size(self):
        return self._size


@pytest.mark.parametrize("where,mesh,match", [
    ("serve", _Mesh(size=4), "mesh has 4 devices but num_shards=2"),
    ("engine", _Mesh(names=("data",)), r"mesh axes must be \('shard',\)"),
    ("engine", _Mesh(size=3), "mesh has 3 devices but the plan has 2 shards"),
    ("make_engine", _Mesh(names=("shard", "x")), r"mesh axes must be \('shard',\)"),
], ids=["serve-size", "engine-names", "engine-size", "make_engine-names"])
def test_mesh_is_validated_where_it_is_passed(graphs, models, where, mesh, match):
    """Each entry point that takes ``mesh`` checks it as the reference does
    (one ``shard`` dimension, one rank per shard); the mesh backend itself
    runs in ``tests/test_torch_mesh.py``."""
    _, pg = graphs
    _, pcfg, _, pp = models["gcn"]
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          num_shards=2, modes=("sum",))
    make = {"serve": lambda: GNNServeEngine(pcfg, pp, num_shards=2, mesh=mesh, device="cpu"),
            "engine": lambda: ShardedAmpleEngine(pg, splan, mesh=mesh),
            "make_engine": lambda: port_api.make_engine(pcfg, pg, num_shards=2, mesh=mesh)}
    with pytest.raises(ValueError, match=match):
        make[where]()


def test_sharded_engine_rejects_what_it_cannot_serve(graphs):
    _, pg = graphs
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          num_shards=2, modes=("sum",))
    other = port_ds.make_dataset("cora", max_nodes=90, max_feature_dim=20, seed=7)
    with pytest.raises(ValueError, match="different graph structure"):
        ShardedAmpleEngine(other, splan)
    eng = ShardedAmpleEngine(pg, splan)
    with pytest.raises(KeyError, match="recompile"):
        eng.aggregate(torch.from_numpy(pg.features), mode="gcn")
    with pytest.raises(NotImplementedError):
        eng.plans("sum")


def test_feature_budget_is_ignored_with_a_warning_on_sharded_engines(graphs, models):
    _, pg = graphs
    with pytest.warns(UserWarning, match="ignored on sharded engines"):
        eng = _port(models, "gcn", num_shards=2, feature_budget_bytes=1024)
    r = eng.infer(pg, pg.features)
    assert not r.streamed and r.num_shards == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _port(models, "gcn", feature_budget_bytes=1024)


def test_model_forward_with_cfg_num_shards(graphs, models):
    """cfg.gnn_num_shards threads the sharded engine through model_forward."""
    _, pg = graphs
    _, pcfg, _, pp = models["gcn"]
    batch = {"graph": pg, "features": pg.features}
    y_ref, _ = model_forward(pp, pcfg, batch)
    for extra in (dict(gnn_num_shards=3), dict(gnn_num_shards=2, gnn_partitioner="mincut",
                                                gnn_halo_overlap=True)):
        y, _ = model_forward(pp, dataclasses.replace(pcfg, **extra), batch)
        assert_mixed_close(y.numpy(), y_ref.numpy())


def test_fronts_pass_the_sharded_engine_kwargs(graphs, models):
    """AsyncGNNEngine and TenantRouter build a sharded serving engine from a
    config; a window is bitwise infer_batch of its composition."""
    _, pg = graphs
    _, pcfg, _, pp = models["gcn"]
    g2 = port_ds.make_dataset("cora", max_nodes=70, max_feature_dim=20, seed=9)
    front = AsyncGNNEngine(pcfg, pp, window=2, num_shards=2, partitioner="mincut",
                           halo_overlap=True, device="cpu")
    assert front.engine.sharded and front.engine.halo_overlap
    for g in (pg, g2):
        front.submit(g, g.features)
    got = front.drain()
    want = GNNServeEngine(pcfg, pp, num_shards=2, partitioner="mincut", halo_overlap=True,
                          device="cpu").infer_batch(
        [GNNRequest(graph=g, features=g.features) for g in (pg, g2)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.outputs, b.outputs)
        assert a.num_shards == 2 and a.halo_bytes == b.halo_bytes > 0
    router = TenantRouter(pcfg, pp, window=2, num_shards=2, device="cpu")
    assert router.engine.engine.sharded and router.engine.engine.num_shards == 2
    router.add_tenant("gold", slo_ms=1e6)
    ticket = router.submit("gold", pg, pg.features)
    router.drain()
    np.testing.assert_array_equal(
        ticket.result().outputs,
        GNNServeEngine(pcfg, pp, num_shards=2, device="cpu").infer(pg, pg.features).outputs)
