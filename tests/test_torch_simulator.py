"""The paper's evaluation and the double-buffered baseline, port against reference.

``core/simulator.py`` is a numpy copy of the reference's discrete-event model,
so its results are equal field for field. The baseline schedules (degree
buckets, double-buffered batches) are numpy too, so their arrays are bitwise
equal; their executors run in plain PyTorch on the CPU here and match the
reference's jnp executors within atol 1e-4 (tests/test_kernels.py:34).
``occupancy_report`` is equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import cfg_pair

from repro.core import aggregation as ref_agg
from repro.core import message_passing as ref_mp
from repro.core import scheduler as ref_sched
from repro.core import simulator as ref_sim
from repro.graphs.datasets import make_dataset, make_lognormal_graph
from repro.models.gnn import api as ref_api
from repro_torch.core import aggregation as port_agg
from repro_torch.core import scheduler as port_sched
from repro_torch.core import simulator as port_sim
from repro_torch.graphs.csr import Graph
from repro_torch.models.gnn import api as port_api


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _sim_cfgs(mod):
    return [
        mod.SimConfig(),
        mod.SimConfig(event_driven=False),
        mod.SimConfig(num_nodeslots=8, float_slots=2, prefetch_depth=2),
        mod.SimConfig(fetch_tag_capacity=8, agg_lanes=32, event_driven=False),
    ]


# ---------------------------------------------------------------- simulator
@pytest.mark.parametrize("case", range(4))
def test_simulate_equals_reference_field_for_field(case):
    g = make_lognormal_graph(2_000, 8.0, sigma=1.4, seed=case)
    fmask = np.random.default_rng(case).random(g.num_nodes) < 0.05
    kw = dict(feature_dim=128, out_dim=16, float_mask=fmask)
    want = ref_sim.simulate(g, cfg=_sim_cfgs(ref_sim)[case], **kw)
    got = port_sim.simulate(_port_graph(g), cfg=_sim_cfgs(port_sim)[case], **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(_sim_cfgs(port_sim)[case]) == dataclasses.asdict(
        _sim_cfgs(ref_sim)[case])


def test_simulate_defaults_follow_the_reference():
    """Feature width from the graph (or 64 without features), out = in."""
    g = make_dataset("cora", max_nodes=300, max_feature_dim=40, seed=1)
    for feats in (g.features, None):
        rg = dataclasses.replace(g, features=feats)
        want = ref_sim.simulate(rg)
        got = port_sim.simulate(_port_graph(rg))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("event_driven", [True, False])
@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed"])
def test_simulate_dataset_equals_reference(name, event_driven):
    want = ref_sim.simulate_dataset(name, cfg=ref_sim.SimConfig(event_driven=event_driven))
    got = port_sim.simulate_dataset(name, cfg=port_sim.SimConfig(event_driven=event_driven))
    assert got == want
    assert got["event_driven"] is event_driven and got["latency_ms"] > 0


def test_simulate_dataset_size_reduced_and_gin_dims_equal_reference():
    want = ref_sim.simulate_dataset("pubmed", model="gin", max_nodes=3_000, seed=2)
    got = port_sim.simulate_dataset("pubmed", model="gin", max_nodes=3_000, seed=2)
    assert got == want


# ----------------------------------------------------------- baseline plans
def _plan_graph(seed=0):
    g = make_lognormal_graph(400, 6.0, sigma=1.5, seed=seed)
    coeff = np.random.default_rng(seed).uniform(0.5, 1.5, g.num_edges).astype(np.float32)
    return g, coeff


def _buckets_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.capacity == b.capacity and a.num_nodes == b.num_nodes
        for f in ("node_ids", "gather_idx", "coeff"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("kw", [
    {}, {"max_capacity": 8}, {"coeff": True}, {"node_ids": True},
], ids=["default", "capped", "coeff", "subset"])
def test_bucket_plan_bitwise_equal_to_reference(kw):
    g, coeff = _plan_graph(1)
    args = dict(kw)
    if args.get("coeff"):
        args["coeff"] = coeff
    if args.get("node_ids"):
        args["node_ids"] = np.arange(3, g.num_nodes, 3)
    want = ref_sched.build_bucket_plan(g, **args)
    got = port_sched.build_bucket_plan(_port_graph(g), **args)
    assert got.num_nodes == want.num_nodes
    _buckets_equal(got.buckets, want.buckets)
    assert got.lane_occupancy == want.lane_occupancy


@pytest.mark.parametrize("batch_size", [64, 7])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_padded_plan_bitwise_equal_to_reference(batch_size, with_coeff):
    g, coeff = _plan_graph(2)
    c = coeff if with_coeff else None
    want = ref_sched.build_padded_plan(g, batch_size=batch_size, coeff=c)
    got = port_sched.build_padded_plan(_port_graph(g), batch_size=batch_size, coeff=c)
    assert (got.num_nodes, got.batch_size) == (want.num_nodes, want.batch_size)
    _buckets_equal(got.batches, want.batches)
    assert got.pipeline_gap_ratio == want.pipeline_gap_ratio
    assert 0.0 < got.pipeline_gap_ratio < 1.0


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_aggregate_bucket_plan_matches_reference(op):
    g, coeff = _plan_graph(3)
    x = np.random.default_rng(3).standard_normal((g.num_nodes, 12)).astype(np.float32)
    for max_capacity in (1 << 14, 4):  # 4: hubs split across rows
        kw = dict(max_capacity=max_capacity, coeff=coeff)
        want = ref_agg.aggregate_bucket_plan(
            jnp.asarray(x), ref_sched.build_bucket_plan(g, **kw), op=op)
        got = port_agg.aggregate_bucket_plan(
            torch.from_numpy(x), port_sched.build_bucket_plan(_port_graph(g), **kw), op=op)
        assert got.shape == (g.num_nodes, 12) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_aggregate_padded_plan_matches_reference_and_edge_tiles():
    g, coeff = _plan_graph(4)
    x = np.random.default_rng(4).standard_normal((g.num_nodes, 12)).astype(np.float32)
    want = ref_agg.aggregate_padded_plan(
        jnp.asarray(x), ref_sched.build_padded_plan(g, coeff=coeff))
    got = port_agg.aggregate_padded_plan(
        torch.from_numpy(x), port_sched.build_padded_plan(_port_graph(g), coeff=coeff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the baseline and the event-driven tiles compute the same aggregation
    tiles = port_agg.to_device_plan(
        port_sched.build_edge_tile_plan(_port_graph(g), edges_per_tile=32, coeff=coeff), "cpu")
    event = port_agg.aggregate_edge_tiles(torch.from_numpy(x), tiles, num_nodes=g.num_nodes)
    np.testing.assert_allclose(got.numpy(), event.numpy(), atol=1e-4)


# -------------------------------------------------------- occupancy report
@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_occupancy_report_equals_reference(arch):
    g = make_dataset("pubmed", max_nodes=1_500, max_feature_dim=24, seed=0)
    rcfg, pcfg = cfg_pair(arch, gnn_edges_per_tile=64)
    reng = ref_mp.AmpleEngine(ref_api.prepare_graph(rcfg, g), ref_api.engine_config(rcfg))
    peng = port_api.make_engine(pcfg, port_api.prepare_graph(pcfg, _port_graph(g)))
    got, want = peng.occupancy_report(), reng.occupancy_report()
    assert got == want
    assert 0.0 < got["event_driven_lane_occupancy"] <= 1.0
    assert got["double_buffer_pipeline_gap_ratio"] > 1.0 - got["event_driven_lane_occupancy"]
