"""The port's partitioner, shard subgraphs and shard plans against the reference.

``graphs/partition.py`` and ``datasets.make_clustered_graph`` are numpy
copies, so for the same graph and seed the port's partitions, subgraphs,
fingerprints and per-shard tile plans (and their interior/boundary halves)
must be bitwise the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import message_passing as ref_mp
from repro.core import scheduler as ref_sched
from repro.graphs import datasets as ref_ds
from repro.graphs import partition as ref_part
from repro_torch.core import message_passing as port_mp
from repro_torch.core import scheduler as port_sched
from repro_torch.graphs import datasets as port_ds
from repro_torch.graphs import partition as port_part

PLAN_ARRAYS = ("gather_idx", "coeff", "seg_ids", "out_node", "node_ids", "edge_ids")
SCALARS = ("num_nodes", "edges_per_tile", "segments_per_tile", "total_edges")


@pytest.fixture(scope="module")
def graphs():
    """The cora-sized graph the reference's sharded tests use, in both packages."""
    kw = dict(max_nodes=160, max_feature_dim=20, seed=2)
    return ref_ds.make_dataset("cora", **kw), port_ds.make_dataset("cora", **kw)


@pytest.fixture(scope="module")
def clustered():
    kw = dict(seed=1, shuffle=True, inter_degree=0.5)
    return (ref_ds.make_clustered_graph(2000, 8, **kw),
            port_ds.make_clustered_graph(2000, 8, **kw))


def _same_partition(a, b):
    np.testing.assert_array_equal(a.starts, b.starts)
    assert (a.order is None) == (b.order is None)
    if a.order is not None:
        np.testing.assert_array_equal(a.order, b.order)
    assert a.kind == b.kind


def _same_plan(a, b):
    for name in PLAN_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


# The partitioners with their inline parameters, as the serving layer spells them.
KINDS = ["edges", "mincut", "mincut(seed=4)", "mincut(seed=1,balance=1.1,passes=4)"]


def test_clustered_graph_is_the_references(clustered):
    r, p = clustered
    np.testing.assert_array_equal(r.indptr, p.indptr)
    np.testing.assert_array_equal(r.indices, p.indices)
    assert (r.num_nodes, r.name) == (p.num_nodes, p.name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_partitions_and_their_metrics_are_the_references(graphs, kind, k):
    rg, pg = graphs
    rp, pp = ref_part.make_partition(rg, k, kind), port_part.make_partition(pg, k, kind)
    _same_partition(rp, pp)
    port_part.validate_partition(pg, pp)
    np.testing.assert_array_equal(ref_part.shard_edge_counts(rg, rp),
                                  port_part.shard_edge_counts(pg, pp))
    assert ref_part.partition_cut_edges(rg, rp) == port_part.partition_cut_edges(pg, pp)
    assert ref_part.partition_halo_volume(rg, rp) == port_part.partition_halo_volume(pg, pp)
    nodes = np.arange(pg.num_nodes)
    np.testing.assert_array_equal(rp.owner_of(nodes), pp.owner_of(nodes))
    np.testing.assert_array_equal(rp.rank_of(nodes), pp.rank_of(nodes))
    for s in range(k):
        np.testing.assert_array_equal(ref_part.halo_nodes(rg, rp, s),
                                      port_part.halo_nodes(pg, pp, s))
    assert (ref_sched.partition_fingerprint(rg, rp)
            == port_sched.partition_fingerprint(pg, pp))
    assert (ref_sched.shard_plan_fingerprint(rg, rp, k - 1, "a", "b")
            == port_sched.shard_plan_fingerprint(pg, pp, k - 1, "a", "b"))


@pytest.mark.parametrize("seed", [0, 4])
def test_mincut_on_the_clustered_graph_is_the_references_and_cuts_the_halo(clustered, seed):
    rg, pg = clustered
    rp = ref_part.partition_min_cut(rg, 4, seed=seed)
    pp = port_part.partition_min_cut(pg, 4, seed=seed)
    _same_partition(rp, pp)
    assert pp.order is not None
    edges = port_part.partition_by_edges(pg, 4)
    assert port_part.partition_halo_volume(pg, pp) < port_part.partition_halo_volume(pg, edges)
    counts = port_part.shard_edge_counts(pg, pp)
    assert counts.max() <= 1.25 * pg.num_edges / 4 + pg.degrees.max()


@pytest.mark.parametrize("kind", ["edges", "mincut"])
def test_shard_subgraphs_are_the_references(graphs, kind):
    rg, pg = graphs
    rp, pp = ref_part.make_partition(rg, 3, kind), port_part.make_partition(pg, 3, kind)
    for s in range(3):
        a, b = ref_part.shard_subgraph(rg, rp, s), port_part.shard_subgraph(pg, pp, s)
        assert (a.index, a.lo, a.hi, a.edge_range) == (b.index, b.lo, b.hi, b.edge_range)
        for name in ("halo", "local_ids"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.edge_idx is None) == (b.edge_idx is None)
        if a.edge_idx is not None:
            np.testing.assert_array_equal(a.edge_idx, b.edge_idx)
        np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
        np.testing.assert_array_equal(a.graph.indices, b.graph.indices)
        assert (a.graph.num_nodes, a.graph.name) == (b.graph.num_nodes, b.graph.name)
        vec = np.arange(pg.num_edges, dtype=np.float32)
        np.testing.assert_array_equal(a.slice_edges(vec), b.slice_edges(vec))


def test_partition_checks_are_the_references(graphs):
    _, pg = graphs
    n = pg.num_nodes
    bad = [
        (port_part.Partition(starts=np.asarray([0, 10, n - 1])), "span"),
        (port_part.Partition(starts=np.asarray([0, 50, 20, n])), "monotone"),
        (port_part.Partition(starts=np.asarray([0, n]), order=np.zeros(n, np.int64)),
         "permutation"),
        (port_part.Partition(starts=np.asarray([0, 2, n]),
                             order=np.r_[[1, 0], np.arange(2, n)]), "sorted"),
    ]
    for part, match in bad:
        with pytest.raises(ValueError, match=match):
            port_part.validate_partition(pg, part)
    with pytest.raises(ValueError, match="unknown partitioner"):
        port_part.make_partition(pg, 2, "spectral")


@pytest.mark.parametrize("kind", ["edges", "mincut(seed=4)"])
@pytest.mark.parametrize("mode", ["gcn", "runtime"])
def test_shard_plans_and_their_halves_are_the_references(graphs, kind, mode):
    """Per-shard plans: global tags and coefficients sliced per shard, the
    local tile arrays, and each plan's interior/boundary split, bitwise."""
    rg, pg = graphs
    rp, pp = ref_part.make_partition(rg, 3, kind), port_part.make_partition(pg, 3, kind)
    rs = ref_mp.compile_sharded_plans(rg, ref_mp.EngineConfig(edges_per_tile=64),
                                      partition=rp, modes=(mode,))
    ps = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                       partition=pp, modes=(mode,))
    assert rs.partition_fp == ps.partition_fp and rs.num_shards == ps.num_shards == 3
    assert (rs.halo_total, rs.edge_balance) == (ps.halo_total, ps.edge_balance)
    np.testing.assert_array_equal(rs.precision_tags, ps.precision_tags)
    assert len({s.fingerprint for s in ps.shards}) == 3
    for a, b in zip(rs.shards, ps.shards):
        np.testing.assert_array_equal(a.plan.precision_tags, b.plan.precision_tags)
        np.testing.assert_array_equal(b.plan.precision_tags[: b.num_owned],
                                      ps.precision_tags[b.shard.owned])
        assert sorted(a.plan.mode_plans[mode]) == sorted(b.plan.mode_plans[mode])
        for tag, rplan in a.plan.mode_plans[mode].items():
            pplan = b.plan.mode_plans[mode][tag]
            _same_plan(rplan, pplan)
            for rh, ph in zip(ref_sched.split_plan_by_halo(rplan, a.num_owned),
                              port_sched.split_plan_by_halo(pplan, b.num_owned)):
                _same_plan(rh, ph)


def test_split_halves_partition_the_runs(graphs):
    """Each output row's tiles fall in one half; interior tiles read owned
    rows only; the halves hold every real edge once."""
    _, pg = graphs
    ps = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=16),
                                       num_shards=4, modes=("sum",))
    for sp in ps.shards:
        for plan in sp.plan.mode_plans["sum"].values():
            inner, bnd = port_sched.split_plan_by_halo(plan, sp.num_owned)
            assert inner.num_tiles + bnd.num_tiles == plan.num_tiles
            assert inner.total_edges + bnd.total_edges == plan.total_edges
            live = inner.edge_ids >= 0
            assert (inner.gather_idx[live] < sp.num_owned).all()
            sent = plan.num_nodes
            a = set(inner.out_node[inner.out_node != sent].tolist())
            b = set(bnd.out_node[bnd.out_node != sent].tolist())
            assert not a & b


def test_sharded_plan_fingerprints_stable_and_distinct(graphs):
    _, pg = graphs
    cfg = port_mp.EngineConfig(edges_per_tile=64)
    a = port_mp.compile_sharded_plans(pg, cfg, num_shards=3, modes=("gcn",))
    b = port_mp.compile_sharded_plans(pg, cfg, num_shards=3, modes=("gcn",))
    assert a == b and hash(a) == hash(b)
    assert [s.fingerprint for s in a.shards] == [s.fingerprint for s in b.shards]
    assert port_mp.compile_sharded_plans(pg, cfg, num_shards=4, modes=("gcn",)) != a
    assert port_mp.compile_sharded_plans(pg, cfg, num_shards=3, modes=("sum",)) != a
    mc = port_mp.compile_sharded_plans(pg, cfg, num_shards=3, partitioner="mincut",
                                       modes=("gcn",))
    assert mc.partition_fp != a.partition_fp
    # a shard compiled alone is the shard compiled with the others
    one = port_mp.compile_shard_plan(pg, a.partition, 1, cfg, modes=("gcn",))
    assert one.fingerprint == a.shards[1].fingerprint
    _same_plan(one.plan.mode_plans["gcn"]["float"], a.shards[1].plan.mode_plans["gcn"]["float"])
