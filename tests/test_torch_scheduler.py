"""The port's planner copy emits the reference's tile arrays, bitwise.

Fingerprints differ by design (the port's EngineConfig has no ``use_kernel``),
so the tests compare plan arrays, tags and node groups, never fingerprints
that embed a config repr.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import message_passing as ref_mp
from repro.core import scheduler as ref_sched
from repro.graphs.csr import add_self_loops, disjoint_union
from repro.graphs.datasets import make_dataset, make_lognormal_graph
from repro_torch.core import message_passing as port_mp
from repro_torch.core import scheduler as port_sched
from repro_torch.graphs import csr as port_csr

_FIELDS = ("gather_idx", "coeff", "seg_ids", "out_node", "node_ids", "edge_ids")


def _same_plan(a, b):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("num_nodes", "edges_per_tile", "segments_per_tile", "total_edges"):
        assert getattr(a, f) == getattr(b, f), f


def _port_graph(g):
    """The same structure as a port Graph (the planner only reads CSR arrays)."""
    return port_csr.Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                          features=g.features, name=g.name)


@pytest.mark.parametrize("ept,spt", [(16, None), (64, None), (64, 8), (256, None)])
def test_build_edge_tile_plan_bitwise(ept, spt):
    g = make_lognormal_graph(300, 9.0, seed=ept)
    coeff = np.random.default_rng(1).uniform(0.1, 2.0, g.num_edges).astype(np.float32)
    kw = dict(edges_per_tile=ept, segments_per_tile=spt, coeff=coeff)
    _same_plan(ref_sched.build_edge_tile_plan(g, **kw),
               port_sched.build_edge_tile_plan(_port_graph(g), **kw))


def test_mixed_precision_and_concat_bitwise():
    gs = [make_lognormal_graph(n, 6.0, seed=s) for n, s in ((90, 1), (140, 2), (60, 3))]
    ref_plans, port_plans = [], []
    for g in gs:
        tags = np.where(np.arange(g.num_nodes) % 9 == 0, "float", "int8")
        r = ref_sched.build_mixed_precision_plans(g, tags, edges_per_tile=32)
        p = port_sched.build_mixed_precision_plans(_port_graph(g), tags, edges_per_tile=32)
        assert r.keys() == p.keys()
        for tag in r:
            _same_plan(r[tag], p[tag])
        ref_plans.append(r["int8"])
        port_plans.append(p["int8"])
    offs = np.cumsum([0] + [g.num_nodes for g in gs])[:-1]
    eoffs = np.cumsum([0] + [g.num_edges for g in gs])[:-1]
    for kw in ({}, {"min_tiles": 64, "edge_offsets": eoffs}):
        _same_plan(ref_sched.concat_tile_plans(ref_plans, offs, num_nodes=400, **kw),
                   port_sched.concat_tile_plans(port_plans, offs, num_nodes=400, **kw))


def test_size_classes_and_fingerprints_match():
    g = make_lognormal_graph(120, 4.0, seed=7)
    assert ref_sched.graph_fingerprint(g) == port_sched.graph_fingerprint(_port_graph(g))
    assert ref_sched.plan_fingerprint(g, "a", "b") == port_sched.plan_fingerprint(
        _port_graph(g), "a", "b")
    for args in ((0, 0, 1024, 8192), (5000, 77777, 1024, 8192), (10, 10, 0, 0)):
        assert ref_sched.size_class(*args) == port_sched.size_class(*args)
        assert ref_sched.union_bucket_fingerprint(*args, "x") == \
            port_sched.union_bucket_fingerprint(*args, "x")


@pytest.mark.parametrize("mixed", [True, False])
def test_compile_and_assemble_union_bitwise(mixed):
    members = [make_dataset("cora", max_nodes=n, max_feature_dim=8, seed=s)
               for n, s in ((120, 1), (80, 2), (150, 3))]
    rcfg = ref_mp.EngineConfig(edges_per_tile=64, mixed_precision=mixed)
    pcfg = port_mp.EngineConfig(edges_per_tile=64, mixed_precision=mixed)
    rplans, pplans, prepared = [], [], []
    for m in members:
        g = add_self_loops(m)
        prepared.append(g)
        rtags = ref_mp.engine_precision_tags(g, rcfg)
        ptags = port_mp.engine_precision_tags(_port_graph(g), pcfg)
        np.testing.assert_array_equal(rtags, ptags)
        r = ref_mp.compile_plans(g, rcfg, modes=("gcn",), precision_tags=rtags)
        p = port_mp.compile_plans(_port_graph(g), pcfg, modes=("gcn",), precision_tags=ptags)
        for tag in r.node_groups:
            np.testing.assert_array_equal(r.node_groups[tag], p.node_groups[tag])
        for tag in r.mode_plans["gcn"]:
            _same_plan(r.mode_plans["gcn"][tag], p.mode_plans["gcn"][tag])
        rplans.append(r)
        pplans.append(p)
    union = disjoint_union(prepared, pad_num_nodes=512)
    for bucket in (0, 2048):
        r = ref_mp.assemble_union_plan(rplans, union, edge_bucket=bucket)
        p = port_mp.assemble_union_plan(pplans, _port_graph(union), edge_bucket=bucket)
        np.testing.assert_array_equal(r.precision_tags, p.precision_tags)
        assert r.node_groups.keys() == p.node_groups.keys()
        for tag in r.node_groups:
            np.testing.assert_array_equal(r.node_groups[tag], p.node_groups[tag])
        for tag in r.mode_plans["gcn"]:
            _same_plan(r.mode_plans["gcn"][tag], p.mode_plans["gcn"][tag])
