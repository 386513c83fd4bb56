"""The port's copies of the numpy graph modules build the reference's arrays.

CSR structures, the dataset generator (and its structure cache) and the
Degree-Quant tags are copies of ``repro``'s; their arrays must be bitwise equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import degree_quant as ref_dq
from repro.graphs import csr as ref_csr
from repro.graphs import datasets as ref_ds
from repro_torch.core import degree_quant as port_dq
from repro_torch.graphs import csr as port_csr
from repro_torch.graphs import datasets as port_ds


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes and a.name == b.name
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype
    if a.features is None:
        assert b.features is None
    else:
        np.testing.assert_array_equal(a.features, b.features)


@pytest.mark.parametrize(
    "name,nodes,dim,seed",
    [("cora", 200, 24, 0), ("citeseer", 150, 24, 3), ("yelp", 500, 300, 1), ("reddit", 300, 16, 2)],
)
def test_make_dataset_bitwise(name, nodes, dim, seed):
    kw = dict(max_nodes=nodes, max_feature_dim=dim, seed=seed, cache_dir="")  # generate
    _same_graph(ref_ds.make_dataset(name, **kw), port_ds.make_dataset(name, **kw))
    assert {k: dataclasses.asdict(v) for k, v in port_ds.PAPER_DATASETS.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_ds.PAPER_DATASETS.items()
    }


def test_structure_cache_shared_and_bitwise(tmp_path):
    port = port_ds.make_dataset("pubmed", max_nodes=400, seed=5, cache_dir=str(tmp_path))
    cached = list(tmp_path.iterdir())
    assert len(cached) == 1  # same key as the reference's cache file
    ref = ref_ds.make_dataset("pubmed", max_nodes=400, seed=5, cache_dir=str(tmp_path))
    assert list(tmp_path.iterdir()) == cached
    _same_graph(ref, port)
    assert port_ds._GEN_VERSION == ref_ds._GEN_VERSION


def test_csr_helpers_bitwise():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    ref = ref_csr.from_edge_list(src, dst, 60, undirected=True)
    port = port_csr.from_edge_list(src, dst, 60, undirected=True)
    _same_graph(ref, port)
    _same_graph(ref_csr.add_self_loops(ref), port_csr.add_self_loops(port))
    np.testing.assert_array_equal(
        ref_csr.gcn_norm_coeffs(ref_csr.add_self_loops(ref)),
        port_csr.gcn_norm_coeffs(port_csr.add_self_loops(port)),
    )
    members = [ref_ds.make_dataset("cora", max_nodes=n, max_feature_dim=8, seed=s)
               for n, s in ((40, 1), (70, 2))]
    pmembers = [port_ds.make_dataset("cora", max_nodes=n, max_feature_dim=8, seed=s)
                for n, s in ((40, 1), (70, 2))]
    for kw in ({}, {"pad_num_nodes": 128}, {"pad_num_nodes": 128, "pad_num_edges": 600}):
        _same_graph(ref_csr.disjoint_union(members, **kw), port_csr.disjoint_union(pmembers, **kw))


@pytest.mark.parametrize("ratio", [0.004, 0.03, 0.5])
def test_precision_tags_bitwise(ratio):
    g = ref_ds.make_dataset("flickr", max_nodes=500, seed=4)
    ref = ref_dq.inference_precision_tags(g, ref_dq.DegreeQuantConfig(float_ratio=ratio))
    port = port_dq.inference_precision_tags(g, port_dq.DegreeQuantConfig(float_ratio=ratio))
    np.testing.assert_array_equal(ref, port)
