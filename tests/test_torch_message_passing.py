"""The port's engine and GCN against the reference on the same graph and params.

Float: atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46). Mixed precision:
atol 6e-2, rtol 2e-3 and fewer than 5% of entries off by more than 2e-3
(tests/test_gnn_models.py:79-80), against the reference engine with its jnp
path and with its Pallas kernels (interpret mode).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.core import message_passing as ref_mp
from repro.core import transformation as ref_tf
from repro.core.aggregation import aggregate_mixed_precision as ref_agg_mixed
from repro.graphs.datasets import make_dataset
from repro.models.gnn import api as ref_api
from repro_torch.core import message_passing as port_mp
from repro_torch.core import transformation as port_tf
from repro_torch.core.aggregation import (
    aggregate_edge_tiles,
    aggregate_mixed_precision,
    to_device_plan,
)
from repro_torch.core.quantization import compute_scale_zp, dequantize, quantize
from repro_torch.core.quantization import quantize_per_channel
from repro_torch.graphs.csr import Graph
from repro_torch.models.gnn import api as port_api


@pytest.fixture(scope="module")
def base_graph():
    return make_dataset("citeseer", max_nodes=150, max_feature_dim=24, seed=3)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _small(precision):
    return cfg_pair(d_model=24, d_ff=16, vocab_size=8, gnn_precision=precision,
                    gnn_edges_per_tile=64)


def _engines(rcfg, pcfg, g, use_kernel=False):
    rg = ref_api.prepare_graph(rcfg, g)
    reng = ref_mp.AmpleEngine(
        rg, dataclasses.replace(ref_api.engine_config(rcfg), use_kernel=use_kernel))
    peng = port_api.make_engine(pcfg, port_api.prepare_graph(pcfg, _port_graph(g)))
    return reng, peng


def test_gcn_float_matches_reference_and_oracle(base_graph):
    rcfg, pcfg = _small("float")
    rp, pp = params_pair(rcfg, pcfg, seed=0)
    reng, peng = _engines(rcfg, pcfg, base_graph)
    x = base_graph.features
    ref = np.asarray(ref_api.gnn_apply(rcfg, rp, reng, jnp.asarray(x)))
    port = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, atol=5e-4, rtol=1e-3)
    oracle = port_api.gnn_reference(pcfg, pp, _port_graph(base_graph), x).numpy()
    np.testing.assert_allclose(port, oracle, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gcn_mixed_matches_reference_engine(base_graph, use_kernel):
    rcfg, pcfg = _small("mixed")
    rp, pp = params_pair(rcfg, pcfg, seed=1)
    reng, peng = _engines(rcfg, pcfg, base_graph, use_kernel=use_kernel)
    x = base_graph.features
    reng.begin_forward()
    peng.begin_forward()
    ref = np.asarray(ref_api.gnn_apply(rcfg, rp, reng, jnp.asarray(x)))
    port = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    assert_mixed_close(port, ref)


def test_gcn_full_widths_forward_matches_reference():
    """FULL ample-gcn widths (300 → 256 → 100) on a 180-node graph."""
    g = make_dataset("yelp", max_nodes=180, max_feature_dim=300, seed=2)
    rcfg, pcfg = cfg_pair(reduced=False)
    rp, pp = params_pair(rcfg, pcfg, seed=2)
    ref, _ = ref_api.gnn_forward(rp, rcfg, {"graph": g, "features": g.features})
    port, aux = port_api.gnn_forward(pp, pcfg, {"graph": _port_graph(g), "features": g.features})
    assert port.shape == (180, 100) and float(aux) == 0.0
    assert_mixed_close(port.numpy(), np.asarray(ref))


def test_aggregate_and_transform_mixed_match_reference(base_graph):
    rcfg, pcfg = _small("mixed")
    reng, peng = _engines(rcfg, pcfg, base_graph)
    plans_r, plans_p = reng.plans("gcn"), peng.plans("gcn")
    x = base_graph.features
    ref = ref_agg_mixed(jnp.asarray(x), plans_r, num_nodes=150)
    port = aggregate_mixed_precision(torch.from_numpy(x), plans_p, num_nodes=150)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4)
    w = np.random.default_rng(5).standard_normal((24, 16)).astype(np.float32)
    yr = ref_tf.transform_mixed_precision(jnp.asarray(x), reng.node_groups, jnp.asarray(w))
    yp = port_tf.transform_mixed_precision(torch.from_numpy(x), peng.node_groups,
                                           torch.from_numpy(w))
    # identical int8 codes and int32 sums; f32 dequant and matmul agree to float
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), atol=1e-5, rtol=1e-5)
    w_q, w_qp = quantize_per_channel(torch.from_numpy(w))
    int8 = torch.as_tensor(peng.node_groups["int8"])
    direct = port_tf.transform_int8(torch.from_numpy(x)[int8], w_q, w_qp)
    np.testing.assert_array_equal(direct.numpy(), yp.numpy()[int8.numpy()])


@pytest.mark.parametrize("runtime", [False, True])
def test_mixed_aggregate_shares_one_output(base_graph, runtime):
    """Both precision groups write their disjoint node rows into one
    zero-filled output: equal (torch.equal) to the sum zeros + float + int8
    of the groups' separate outputs, the int8 group dequantized first, and
    within 1e-4 of the reference engine's mixed aggregate."""
    rcfg, pcfg = _small("mixed")
    reng, peng = _engines(rcfg, pcfg, base_graph)
    mode = "runtime" if runtime else "gcn"
    plans_r, plans_p = reng.plans(mode), peng.plans(mode)
    x = torch.from_numpy(base_graph.features)
    ec = None
    if runtime:
        ec = torch.from_numpy(np.random.default_rng(4).uniform(
            0.5, 1.5, peng.graph.num_edges).astype(np.float32))
    got = aggregate_mixed_precision(x, plans_p, num_nodes=150, edge_coeff=ec)
    qp = compute_scale_zp(x, symmetric=True)
    dps = {tag: to_device_plan(p, "cpu") for tag, p in plans_p.items()}
    old = torch.zeros((150, x.shape[1]))
    old = old + aggregate_edge_tiles(x, dps["float"], num_nodes=150, edge_coeff=ec)
    old = old + aggregate_edge_tiles(dequantize(quantize(x, qp), qp), dps["int8"],
                                     num_nodes=150, edge_coeff=ec)
    assert torch.equal(got, old)
    ref = ref_agg_mixed(jnp.asarray(base_graph.features), plans_r, num_nodes=150,
                        edge_coeff=None if ec is None else jnp.asarray(ec.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_engine_caches_are_static_per_plan(base_graph):
    rcfg, pcfg = _small("mixed")
    _, pp = params_pair(rcfg, pcfg, seed=3)
    _, peng = _engines(rcfg, pcfg, base_graph)
    x = torch.from_numpy(base_graph.features)
    peng.begin_forward()
    first = port_api.gnn_apply(pcfg, pp, peng, x)
    qps = dict(peng._act_qp)
    assert sorted(qps) == [("agg", 0), ("agg", 1), ("fte", 0), ("fte", 1)]
    peng.begin_forward()
    assert torch.equal(port_api.gnn_apply(pcfg, pp, peng, x), first)
    assert peng._act_qp == qps
    w = pp["layers"][0]["w"]
    assert peng._weight_q(w)[2] is peng._weight_q(w)[2]  # relayout built once
    assert len(peng._dplan_cache) == 1
