"""The port's GIN and GraphSAGE against the reference, on the CPU.

Both archs run on the AGE and the int8 FTE (the kernels' plain versions
here; ``test_torch_kernels_gpu.py`` holds the CUDA kernels against them on
the card), GIN with ``sum`` and SAGE with ``mean`` coefficients on the raw
graph (no self-loops). Inputs are made with numpy from a seed and handed to
both packages; params come from the reference's own init. Tolerances:

- float model: atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46), also
  against the dense oracle;
- mixed model: ``assert_mixed_close`` (tests/test_gnn_models.py:66-80),
  against the reference's jnp path and its Pallas path in interpret mode;
- the activation-quantization slots of a forward: the same slots, in the
  same order, with equal scales and zero points.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.core import message_passing as ref_mp
from repro.graphs.csr import Graph as RefGraph
from repro.graphs.datasets import make_dataset
from repro.models.gnn import api as ref_api
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import build
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine

ARCHS = ["gin", "sage"]
# FTE call sites per layer: GIN's two linears, SAGE's φ, W1 and W2.
FTE_PER_LAYER = {"gin": 2, "sage": 3}


@pytest.fixture(scope="module")
def graph():
    return make_dataset("citeseer", max_nodes=150, max_feature_dim=24, seed=3)


@pytest.fixture(scope="module")
def pool():
    return [make_dataset("cora", max_nodes=n, max_feature_dim=24, seed=s)
            for n, s in ((60, 1), (110, 2), (90, 3))]


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _small(arch, precision="mixed", **overrides):
    return cfg_pair(arch, d_model=24, d_ff=16, vocab_size=8, gnn_precision=precision,
                    gnn_edges_per_tile=64, **overrides)


def _engines(rcfg, pcfg, g, use_kernel=False):
    rg = ref_api.prepare_graph(rcfg, g)
    reng = ref_mp.AmpleEngine(
        rg, dataclasses.replace(ref_api.engine_config(rcfg), use_kernel=use_kernel))
    peng = port_api.make_engine(pcfg, port_api.prepare_graph(pcfg, _port_graph(g)))
    return reng, peng


def _with_eps(rp, pp, eps):
    """GIN params with a nonzero ε in both packages (the init gives 0)."""
    return dict(rp, eps=jnp.asarray(eps, jnp.float32)), dict(pp, eps=torch.tensor(eps))


# ------------------------------------------------------------------ registry
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_resolves_with_its_aggregation_and_raw_graph(arch, graph):
    spec = port_api.get_arch(arch)
    assert spec.default_agg == ref_api.get_arch(arch).default_agg
    assert spec.default_agg == {"gin": "sum", "sage": "mean"}[arch]
    assert not spec.needs_self_loops
    assert arch in port_api.list_archs()
    _, pcfg = _small(arch)
    pg = _port_graph(graph)
    assert port_api.prepare_graph(pcfg, pg) is pg


def test_gin_eps_is_a_zero_d_leaf():
    rcfg, pcfg = _small("gin")
    rp, pp = params_pair(rcfg, pcfg, seed=0)
    assert pp["eps"].shape == () and float(pp["eps"]) == 0.0
    assert port_api.get_arch("gin").param_shapes(pcfg)["eps"] == ()
    own = port_api.gnn_init(pcfg, device="cpu")
    assert own["eps"].shape == () and own["eps"].dtype == torch.float32
    bad = jax.tree_util.tree_map(np.asarray, rp)
    bad["eps"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="weights must be"):
        port_api.params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_is_glorot_with_zero_biases_and_seeded(arch):
    _, pcfg = cfg_pair(arch, reduced=False)
    a = port_api.gnn_init(pcfg, torch.Generator().manual_seed(3), device="cpu")
    b = port_api.gnn_init(pcfg, torch.Generator().manual_seed(3), device="cpu")
    flat_a, flat_b = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    first = a["layers"][0]["layers"][0] if arch == "gin" else a["layers"][0]["w3"]
    assert not first["b"].any()
    fan_in, fan_out = first["w"].shape
    assert float(first["w"].abs().max()) <= float(np.sqrt(6.0 / (fan_in + fan_out)))


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_float_matches_reference_and_oracle(graph, arch):
    rcfg, pcfg = _small(arch, precision="float")
    rp, pp = params_pair(rcfg, pcfg, seed=5)
    if arch == "gin":
        rp, pp = _with_eps(rp, pp, 0.25)
    reng, peng = _engines(rcfg, pcfg, graph)
    x = graph.features
    ref = np.asarray(ref_api.gnn_apply(rcfg, rp, reng, jnp.asarray(x)))
    port = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, atol=5e-4, rtol=1e-3)
    oracle = port_api.gnn_reference(pcfg, pp, _port_graph(graph), x).numpy()
    np.testing.assert_allclose(port, oracle, atol=5e-4, rtol=1e-3)
    ref_oracle = np.asarray(ref_api.gnn_reference(rcfg, rp, graph, jnp.asarray(x)))
    np.testing.assert_allclose(oracle, ref_oracle, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_matches_reference_engine_slot_for_slot(graph, arch, use_kernel):
    """After ``begin_forward()`` both engines calibrate the same
    activation-quantization slots in the same order (GIN: agg, fte, fte per
    layer; SAGE: fte φ, agg, fte W1, fte W2), so a warm request quantizes
    every call site with its own scale."""
    rcfg, pcfg = _small(arch)
    rp, pp = params_pair(rcfg, pcfg, seed=11)
    reng, peng = _engines(rcfg, pcfg, graph, use_kernel=use_kernel)
    x = graph.features
    reng.begin_forward()
    peng.begin_forward()
    ref = np.asarray(ref_api.gnn_apply(rcfg, rp, reng, jnp.asarray(x)))
    port = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    assert_mixed_close(port, ref)
    layers = len(rcfg.gnn_layer_dims) - 1
    assert list(peng._act_qp) == list(reng._act_qp)
    assert sum(k[0] == "fte" for k in peng._act_qp) == FTE_PER_LAYER[arch] * layers
    assert sum(k[0] == "agg" for k in peng._act_qp) == layers
    for slot, qp in peng._act_qp.items():
        want = reng._act_qp[slot]
        assert float(qp.scale) == pytest.approx(float(want.scale), rel=1e-6), slot
        assert float(qp.zero_point) == float(want.zero_point), slot
    # a second forward reuses the calibrated slots: bitwise equal
    peng.begin_forward()
    again = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    assert np.array_equal(port, again)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_widths_forward_matches_reference(arch):
    """FULL widths (300 → 256 → 100) on a 180-node Yelp cut: GIN's last
    linear is K 100 × N 100, SAGE's φ K 300 × N 300 then K 256 × N 256."""
    g = make_dataset("yelp", max_nodes=180, max_feature_dim=300, seed=2)
    rcfg, pcfg = cfg_pair(arch, reduced=False)
    rp, pp = params_pair(rcfg, pcfg, seed=2)
    ref, _ = ref_api.gnn_forward(rp, rcfg, {"graph": g, "features": g.features})
    build.reset_launch_counts()
    port, aux = port_api.gnn_forward(pp, pcfg, {"graph": _port_graph(g), "features": g.features})
    assert build.launch_counts() == {}  # CPU tensors: the plain versions, no launch
    assert port.shape == (180, 100) and float(aux) == 0.0
    assert_mixed_close(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_zero_degree_nodes_aggregate_to_exact_zero(mode):
    """The raw graph has nodes without in-edges: their rows of the shared
    zero-filled output stay exactly 0 in both precision groups."""
    full = make_dataset("cora", max_nodes=200, max_feature_dim=24, seed=5)
    isolated = np.arange(0, full.num_nodes, 7)
    keep = ~np.isin(np.repeat(np.arange(full.num_nodes), full.degrees), isolated)
    deg = np.where(np.isin(np.arange(full.num_nodes), isolated), 0, full.degrees)
    g = RefGraph(indptr=np.concatenate([[0], np.cumsum(deg)]).astype(full.indptr.dtype),
                 indices=full.indices[keep], num_nodes=full.num_nodes,
                 features=full.features, name="cora-isolated")
    assert not g.degrees[isolated].any()
    rcfg, pcfg = _small("gin" if mode == "sum" else "sage")
    reng, peng = _engines(rcfg, pcfg, g)
    assert set(peng.plans(mode)) == {"int8", "float"}
    x = np.random.default_rng(0).standard_normal((g.num_nodes, 24)).astype(np.float32)
    out = peng.aggregate(torch.from_numpy(x), mode=mode).numpy()
    assert not out[isolated].any()
    ref = np.asarray(reng.aggregate(jnp.asarray(x), mode=mode))
    np.testing.assert_allclose(out, ref, atol=1e-4)


# ------------------------------------------------------------------ serving
def _serve_pair(arch, buckets):
    rcfg, pcfg = _small(arch, gnn_union_node_bucket=buckets[0],
                        gnn_union_edge_bucket=buckets[1])
    rp, pp = params_pair(rcfg, pcfg, seed=7)
    if arch == "gin":
        rp, pp = _with_eps(rp, pp, 0.1)
    return RefServe(rcfg, rp), GNNServeEngine(pcfg, pp, device="cpu")


@pytest.mark.parametrize("buckets", [(0, 0), (256, 2048)])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_warm_equals_cold_and_matches_reference(pool, arch, buckets):
    ref, port = _serve_pair(arch, buckets)
    g = pool[1]
    want = ref.infer(g, g.features).outputs
    cold = port.infer(_port_graph(g), g.features)
    warm = port.infer(_port_graph(g), g.features)
    assert not cold.cache_hit and warm.cache_hit and warm.plan_ms == 0.0
    assert np.array_equal(cold.outputs, warm.outputs)
    assert cold.outputs.shape == (g.num_nodes, 8)
    assert_mixed_close(cold.outputs, want)
    assert port.cache_info()["planner_calls"] == 1


@pytest.mark.parametrize("buckets", [(0, 0), (256, 2048)])
@pytest.mark.parametrize("arch", ARCHS)
def test_infer_batch_matches_reference(pool, arch, buckets):
    ref, port = _serve_pair(arch, buckets)
    want = ref.infer_batch([RefRequest(graph=g, features=g.features) for g in pool])
    got = port.infer_batch([GNNRequest(graph=_port_graph(g), features=g.features)
                            for g in pool])
    again = port.infer_batch([GNNRequest(graph=_port_graph(g), features=g.features)
                              for g in pool])
    for w, a, b, g in zip(want, got, again, pool):
        assert a.batch_size == 3 and a.outputs.shape == (g.num_nodes, 8)
        assert np.array_equal(a.outputs, b.outputs)
        assert_mixed_close(a.outputs, w.outputs)
    if buckets[0]:
        _, plan, eng = next(iter(port._cache.values()))
        n_real = sum(g.num_nodes for g in pool)
        assert plan.num_nodes % 256 == 0 and plan.num_nodes > n_real
        x = np.zeros((plan.num_nodes, 24), np.float32)
        x[:n_real] = np.concatenate([g.features for g in pool])
        eng.begin_forward()
        y = port_api.gnn_apply(port.cfg, port.params, eng, torch.from_numpy(x))
        assert not y[n_real:].any()  # padding rows stay zero
