"""The port's serving engine against the reference's, and its device contract.

Served on the CPU (``device="cpu"``), where the kernels' plain versions run.
Outputs are compared at the mixed-precision tolerance of
tests/test_gnn_models.py:79-80; warm requests must equal cold ones bitwise.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.graphs.datasets import make_dataset
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro_torch.graphs.csr import Graph
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine, request_stamp

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _pair(buckets=(0, 0), **overrides):
    rcfg, pcfg = cfg_pair(d_model=24, d_ff=16, vocab_size=8, gnn_edges_per_tile=64,
                          gnn_union_node_bucket=buckets[0],
                          gnn_union_edge_bucket=buckets[1], **overrides)
    rp, pp = params_pair(rcfg, pcfg, seed=7)
    return RefServe(rcfg, rp), GNNServeEngine(pcfg, pp, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    return [make_dataset("cora", max_nodes=n, max_feature_dim=24, seed=s)
            for n, s in ((150, 1), (110, 2), (180, 3))]


@pytest.mark.parametrize("buckets", [(0, 0), (256, 2048)])
def test_infer_matches_reference_and_warm_equals_cold(graphs, buckets):
    ref, port = _pair(buckets)
    g = graphs[0]
    want = ref.infer(g, g.features).outputs
    cold = port.infer(_port_graph(g), g.features)
    warm = port.infer(_port_graph(g), g.features)
    assert not cold.cache_hit and warm.cache_hit and warm.plan_ms == 0.0
    assert np.array_equal(cold.outputs, warm.outputs)
    assert cold.outputs.shape == (g.num_nodes, 8)
    assert_mixed_close(cold.outputs, want)
    info = port.cache_info()
    assert info["requests"] == 2 and info["cache_hits"] == 1 and info["planner_calls"] == 1
    assert info["size"] == 1


@pytest.mark.parametrize("buckets", [(0, 0), (256, 2048)])
def test_infer_batch_matches_reference(graphs, buckets):
    ref, port = _pair(buckets)
    want = ref.infer_batch([RefRequest(graph=g, features=g.features) for g in graphs])
    got = port.infer_batch([GNNRequest(graph=_port_graph(g), features=g.features)
                            for g in graphs])
    again = port.infer_batch([GNNRequest(graph=_port_graph(g), features=g.features)
                              for g in graphs])
    for w, a, b, g in zip(want, got, again, graphs):
        assert a.batch_size == 3 and a.outputs.shape == (g.num_nodes, 8)
        assert np.array_equal(a.outputs, b.outputs)
        assert_mixed_close(a.outputs, w.outputs)
    assert port.stats["batches"] == 2 and port.stats["requests"] == 6
    if buckets[0]:
        assert port.stats["member_misses"] == 3 and port.stats["member_hits"] == 3


def test_padded_member_plans_are_reused(graphs):
    _, port = _pair((256, 2048))
    port.infer(_port_graph(graphs[1]), graphs[1].features)
    port.infer_batch([GNNRequest(graph=_port_graph(g), features=g.features) for g in graphs])
    assert port.stats["member_hits"] == 1 and port.stats["member_misses"] == 3
    assert port.stats["class_misses"] == 2


def test_float_policy_matches_reference(graphs):
    ref, port = _pair(gnn_precision="float")
    g = graphs[2]
    np.testing.assert_allclose(port.infer(_port_graph(g), g.features).outputs,
                               ref.infer(g, g.features).outputs, atol=5e-4, rtol=1e-3)


def test_queue_ms_and_request_checks(graphs):
    _, port = _pair()
    g = graphs[0]
    r = port.infer(_port_graph(g), g.features, admitted_at=request_stamp() - 0.05)
    assert r.queue_ms >= 50.0
    with pytest.raises(ValueError, match="columns"):
        port.infer(_port_graph(g), g.features[:, :5])
    with pytest.raises(ValueError, match="rows"):
        port.infer(_port_graph(g), g.features[:-1])
    with pytest.raises(ValueError, match="route"):
        port.infer(_port_graph(g), g.features, arch="gin")


def test_engine_without_a_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = cfg_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServeEngine(pcfg)
    port = GNNServeEngine(pcfg, device="cpu")
    assert port.device == torch.device("cpu")
    assert all(lyr["w"].device.type == "cpu" for lyr in port.params["layers"])


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.configs.base as cb\n"
        "cb.list_configs()\n"
        "assert 'repro_torch.kernels.ssd_scan.ops' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=_SRC)
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


def test_port_init_is_seeded_by_its_generator():
    _, pcfg = cfg_pair(reduced=False)
    a = GNNServeEngine(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = GNNServeEngine(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    shapes = [tuple(lyr["w"].shape) for lyr in a.params["layers"]]
    assert shapes == [(300, 256), (256, 100)]
    assert all(torch.equal(x["w"], y["w"]) for x, y in
               zip(a.params["layers"], b.params["layers"]))
    limit = float(np.sqrt(6.0 / (300 + 256)))
    assert float(a.params["layers"][0]["w"].abs().max()) <= limit
