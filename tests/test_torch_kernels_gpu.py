"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips where there
is no card. Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports only the port (no JAX), so it runs where JAX is absent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.aggregation import to_device_plan
from repro_torch.core.scheduler import build_edge_tile_plan, build_mixed_precision_plans
from repro_torch.graphs.datasets import make_dataset, make_lognormal_graph
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.kernels.segment_agg.ref import aggregate_tiles_ref
from repro_torch.serve.gnn_engine import GNNServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _agg(x, dp, n, fn):
    return fn(x, dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split, num_nodes=n)


@pytest.mark.parametrize("d", [1, 4, 130, 300, 600])
@pytest.mark.parametrize("ept", [16, 64, 256])
def test_segment_agg_matches_plain(cuda, d, ept):
    n = 300
    g = make_lognormal_graph(n, 12.0, seed=d + ept)
    rng = np.random.default_rng(d)
    coeff = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)
    plan = build_edge_tile_plan(g, edges_per_tile=ept, coeff=coeff)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cpu = _agg(x, to_device_plan(plan, "cpu"), n, aggregate_tiles_ref)
    dp = to_device_plan(plan, cuda)
    xg = x.to(cuda)
    before = build.launch_counts().get(seg_ops.KERNEL, 0)
    out = _agg(xg, dp, n, seg_ops.aggregate_tiles)
    again = _agg(xg, dp, n, seg_ops.aggregate_tiles)
    torch.cuda.synchronize()
    assert build.launch_counts()[seg_ops.KERNEL] == before + 2
    assert torch.equal(out, again)  # no atomics: run-to-run bitwise
    plain = _agg(xg, dp, n, aggregate_tiles_ref)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), atol=1e-4)


def test_segment_agg_padded_union_rows_stay_zero(cuda):
    g = make_lognormal_graph(200, 30.0, seed=1)
    tags = np.where(np.arange(200) % 7 == 0, "float", "int8")
    plans = build_mixed_precision_plans(g, tags, edges_per_tile=64)
    x = torch.randn(200, 32, device=cuda)
    for tag, p in plans.items():
        out = _agg(x, to_device_plan(p, cuda), 200, seg_ops.aggregate_tiles)
        other = torch.as_tensor(np.nonzero(tags != tag)[0], device=cuda)
        assert torch.count_nonzero(out[other]) == 0


@pytest.mark.parametrize(
    "m,k,n", [(1, 1, 1), (8, 8, 8), (100, 64, 48), (33, 130, 7), (1000, 300, 256), (517, 256, 100)]
)
def test_quant_matmul_bitwise(cuda, m, k, n):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    want = quant_matmul_ref(a.cpu(), b.cpu())
    out = qm_ops.quant_matmul_repacked(a, qm_ops.repack_weight(b))
    assert out.dtype == torch.int32
    assert torch.equal(out.cpu(), want)
    assert torch.equal(qm_ops.quant_matmul(a, b).cpu(), want)
    assert torch.equal(quant_matmul_ref(a, b).cpu(), want)


def test_quant_matmul_extremes_and_unaligned_rows(cuda):
    k = 300
    a = torch.full((70, k), -128, dtype=torch.int8, device=cuda)
    b = torch.full((k, 65), -128, dtype=torch.int8, device=cuda)
    out = qm_ops.quant_matmul(a, b)
    assert int(out[0, 0]) == k * 128 * 128
    assert torch.equal(out.cpu(), quant_matmul_ref(a.cpu(), b.cpu()))
    # rows that start off a 4-byte boundary take the kernel's byte loads
    m = 45
    flat = torch.randint(-128, 128, (m * k + 1,), dtype=torch.int8, device=cuda)
    a2 = flat[1:].view(m, k)
    assert a2.data_ptr() % 4 != 0
    assert torch.equal(qm_ops.quant_matmul(a2, b).cpu(), quant_matmul_ref(a2.cpu(), b.cpu()))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    packed = qm_ops.repack_weight(torch.zeros((16, 8), dtype=torch.int8, device=cuda))
    with pytest.raises(TypeError):
        qm_ops.quant_matmul_repacked(torch.zeros((4, 16), dtype=torch.int32, device=cuda), packed)
    with pytest.raises(ValueError):
        qm_ops.quant_matmul_repacked(torch.zeros((4, 15), dtype=torch.int8, device=cuda), packed)
    g = make_lognormal_graph(40, 3.0, seed=0)
    dp = to_device_plan(build_edge_tile_plan(g, edges_per_tile=16), cuda)
    with pytest.raises(TypeError):
        _agg(torch.zeros((40, 8), dtype=torch.float64, device=cuda), dp, 40, seg_ops.aggregate_tiles)
    with pytest.raises(ValueError):
        _agg(torch.zeros((40, 8), device=cuda)[:, ::2], dp, 40, seg_ops.aggregate_tiles)


def test_serving_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("ample-gcn"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=400, max_feature_dim=300, seed=2)
    gpu = GNNServeEngine(cfg, device=cuda)
    cpu = GNNServeEngine(cfg, params=gpu.params, device="cpu")
    build.reset_launch_counts()
    cold = gpu.infer(g, g.features)
    warm = gpu.infer(g, g.features)
    assert build.launch_counts() == {seg_ops.KERNEL: 8, qm_ops.KERNEL: 4}
    assert np.array_equal(cold.outputs, warm.outputs)
    ref = cpu.infer(g, g.features).outputs
    np.testing.assert_allclose(cold.outputs, ref, atol=6e-2, rtol=2e-3)
    assert (np.abs(cold.outputs - ref) > 2e-3).mean() < 0.05
