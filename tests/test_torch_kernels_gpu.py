"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips where there
is no card. Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports only the port (no JAX), so it runs where JAX is absent.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.aggregation import to_device_plan
from repro_torch.core.quantization import (
    QuantParams,
    compute_scale_zp,
    quantize,
    quantize_per_channel,
)
from repro_torch.core.transformation import transform_int8
from repro_torch.core.message_passing import AmpleEngine, EngineConfig, compile_plans
from repro_torch.core.scheduler import build_edge_tile_plan, build_mixed_precision_plans
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.datasets import make_dataset, make_lognormal_graph
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.kernels.segment_agg.ref import (
    aggregate_tiles_mh_ref,
    aggregate_tiles_ref,
    attend_tiles_bwd_ref,
    attend_tiles_ref,
    edge_dot_ref,
)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref
from repro_torch.memory.feature_store import FeatureStore
from repro_torch.memory import prefetcher
from repro_torch.memory.prefetcher import ChunkPrefetcher, StreamedFeatures
from repro_torch.models.api import (
    model_decode_step,
    model_forward,
    model_init,
    model_init_cache,
    model_prefill,
    params_to,
)
from repro_torch.models.gnn import api as gnn_api
from repro_torch.models.lm.moe import moe_apply
from repro_torch.models.lm.transformer import mixer_counts
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.gnn_engine import GNNServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _agg(x, dp, n, fn, qp=None, out=None):
    return fn(x, dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split, num_nodes=n, qp=qp,
              out=out)


def _age_rows(x, kind, dev, ld=None):
    """x [N, D] on ``dev`` as f32 rows or int8 codes (with QuantParams on
    ``dev``); codes written at a row stride of ``ld`` when given."""
    if kind == "f32":
        return x.to(dev), None
    qp = compute_scale_zp(x, symmetric=True)
    q = quantize(x, qp)
    if ld is not None:
        buf = torch.zeros((x.shape[0], ld), dtype=torch.int8)
        buf[:, :x.shape[1]] = q
        q = buf.to(dev)[:, :x.shape[1]]
    return q.to(dev), QuantParams(qp.scale.to(dev), qp.zero_point.to(dev))


def _check_age(cuda, x, dp_cpu, dp, n, kind, ld=None):
    """The AGE on the walk against its plain version on the card (atol 1e-4)
    and on the CPU (bitwise: each segment is summed in lane order by one lane
    group), run-to-run bitwise, one launch per call."""
    xc, qpc = _age_rows(x, kind, "cpu")
    xg, qpg = _age_rows(x, kind, cuda, ld)
    before = build.launch_counts().get(seg_ops.KERNEL, 0)
    out = _agg(xg, dp, n, seg_ops.aggregate_tiles, qpg)
    again = _agg(xg, dp, n, seg_ops.aggregate_tiles, qpg)
    torch.cuda.synchronize()
    assert build.launch_counts()[seg_ops.KERNEL] == before + 2
    assert torch.equal(out, again)  # no atomics: run-to-run bitwise
    assert torch.isfinite(out).all()
    for want in (_agg(xg, dp, n, aggregate_tiles_ref, qpg), _agg(xc, dp_cpu, n, aggregate_tiles_ref,
                                                                  qpc)):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    assert torch.equal(out.cpu(), want)  # the CPU's plain version, bitwise
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("d", [1, 4, 130, 300, 600])
@pytest.mark.parametrize("ept", [16, 64, 256])
def test_segment_agg_matches_plain(cuda, d, ept, kind):
    """The AGE on heads_walk_kernel (one head, the plan's coeff as lane
    weights), f32 rows and int8 codes."""
    n = 300
    g = make_lognormal_graph(n, 12.0, seed=d + ept)
    rng = np.random.default_rng(d)
    coeff = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)
    plan = build_edge_tile_plan(g, edges_per_tile=ept, coeff=coeff)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    _check_age(cuda, x, to_device_plan(plan, "cpu"), to_device_plan(plan, cuda), n, kind)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("ept", [16, 64, 256])
def test_segment_agg_lane_order_whatever_the_groups(cuda, ept, kind):
    """Each segment is summed in lane order by one lane group however many
    groups split a tile and however deep the ring: a hub's segment fills
    whole tiles, short ones cross the groups' nominal bounds. Every geometry
    gives the CPU's plain version bitwise."""
    n, d = 400, 40
    g = make_lognormal_graph(n, 6.0, seed=ept)
    hub = np.arange(n)  # node 0 takes every node as an in-neighbour
    g = Graph(indptr=np.concatenate([[0], n + np.cumsum(g.degrees)]).astype(g.indptr.dtype),
              indices=np.concatenate([hub, g.indices]).astype(g.indices.dtype), num_nodes=n)
    rng = np.random.default_rng(ept)
    coeff = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)
    plan = build_edge_tile_plan(g, edges_per_tile=ept, coeff=coeff)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    xc, qpc = _age_rows(x, kind, "cpu")
    xg, qpg = _age_rows(x, kind, cuda)
    dp, dp_cpu = to_device_plan(plan, cuda), to_device_plan(plan, "cpu")
    want = _agg(xc, dp_cpu, n, aggregate_tiles_ref, qpc)
    args = (dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
    chunk = seg_ops.walk_geometry(ept, dp.out_node.shape[1], 1, d, xg.element_size(),
                                  xg.data_ptr(), aligned=True).chunk_bytes
    for groups in (1, 2, 3, 5, 8):
        for k in (1, 2, 4, 16):
            wk = seg_ops._walk(ept, dp.out_node.shape[1], 1, d, xg.element_size(), chunk,
                               groups, k)
            out = seg_ops._launch(xg, qpg, *args, n, torch.zeros((n, d), device=cuda), wk)
            assert torch.equal(out.cpu(), want), (groups, k)


def test_segment_agg_padded_union_rows_stay_zero(cuda):
    """Each precision group writes only its own nodes' rows (f32 rows and
    int8 codes): the other group's rows of a fresh output stay zero."""
    g = make_lognormal_graph(200, 30.0, seed=1)
    tags = np.where(np.arange(200) % 7 == 0, "float", "int8")
    plans = build_mixed_precision_plans(g, tags, edges_per_tile=64)
    x = torch.randn(200, 32)
    for kind in ("f32", "int8"):
        xg, qp = _age_rows(x, kind, cuda)
        for tag, p in plans.items():
            out = _agg(xg, to_device_plan(p, cuda), 200, seg_ops.aggregate_tiles, qp)
            other = torch.as_tensor(np.nonzero(tags != tag)[0], device=cuda)
            assert torch.count_nonzero(out[other]) == 0


# The GCN widths in both precision groups: f32 rows, int8 codes, and codes
# at d 300 written at a row stride of 304 bytes (16-byte chunks whose last
# reads the padding).
@pytest.mark.parametrize("d,kind,ld", [(300, "f32", None), (256, "f32", None),
                                       (300, "int8", None), (256, "int8", None),
                                       (300, "int8", 304)])
def test_segment_agg_gcn_widths_in_both_groups(cuda, d, kind, ld):
    g = make_lognormal_graph(3000, 14.0, seed=d)
    tags = np.where(np.arange(3000) % 11 == 0, "float", "int8")
    rng = np.random.default_rng(d)
    coeff = rng.uniform(0.2, 1.0, g.num_edges).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((3000, d)).astype(np.float32))
    for p in build_mixed_precision_plans(g, tags, edges_per_tile=256, coeff=coeff).values():
        assert p.num_tiles > 8
        _check_age(cuda, x, to_device_plan(p, "cpu"), to_device_plan(p, cuda), 3000, kind, ld)


def test_segment_agg_codes_at_the_extremes(cuda):
    """Codes at +-127 (and -128) with a nonzero zero point: the walk's
    dequantization is the plain version's."""
    g = make_lognormal_graph(300, 12.0, seed=5)
    plan = build_edge_tile_plan(g, edges_per_tile=64)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.choice(np.array([-128, -127, 127, 0, 5], np.int8), (300, 48)))
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}

    def run(fn, dev):
        qp = QuantParams(torch.tensor(0.0371, device=dev), torch.tensor(-3.0, device=dev))
        return _agg(q.to(dev), dps[dev], 300, fn, qp)

    out = run(seg_ops.aggregate_tiles, "cuda")
    assert torch.equal(out, run(seg_ops.aggregate_tiles, "cuda"))
    for want in (run(aggregate_tiles_ref, "cuda"), run(aggregate_tiles_ref, "cpu")):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=1e-4)


def test_segment_agg_groups_share_one_output(cuda):
    """The int8 group written into the float group's output leaves the float
    group's rows untouched, and the shared output equals zeros + float +
    int8 (torch.equal)."""
    g = make_lognormal_graph(400, 20.0, seed=6)
    tags = np.where(np.arange(400) % 5 == 0, "float", "int8")
    plans = {t: to_device_plan(p, cuda)
             for t, p in build_mixed_precision_plans(g, tags, edges_per_tile=64).items()}
    x = torch.randn(400, 300, device=cuda)
    codes, qp = _age_rows(x.cpu(), "int8", cuda)
    out = _agg(x, plans["float"], 400, seg_ops.aggregate_tiles)
    float_rows = out.clone()
    shared = _agg(codes, plans["int8"], 400, seg_ops.aggregate_tiles, qp, out=out)
    assert shared is out
    fl = torch.as_tensor(np.nonzero(tags == "float")[0], device=cuda)
    assert torch.equal(out[fl], float_rows[fl])
    alone = _agg(codes, plans["int8"], 400, seg_ops.aggregate_tiles, qp)
    assert torch.equal(out, torch.zeros_like(out) + float_rows + alone)


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


# Tensor-core GEMM edges: M off the 128-row tile, K off the 32-byte k step
# and off the 16- and 4-byte copies (1, 31, 130 take byte loads, 300 4-byte
# copies), N off the 8-column mma tile and the 128-column group; then the
# largest weight that stays resident in shared memory (K 704) and weights
# that stream through it in K chunks (K 720, K 4096; K 4097 with the
# shifted loads of rows off a word boundary).
@pytest.mark.parametrize("k", [1, 31, 130, 300])
@pytest.mark.parametrize("n", [7, 100, 400])
def test_quant_matmul_tensor_core_edges_bitwise(cuda, k, n):
    _int8_bitwise(cuda, 300, k, n, seed=k * 1000 + n)


@pytest.mark.parametrize(
    "m,k,n", [(1000, 4096, 512), (129, 704, 256), (257, 720, 130), (70, 4097, 130)]
)
def test_quant_matmul_resident_and_streamed_weight_bitwise(cuda, m, k, n):
    _int8_bitwise(cuda, m, k, n, seed=m + k + n)


def _int8_bitwise(cuda, m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    before = build.launch_counts().get(qm_ops.KERNEL, 0)
    out = qm_ops.quant_matmul_repacked(a, qm_ops.repack_weight(b))
    torch.cuda.synchronize()
    assert build.launch_counts()[qm_ops.KERNEL] == before + 1
    assert torch.equal(out.cpu(), quant_matmul_ref(a.cpu(), b.cpu()))


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


# GIN's and SAGE's GEMM shapes: K 300 x N 300 (SAGE's φ in layer 1), K 256 x
# N 256 (GIN's second linear in layer 1, SAGE's φ in layer 2), K 100 x N 100
# (GIN's last linear; 100-byte rows, not a 16-byte multiple).
@pytest.mark.parametrize("k,n", [(300, 300), (256, 256), (100, 100)])
@pytest.mark.parametrize("m", [1, 4099])
def test_quant_matmul_gin_sage_shapes_bitwise(cuda, m, k, n):
    _int8_bitwise(cuda, m, k, n, seed=m + 7 * k)


def _isolated_graph(n=500, every=7, seed=3):
    """A lognormal graph whose every ``every``-th node has no in-edges."""
    full = make_lognormal_graph(n, 10.0, seed=seed)
    isolated = np.arange(0, n, every)
    dst = np.repeat(np.arange(n), full.degrees)
    deg = np.where(np.isin(np.arange(n), isolated), 0, full.degrees)
    g = Graph(indptr=np.concatenate([[0], np.cumsum(deg)]).astype(full.indptr.dtype),
              indices=full.indices[~np.isin(dst, isolated)], num_nodes=n)
    return g, isolated


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [100, 256, 300])
def test_age_zero_degree_rows_stay_exactly_zero(cuda, mode, d):
    """GIN's ``sum`` and SAGE's ``mean`` plans on a raw graph with nodes
    without in-edges: both precision groups (f32 rows, int8 codes) write one
    zero-filled output, and the empty segments' rows stay exactly 0."""
    g, isolated = _isolated_graph()
    assert not g.degrees[isolated].any()
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((g.num_nodes, d))
                         .astype(np.float32))
    card = AmpleEngine(g, EngineConfig(edges_per_tile=64))
    cpu = AmpleEngine(g, card.cfg)
    assert set(card.plans(mode)) == {"int8", "float"}
    before = build.launch_counts().get(seg_ops.KERNEL, 0)
    out = card.aggregate(x.to(cuda), mode=mode)
    again = card.aggregate(x.to(cuda), mode=mode)
    torch.cuda.synchronize()
    assert build.launch_counts()[seg_ops.KERNEL] == before + 4  # two groups, twice
    assert torch.equal(out, again)
    assert torch.count_nonzero(out[torch.as_tensor(isolated, device=cuda)]) == 0
    want = cpu.aggregate(x, mode=mode)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), atol=1e-4)
    assert torch.equal(out.cpu(), want)  # lane-order sums: the plain version, bitwise


@pytest.mark.parametrize("arch,gemms", [("gin", 4), ("sage", 6)])
def test_gin_sage_serving_on_card_matches_cpu(cuda, arch, gemms):
    """FULL ample-gin / ample-sage widths on a cora-sized graph: 4 AGE
    launches and 4 (GIN) or 6 (SAGE) int8 GEMMs per request, warm == cold
    bitwise, card vs CPU at the mixed tolerance."""
    cfg = dataclasses.replace(get_config(f"ample-{arch}"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=400, max_feature_dim=300, seed=2)
    gpu = GNNServeEngine(cfg, device=cuda)
    cpu = GNNServeEngine(cfg, params=gpu.params, device="cpu")
    build.reset_launch_counts()
    cold = gpu.infer(g, g.features)
    warm = gpu.infer(g, g.features)
    assert build.launch_counts() == {seg_ops.KERNEL: 8, qm_ops.KERNEL: 2 * gemms}
    assert np.array_equal(cold.outputs, warm.outputs)
    ref = cpu.infer(g, g.features).outputs
    np.testing.assert_allclose(cold.outputs, ref, atol=6e-2, rtol=2e-3)
    assert (np.abs(cold.outputs - ref) > 2e-3).mean() < 0.05


# ------------------------------------------------------------- GAT kernels
def _attend(z, sc, dp, n, fn, qp=None):
    return fn(z, dp.gather_idx, dp.edge_ids, sc, dp.coeff, dp.seg_ids, dp.out_node, dp.split,
              num_nodes=n, leaky_slope=0.2, qp=qp)


def _mh(x, cf, dp, n, fn, qp=None):
    return fn(x, dp.gather_idx, dp.edge_ids, cf, dp.coeff, dp.seg_ids, dp.out_node, dp.split,
              num_nodes=n, qp=qp)


def _check_kernel(run, plain_fn, kernel_fn, name):
    """Kernel vs its plain version on the card and on the CPU, run-to-run
    bitwise, one launch per call."""
    before = build.launch_counts().get(name, 0)
    out = run(kernel_fn, "cuda")
    again = run(kernel_fn, "cuda")
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 2
    assert torch.equal(out, again)  # no atomics: run-to-run bitwise
    assert torch.isfinite(out).all()
    for want in (run(plain_fn, "cuda"), run(plain_fn, "cpu")):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    return out


def _hub_graph(n=700, hub=600, seed=0):
    """A lognormal graph plus node 0 with ``hub`` in-edges: 256-lane tiles
    hold whole-tile runs of node 0 (every lane group shares the segment) and
    split it across three tiles."""
    g = make_lognormal_graph(n, 6.0, seed=seed)
    rows = [np.arange(1, hub + 1, dtype=np.int32)] + [
        g.indices[g.indptr[i]:g.indptr[i + 1]] for i in range(1, n)]
    indptr = np.concatenate([[0], np.cumsum([r.size for r in rows])]).astype(np.int64)
    return Graph(indptr=indptr, indices=np.concatenate(rows).astype(np.int32), num_nodes=n)


def _gat_inputs(heads, dh, ept=64, n=300, seed=0, hub=False):
    g = _hub_graph(seed=seed) if hub else make_lognormal_graph(n, 12.0, seed=seed)
    rng = np.random.default_rng(seed)
    plan = build_edge_tile_plan(
        g, edges_per_tile=ept, coeff=rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((g.num_nodes, heads, dh)).astype(np.float32))
    edges = torch.from_numpy(
        rng.standard_normal((g.num_edges, heads)).astype(np.float32) * 3)
    return plan, x, edges


def _rows(x, rows, dev):
    """x on ``dev`` as f32 rows or int8 codes (with QuantParams on ``dev``);
    ``offset`` elements of slack put the rows off a 16-byte boundary."""
    kind, offset = rows
    if kind == "int8":
        qp = compute_scale_zp(x, symmetric=True)
        q = quantize(x, qp)
        qp = QuantParams(qp.scale.to(dev), qp.zero_point.to(dev))
        x = q
    else:
        qp = None
    if offset:
        flat = torch.zeros(x.numel() + offset, dtype=x.dtype)
        flat[offset:] = x.reshape(-1)
        flat = flat.to(dev)
        return flat[offset:].view(x.shape), qp
    return x.to(dev), qp


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("dh", [8, 64, 100])
def test_attention_matches_plain(cuda, heads, dh):
    plan, z, sc = _gat_inputs(heads, dh, seed=heads * 100 + dh)
    n = plan.num_nodes
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}
    _check_kernel(lambda fn, dev: _attend(z.to(dev), sc.to(dev), dps[dev], n, fn),
                  attend_tiles_ref, attn_ops.attend_tiles, attn_ops.ATTENTION)


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("dh", [8, 64, 100])
def test_segment_agg_mh_matches_plain(cuda, heads, dh):
    plan, x, cf = _gat_inputs(heads, dh, seed=heads * 10 + dh)
    cf = cf.abs()
    cf[::3, 0] = 0.0  # edges dead for head 0 only
    n = plan.num_nodes
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}
    _check_kernel(lambda fn, dev: _mh(x.to(dev), cf.to(dev), dps[dev], n, fn),
                  aggregate_tiles_mh_ref, attn_ops.aggregate_tiles_mh, attn_ops.SEGMENT_AGG_MH)


def _softmax_weights(plan, edges):
    """Per-edge softmax over each destination's in-edges (GAT's alpha):
    weights in (0, 1] that sum to 1 per node, so a 600-lane hub sums to the
    size of one row, as in the decomposed GAT layer."""
    dst = torch.from_numpy(np.repeat(np.arange(plan.num_nodes), np.diff(_plan_indptr(plan))))
    ex = torch.exp(edges - edges.max())
    den = torch.zeros((plan.num_nodes, edges.shape[1])).index_add_(0, dst, ex)
    return ex / den[dst]


def _plan_indptr(plan):
    """CSR row pointers of the plan's graph, from the lanes' destinations."""
    live = plan.edge_ids >= 0
    dst = np.empty(plan.total_edges, np.int64)
    t_idx = np.nonzero(live)[0]
    dst[plan.edge_ids[live]] = plan.out_node[t_idx, plan.seg_ids[live]]
    return np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=plan.num_nodes))])


# Rows as f32 and as int8 codes, 16-byte aligned and not (an offset of one
# element: 4-byte chunks for f32, 1-byte for codes; 4 codes: 4-byte chunks);
# lane counts that give two- and four-stage rings; a 256-lane hub.
ROWS = [("f32", 0), ("int8", 0), ("f32", 1), ("int8", 1), ("int8", 4)]


@pytest.mark.parametrize("rows", ROWS, ids=lambda r: f"{r[0]}+{r[1]}")
@pytest.mark.parametrize("heads,dh", [(4, 64), (4, 100), (2, 12), (1, 8), (4, 5)])
@pytest.mark.parametrize("ept,hub", [(16, False), (64, False), (256, True)])
def test_gat_kernels_rows_at_their_precision_match_plain(cuda, rows, heads, dh, ept, hub):
    plan, x, edges = _gat_inputs(heads, dh, ept=ept, seed=heads + dh + ept, hub=hub)
    n = plan.num_nodes
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}
    xs = {dev: _rows(x, rows, dev) for dev in ("cpu", "cuda")}
    assert rows[1] == 0 or xs["cuda"][0].data_ptr() % 16 != 0
    cf = _softmax_weights(plan, edges)  # what the decomposed layer feeds the mh kernel
    _check_kernel(lambda fn, dev: _attend(xs[dev][0], edges.to(dev), dps[dev], n, fn,
                                          qp=xs[dev][1]),
                  attend_tiles_ref, attn_ops.attend_tiles, attn_ops.ATTENTION)
    _check_kernel(lambda fn, dev: _mh(xs[dev][0], cf.to(dev), dps[dev], n, fn, qp=xs[dev][1]),
                  aggregate_tiles_mh_ref, attn_ops.aggregate_tiles_mh, attn_ops.SEGMENT_AGG_MH)


@pytest.mark.parametrize("rows", [("f32", 0), ("int8", 0)], ids=lambda r: r[0])
@pytest.mark.parametrize("heads,dh", [(4, 1), (4, 5), (4, 100)])
@pytest.mark.parametrize("ept", [16, 64])
def test_gat_kernels_walk_many_tiles_per_block(cuda, rows, heads, dh, ept):
    """Enough tiles that each block of the persistent grid walks several,
    staging the next tile's metadata and scores during the current one (dh 1
    is the softmax denominator's rows of ones; at 16 lanes a tile is one or
    two ring steps)."""
    plan, x, edges = _gat_inputs(heads, dh, ept=ept, n=6000, seed=ept + dh)
    assert plan.num_tiles > 132 * 8
    n = plan.num_nodes
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}
    xs = {dev: _rows(x, rows, dev) for dev in ("cpu", "cuda")}
    _check_kernel(lambda fn, dev: _attend(xs[dev][0], edges.to(dev), dps[dev], n, fn,
                                          qp=xs[dev][1]),
                  attend_tiles_ref, attn_ops.attend_tiles, attn_ops.ATTENTION)
    cf = _softmax_weights(plan, edges)
    _check_kernel(lambda fn, dev: _mh(xs[dev][0], cf.to(dev), dps[dev], n, fn, qp=xs[dev][1]),
                  aggregate_tiles_mh_ref, attn_ops.aggregate_tiles_mh, attn_ops.SEGMENT_AGG_MH)


def test_gat_kernels_int8_codes_at_the_extremes(cuda):
    """Codes at +-127 (and -128) with a nonzero zero point: the kernel's
    dequantization is the plain version's."""
    plan, _, edges = _gat_inputs(4, 16, seed=7)
    n = plan.num_nodes
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.choice(np.array([-128, -127, 127, 0, 5], np.int8), (n, 4, 16)))
    dps = {"cpu": to_device_plan(plan, "cpu"), "cuda": to_device_plan(plan, cuda)}

    def qp(dev):
        return QuantParams(torch.tensor(0.0371, device=dev), torch.tensor(-3.0, device=dev))

    _check_kernel(lambda fn, dev: _attend(q.to(dev), edges.to(dev), dps[dev], n, fn, qp=qp(dev)),
                  attend_tiles_ref, attn_ops.attend_tiles, attn_ops.ATTENTION)
    _check_kernel(lambda fn, dev: _mh(q.to(dev), edges.abs().to(dev), dps[dev], n, fn,
                                      qp=qp(dev)),
                  aggregate_tiles_mh_ref, attn_ops.aggregate_tiles_mh, attn_ops.SEGMENT_AGG_MH)


def _edge_case_plan():
    """Hand-built tiles (E = S = 8, 5 nodes, 32 graph edges): node 0 split
    over three tiles, unused segments between real ones and the padding
    segment, padding lanes (edge id -1), a node whose lanes all score -inf,
    scores near -1e30, and an all-padding tile."""
    e, s, n = 8, 8, 5
    sentinel = n
    gather = np.array([[1, 2, 3, 4, 1, 2, 3, 4],
                       [3, 4, 0, 2, 3, 0, 0, 0],
                       [4, 1, 0, 1, 2, 3, 0, 0],
                       [0] * 8], np.int32)
    seg = np.array([[0] * 8,
                    [0, 0, 0, 1, 1, 7, 7, 7],
                    [0, 0, 2, 2, 3, 3, 7, 7],
                    [7] * 8], np.int32)
    out_node = np.full((4, s), sentinel, np.int32)
    out_node[0, 0] = 0
    out_node[1, :2] = (0, 1)
    out_node[2, [0, 2, 3]] = (0, 2, 3)
    edge_ids = np.where(gather == 0, -1, np.arange(32).reshape(4, 8)).astype(np.int32)
    edge_ids[1, 2] = 10  # a real lane gathering row 0
    edge_ids[2, 2] = 18
    coeff = (edge_ids >= 0).astype(np.float32)
    return dict(gather=gather, seg=seg, out_node=out_node, coeff=coeff,
                edge_ids=edge_ids, n=n, e=e, s=s)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_kernels_edge_cases(cuda, heads):
    p = _edge_case_plan()
    split = seg_ops.split_segment_map(p["out_node"], p["seg"], p["n"])
    assert split.split_node.tolist() == [0] and split.split_ptr.tolist() == [0, 3]
    rng = np.random.default_rng(heads)
    dh = 3
    x = torch.from_numpy(rng.standard_normal((p["n"], heads, dh)).astype(np.float32))
    sc = rng.standard_normal((32, heads)).astype(np.float32)
    sc[18:20] = -1e30 + sc[18:20]  # node 2 (tile 2, lanes 2-3): scores near -1e30
    sc[20:22] = -np.inf             # node 3 (tile 2, lanes 4-5): every lane -inf
    cf = rng.uniform(0.1, 1, (32, heads)).astype(np.float32)
    if heads > 1:
        cf[11, 1] = 0.0  # one lane (tile 1, lane 3) zero for head 1 only
    sc, cf = torch.from_numpy(sc), torch.from_numpy(cf)

    def dplan(dev):
        return SimpleNamespace(
            **{k: torch.as_tensor(p[a], device=dev) for k, a in (
                ("gather_idx", "gather"), ("coeff", "coeff"), ("seg_ids", "seg"),
                ("out_node", "out_node"), ("edge_ids", "edge_ids"))},
            split=split.to(dev))

    dps = {"cpu": dplan("cpu"), "cuda": dplan(cuda)}
    att = _check_kernel(lambda fn, dev: _attend(x.to(dev), sc.to(dev), dps[dev], p["n"], fn),
                        attend_tiles_ref, attn_ops.attend_tiles, attn_ops.ATTENTION)
    assert not att[3].any() and not att[4].any()  # all -inf lanes / no lanes: 0
    assert att[2].abs().max() > 0
    mh = _check_kernel(lambda fn, dev: _mh(x.to(dev), cf.to(dev), dps[dev], p["n"], fn),
                       aggregate_tiles_mh_ref, attn_ops.aggregate_tiles_mh,
                       attn_ops.SEGMENT_AGG_MH)
    assert not mh[4].any()


def test_gat_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    plan, x, sc = _gat_inputs(2, 8, n=60)
    cpu_dp, dp = to_device_plan(plan, "cpu"), to_device_plan(plan, cuda)
    n = plan.num_nodes
    with pytest.raises(ValueError, match="tile arrays"):
        _attend(x.to(cuda), sc.to(cuda), cpu_dp, n, attn_ops.attend_tiles)
    with pytest.raises(ValueError, match="tile arrays"):
        _attend(x, sc, dp, n, attn_ops.attend_tiles)
    with pytest.raises(ValueError, match="tile arrays"):
        _mh(x, sc.abs(), dp, n, attn_ops.aggregate_tiles_mh)
    with pytest.raises(ValueError, match="heads"):
        _mh(x.to(cuda), sc[:, :1].contiguous().to(cuda), dp, n, attn_ops.aggregate_tiles_mh)
    with pytest.raises(TypeError):
        _attend(x.double().to(cuda), sc.to(cuda), dp, n, attn_ops.attend_tiles)
    with pytest.raises(TypeError):  # codes without their QuantParams
        _attend(x.to(torch.int8).to(cuda), sc.to(cuda), dp, n, attn_ops.attend_tiles)
    with pytest.raises(ValueError, match="contiguous"):
        _attend(x.to(cuda).transpose(1, 2).contiguous().transpose(1, 2), sc.to(cuda), dp, n,
                attn_ops.attend_tiles)
    big = build_edge_tile_plan(make_lognormal_graph(60, 80.0, seed=1), edges_per_tile=4096)
    bdp = to_device_plan(big, cuda)
    bsc = torch.zeros((big.total_edges, 4), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        _attend(torch.zeros((60, 4, 2), device=cuda), bsc, bdp, 60, attn_ops.attend_tiles)


def test_gat_decomposed_layer_matches_fused_on_card(cuda):
    cfg = get_config("ample-gat")
    g = gnn_api.prepare_graph(cfg, make_lognormal_graph(500, 20.0, seed=4))
    tags = np.where(np.arange(500) % 9 == 0, "float", "int8")
    eng = AmpleEngine(g, plan=compile_plans(g, gnn_api.engine_config(cfg), modes=("runtime",),
                                            precision_tags=tags))
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((500, 4, 100)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(rng.standard_normal((g.num_edges, 4)).astype(np.float32)).to(cuda)
    build.reset_launch_counts()
    fused = eng.attention_aggregate(s, z)
    alpha = eng.edge_softmax(torch.where(s >= 0, s, 0.2 * s))
    dec = eng.aggregate(z, mode="runtime", edge_coeff=alpha)
    again = eng.aggregate(z, mode="runtime", edge_coeff=eng.edge_softmax(
        torch.where(s >= 0, s, 0.2 * s)))
    torch.cuda.synchronize()
    groups = len(eng.plans("runtime"))
    assert build.launch_counts() == {attn_ops.ATTENTION: groups,
                                     attn_ops.SEGMENT_AGG_MH: 4 * groups}
    assert torch.equal(dec, again)
    np.testing.assert_allclose(dec.cpu().numpy(), fused.cpu().numpy(), atol=5e-5, rtol=1e-4)


def test_gat_serving_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(get_config("ample-gat"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=400, max_feature_dim=300, seed=2)
    gpu = GNNServeEngine(cfg, device=cuda)
    cpu = GNNServeEngine(cfg, params=gpu.params, device="cpu")
    build.reset_launch_counts()
    cold = gpu.infer(g, g.features)
    warm = gpu.infer(g, g.features)
    assert build.launch_counts() == {attn_ops.ATTENTION: 8, qm_ops.KERNEL: 4}
    assert np.array_equal(cold.outputs, warm.outputs) and warm.plan_ms == 0.0
    assert cold.outputs.shape == (400, 100) and np.isfinite(cold.outputs).all()
    ref = cpu.infer(g, g.features).outputs
    np.testing.assert_allclose(cold.outputs, ref, atol=6e-2, rtol=2e-3)
    assert (np.abs(cold.outputs - ref) > 2e-3).mean() < 0.05


# ------------------------------------------------------------- out-of-core
@pytest.mark.parametrize("d", [8, 300])
def test_host_int8_chunks_equal_the_cards_quantize(cuda, d):
    """The store's host codes (and the FTE stream's host quantization under
    another scale) are bitwise the card's ``quantize``: a fused or contracted
    quantize on the card would break streamed == in-memory."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((1000, d)) * 3).astype(np.float32)
    x[0, 0] = 127.0  # scale 1: the next entries sit on rounding ties
    x[1, : min(d, 6)] = [2.5, -3.5, 0.5, -0.5, 126.5, -126.5][: min(d, 6)]
    store = FeatureStore.from_array(x, chunk_rows=128, pin_memory=True)
    xt = torch.from_numpy(x).to(cuda)
    qp = compute_scale_zp(xt, symmetric=True)
    assert qp.scale.item() == float(store.agg_scale) == 1.0
    np.testing.assert_array_equal(store.stream_rows("i8")[:1000], quantize(xt, qp).cpu().numpy())
    sf = StreamedFeatures(store, 1, device=cuda)
    assert sf.agg_qp().scale.device.type == "cuda"
    np.testing.assert_array_equal(quantize(xt, sf.agg_qp()).cpu().numpy(),
                                  store.stream_rows("i8")[:1000])
    for factor in (0.37, 1.9):
        scale = np.float32(store.agg_scale * np.float32(factor))
        qp2 = QuantParams(torch.tensor(scale, device=cuda), torch.zeros((), device=cuda))
        want = quantize(xt, qp2).cpu().numpy()
        np.testing.assert_array_equal(FeatureStore._quantize_block(x, scale), want)
        np.testing.assert_array_equal(store.stream_rows("i8", scale)[:1000], want)


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
def test_streamed_request_on_card_is_bitwise_its_in_memory_run(cuda, arch, monkeypatch):
    """FULL widths on a cora-sized graph at a 1/8 budget: the streamed
    request is bitwise the in-memory card request, launches the AGE (GCN,
    GIN: the streamed layer's batches and the dense layer) and the int8 GEMM,
    and the stream's tile step never calls ``index_add_``; a second depth-2
    request replays the stream programs the first built, bitwise."""
    cfg = dataclasses.replace(get_config(f"ample-{arch}"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=2000, max_feature_dim=300, seed=3)
    mem = GNNServeEngine(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    want = mem.infer(g, g.features).outputs
    srv = GNNServeEngine(cfg, params=mem.params, feature_budget_bytes=g.features.nbytes // 8,
                         feature_chunk_rows=128, device=cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ on the streamed path")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    for depth in (2, 2, 0):
        srv.stream_prefetch_depth = depth
        build.reset_launch_counts()
        r = srv.infer(g, g.features)
        counts = build.launch_counts()
        assert r.streamed and np.array_equal(r.outputs, want)
        assert counts.get(qm_ops.KERNEL, 0) > 0
        if arch in ("gcn", "gin"):
            assert counts.get(seg_ops.KERNEL, 0) >= 4 and r.bytes_streamed > 0
            assert (r.copy_ms > 0.0) == (depth > 0) and 0.0 <= r.prefetch_overlap <= 1.0


@pytest.mark.parametrize("batch_lanes", [512, 1 << 16])
def test_pinned_staging_gives_the_bits_of_synchronous_staging(cuda, batch_lanes, monkeypatch):
    """A pinned store staged on the side stream (depth 2, 5) against the
    synchronous replay (depth 0) and the in-memory card aggregate, on both
    streams, in many AGE launches or one."""
    from repro_torch.core import scheduler

    g = make_lognormal_graph(3000, 8.0, seed=5)
    x = np.random.default_rng(5).standard_normal((3000, 64)).astype(np.float32)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64))
    want = eng.aggregate(torch.from_numpy(x).to(cuda), mode="gcn")
    store = FeatureStore.from_array(x, chunk_rows=128, pin_memory=True)
    assert store.pinned and store.stream_tensor("f32").is_pinned()
    for depth in (0, 2, 5):
        sf = StreamedFeatures(store, store.nbytes // 6, prefetch_depth=depth, device=cuda)
        assert torch.equal(eng.aggregate(sf, mode="gcn"), want)
        assert (sf.stats.copy_ms > 0.0) == (depth > 0)
        assert 0.0 <= sf.stats.prefetch_overlap <= 1.0
    plan = eng.plans("gcn")["float"]
    schedule = scheduler.build_chunk_schedule(plan, 128)
    out = torch.zeros_like(want)
    before = build.launch_counts().get(seg_ops.KERNEL, 0)
    monkeypatch.setattr(prefetcher, "BATCH_LANES", batch_lanes)
    for depth in (0, 2):
        got = ChunkPrefetcher(store, schedule, stream="f32", budget_bytes=store.nbytes // 6,
                              prefetch_depth=depth, device=cuda).aggregate(plan, out=out.clone())
        rows = torch.as_tensor(plan.node_ids, device=cuda).long()
        assert torch.equal(got[rows], want[rows])
    launches = build.launch_counts()[seg_ops.KERNEL] - before
    assert (launches > 2) == (batch_lanes < plan.num_tiles * 64)  # one launch per batch


# ------------------------------------------------------------- LM kernels
def _close(out, want, bf16):
    """f32: 1e-4 (order of sums); bf16: both keep p in f32 and round only the
    output, so two bf16 ulps at magnitude 1."""
    atol = 1.6e-2 if bf16 else 1e-4
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol,
                               rtol=0 if bf16 else 1e-4)


def _bf16_equal_share(out, want):
    """Share of bf16 entries bitwise equal. A computation that keeps p in f32
    differs from the plain version only in the order of its sums (~2^-18
    relative) and flips well under 1% of the output's roundings; one bf16 p
    errs by up to 2^-9 and flips a large share of them."""
    return float((out.cpu() == want.cpu()).float().mean())


# GQA groups 3 (Granite-MoE: 24/8 heads, hd 64) and 5 (Llama-4 Maverick:
# 40/8, hd 128) at both head dims, and 7 (Qwen2-VL-7B: 28/4, hd 128).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,s,t,h,kv", [
    (16, 16, 16, 2, 2), (20, 200, 200, 3, 1), (64, 300, 300, 15, 5), (128, 130, 130, 8, 2),
    (128, 1000, 1000, 12, 2), (64, 40, 100, 6, 1), (128, 1, 65, 4, 4),
    (64, 256, 256, 24, 8), (128, 200, 200, 24, 8), (64, 300, 300, 40, 8),
    (128, 256, 256, 40, 8), (128, 256, 256, 28, 4),
])
def test_flash_attention_matches_plain(cuda, dtype, hd, s, t, h, kv):
    gen = torch.Generator(device=cuda).manual_seed(hd + s + h)
    q = torch.randn((2, s, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(dtype)
    before = build.launch_counts().get(fa_ops.KERNEL, 0)
    before_tc = build.launch_counts().get(fa_ops.TC_KERNEL, 0)
    out = fa_ops.flash_attention(q, k, v)
    again = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert build.launch_counts()[fa_ops.KERNEL] == before + 2
    # bf16 with hd 64 and 128 runs on the tensor cores, everything else on the CUDA cores
    tc = dtype == torch.bfloat16 and hd in (64, 128)
    assert build.launch_counts().get(fa_ops.TC_KERNEL, 0) == before_tc + (2 if tc else 0)
    assert out.dtype == dtype and torch.equal(out, again)  # run-to-run bitwise
    assert torch.isfinite(out).all()
    bf16 = dtype == torch.bfloat16
    plain = flash_attention_ref(q, k, v)
    _close(out, plain, bf16)
    _close(out, flash_attention_ref(q.cpu(), k.cpu(), v.cpu()), bf16)
    if bf16:
        assert _bf16_equal_share(out, plain) >= 0.99


# Unmasked (an encoder's self-attention and cross-attention): S < T (a
# target prefix over 1,024 source frames), S = T, S > T, S = 1 (a decode
# step's cross-attention), T ragged against the 64-key blocks, at hd 64 and
# 128 (bf16: the tensor-core kernel) and 16 and 20 (the CUDA-core kernel in
# both dtypes), GQA groups 1, 2 and 7.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,s,t,h,kv", [
    (64, 36, 1024, 16, 16), (64, 300, 300, 16, 16), (128, 200, 70, 28, 4), (64, 1, 1024, 16, 16),
    (128, 1, 201, 28, 4), (64, 130, 1000, 8, 4), (16, 40, 100, 4, 2), (20, 65, 33, 3, 1),
    (128, 70, 129, 7, 1),
])
def test_flash_attention_noncausal_matches_plain(cuda, dtype, hd, s, t, h, kv):
    gen = torch.Generator(device=cuda).manual_seed(hd + s + t + h)
    q = torch.randn((2, s, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(dtype)
    before = build.launch_counts().get(fa_ops.KERNEL, 0)
    before_tc = build.launch_counts().get(fa_ops.TC_KERNEL, 0)
    before_nc = build.launch_counts().get(fa_ops.NONCAUSAL_KERNEL, 0)
    out = fa_ops.flash_attention(q, k, v, causal=False)
    again = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert build.launch_counts()[fa_ops.KERNEL] == before + 2
    assert build.launch_counts()[fa_ops.NONCAUSAL_KERNEL] == before_nc + 2
    tc = dtype == torch.bfloat16 and hd in (64, 128)
    assert build.launch_counts().get(fa_ops.TC_KERNEL, 0) == before_tc + (2 if tc else 0)
    assert out.dtype == dtype and torch.equal(out, again)
    assert torch.isfinite(out).all()
    bf16 = dtype == torch.bfloat16
    plain = flash_attention_ref(q, k, v, causal=False)
    _close(out, plain, bf16)
    _close(out, flash_attention_ref(q.cpu(), k.cpu(), v.cpu(), causal=False), bf16)
    if bf16:
        assert _bf16_equal_share(out, plain) >= 0.99
    if 1 < s <= t:  # the causal kernel on the same inputs is another function
        assert not torch.allclose(fa_ops.flash_attention(q, k, v).float(), out.float(),
                                  atol=1.6e-2)


def test_flash_attention_unaligned_bf16_takes_the_cuda_core_kernel(cuda):
    """A base off a 16-byte boundary cannot feed the tensor-core kernel's
    16-byte copies: the wrapper picks the CUDA-core kernel, same function."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (1, 70, 4, 64)
    flat = torch.randn(int(np.prod(shape)) + 1, generator=gen, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(shape)
    k, v = (torch.randn((1, 70, 2, 64), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = dict(build.launch_counts())
    out = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[fa_ops.KERNEL] == before.get(fa_ops.KERNEL, 0) + 1
    assert after.get(fa_ops.TC_KERNEL, 0) == before.get(fa_ops.TC_KERNEL, 0)
    plain = flash_attention_ref(q, k, v)
    _close(out, plain, True)
    assert _bf16_equal_share(out, plain) >= 0.99


# The Mamba2-370M prefill shape; a ragged chunk of 200; P 16, 32, 64 and 128
# (P 30 and N 37 take the 4-byte copies); N not a multiple of 8; H not a
# multiple of the 8 heads of a block; Jamba's N 16 (half of one 32-column
# staging chunk) with its 128 heads of P 64; a tp mesh rank's head shard of
# each (chip_smoke.py's mesh: Mamba2-370M B 4 and Jamba B 2 over 2 data x 2
# model ranks).
@pytest.mark.parametrize("b,nc,q,n,h,p", [
    (1, 2, 16, 8, 2, 8), (2, 3, 32, 16, 4, 16), (1, 1, 64, 32, 1, 32),
    (2, 2, 256, 128, 9, 64), (1, 3, 200, 20, 3, 24), (1, 1, 5, 4, 2, 128),
    (4, 8, 256, 128, 32, 64), (2, 2, 200, 128, 32, 64), (1, 2, 256, 44, 8, 16),
    (1, 2, 192, 37, 5, 32), (1, 1, 256, 130, 3, 128), (1, 2, 100, 16, 3, 30),
    (2, 2, 256, 16, 128, 64), (1, 3, 200, 16, 128, 64),
    (2, 8, 256, 128, 16, 64), (1, 8, 256, 16, 64, 64),
])
def test_ssd_intra_chunk_matches_plain(cuda, b, nc, q, n, h, p):
    rng = np.random.default_rng(q * h + p)
    cc = torch.from_numpy(rng.standard_normal((b, nc, q, n)).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((b, nc, q, n)).astype(np.float32))
    xdt = torch.from_numpy(rng.standard_normal((b, nc, h, q, p)).astype(np.float32))
    acum = torch.from_numpy(
        -np.cumsum(rng.uniform(size=(b, nc, h, q)) * 0.1, axis=-1).astype(np.float32))
    args = [a.to(cuda) for a in (cc, bc, xdt, acum)]
    before = build.launch_counts().get(ssd_ops.KERNEL, 0)
    out = ssd_ops.ssd_intra_chunk(*args)
    again = ssd_ops.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert build.launch_counts()[ssd_ops.KERNEL] == before + 2
    assert torch.equal(out, again)
    for want in (ssd_intra_chunk_ref(*args), ssd_intra_chunk_ref(cc, bc, xdt, acum)):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)


def _ssd_bwd_inputs(b, nc, q, n, h, p, seed, device):
    """Unit-normal C, B, Xdt and dY and a realistic decreasing log-decay."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, nc, q, n)), rng.standard_normal((b, nc, q, n)),
            rng.standard_normal((b, nc, h, q, p)),
            -np.cumsum(rng.uniform(size=(b, nc, h, q)) * 0.05, axis=-1),
            rng.standard_normal((b, nc, h, q, p))]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


# The SSD backward (csrc/ssd_scan_bwd.cu) at the shapes of chip_smoke.py's
# ``ssd bwd`` phase (the Mamba2-370M training shape, Jamba's N 16 H 128, a
# ragged Q 200, the REDUCED configs' P 16, a tp mesh rank's head shard of
# the Mamba2-370M step: 3 runs of 6 heads) and small ragged ones: Q = 1, N
# and P off the 32-column steps, H odd.
SSD_BWD_SHAPES = [
    (4, 8, 256, 128, 32, 64), (2, 2, 256, 16, 128, 64), (2, 2, 200, 128, 32, 64),
    (1, 3, 256, 16, 8, 16), (1, 2, 1, 4, 2, 8), (1, 1, 70, 37, 3, 24), (2, 1, 130, 70, 5, 128),
    (2, 8, 256, 128, 16, 64),
]


@pytest.mark.parametrize("b,nc,q,n,h,p", SSD_BWD_SHAPES)
def test_ssd_intra_chunk_bwd_matches_plain(cuda, b, nc, q, n, h, p):
    """Each gradient within 1e-4 of its largest magnitude of the plain
    backward's, one counted launch a call, bitwise on a second call."""
    args = _ssd_bwd_inputs(b, nc, q, n, h, p, q * h + p, cuda)
    before = build.launch_counts().get(ssd_ops.KERNEL_BWD, 0)
    got = ssd_ops.ssd_intra_chunk_bwd(*args)
    again = ssd_ops.ssd_intra_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert build.launch_counts()[ssd_ops.KERNEL_BWD] == before + 2
    for g, a, w in zip(got, again, ssd_intra_chunk_bwd_ref(*args)):
        assert g.shape == w.shape and torch.equal(g, a)
        scale = float(w.abs().max().clamp_min(1e-30))
        assert float((g - w).abs().max()) <= 1e-4 * scale


def test_ssd_intra_chunk_gradient_under_grad_launches_the_backward(cuda):
    """Under grad the wrapper's autograd Function launches the forward once
    and the backward once; its gradients against autograd through the plain
    forward on the card, dy handed as a permuted view as the layer does."""
    cc, bc, xdt, acum, dy = _ssd_bwd_inputs(2, 2, 96, 24, 3, 16, 5, cuda)
    dyv = dy.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    leaves = [x.clone().requires_grad_() for x in (cc, bc, xdt, acum)]
    build.reset_launch_counts()
    out = ssd_ops.ssd_intra_chunk(*leaves)
    got = torch.autograd.grad(out, leaves, dyv)
    torch.cuda.synchronize()
    assert build.launch_counts() == {ssd_ops.KERNEL: 1, ssd_ops.KERNEL_BWD: 1}
    plain = [x.clone().requires_grad_() for x in (cc, bc, xdt, acum)]
    want = torch.autograd.grad(ssd_intra_chunk_ref(*plain), plain, dy)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_ssd_intra_chunk_bwd_refuses_what_the_kernels_do_not_take(cuda):
    args = _ssd_bwd_inputs(1, 1, 16, 8, 2, 8, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_intra_chunk_bwd(*args[:4], args[4].double())
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_intra_chunk_bwd(args[0].double(), *args[1:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no SSD kernel for device meta"):
        ssd_ops.ssd_intra_chunk_bwd(*meta)
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_intra_chunk_bwd(*args[:4], args[4][..., :4])


@pytest.mark.parametrize("b,nc,q,n,h,p", [(1, 2, 256, 16, 4, 64), (1, 1, 200, 8, 3, 16)])
def test_ssd_intra_chunk_bwd_keeps_steep_decays_finite(cuda, b, nc, q, n, h, p):
    """A steep decay (a_i − a_j above the diagonal up to ~+260 at Q 256,
    past f32's exp range): every gradient stays finite, since the kernel
    forms the decay only for i ≥ j, and within 1e-4 of each one's largest
    magnitude of the plain version where the plain version is finite."""
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((b, nc, q, n)), rng.standard_normal((b, nc, q, n)),
            rng.standard_normal((b, nc, h, q, p)),
            -np.cumsum(rng.uniform(size=(b, nc, h, q)) * 2.0, axis=-1),
            rng.standard_normal((b, nc, h, q, p))]
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in arrs]
    got = ssd_ops.ssd_intra_chunk_bwd(*args)
    for g, w in zip(got, ssd_intra_chunk_bwd_ref(*args)):
        assert bool(torch.isfinite(g).all())
        ok = torch.isfinite(w)
        scale = float(w[ok].abs().max().clamp_min(1e-30))
        assert float((g[ok] - w[ok]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("b,nc,q,n,h,p", [
    (2, 3, 256, 16, 4, 64), (1, 2, 70, 37, 3, 24), (2, 1, 130, 8, 5, 128)])
def test_ssd_intra_chunk_bwd_reads_the_layers_permuted_dy(cuda, b, nc, q, n, h, p):
    """dY as the Mamba layer hands it, a permuted view of a [B, NC, Q, H, P]
    gradient, is read at its strides: bitwise the contiguous dY's result."""
    args = _ssd_bwd_inputs(b, nc, q, n, h, p, q + h, cuda)
    view = args[4].permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    assert not view.is_contiguous()
    got = ssd_ops.ssd_intra_chunk_bwd(*args[:4], view)
    for g, w in zip(got, ssd_ops.ssd_intra_chunk_bwd(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("heads_per_run,stages", [(1, 1), (1, 2), (3, 2), (8, 1), (8, 2)])
def test_ssd_intra_chunk_bwd_design_knobs_agree(cuda, heads_per_run, stages):
    """Every run length and ring depth of the fused kernel gives the plain
    backward's gradients within 1e-4 of each one's largest magnitude; a ring
    that does not fit the card's shared memory, and more runs than the
    second kernel sums, are refused."""
    args = _ssd_bwd_inputs(2, 2, 256, 32, 8, 64, 11, cuda)
    got = ssd_ops.ssd_intra_chunk_bwd(*args, heads_per_run=heads_per_run, stages=stages)
    for g, w in zip(got, ssd_intra_chunk_bwd_ref(*args)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    wide = _ssd_bwd_inputs(1, 1, 256, 8, 2, 128, 0, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_ops.ssd_intra_chunk_bwd(*wide, stages=2)  # P 128 at Q 256: one slot only
    with pytest.raises(ValueError, match="runs"):
        ssd_ops.ssd_intra_chunk_bwd(*_ssd_bwd_inputs(1, 1, 64, 8, 9, 8, 0, cuda),
                                    heads_per_run=1)


def test_mamba_loss_gradient_on_card_matches_cpu(cuda):
    """REDUCED mamba2-370m: ``loss_fn``'s every gradient leaf on the card
    (the SSD kernels forward and backward once per layer) within atol 5e-4,
    rtol 1e-3 of the CPU's (the plain versions)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.api import loss_fn

    cfg = get_config("mamba2-370m", reduced=True)
    params = model_init(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    batch = synthetic_batch(seed=0, step=0, batch=2, seq=300, vocab=cfg.vocab_size,
                            family=cfg.family, d_model=cfg.d_model)
    grads = []
    for dev, p in ((cuda, params), ("cpu", params_to(params, "cpu"))):
        leaves = [t.detach().clone().requires_grad_() for t in _flat(p)]
        tree = _rebuild(p, leaves)
        build.reset_launch_counts()
        loss, _ = loss_fn(tree, cfg, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
        if dev is cuda:
            assert build.launch_counts() == {ssd_ops.KERNEL: cfg.num_layers,
                                             ssd_ops.KERNEL_BWD: cfg.num_layers}
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, rtol=1e-3)


def _rebuild(tree, leaves):
    from repro_torch.optim.adamw import _rebuild as rebuild

    return rebuild(tree, iter(leaves))


# The backward kernels (csrc/flash_attention_bwd.cu) against their plain
# version: Qwen2-1.5B's GQA 12/2 at hd 128 and SmolLM's 15/5 at hd 64 (bf16:
# the forward on the tensor cores), the REDUCED configs' hd 20, causal with
# S < T (end-aligned), unmasked cross-attention (S 36 and S 1 over T 1,024,
# S > T), T ragged against the 64-key blocks.
BWD_SHAPES = [
    (128, 256, 256, 12, 2, True), (64, 300, 300, 15, 5, True), (20, 200, 200, 3, 1, True),
    (128, 130, 1000, 8, 2, True), (64, 36, 1024, 16, 16, False), (16, 1, 65, 4, 4, False),
    (32, 100, 70, 4, 4, False), (128, 70, 129, 7, 1, False),
]


def _bwd_close(got, want, bf16):
    """Within a share of the tensor's largest magnitude: f32 1e-4 (the sums run
    in another order, and dS = P ∘ (dP - D) cancels); bf16 2^-7, two bf16 ulps
    at that magnitude (both sides compute in f32 and round once)."""
    tol = 2.0 ** -7 if bf16 else 1e-4
    w = want.float().cpu()
    err = float((got.float().cpu() - w).abs().max())
    assert err <= tol * float(w.abs().max()), (err, float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,s,t,h,kv,causal", BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(cuda, dtype, hd, s, t, h, kv, causal):
    gen = torch.Generator(device=cuda).manual_seed(hd + s + t)
    q, do = (torch.randn((2, s, h, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    bf16 = dtype == torch.bfloat16
    out, lse = fa_ops._forward(q, k, v, causal, with_lse=True)
    want_out, want_lse = flash_attention_lse_ref(q, k, v, causal=causal)
    _close(out, want_out, bf16)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, causal=causal))  # lse moves nothing
    before = dict(build.launch_counts())
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    after = build.launch_counts()
    for name in (fa_ops.BWD_DQ_KERNEL, fa_ops.BWD_DKDV_KERNEL):
        assert after[name] == before.get(name, 0) + 2
    # bf16 with hd 64 and 128 runs the tensor-core pair, everything else the CUDA-core pair
    tc = bf16 and hd in (64, 128)
    assert after.get(fa_ops.BWD_TC_KERNEL, 0) == before.get(fa_ops.BWD_TC_KERNEL, 0) + 2 * tc
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)  # run-to-run bitwise: no atomics
        assert torch.isfinite(g).all()
        _bwd_close(g, w, bf16)


def _bwd_pair(name, q, k, v, out, lse, do, causal, splits=1):
    """(dq, dk, dv) from one pair's C entry points: ``"cuda_cores"`` or
    ``"tensor_cores"`` with ``splits`` blocks over each kv-head's q-heads."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty_like(lse)
    tail = (b, s, t, h, kv, hd, int(causal), 1.0 / math.sqrt(hd))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if name == "cuda_cores":
        flag = int(q.dtype == torch.bfloat16)
        build.call("ample_flash_attention_bwd_dq", q.device, *ptrs, out.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), flag, *tail)
        build.call("ample_flash_attention_bwd_dkdv", q.device, *ptrs, do.data_ptr(),
                   lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), flag, *tail)
        return dq, dk, dv
    part = (torch.empty((2, splits, b, t, kv, hd), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    build.call("ample_flash_attention_bwd_tc_dq", q.device, *ptrs, out.data_ptr(), do.data_ptr(),
               lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), *tail)
    build.call("ample_flash_attention_bwd_tc_dkdv", q.device, *ptrs, do.data_ptr(),
               lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               None if part is None else part.data_ptr(), splits, *tail)
    return dq, dk, dv


@pytest.mark.parametrize("all_heads", [False, True])
@pytest.mark.parametrize("hd,s,t,h,kv,causal", [c for c in BWD_SHAPES if c[0] in (64, 128)])
def test_flash_attention_bwd_tensor_core_pair_matches_cuda_core_pair(cuda, hd, s, t, h, kv,
                                                                      causal, all_heads):
    """The tensor-core pair against the CUDA-core pair on the same bf16
    inputs, both by their C entry points: within 2^-7 of each gradient's
    largest magnitude (the two round f32 sums of another order once to
    bf16), each run-to-run bitwise. The dK/dV kernel runs unsplit and with
    every q-head its own block (f32 partial sums added in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(hd * s + t)
    q, do = (torch.randn((2, s, h, hd), generator=gen, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((2, t, kv, hd), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fa_ops._forward(q, k, v, causal, with_lse=True)
    splits = h // kv if all_heads else 1
    got = _bwd_pair("tensor_cores", q, k, v, out, lse, do, causal, splits)
    again = _bwd_pair("tensor_cores", q, k, v, out, lse, do, causal, splits)
    cc = _bwd_pair("cuda_cores", q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, cc):
        assert torch.equal(g, a) and torch.isfinite(g).all()
        _bwd_close(g, w, True)
    if splits > 1:  # the split sums are another order of the same f32 terms
        for g, w in zip(got[1:], _bwd_pair("tensor_cores", q, k, v, out, lse, do, causal)[1:]):
            _bwd_close(g, w, True)


def test_flash_attention_bwd_unaligned_bf16_takes_the_cuda_core_pair(cuda):
    """A bf16 base off a 16-byte boundary (here dout's) cannot feed the
    tensor-core pair's 16-byte copies: the wrapper runs the CUDA-core pair,
    same function."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape = (2, 130, 8, 128)
    q = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 130, 2, 128), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    flat = torch.randn(int(np.prod(shape)) + 1, generator=gen, device=cuda).to(torch.bfloat16)
    do = flat[1:].view(shape)
    assert do.is_contiguous() and do.data_ptr() % 16 != 0
    out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    before = dict(build.launch_counts())
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[fa_ops.BWD_DQ_KERNEL] == before.get(fa_ops.BWD_DQ_KERNEL, 0) + 1
    assert after.get(fa_ops.BWD_TC_KERNEL, 0) == before.get(fa_ops.BWD_TC_KERNEL, 0)
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, lse, do)):
        _bwd_close(g, w, True)
    aligned = fa_ops.flash_attention_bwd(q, k, v, out, lse, do.clone())
    assert build.launch_counts()[fa_ops.BWD_TC_KERNEL] == after.get(fa_ops.BWD_TC_KERNEL, 0) + 1
    for g, w in zip(aligned, got):
        _bwd_close(g, w, True)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_under_grad_launches_the_backward(cuda, causal):
    """Under grad the wrapper's autograd Function launches the forward (with
    lse) once and each backward kernel once; f32, its gradient against
    autograd through the plain version on the card."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((2, 90, 6, 32), generator=gen, device=cuda)
    k, v = (torch.randn((2, 130 if not causal else 90, 2, 32), generator=gen, device=cuda)
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device=cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    build.reset_launch_counts()
    out = fa_ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts[fa_ops.KERNEL] == 1
    assert counts[fa_ops.BWD_DQ_KERNEL] == counts[fa_ops.BWD_DKDV_KERNEL] == 1
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*plain, causal=causal), plain, do)
    for g, w in zip(got, want):
        _bwd_close(g, w, False)


def test_lm_train_step_on_card_matches_cpu_and_repeats_bitwise(cuda):
    """Two steps of REDUCED Qwen2-1.5B (f32) on the card: the flash kernels
    forward and backward once per layer a step, params within atol 5e-4,
    rtol 1e-3 of the CPU's (plain versions), and bitwise the same twice."""
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = get_config("qwen2-1.5b", reduced=True)
    t = TrainerConfig(steps=2, batch=2, seq=100, log_every=1)
    build.reset_launch_counts()
    runs = [Trainer(cfg, t, device=cuda).run() for _ in range(2)]
    counts = build.launch_counts()
    n = 2 * 2 * cfg.num_layers  # runs x steps x layers
    assert counts[fa_ops.KERNEL] == counts[fa_ops.BWD_DQ_KERNEL] == n
    assert counts[fa_ops.BWD_DKDV_KERNEL] == n
    assert counts.get(fa_ops.BWD_TC_KERNEL, 0) == 0  # f32, hd 20: the CUDA-core pair
    cpu = Trainer(cfg, t, device="cpu")
    cpu.init_state = lambda: _cpu_init(cfg, cuda)
    cpu_out = cpu.run()
    for a, b in zip(_flat(runs[0]["state"]["params"]), _flat(runs[1]["state"]["params"])):
        assert torch.equal(a, b)
    for a, b in zip(_flat(runs[0]["state"]["params"]), _flat(cpu_out["state"]["params"])):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(), atol=5e-4,
                                   rtol=1e-3)
    for a, b in zip(runs[0]["metrics"], cpu_out["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], atol=5e-4, rtol=1e-3)


def _cpu_init(cfg, cuda):
    """The card's initial train state (seed 0) on the CPU."""
    from repro_torch.train.train_step import init_train_state

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = params_to(model_init(cfg, gen, device=cuda), "cpu")
    return init_train_state(cfg, params)


def _flat(tree):
    from repro_torch.optim.adamw import _leaves

    return _leaves(tree)


def test_lm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    k = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 2, 256), device=cuda)
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="k on cpu"):
        fa_ops.flash_attention(q, k.cpu(), k.cpu())
    cc = torch.zeros((1, 1, 300, 8), device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_intra_chunk(cc, cc, torch.zeros((1, 1, 2, 300, 8), device=cuda),
                                torch.zeros((1, 1, 2, 300), device=cuda))


@pytest.mark.parametrize("arch,kernel", [("qwen3-8b", fa_ops.KERNEL),
                                         ("mamba2-370m", ssd_ops.KERNEL)])
def test_lm_generate_on_card_matches_cpu(cuda, arch, kernel):
    cfg = get_config(arch, reduced=True)
    gpu = ServeEngine(cfg, max_len=80, device=cuda, generator=torch.Generator().manual_seed(0))
    cpu = ServeEngine(cfg, params_to(gpu.params, "cpu"), max_len=80, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 60))
    build.reset_launch_counts()
    out = gpu.generate(prompts, max_new_tokens=8)
    assert build.launch_counts() == {kernel: cfg.num_layers}  # one prefill per layer
    assert torch.equal(out, gpu.generate(prompts, max_new_tokens=8))
    assert torch.equal(out.cpu(), cpu.generate(prompts, max_new_tokens=8))
    toks = {"tokens": torch.as_tensor(prompts)}
    want = model_prefill(cpu.params, cfg, toks, 80)[0]
    got = model_prefill(gpu.params, cfg, {"tokens": toks["tokens"].to(cuda)}, 80)[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4, rtol=1e-3)


def test_vlm_and_encdec_on_card_match_cpu(cuda):
    """REDUCED Qwen2-VL on embeds with image-grid M-RoPE positions, and
    REDUCED Seamless through prefill and decode: flash once per attention
    layer (the enc-dec: causal per decoder layer, unmasked per encoder and
    cross layer, and unmasked per decode step and layer), logits within the
    f32 tolerance of the CPU's, run-to-run bitwise."""
    gen = torch.Generator().manual_seed(0)
    vlm = get_config("qwen2-vl-7b", reduced=True)
    params = params_to(model_init(vlm, gen, device="cpu"), cuda)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((2, 40, vlm.d_model)).astype(np.float32))
    pos = torch.arange(40, dtype=torch.int32)[None, None].repeat(3, 2, 1)
    pos[1, :, 8:24] = 8 + torch.arange(16, dtype=torch.int32) // 4  # a 4 x 4 grid's h
    pos[2, :, 8:24] = 8 + torch.arange(16, dtype=torch.int32) % 4  # and w
    pos[0, :, 8:24] = 8
    batch = {"embeds": emb, "positions": pos}
    want = model_prefill(params_to(params, "cpu"), vlm, batch, 48)[0]
    build.reset_launch_counts()
    got = model_prefill(params, vlm, {k: t.to(cuda) for k, t in batch.items()}, 48)[0]
    assert build.launch_counts() == {fa_ops.KERNEL: vlm.num_layers}
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4, rtol=1e-3)

    sea = get_config("seamless-m4t-medium", reduced=True)
    params = params_to(model_init(sea, gen, device="cpu"), cuda)
    src = torch.from_numpy(rng.standard_normal((2, 70, sea.d_model)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, sea.vocab_size, (2, 6)))
    cpu_batch = {"src_embeds": src, "tgt_tokens": tgt}
    card_batch = {k: t.to(cuda) for k, t in cpu_batch.items()}
    cpu_params = params_to(params, "cpu")
    want = model_forward(cpu_params, sea, cpu_batch)[0]
    build.reset_launch_counts()
    got = model_forward(params, sea, card_batch)[0]
    unmasked = sea.encoder_layers + sea.num_layers  # encoder, cross-attention
    assert build.launch_counts() == {fa_ops.KERNEL: sea.num_layers + unmasked,
                                     fa_ops.NONCAUSAL_KERNEL: unmasked}
    assert torch.equal(got, model_forward(params, sea, card_batch)[0])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4, rtol=1e-3)
    cache = model_init_cache(sea, params, card_batch, 16)
    cpu_cache = model_init_cache(sea, cpu_params, cpu_batch, 16)
    for i in range(tgt.shape[1]):
        build.reset_launch_counts()
        lg, cache = model_decode_step(params, sea, {"tokens": card_batch["tgt_tokens"][:, i:i + 1]},
                                      cache, i)
        assert build.launch_counts() == {fa_ops.KERNEL: sea.num_layers,
                                         fa_ops.NONCAUSAL_KERNEL: sea.num_layers}
        clg, cpu_cache = model_decode_step(cpu_params, sea, {"tokens": tgt[:, i:i + 1]},
                                           cpu_cache, i)
        np.testing.assert_allclose(lg.cpu().numpy(), clg.numpy(), atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(lg.cpu().numpy(), want[:, i].numpy(), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("e,k,cf,shared", [(40, 8, 1.25, False), (128, 1, 1.25, True),
                                           (16, 2, 0.25, False), (16, 2, 8.0, True)])
def test_moe_apply_on_card_matches_cpu(cuda, e, k, cf, shared):
    """The MoE layer (plain PyTorch on both devices) at the f32 tolerance,
    and bitwise from call to call on the card: the combine sums each token's
    k rows in a fixed order, with no float atomics."""
    gen = torch.Generator().manual_seed(e + k)
    d, f = 64, 96

    def w(*shape):
        return torch.randn(shape, generator=gen) * shape[-2] ** -0.5

    experts = {"w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    params = {"router": w(d, e), "experts": experts}
    if shared:
        params["shared"] = {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    x = torch.randn((4, 256, d), generator=gen)
    kw = dict(num_experts=e, top_k=k, kind="swiglu", capacity_factor=cf, return_stats=True)
    want, want_aux, want_stats = moe_apply(params, x, **kw)
    card = params_to(params, cuda)
    got, aux, stats = moe_apply(card, x.to(cuda), **kw)
    again, aux2, _ = moe_apply(card, x.to(cuda), **kw)
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4, rtol=1e-3)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert torch.equal(stats["expert_load"].cpu(), want_stats["expert_load"])
    assert float(stats["dropped_fraction"]) == float(want_stats["dropped_fraction"])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_moe_generate_on_card_matches_cpu(cuda, arch):
    """REDUCED MoE and hybrid configs: the flash and SSD kernels once per
    layer of their mixer, the repeat bitwise, tokens equal to the CPU's."""
    cfg = get_config(arch, reduced=True)
    gpu = ServeEngine(cfg, max_len=80, device=cuda, generator=torch.Generator().manual_seed(0))
    cpu = ServeEngine(cfg, params_to(gpu.params, "cpu"), max_len=80, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 60))
    build.reset_launch_counts()
    out = gpu.generate(prompts, max_new_tokens=8)
    layers = mixer_counts(cfg)
    want = {fa_ops.KERNEL: layers["attn"], ssd_ops.KERNEL: layers["mamba"]}
    assert build.launch_counts() == {name: n for name, n in want.items() if n}
    assert torch.equal(out, gpu.generate(prompts, max_new_tokens=8))
    assert torch.equal(out.cpu(), cpu.generate(prompts, max_new_tokens=8))
    toks = {"tokens": torch.as_tensor(prompts)}
    want = model_prefill(cpu.params, cfg, toks, 80)[0]
    got = model_prefill(gpu.params, cfg, {"tokens": toks["tokens"].to(cuda)}, 80)[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4, rtol=1e-3)


# ------------------------------------------------------------------ sharded
def _split_launches(splan, mode):
    """AGE launches of one sharded pass split at the halo: one per non-empty
    half of each shard's precision groups (whole groups where a shard has no
    halo rows), and the number of groups."""
    from repro_torch.core.scheduler import split_plan_by_halo

    n = groups = 0
    for sp in splan.shards:
        for plan in sp.plan.mode_plans[mode].values():
            groups += 1
            n += (sum(h.num_tiles > 0 for h in split_plan_by_halo(plan, sp.num_owned))
                  if sp.halo_size else 1)
    return n, groups


# (partitioner, inter-community degree, lanes a tile): with few cut edges and
# small tiles every group of the min-cut shards has interior tiles, so each
# split group runs as two launches; on the edge-balanced cut of a
# well-mixed graph every tile reads a halo row and the interior half is empty.
SPLITS = [("mincut", 0.02, 16), ("edges", 0.5, 64)]


@pytest.mark.parametrize("kind,inter,ept", SPLITS)
@pytest.mark.parametrize("mode", ["gcn", "runtime"])
def test_sharded_split_halves_are_bitwise_the_unsplit_on_card(cuda, kind, inter, ept, mode):
    """Both halves of a split group through the AGE (static coeff) or the
    multi-head AGE (per-edge [E, H] coeff), into one output: bitwise the
    unsplit schedule, the halo gather on the side stream."""
    from repro_torch.core.message_passing import compile_sharded_plans
    from repro_torch.distributed.graph_shard import ShardedAmpleEngine
    from repro_torch.graphs.datasets import make_clustered_graph
    from repro_torch.graphs.partition import make_partition

    g = make_clustered_graph(20000, 8, seed=1, shuffle=True, inter_degree=inter)
    splan = compile_sharded_plans(g, EngineConfig(edges_per_tile=ept),
                                  partition=make_partition(g, 4, kind), modes=(mode,))
    launches, groups = _split_launches(splan, mode)
    if kind == "mincut":
        assert launches == 2 * groups  # every group split in two
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((g.num_nodes, 300)).astype(np.float32)).to(cuda)
    coeff = None
    if mode == "runtime":
        x = x[:, :256].reshape(-1, 4, 64).contiguous()
        coeff = torch.rand((g.num_edges, 4), device=cuda)
    plain, split = ShardedAmpleEngine(g, splan), ShardedAmpleEngine(g, splan, halo_overlap=True)
    a = plain.aggregate(x, mode=mode, edge_coeff=coeff)
    build.reset_launch_counts()
    b = split.aggregate(x, mode=mode, edge_coeff=coeff)
    torch.cuda.synchronize()
    kernel = seg_ops.KERNEL if mode == "gcn" else attn_ops.SEGMENT_AGG_MH
    assert build.launch_counts() == {kernel: launches}
    assert torch.equal(a, b)
    stats = split.halo_stats
    assert stats["split_exchanges"] == stats["halo_exchanges"] == 4
    assert stats["halo_ms"] > 0.0 and stats["halo_wait_ms"] >= 0.0


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
def test_sharded_request_on_card_matches_cpu(cuda, arch):
    """A 4-shard request at FULL widths on the card within the mixed
    tolerance of the same request on the CPU; warm == cold."""
    cfg = dataclasses.replace(get_config(f"ample-{arch}"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=400, max_feature_dim=300, seed=2)
    gpu = GNNServeEngine(cfg, device=cuda, num_shards=4)
    cpu = GNNServeEngine(cfg, params=gpu.params, device="cpu", num_shards=4)
    cold, warm = gpu.infer(g, g.features), gpu.infer(g, g.features)
    assert cold.num_shards == 4 and warm.cache_hit and warm.plan_ms == 0.0
    assert np.array_equal(cold.outputs, warm.outputs)
    ref = cpu.infer(g, g.features).outputs
    np.testing.assert_allclose(cold.outputs, ref, atol=6e-2, rtol=2e-3)
    assert (np.abs(cold.outputs - ref) > 2e-3).mean() < 0.05


def test_halo_overlap_on_card_launches_the_split(cuda):
    """halo_overlap=True serves split on the card, with no unsplit fallback:
    every exchange split, two AGE launches per split group, bitwise the
    unsplit request, the overlap in [0, 1]."""
    from repro_torch.graphs.datasets import make_clustered_graph

    cfg = dataclasses.replace(get_config("ample-gcn"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0, gnn_edges_per_tile=16)
    g = make_clustered_graph(20000, 8, seed=1, shuffle=True, inter_degree=0.02)
    feats = np.random.default_rng(0).standard_normal((20000, 300)).astype(np.float32)
    plain = GNNServeEngine(cfg, device=cuda, num_shards=4, partitioner="mincut")
    split = GNNServeEngine(cfg, params=plain.params, device=cuda, num_shards=4,
                           partitioner="mincut", halo_overlap=True)
    want = plain.infer(g, feats)
    split.infer(g, feats)
    build.reset_launch_counts()
    got = split.infer(g, feats)
    splan, eng = next((p, e) for _, p, e in split._cache.values())
    launches, groups = _split_launches(splan, "gcn")
    assert launches == 2 * groups
    assert build.launch_counts() == {seg_ops.KERNEL: 2 * launches, qm_ops.KERNEL: 2}
    assert np.array_equal(got.outputs, want.outputs)
    stats = eng.halo_stats
    assert stats["split_exchanges"] == stats["halo_exchanges"] == 16  # 4 shards, 2 layers, 2 requests
    assert got.halo_ms > 0.0 and 0.0 <= got.halo_overlap <= 1.0 and got.halo_bytes > 0


# ----------------------------------------------------------- training (QAT)
def _qat_example():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                        "train_gcn_degreequant_torch.py")
    spec = importlib.util.spec_from_file_location("train_gcn_degreequant_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _directed_graph(n=600, seed=21):
    from repro_torch.graphs.csr import add_self_loops

    return add_self_loops(make_lognormal_graph(n, 8.0, seed=seed))


@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("d", [1, 100, 256, 300])
@pytest.mark.parametrize("mixed", [False, True])
def test_age_backward_on_transposed_plan_is_bitwise_plain(cuda, mode, d, mixed):
    """The backward's launch, the AGE on each group's transposed plan,
    against its plain version on the card (within 1e-4: its index_add_
    sums in another order) and on the CPU (bitwise), run-to-run bitwise."""
    g = _directed_graph()
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    gr = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (g.num_nodes, d)).astype(np.float32))
    for tag in eng.plans(mode):
        dp, dp_cpu = (eng._transposed_plan(mode, tag, dev) for dev in (cuda, torch.device("cpu")))
        out = _agg(gr.to(cuda), dp, g.num_nodes, seg_ops.aggregate_tiles)
        assert torch.equal(out, _agg(gr.to(cuda), dp, g.num_nodes, seg_ops.aggregate_tiles))
        np.testing.assert_allclose(
            out.cpu().numpy(),
            _agg(gr.to(cuda), dp, g.num_nodes, aggregate_tiles_ref).cpu().numpy(), atol=1e-4)
        assert torch.equal(out.cpu(), _agg(gr, dp_cpu, g.num_nodes, aggregate_tiles_ref))


@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("mixed", [False, True])
def test_aggregate_grad_on_card_matches_cpu(cuda, mode, mixed):
    """x's gradient (and, mixed, the int8 scale's through its calibration)
    on the card against the CPU, at the f32 tolerance; a float engine's
    forward and backward each launch the AGE once."""
    g = _directed_graph()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.num_nodes, 64)).astype(np.float32)
    r = rng.standard_normal((g.num_nodes, 64)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=mixed))
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        build.reset_launch_counts()
        (eng.aggregate(xt, mode=mode) * torch.from_numpy(r).to(dev)).sum().backward()
        if dev.type == "cuda":
            assert build.launch_counts() == {seg_ops.KERNEL: 3 if mixed else 2}
        grads.append(xt.grad.cpu().numpy())
    np.testing.assert_allclose(grads[0], grads[1], atol=5e-4, rtol=1e-3)


def test_qat_step_on_card_matches_cpu(cuda):
    """The example's loss and gradients at step 0 on the card against the
    CPU (f32 tolerance), three AGE launches a step, and a short training run
    that is bitwise the same twice."""
    ex = _qat_example()
    g = ex.example_graph(400)
    labels, train = ex.node_task(g, ex.NUM_CLASSES)
    mask = torch.from_numpy(ex.sample_protection_mask(g, ex.DQ, np.random.default_rng(3)))
    cfg = ex.example_model(g)
    params = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = []
    for dev in (cuda, torch.device("cpu")):
        eng = AmpleEngine(g, EngineConfig(mixed_precision=False))
        args = (torch.from_numpy(g.features).to(dev), torch.from_numpy(labels).long().to(dev),
                torch.from_numpy(train).to(dev), mask.to(dev))
        p = ex.trainable(params_to(params, dev))
        build.reset_launch_counts()
        loss, grads = ex.qat_grads(p, eng, *args)
        if dev.type == "cuda":
            assert build.launch_counts() == {seg_ops.KERNEL: 3}
        got.append([loss.detach().cpu()] + [gl["w"].cpu() for gl in grads["layers"]])
    for a, b in zip(*got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3)
    runs = []
    for _ in range(2):
        eng = AmpleEngine(g, EngineConfig(mixed_precision=False))
        p, _ = ex.train(params_to(params, cuda), eng, torch.from_numpy(g.features).to(cuda),
                        torch.from_numpy(labels).long().to(cuda),
                        torch.from_numpy(train).to(cuda), steps=3, lr=5e-3)
        runs.append([lyr["w"].detach() for lyr in p["layers"]])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_kernel_wrappers_raise_under_grad(cuda):
    """The AGE's bare wrapper, whose launch has no backward of its own (the
    engines, sharded too, differentiate it through ``aggregate_autograd``),
    raises under grad when an input requires grad and launches under
    no_grad. The GAT kernels' wrappers
    and the int8 FTE launch their backward under grad, as flash's and the
    SSD's do (``test_flash_attention_gradient_under_grad_launches_the_backward``,
    ``test_ssd_intra_chunk_gradient_under_grad_launches_the_backward``)."""
    g = make_lognormal_graph(60, 4.0, seed=1)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=16, mixed_precision=False))
    dp = eng._device_plans("runtime", eng.plans("runtime"), cuda)["float"]
    tg = eng._tile_grad("runtime", "float", cuda)
    x = torch.randn((60, 8), device=cuda, requires_grad=True)
    edges = torch.rand((g.num_edges, 2), device=cuda, requires_grad=True)
    z = torch.randn((60, 2, 4), device=cuda, requires_grad=True)
    w = torch.randn((8, 5), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="segment_agg: an input requires grad.*aggregate_autograd"):
        _agg(x, dp, 60, seg_ops.aggregate_tiles)
    with torch.no_grad():
        assert torch.isfinite(_agg(x, dp, 60, seg_ops.aggregate_tiles)).all()
    calls = {
        "attention": (lambda: attn_ops.attend_tiles(
            z, dp.gather_idx, dp.edge_ids, edges, dp.coeff, dp.seg_ids, dp.out_node, dp.split,
            num_nodes=60, leaky_slope=0.2, grad=tg), (z, edges),
            {attn_ops.ATTENTION: 1, attn_ops.ATTENTION_BWD: 1, attn_ops.SEGMENT_AGG_MH: 1}),
        "segment_agg_mh": (lambda: attn_ops.aggregate_tiles_mh(
            z, dp.gather_idx, dp.edge_ids, edges, dp.coeff, dp.seg_ids, dp.out_node, dp.split,
            num_nodes=60, grad=tg), (z, edges),
            {attn_ops.SEGMENT_AGG_MH: 2, attn_ops.ATTENTION_BWD: 1}),
        "quant_matmul": (lambda: transform_int8(x, *quantize_per_channel(w)), (x, w),
                         {qm_ops.KERNEL: 1}),
    }
    for name, (call, leaves, want) in calls.items():
        build.reset_launch_counts()
        grads = torch.autograd.grad(call().square().sum(), leaves)
        torch.cuda.synchronize()
        assert build.launch_counts() == want, name
        assert all(torch.isfinite(t).all() and t.abs().max() > 0 for t in grads), name
    y = eng.aggregate(x[:, :2].contiguous().view(60, 2, 1), mode="runtime", edge_coeff=edges)
    assert torch.autograd.grad(y.sum(), edges)[0].abs().max() > 0


# ------------------------------------------------------------ GAT backward
def _bwd_rel_close(got, want, tol=1e-5):
    """Within ``tol`` of each value and of the largest magnitude (ds is a
    difference of two dot products, so its small entries carry their
    operands' absolute error)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


def _bwd_case(cuda, heads, dh, rows, seed=0, hub=True, mixed=False):
    """A runtime-mode engine on a graph with a split hub, z (and in
    ``rows``' form on the CPU and the card), raw scores with exact zeros and
    a gradient g."""
    g = _hub_graph(seed=seed) if hub else make_lognormal_graph(400, 10.0, seed=seed)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((g.num_nodes, heads, dh)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((g.num_edges, heads)).astype(np.float32) * 2)
    sc[::11] = 0.0
    gr = torch.from_numpy(rng.standard_normal((g.num_nodes, heads, dh)).astype(np.float32))
    return eng, z, sc, gr, {"cpu": _rows(z, rows, "cpu"), "card": _rows(z, rows, cuda)}


@pytest.mark.parametrize("rows", ROWS, ids=lambda r: f"{r[0]}+{r[1]}")
@pytest.mark.parametrize("heads,dh", [(4, 64), (4, 100), (2, 12), (1, 8), (4, 5), (1, 300)])
def test_attention_bwd_matches_plain(cuda, rows, heads, dh):
    """csrc/attn_agg_bwd.cu in both modes against its plain version on the
    CPU (alpha, ds and the coefficients' gradient within 1e-5 of the
    largest), on f32 rows and int8 codes, aligned and not; run-to-run
    bitwise; edges of other rows untouched."""
    eng, z, sc, gr, xs = _bwd_case(cuda, heads, dh, rows, seed=heads + dh)
    n = eng.graph.num_nodes
    devs = {"cpu": torch.device("cpu"), "card": cuda}
    for tag in eng.plans("runtime"):
        dps = {d: eng._device_plans("runtime", eng.plans("runtime"), devs[d])[tag] for d in devs}
        tgs = {d: eng._tile_grad("runtime", tag, devs[d]) for d in devs}
        x, qp = xs["cpu"]
        lse = torch.zeros((n, heads))
        out = attn_ops.attend_tiles(x, dps["cpu"].gather_idx, dps["cpu"].edge_ids, sc,
                                    dps["cpu"].coeff, dps["cpu"].seg_ids, dps["cpu"].out_node,
                                    dps["cpu"].split, num_nodes=n, leaky_slope=0.2, qp=qp,
                                    lse=lse)
        cf = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 1.5, eng.graph.num_edges)
                              .astype(np.float32))

        def run(dev, attn):
            xd, qpd = xs[dev]
            tg = tgs[dev]
            args = [t.to(devs[dev]) for t in (gr, out, lse, sc)]
            if attn:
                return attn_ops.attend_tiles_bwd(
                    xd, args[0], args[1], args[2], args[3], tg.indices, tg.items,
                    leaky_slope=0.2, coeff=cf.to(devs[dev]), qp=qpd,
                    alpha=torch.full(sc.shape, 7.0, device=devs[dev]))
            return (attn_ops.edge_dot(xd, args[0], tg.indices, tg.items,
                                      coeff=cf.to(devs[dev]), qp=qpd),)

        for attn in (True, False):
            build.reset_launch_counts()
            got, again = run("card", attn), run("card", attn)
            torch.cuda.synchronize()
            assert build.launch_counts() == {attn_ops.ATTENTION_BWD: 2}
            want = run("cpu", attn)
            for a, b, w in zip(got, again, want):
                assert torch.equal(a, b) and torch.isfinite(a).all()
                _bwd_rel_close(a, w)
            if attn:  # alpha of the edges of other groups' rows is left as it was
                other = torch.ones(eng.graph.num_edges, dtype=torch.bool)
                for _, lo, hi in tgs["cpu"].items.tolist():
                    other[lo:hi] = False
                assert (got[0].cpu()[other] == 7.0).all()


@pytest.mark.parametrize("rows", [("f32", 0), ("int8", 0), ("f32", 1), ("int8", 1)],
                         ids=lambda r: f"{r[0]}+{r[1]}")
@pytest.mark.parametrize("heads,dh", [(4, 64), (4, 100), (1, 300)])
def test_attention_bwd_item_cuts_agree(cuda, rows, heads, dh):
    """The design's one knob, how rows are cut into work items, moves no
    bit: items of 1, 3, 7, 64 and 200 in-edges (a 600-edge hub over several
    items, runs that are no multiple of the edges a warp keeps in flight,
    items longer than the kernel's staged run of 64) give the same alpha, ds
    and coefficients' gradient in both modes, within 1e-5 of the plain
    version; (1, 300) unaligned takes several passes over a head."""
    eng, _, sc, gr, xs = _bwd_case(cuda, heads, dh, rows, seed=5 * heads + dh)
    g = eng.graph
    n = g.num_nodes
    rng = np.random.default_rng(dh)
    out = torch.from_numpy(rng.standard_normal((n, heads, dh)).astype(np.float32))
    lse = torch.from_numpy(rng.uniform(1.0, 3.0, (n, heads)).astype(np.float32))
    cf = torch.from_numpy(rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32))
    indices = torch.as_tensor(g.indices, dtype=torch.int32)

    def run(dev, items):
        x, qp = xs["card" if dev is cuda else "cpu"]
        args = [t.to(dev) for t in (gr, out, lse, sc, indices, items)]
        alpha, ds = attn_ops.attend_tiles_bwd(x, *args, leaky_slope=0.2, coeff=cf.to(dev),
                                              qp=qp)
        return alpha, ds, attn_ops.edge_dot(x, args[0], args[4], args[5], coeff=cf.to(dev),
                                            qp=qp)

    cuts = {k: torch.from_numpy(attn_ops.row_items(g.indptr, np.arange(n), k))
            for k in (1, 3, 7, attn_ops.ITEM_EDGES, 200)}
    hub = cuts[attn_ops.ITEM_EDGES]
    assert int((hub[:, 0] == 0).sum()) > 1  # node 0's in-edges span several items
    assert (hub[:, 2] - hub[:, 1]).remainder(2).any()  # odd runs
    got = {k: run(cuda, items) for k, items in cuts.items()}
    for k, res in got.items():
        for a, b in zip(res, got[1]):
            assert torch.equal(a, b) and torch.isfinite(a).all(), k
    for a, w in zip(got[1], run(torch.device("cpu"), cuts[attn_ops.ITEM_EDGES])):
        _bwd_rel_close(a, w)


@pytest.mark.parametrize("rows", [("f32", 0), ("int8", 0)], ids=lambda r: r[0])
@pytest.mark.parametrize("heads,dh", [(4, 64), (4, 100), (1, 8)])
def test_attention_lse_output_keeps_the_output_bitwise(cuda, rows, heads, dh):
    """The forward with its lse buffer: the output bitwise the one without,
    the lse within 1e-5 of the plain version's (split nodes combined)."""
    eng, z, sc, _, xs = _bwd_case(cuda, heads, dh, rows, seed=3 * heads + dh)
    n = eng.graph.num_nodes
    for tag in eng.plans("runtime"):
        outs = {}
        for key, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
            dp = eng._device_plans("runtime", eng.plans("runtime"), dev)[tag]
            x, qp = xs[key]
            lse = torch.full((n, heads), float("nan"), device=dev)
            with_lse = _attend_lse(x, sc.to(dev), dp, n, qp, lse)
            outs[key] = (with_lse, lse, _attend(x, sc.to(dev), dp, n, attn_ops.attend_tiles,
                                                qp=qp))
        assert dp.split.num_slots > 0
        got, lse, plain = outs["card"]
        assert torch.equal(got, plain)
        rows_w = eng._tile_grad("runtime", tag, cuda).items[:, 0].long()
        _bwd_rel_close(lse[rows_w], outs["cpu"][1][rows_w.cpu()])
        assert torch.isfinite(lse[rows_w]).all()


def _attend_lse(x, sc, dp, n, qp, lse):
    return attn_ops.attend_tiles(x, dp.gather_idx, dp.edge_ids, sc, dp.coeff, dp.seg_ids,
                                 dp.out_node, dp.split, num_nodes=n, leaky_slope=0.2, qp=qp,
                                 lse=lse)


@pytest.mark.parametrize("heads,dh", [(4, 64), (4, 100)])
def test_gat_backward_walks_are_bitwise_the_cpus(cuda, heads, dh):
    """Given the kernel's alpha and ds, the walks on the transposed plan (dz)
    and the score sums (forward and transposed plans) are bitwise the CPU's
    plain versions: the backward's multi-head walks are aligned, summing
    each segment in lane order."""
    from repro_torch.core.aggregation import edge_segment_sum_tiles

    eng, z, sc, gr, _ = _bwd_case(cuda, heads, dh, ("f32", 0), seed=heads * dh, mixed=True)
    n = eng.graph.num_nodes
    alpha = torch.rand((eng.graph.num_edges, heads)).to(cuda)
    ds = torch.randn((eng.graph.num_edges, heads)).to(cuda)
    for tag in eng.plans("runtime"):
        tp, tp_cpu = (eng._transposed_plan("runtime", tag, d) for d in (cuda, torch.device("cpu")))
        fp, fp_cpu = (eng._device_plans("runtime", eng.plans("runtime"), d)[tag]
                      for d in (cuda, torch.device("cpu")))
        walk = functools.partial(attn_ops.aggregate_tiles_mh, aligned=True)
        dz = _mh(gr.to(cuda), alpha, tp, n, walk)
        assert torch.equal(dz, _mh(gr.to(cuda), alpha, tp, n, walk))
        assert torch.equal(dz.cpu(), _mh(gr, alpha.cpu(), tp_cpu, n, aggregate_tiles_mh_ref))
        for p, p_cpu in ((tp, tp_cpu), (fp, fp_cpu)):
            got = edge_segment_sum_tiles(ds, p, num_nodes=n, aligned=True)
            assert torch.equal(got.cpu(), edge_segment_sum_tiles(ds.cpu(), p_cpu, num_nodes=n))


@pytest.mark.parametrize("mixed", [False, True])
def test_gat_attention_gradient_under_grad_launches_the_backward(cuda, mixed):
    """``attention_aggregate`` and ``edge_scores`` under grad on the card:
    per group the fused forward, the backward kernel, and the walks (dz on
    the float group's transposed plan, the score sums per group on the
    transposed and forward plans); gradients within the CPU's (f32
    tolerance, mixed tolerance on a mixed engine), run-to-run bitwise."""
    g = _hub_graph(seed=5)
    rng = np.random.default_rng(5)
    zh = rng.standard_normal((g.num_nodes, 4, 16)).astype(np.float32)
    a_s, a_d = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    r = rng.standard_normal(zh.shape).astype(np.float32)
    got = []
    for dev in (cuda, cuda, torch.device("cpu")):
        eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=mixed))
        z = torch.from_numpy(zh).to(dev).requires_grad_()
        ps = [torch.from_numpy(a).to(dev).requires_grad_() for a in (a_s, a_d)]
        build.reset_launch_counts()
        src_sc = torch.einsum("nhd,hd->nh", z, ps[0])
        dst_sc = torch.einsum("nhd,hd->nh", z, ps[1])
        out = eng.attention_aggregate(eng.edge_scores(src_sc, dst_sc), z)
        grads = torch.autograd.grad((out * torch.from_numpy(r).to(dev)).sum(), [z] + ps)
        groups = len(eng.plans("runtime"))
        if dev is cuda:
            torch.cuda.synchronize()
            assert build.launch_counts() == {
                attn_ops.ATTENTION: groups, attn_ops.ATTENTION_BWD: groups,
                attn_ops.SEGMENT_AGG_MH: 1 + 2 * groups}
        got.append([t.cpu() for t in grads])
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
    for a, b in zip(got[0], got[2]):
        if mixed:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=6e-2, rtol=2e-3)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3)


def test_gat_train_steps_on_card_match_cpu_and_repeat_bitwise(cuda):
    """gat.apply at FULL ample-gat widths (300 -> 256 -> 100, 4 heads) on a
    400-node graph, float engine: the loss's gradients on the card within
    the CPU's f32 tolerance, per step 2 attention, 2 backward kernel and 6
    walk launches, and two 2-step AdamW runs bitwise."""
    from repro_torch.models.gnn import gat
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    cfg = dataclasses.replace(get_config("ample-gat"), gnn_precision="float")
    g = gnn_api.prepare_graph(cfg, make_dataset("cora", max_nodes=400, max_feature_dim=300,
                                                seed=4))
    labels = torch.from_numpy(np.random.default_rng(1).integers(0, 100, g.num_nodes))
    params = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def loss_fn(p, eng, dev):
        y = gat.apply(cfg, p, eng, torch.from_numpy(g.features).to(dev))
        return torch.nn.functional.cross_entropy(y, labels.to(dev))

    grads = []
    for dev in (cuda, torch.device("cpu")):
        eng = AmpleEngine(g, gnn_api.engine_config(cfg))
        p = {"layers": [{k: v.to(dev).requires_grad_() for k, v in lyr.items()}
                        for lyr in params["layers"]]}
        build.reset_launch_counts()
        loss = loss_fn(p, eng, dev)
        leaves = [lyr[k] for lyr in p["layers"] for k in sorted(lyr)]
        grads.append([t.cpu() for t in torch.autograd.grad(loss, leaves)])
        if dev is cuda:
            torch.cuda.synchronize()
            assert build.launch_counts() == {attn_ops.ATTENTION: 2, attn_ops.ATTENTION_BWD: 2,
                                             attn_ops.SEGMENT_AGG_MH: 6}
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3)
    runs = []
    for _ in range(2):
        eng = AmpleEngine(g, gnn_api.engine_config(cfg))
        p = params_to(params, cuda)
        p = {"layers": [{k: v.detach().requires_grad_() for k, v in lyr.items()}
                        for lyr in p["layers"]]}
        opt = adamw_init(p)
        for _ in range(2):
            leaves = [lyr[k] for lyr in p["layers"] for k in sorted(lyr)]
            gl = torch.autograd.grad(loss_fn(p, eng, cuda), leaves)
            it = iter(gl)
            gtree = {"layers": [{k: next(it) for k in sorted(lyr)} for lyr in p["layers"]]}
            p, opt, _ = adamw_update(gtree, opt, p, AdamWConfig(lr=1e-3))
        runs.append([lyr[k].detach() for lyr in p["layers"] for k in sorted(lyr)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mixed_qat_step_through_the_int8_fte_on_card_matches_cpu(cuda):
    """gcn.apply on a mixed-precision engine under grad (ROADMAP.md queue 1
    item 9): the int8 GEMM launches in the forward, its backward reads the
    int32 output; the weights' gradients within the CPU's at the mixed
    tolerance; 5 AGE launches (2 a layer, 1 backward) and 2 GEMMs."""
    from repro_torch.models.gnn import gcn

    cfg = get_config("ample-gcn")
    g = gnn_api.prepare_graph(cfg, make_dataset("cora", max_nodes=500, max_feature_dim=300,
                                                seed=6))
    params = gnn_api.gnn_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    r = torch.from_numpy(np.random.default_rng(2).standard_normal((g.num_nodes, 100))
                         .astype(np.float32))
    got = []
    for dev in (cuda, torch.device("cpu")):
        eng = AmpleEngine(g, EngineConfig(mixed_precision=True))
        p = {"layers": [{"w": lyr["w"].to(dev).requires_grad_()} for lyr in params["layers"]]}
        build.reset_launch_counts()
        y = gcn.apply(cfg, p, eng, torch.from_numpy(g.features).to(dev))
        got.append([t.cpu() for t in torch.autograd.grad(
            (y * r.to(dev)).sum(), [lyr["w"] for lyr in p["layers"]])])
        if dev is cuda:
            torch.cuda.synchronize()
            assert build.launch_counts() == {seg_ops.KERNEL: 5, qm_ops.KERNEL: 2}
    for a, b in zip(*got):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=6e-2, rtol=2e-3)


def test_serving_with_params_that_require_grad_on_card(cuda):
    cfg = dataclasses.replace(get_config("ample-gcn"), gnn_union_node_bucket=0,
                              gnn_union_edge_bucket=0)
    g = make_dataset("cora", max_nodes=400, max_feature_dim=300, seed=2)
    plain = GNNServeEngine(cfg, device=cuda)
    params = {"layers": [{"w": lyr["w"].clone().requires_grad_()}
                         for lyr in plain.params["layers"]]}
    srv = GNNServeEngine(cfg, params=params, device=cuda)
    assert np.array_equal(srv.infer(g, g.features).outputs, plain.infer(g, g.features).outputs)


# ----------------------------------------- training through the sharded and streamed engines
def _gnn_grads(cfg, params, eng, x, device):
    """(output, gradient leaves) of Σ y · r through ``eng`` on ``device``."""
    p = gnn_api.params_from_numpy(cfg, params, device=device)
    leaves = [t.requires_grad_() for t in _tree_leaves(p)]
    y = gnn_api.gnn_apply(cfg, p, eng, x.to(device) if torch.is_tensor(x) else x)
    r = torch.linspace(-1.0, 1.0, y.numel(), device=device).reshape(y.shape)
    return y.detach(), torch.autograd.grad((y * r).sum(), leaves)


def _tree_leaves(node):
    if isinstance(node, dict):
        return [t for k in sorted(node) for t in _tree_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _tree_leaves(v)]
    return [node]


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_numpy_tree(v) for v in node]
    return node.numpy()


def _numpy_params(cfg, seed=0):
    return _numpy_tree(gnn_api.gnn_init(cfg, torch.Generator().manual_seed(seed), device="cpu"))


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
def test_sharded_training_on_card_is_deterministic_and_matches_cpu(cuda, arch):
    """Gradients through ``ShardedAmpleEngine`` (3 mincut shards, float) on
    the card: bitwise twice, within the f32 tolerance of the CPU's, with the
    AGE (halo-transpose sums) launched and nothing raised."""
    cfg = dataclasses.replace(get_config(f"ample-{arch}", reduced=True), gnn_precision="float",
                              gnn_edges_per_tile=64)
    g = gnn_api.prepare_graph(cfg, make_dataset("cora", max_nodes=300,
                                                max_feature_dim=cfg.d_model, seed=1))
    params = _numpy_params(cfg)
    x = torch.from_numpy(g.features)
    outs = {}
    for dev in ("cpu", cuda, cuda):
        eng = gnn_api.make_engine(cfg, g, num_shards=3, partitioner="mincut")
        build.reset_launch_counts()
        outs.setdefault(str(dev), []).append(_gnn_grads(cfg, params, eng, x, dev))
        if dev != "cpu":
            assert build.launch_counts().get(seg_ops.KERNEL, 0) > 0
    (y0, g0), (y1, g1) = outs[str(cuda)]
    assert torch.equal(y0, y1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    yc, gc = outs["cpu"][0]
    torch.testing.assert_close(y0.cpu(), yc, atol=5e-4, rtol=1e-3)
    for a, b in zip(g0, gc):
        torch.testing.assert_close(a.cpu(), b, atol=5e-4, rtol=1e-3)


def test_streamed_int8_fte_gradient_on_card_is_the_in_memory_one(cuda):
    """The int8 FTE over streamed features under grad launches the GEMM once
    a chunk and gives the in-memory output and weight gradient, bitwise."""
    cfg = get_config("ample-sage", reduced=True)
    g = make_dataset("cora", max_nodes=700, max_feature_dim=cfg.d_model, seed=2)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=True))
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((cfg.d_model, 24), generator=gen, device=cuda, requires_grad=True)
    gy = torch.randn((g.num_nodes, 24), generator=gen, device=cuda)
    store = FeatureStore.from_array(g.features, chunk_rows=64)
    outs = []
    for x in (StreamedFeatures(store, g.features.nbytes // 8, device=cuda),
              torch.from_numpy(g.features).to(cuda)):
        build.reset_launch_counts()
        y = eng.transform(x, w, None, torch.relu)
        outs.append([y.detach(), *torch.autograd.grad((y * gy).sum(), [w])])
        if not torch.is_tensor(x):
            assert build.launch_counts().get(qm_ops.KERNEL, 0) >= store.num_chunks - 1
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# A context-parallel mesh rank's flash call (distributed/sharding.py: the qkv
# hook): Qwen3-8B's rows [1,024, 2,048) of B 2, every head (32/8, hd 128,
# bf16), K/V cut to the 2,048 positions those rows read, end-aligned causal.
# K/V come as the hook builds them (one cat of the ranks' head blocks, each
# narrowed to the cut: contiguous, no copy for the kernel), and the call must
# reach the tensor-core variant forward and backward.
def _cp_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(32)
    b, s, t, h, kv, hd = 2, 1024, 2048, 32, 8, 128
    q, do = (torch.randn((b, s, h, hd), generator=gen, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    blocks = [torch.randn((b, t + 8, kv // 2, hd), generator=gen, device=cuda).to(torch.bfloat16)
              for _ in range(4)]
    k = torch.cat([x.narrow(1, 0, t) for x in blocks[:2]], 2)
    v = torch.cat([x.narrow(1, 0, t) for x in blocks[2:]], 2)
    return q, k, v, do


def test_flash_attention_at_the_context_parallel_rank_shape(cuda):
    q, k, v, _ = _cp_inputs(cuda)
    assert k.is_contiguous() and v.is_contiguous()
    before = dict(build.launch_counts())
    out = fa_ops.flash_attention(q, k, v, causal=True)
    again = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after.get(fa_ops.TC_KERNEL, 0) == before.get(fa_ops.TC_KERNEL, 0) + 2
    assert torch.equal(out, again) and torch.isfinite(out).all()
    plain = flash_attention_ref(q, k, v, causal=True)
    _close(out, plain, True)
    assert _bf16_equal_share(out, plain) >= 0.99


# The enc-dec's unmasked flash calls on a tp mesh rank (SeamlessM4T-medium,
# B 4 over 2 data ranks, 16 heads of 64, bf16): the encoder's context-parallel
# rows [512, 1,024) against all 1,024 frames, and the cross-attention's 2 of a
# 4-token target prefix against them.
@pytest.mark.parametrize("s", [512, 2], ids=["encoder", "cross"])
def test_flash_attention_unmasked_at_the_encdec_mesh_rank_shapes(cuda, s):
    gen = torch.Generator(device=cuda).manual_seed(s)
    b, t, h, hd = 2, 1024, 16, 64
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, t, h, hd), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    before = dict(build.launch_counts())
    out = fa_ops.flash_attention(q, k, v, causal=False)
    again = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    after = build.launch_counts()
    for kernel in (fa_ops.TC_KERNEL, fa_ops.NONCAUSAL_KERNEL):
        assert after.get(kernel, 0) == before.get(kernel, 0) + 2
    assert torch.equal(out, again) and torch.isfinite(out).all()
    plain = flash_attention_ref(q, k, v, causal=False)
    _close(out, plain, True)
    assert _bf16_equal_share(out, plain) >= 0.99


def test_flash_attention_bwd_at_the_context_parallel_rank_shape(cuda):
    q, k, v, do = _cp_inputs(cuda)
    out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    before = dict(build.launch_counts())
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    again = fa_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after.get(fa_ops.BWD_TC_KERNEL, 0) == before.get(fa_ops.BWD_TC_KERNEL, 0) + 2
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a) and torch.isfinite(g).all()
        _bwd_close(g, w, True)
