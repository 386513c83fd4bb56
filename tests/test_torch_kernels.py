"""The kernels' plain versions (what a CPU tensor runs) against the reference.

AGE: the port's ``aggregate_tiles`` on CPU tensors against the reference's jnp
path (``aggregate_edge_tiles``) and its Pallas kernel in interpret mode
(``ops.aggregate_tiles``), atol 1e-4 (tests/test_kernels.py:34); on int8
codes with their ``QuantParams`` bitwise equal to dequantize-then-aggregate.
int8 FTE: bitwise against ``quant_matmul`` and ``quant_matmul_repacked``
(Pallas, interpret), including −128 codes and a ragged K.
The kernels themselves run in ``test_torch_kernels_gpu.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_edge_tile_plan, build_mixed_precision_plans
from repro.core.aggregation import aggregate_edge_tiles as ref_aggregate
from repro.core.aggregation import to_device_plan as ref_device_plan
from repro.graphs.datasets import make_lognormal_graph
from repro.kernels.quant_matmul import ops as ref_qm
from repro.kernels.segment_agg import ops as ref_seg
from repro_torch.core.aggregation import aggregate_edge_tiles, to_device_plan
from repro_torch.core.quantization import QuantParams, compute_scale_zp, dequantize, quantize
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.quant_matmul.repack import repack_weight, unpack_weight
from repro_torch.kernels.segment_agg import ops as seg_ops


def _plan_and_x(n, deg, d, ept, seed, coeff=True):
    g = make_lognormal_graph(n, deg, seed=seed)
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32) if coeff else None
    plan = build_edge_tile_plan(g, edges_per_tile=ept, coeff=c)
    return plan, rng.standard_normal((n, d)).astype(np.float32)


# ---------------------------------------------------------------- segment_agg
@pytest.mark.parametrize("d", [4, 20, 130, 300])
@pytest.mark.parametrize("ept", [16, 64])
def test_age_plain_matches_reference_jnp_and_pallas(d, ept):
    plan, x = _plan_and_x(80, 6.0, d, ept, seed=d * 7 + ept)
    kw = dict(num_nodes=80, segments_per_tile=plan.segments_per_tile)
    port = aggregate_edge_tiles(torch.from_numpy(x), to_device_plan(plan, "cpu"), num_nodes=80)
    jnp_out = ref_aggregate(jnp.asarray(x), ref_device_plan(plan), **kw)
    args = [jnp.asarray(a) for a in (plan.gather_idx, plan.coeff, plan.seg_ids, plan.out_node)]
    pallas = ref_seg.aggregate_tiles(jnp.asarray(x), *args, block_d=128, **kw)
    np.testing.assert_allclose(port.numpy(), np.asarray(jnp_out), atol=1e-4)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), atol=1e-4)


def test_age_mixed_groups_leave_other_rows_zero():
    g = make_lognormal_graph(150, 25.0, seed=3)
    tags = np.where(np.arange(150) % 5 == 0, "float", "int8")
    x = np.random.default_rng(0).standard_normal((150, 12)).astype(np.float32)
    for tag, plan in build_mixed_precision_plans(g, tags, edges_per_tile=32).items():
        out = aggregate_edge_tiles(torch.from_numpy(x), to_device_plan(plan, "cpu"), num_nodes=150)
        want = ref_aggregate(jnp.asarray(x), ref_device_plan(plan), num_nodes=150,
                             segments_per_tile=plan.segments_per_tile)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
        assert not out.numpy()[tags != tag].any()


@pytest.mark.parametrize("d", [4, 300, 256])
def test_age_plain_on_codes_equals_dequantize_then_aggregate(d):
    """The int8 group's rows as codes with their QuantParams: bitwise the
    aggregate of the dequantized rows, also from rows padded to a 16-byte
    stride and written into a shared output."""
    plan, x = _plan_and_x(90, 8.0, d, 32, seed=d)
    dp = to_device_plan(plan, "cpu")
    xt = torch.from_numpy(x)
    qps = [compute_scale_zp(xt, symmetric=True),
           QuantParams(torch.tensor(0.0371), torch.tensor(-3.0))]
    for qp in qps:
        q = quantize(xt, qp)
        want = aggregate_edge_tiles(dequantize(q, qp), dp, num_nodes=90)
        got = aggregate_edge_tiles(q, dp, num_nodes=90, qp=qp)
        assert torch.equal(got, want)
        ld = -(-d // 16) * 16
        padded = torch.zeros((90, ld), dtype=torch.int8)
        padded[:, :d] = q
        out = torch.full((90, d), 7.0)
        args = (dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
        got = seg_ops.aggregate_tiles(padded[:, :d], *args, num_nodes=90, qp=qp, out=out)
        assert got is out
        node_rows = np.unique(plan.out_node[plan.out_node < 90])
        assert torch.equal(out[node_rows], want[node_rows])
        others = np.setdiff1d(np.arange(90), node_rows)
        assert (out[others] == 7.0).all()  # rows of no segment stay as they were


def test_split_segment_map_covers_split_nodes_in_tile_order():
    plan, _ = _plan_and_x(120, 30.0, 4, 16, seed=1)  # many nodes span tiles
    split = seg_ops.split_segment_map(plan.out_node, plan.seg_ids, plan.num_nodes)
    real = plan.out_node != plan.num_nodes
    nodes, counts = np.unique(plan.out_node[real], return_counts=True)
    np.testing.assert_array_equal(split.split_node, nodes[counts > 1])
    assert split.num_slots == int(counts[counts > 1].sum()) == split.split_ptr[-1]
    assert (split.slot_of[~real] == -1).all()
    for i, node in enumerate(split.split_node):
        slots = np.arange(split.split_ptr[i], split.split_ptr[i + 1])
        t, s = np.nonzero(split.slot_of == slots[:, None, None])[1:]
        assert (plan.out_node[t, s] == node).all()
        assert (np.diff(t) > 0).all()  # partial rows follow tile order
    single = real & (split.slot_of < 0)
    assert np.isin(plan.out_node[single], nodes[counts == 1]).all()


def test_split_segment_map_rejects_unordered_lanes():
    plan, _ = _plan_and_x(40, 3.0, 4, 16, seed=2)
    segs = plan.seg_ids.copy()
    segs[0, :2] = segs[0, 1::-1] + np.array([1, 0])  # lane 0 after lane 1's segment
    with pytest.raises(ValueError, match="segment order"):
        seg_ops.split_segment_map(plan.out_node, segs, plan.num_nodes)


def test_age_cpu_tensor_runs_plain_version_without_a_launch():
    plan, x = _plan_and_x(60, 4.0, 8, 16, seed=4)
    before = build.launch_counts()
    aggregate_edge_tiles(torch.from_numpy(x), to_device_plan(plan, "cpu"), num_nodes=60)
    assert build.launch_counts() == before


# --------------------------------------------------------------- quant_matmul
@pytest.mark.parametrize(
    "m,k,n", [(8, 8, 8), (100, 64, 48), (33, 130, 7), (1, 300, 5), (70, 300, 256)]
)
def test_int8_plain_matches_reference_kernels_bitwise(m, k, n):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    ref = np.asarray(ref_qm.quant_matmul(jnp.asarray(a), jnp.asarray(b)))
    ref_packed = np.asarray(
        ref_qm.quant_matmul_repacked(jnp.asarray(a), ref_qm.repack_weight(jnp.asarray(b)))
    )
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    out = qm_ops.quant_matmul(ta, tb)
    out_packed = qm_ops.quant_matmul_repacked(ta, repack_weight(tb))
    assert out.dtype == out_packed.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out_packed.numpy(), ref_packed)


def test_int8_extreme_codes_no_overflow():
    k = 1024
    a = np.full((4, k), -128, np.int8)
    b = np.full((k, 4), -128, np.int8)
    ref = np.asarray(ref_qm.quant_matmul(jnp.asarray(a), jnp.asarray(b)))
    out = qm_ops.quant_matmul_repacked(torch.from_numpy(a), repack_weight(torch.from_numpy(b)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(out[0, 0]) == k * 128 * 128


@pytest.mark.parametrize(
    "k,n", [(1, 1), (15, 3), (16, 8), (300, 256), (130, 100), (31, 7), (4096, 512)]
)
def test_repack_layout(k, n):
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8)
    p = repack_weight(w)
    assert p.w_nk.shape == (n, -(-k // 16) * 16) and p.w_nk.is_contiguous()
    assert (p.k, p.n) == (k, n)
    assert not p.w_nk[:, k:].any()
    assert torch.equal(unpack_weight(p), w)


def test_int8_wrapper_rejects_mismatched_k():
    p = repack_weight(torch.zeros((16, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        qm_ops.quant_matmul_repacked(torch.zeros((3, 15), dtype=torch.int8), p)
