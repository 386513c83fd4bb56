"""The port's multi-head GAT path against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the port
runs its kernels' plain versions here (``test_torch_kernels_gpu.py`` holds the
CUDA kernels against them on the card). Tolerances:

- fused attention vs the reference's (Pallas interpret and ``attend_tiles_ref``)
  and vs the decomposed layer: atol 5e-5, rtol 1e-4 (tests/test_gat.py:101);
- multi-head AGE: atol 1e-4 (tests/test_kernels.py:34);
- ``edge_softmax``: atol 1e-6, rtol 1e-5 (one f32 exp and division per edge);
- float model: atol 5e-4, rtol 1e-3 (tests/test_gat.py:62); mixed model:
  ``assert_mixed_close`` (tests/test_gnn_models.py:79-80).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.configs.base import get_config as ref_get_config
from repro.core import build_edge_tile_plan
from repro.core import message_passing as ref_mp
from repro.graphs.datasets import make_dataset, make_lognormal_graph
from repro.kernels.segment_agg import attn_ops as ref_attn
from repro.kernels.segment_agg import ref as ref_ref
from repro.models.gnn import api as ref_api
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_config as port_get_config
from repro_torch.core import aggregation as port_aggregation
from repro_torch.core.aggregation import to_device_plan
from repro_torch.core.quantization import compute_scale_zp, dequantize, quantize
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import build
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.kernels.segment_agg import ref as port_ref
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine

ATTN_ATOL, ATTN_RTOL = 5e-5, 1e-4


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


def _small(precision="mixed", heads=2):
    return cfg_pair("gat", d_model=24, d_ff=16, vocab_size=8, gnn_precision=precision,
                    gnn_edges_per_tile=64, gnn_heads=heads)


def _engines(rcfg, pcfg, g, use_kernel=False):
    rg = ref_api.prepare_graph(rcfg, g)
    reng = ref_mp.AmpleEngine(
        rg, dataclasses.replace(ref_api.engine_config(rcfg), use_kernel=use_kernel))
    peng = port_api.make_engine(pcfg, port_api.prepare_graph(pcfg, _port_graph(g)))
    return reng, peng


def _tiles(heads, dh, ept=16, n=90, seed=0):
    """A tile plan with split nodes, static coeffs, and per-edge inputs
    [E_graph, H] (the port's operands; the reference takes them in tile
    layout, ``_tile_layout``)."""
    g = make_lognormal_graph(n, 8.0, seed=seed)
    rng = np.random.default_rng(seed)
    plan = build_edge_tile_plan(
        g, edges_per_tile=ept, coeff=rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32))
    z = rng.standard_normal((n, heads, dh)).astype(np.float32)
    edges = rng.standard_normal((g.num_edges, heads)).astype(np.float32)
    return plan, z, edges


def _tile_layout(plan, edges, fill):
    """Per-edge values [E_graph, H] in the reference kernels' tile layout
    [T, E, H], ``fill`` on padding lanes."""
    live = plan.edge_ids >= 0
    return np.where(live[..., None], edges[np.where(live, plan.edge_ids, 0)],
                    fill).astype(np.float32)


def _codes(z):
    """int8 codes of z with symmetric per-tensor scale (as the engine makes
    them), their QuantParams, and dequantize(quantize(z)) as numpy."""
    zt = torch.from_numpy(z)
    qp = compute_scale_zp(zt, symmetric=True)
    q = quantize(zt, qp)
    return q, qp, dequantize(q, qp).numpy()


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
def test_configs_match_reference_on_shared_fields(arch, reduced):
    ref = ref_get_config(f"ample-{arch}", reduced=reduced)
    port = port_get_config(f"ample-{arch}", reduced=reduced)
    shared = [f.name for f in dataclasses.fields(ModelConfig)]
    assert "gnn_heads" in shared
    for name in shared:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.gnn_layer_dims == ref.gnn_layer_dims


# ------------------------------------------------------------------ kernels
def _attend_port(plan, z, scores, qp=None):
    dp = to_device_plan(plan, "cpu")
    return attn_ops.attend_tiles(z, dp.gather_idx, dp.edge_ids, torch.from_numpy(scores),
                                 dp.coeff, dp.seg_ids, dp.out_node, dp.split,
                                 num_nodes=plan.num_nodes, leaky_slope=0.2, qp=qp).numpy()


def _attend_reference(plan, z, scores):
    """The reference's Pallas kernel (interpret mode) and its ref.py."""
    kw = dict(num_nodes=plan.num_nodes, leaky_slope=0.2,
              segments_per_tile=plan.segments_per_tile)
    rargs = [jnp.asarray(a) for a in (z, plan.gather_idx, _tile_layout(plan, scores, -np.inf),
                                      plan.coeff, plan.seg_ids, plan.out_node)]
    return (np.asarray(ref_attn.attend_tiles(*rargs, interpret=True, **kw)),
            np.asarray(ref_ref.attend_tiles_ref(*rargs, **kw)))


@pytest.mark.parametrize("heads,dh", [(1, 8), (2, 12), (4, 5)])
def test_attend_tiles_plain_matches_reference_pallas_and_ref(heads, dh):
    plan, z, scores = _tiles(heads, dh, seed=heads)
    port = _attend_port(plan, torch.from_numpy(z), scores)
    pallas, oracle = _attend_reference(plan, z, scores)
    assert port.shape == (plan.num_nodes, heads, dh) and np.isfinite(port).all()
    np.testing.assert_allclose(port, pallas, atol=ATTN_ATOL, rtol=ATTN_RTOL)
    np.testing.assert_allclose(port, oracle, atol=ATTN_ATOL, rtol=ATTN_RTOL)


@pytest.mark.parametrize("heads,dh", [(1, 8), (2, 12), (4, 5)])
def test_attend_tiles_int8_codes_plain_matches_reference_and_f32_rows(heads, dh):
    """int8 codes with their scale: bitwise the f32 plain version on
    dequantize(quantize(z)), and the reference on those rows."""
    plan, z, scores = _tiles(heads, dh, seed=20 + heads)
    q, qp, zdq = _codes(z)
    port = _attend_port(plan, q, scores, qp=qp)
    assert np.array_equal(port, _attend_port(plan, torch.from_numpy(zdq), scores))
    pallas, oracle = _attend_reference(plan, zdq, scores)
    np.testing.assert_allclose(port, pallas, atol=ATTN_ATOL, rtol=ATTN_RTOL)
    np.testing.assert_allclose(port, oracle, atol=ATTN_ATOL, rtol=ATTN_RTOL)


def test_combine_attention_matches_reference():
    rng = np.random.default_rng(4)
    t, s, h, dh, n = 6, 5, 3, 4, 7
    m = rng.standard_normal((t, s, h)).astype(np.float32)
    m[0, 0] = -np.inf  # an empty segment's row
    l = rng.uniform(0.5, 2.0, (t, s, h)).astype(np.float32)
    l[0, 0] = 0.0
    a = rng.standard_normal((t, s, h, dh)).astype(np.float32)
    a[0, 0] = 0.0
    out_node = rng.integers(0, n + 1, (t, s)).astype(np.int32)  # n = sentinel
    want = ref_attn.combine_attention(jnp.asarray(m), jnp.asarray(l), jnp.asarray(a),
                                      jnp.asarray(out_node), num_nodes=n, dh=dh)
    got = port_ref.combine_attention(
        torch.from_numpy(m.reshape(-1, h)), torch.from_numpy(l.reshape(-1, h)),
        torch.from_numpy(a.reshape(-1, h, dh)), torch.from_numpy(out_node.reshape(-1)),
        num_nodes=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=ATTN_RTOL)


def _mh_port(plan, x, coeff, qp=None):
    dp = to_device_plan(plan, "cpu")
    return attn_ops.aggregate_tiles_mh(x, dp.gather_idx, dp.edge_ids, torch.from_numpy(coeff),
                                       dp.coeff, dp.seg_ids, dp.out_node, dp.split,
                                       num_nodes=plan.num_nodes, qp=qp).numpy()


def _mh_reference(plan, x, coeff):
    """The reference takes the lane weights coeff·edge_coeff in tile layout."""
    lanes = (plan.coeff[..., None] * _tile_layout(plan, coeff, 0.0)).astype(np.float32)
    rargs = [jnp.asarray(a) for a in (x, plan.gather_idx, lanes, plan.seg_ids, plan.out_node)]
    kw = dict(num_nodes=plan.num_nodes, segments_per_tile=plan.segments_per_tile)
    return (np.asarray(ref_attn.aggregate_tiles_mh(*rargs, interpret=True, **kw)),
            np.asarray(ref_ref.aggregate_tiles_mh_ref(*rargs, **kw)))


def _mh_edges(heads, dh, seed):
    plan, x, coeff = _tiles(heads, dh, seed=seed)
    if heads > 1:
        coeff[::3, 0] = 0.0  # edges dead for one head only
    return plan, x, coeff


@pytest.mark.parametrize("heads,dh", [(1, 8), (2, 12), (4, 5)])
def test_aggregate_tiles_mh_plain_matches_reference_pallas_and_ref(heads, dh):
    plan, x, coeff = _mh_edges(heads, dh, seed=10 + heads)
    port = _mh_port(plan, torch.from_numpy(x), coeff)
    pallas, oracle = _mh_reference(plan, x, coeff)
    np.testing.assert_allclose(port, pallas, atol=1e-4)
    np.testing.assert_allclose(port, oracle, atol=1e-4)


@pytest.mark.parametrize("heads,dh", [(1, 8), (2, 12), (4, 5)])
def test_aggregate_tiles_mh_int8_codes_plain_matches_reference_and_f32_rows(heads, dh):
    plan, x, coeff = _mh_edges(heads, dh, seed=30 + heads)
    q, qp, xdq = _codes(x)
    port = _mh_port(plan, q, coeff, qp=qp)
    assert np.array_equal(port, _mh_port(plan, torch.from_numpy(xdq), coeff))
    pallas, oracle = _mh_reference(plan, xdq, coeff)
    np.testing.assert_allclose(port, pallas, atol=1e-4)
    np.testing.assert_allclose(port, oracle, atol=1e-4)


def test_aggregate_tiles_mh_without_static_coeff_is_ones():
    """coeff None stands for ones (the softmax denominator pass): the same
    result as a static coeff of ones, bitwise."""
    plan, x, coeff = _mh_edges(2, 3, seed=6)
    dp = to_device_plan(plan, "cpu")
    args = (torch.from_numpy(x), dp.gather_idx, dp.edge_ids, torch.from_numpy(coeff))
    rest = (dp.seg_ids, dp.out_node, dp.split)
    none = attn_ops.aggregate_tiles_mh(*args, None, *rest, num_nodes=plan.num_nodes)
    ones = attn_ops.aggregate_tiles_mh(*args, torch.ones_like(dp.coeff), *rest,
                                       num_nodes=plan.num_nodes)
    assert torch.equal(none, ones)


def test_gat_wrappers_on_cpu_tensors_run_plain_versions_without_a_launch():
    plan, z, edges = _tiles(2, 4, seed=5)
    dp = to_device_plan(plan, "cpu")
    before = build.launch_counts()
    attn_ops.attend_tiles(torch.from_numpy(z), dp.gather_idx, dp.edge_ids,
                          torch.from_numpy(edges), dp.coeff, dp.seg_ids, dp.out_node, dp.split,
                          num_nodes=plan.num_nodes, leaky_slope=0.2)
    attn_ops.aggregate_tiles_mh(torch.from_numpy(z), dp.gather_idx, dp.edge_ids,
                                torch.from_numpy(edges), dp.coeff, dp.seg_ids, dp.out_node,
                                dp.split, num_nodes=plan.num_nodes)
    assert build.launch_counts() == before


@pytest.mark.parametrize("elem", [4, 1])
@pytest.mark.parametrize("d", [256, 400])
def test_walk_geometry_fills_the_load_slots(d, elem):
    """At the served widths the column map takes 16-byte chunks and keeps at
    least 90% of the block's threads on a chunk; two blocks fit on an SM."""
    wk = attn_ops.walk_geometry(256, 256, 4, d, elem)
    assert wk.chunk_bytes == 16 and wk.chunks * 16 == d * elem
    assert wk.live_share >= 0.9 and wk.threads % 32 == 0 and wk.threads >= 256
    assert wk.lanes_per_stage >= 2 and -(-wk.per_group // wk.lanes_per_stage) >= 2
    assert (wk.groups - 1) * wk.per_group < 256 <= wk.groups * wk.per_group
    assert 2 * (wk.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("d,elem,base,chunk", [
    (400, 4, 4, 4), (20, 4, 0, 16), (5, 4, 0, 4), (20, 1, 0, 4), (24, 1, 4, 4),
    (400, 1, 2, 1), (3, 1, 0, 1), (4, 4, 0, 16),
])
def test_walk_geometry_chunks_follow_row_alignment(d, elem, base, chunk):
    wk = attn_ops.walk_geometry(64, 64, 1, d, elem, base)
    assert wk.chunk_bytes == chunk and wk.chunks * chunk == d * elem
    assert wk.groups * wk.chunks <= wk.threads <= 512


# The AGE's walk (one head) at the GCN widths: (d, element bytes, row stride,
# chunk bytes). Codes at d 300 take 4-byte chunks from contiguous rows and
# 16-byte chunks from rows padded to a stride of 304.
@pytest.mark.parametrize("d,elem,ld,chunk", [
    (300, 4, 300, 16), (256, 4, 256, 16), (300, 1, 300, 4), (256, 1, 256, 16),
    (300, 1, 304, 16),
])
def test_walk_geometry_for_the_age(d, elem, ld, chunk):
    wk = attn_ops.walk_geometry(256, 256, 1, d, elem, 0, ld)
    assert wk.chunk_bytes == chunk and wk.chunks == -(-d * elem // chunk)
    assert wk.chunks * chunk <= ld * elem
    best = max(g * wk.chunks / (-(-g * wk.chunks // 32) * 32)
               for g in range(1, 512 // wk.chunks + 1))
    assert wk.live_share >= 0.9 or wk.live_share == best
    assert wk.threads % 32 == 0 and wk.threads >= 256
    assert (wk.groups - 1) * wk.per_group < 256 <= wk.groups * wk.per_group
    assert 2 * (wk.smem_bytes + 1024) <= 233472  # two blocks on an SM


def test_walk_geometry_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        attn_ops.walk_geometry(4096, 4096, 4, 8, 4)
    with pytest.raises(ValueError, match="threads"):
        attn_ops.walk_geometry(256, 256, 4, 4100, 4)


# ------------------------------------------------------------------- engine
@pytest.mark.parametrize("heads", [0, 3])  # 0: a 1-D score vector
def test_edge_softmax_matches_reference(graph, heads):
    rcfg, pcfg = _small(heads=max(heads, 1))
    reng, peng = _engines(rcfg, pcfg, graph)
    e = reng.graph.num_edges
    shape = (e, heads) if heads else (e,)
    s = np.random.default_rng(heads).standard_normal(shape).astype(np.float32) * 3
    want = np.asarray(reng.edge_softmax(jnp.asarray(s)))
    got = peng.edge_softmax(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kind", ["vector", "heads", "uniform"])
def test_aggregate_with_edge_coeff_matches_reference(graph, kind):
    rcfg, pcfg = _small(precision="float")
    reng, peng = _engines(rcfg, pcfg, graph)
    n, e = reng.graph.num_nodes, reng.graph.num_edges
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, 3, 4) if kind != "vector" else (n, 6)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, (e, 3) if kind == "heads" else (e,)).astype(np.float32)
    want = np.asarray(reng.aggregate(jnp.asarray(x), mode="runtime", edge_coeff=jnp.asarray(c)))
    got = peng.aggregate(torch.from_numpy(x), mode="runtime", edge_coeff=torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    with pytest.raises(ValueError, match="edge_coeff must be"):
        peng.aggregate(torch.from_numpy(x), mode="runtime", edge_coeff=torch.ones(e + 1))


@pytest.mark.parametrize("precision", ["float", "mixed"])
def test_decomposed_layer_matches_fused(graph, precision):
    rcfg, pcfg = _small(precision=precision, heads=4)
    _, peng = _engines(rcfg, pcfg, graph)
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.standard_normal((graph.num_nodes, 4, 6)).astype(np.float32))
    scores = torch.from_numpy(rng.standard_normal((peng.graph.num_edges, 4)).astype(np.float32))
    fused = peng.attention_aggregate(scores, z)
    alpha = peng.edge_softmax(torch.where(scores >= 0, scores, 0.2 * scores))
    decomposed = peng.aggregate(z, mode="runtime", edge_coeff=alpha)
    np.testing.assert_allclose(decomposed.numpy(), fused.numpy(), atol=ATTN_ATOL, rtol=ATTN_RTOL)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_gat_float_matches_reference_and_oracle(graph, heads):
    rcfg, pcfg = _small(precision="float", heads=heads)
    rp, pp = params_pair(rcfg, pcfg, seed=heads)
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
def test_gat_mixed_matches_reference_engine(graph, use_kernel):
    rcfg, pcfg = _small(precision="mixed", heads=2)
    rp, pp = params_pair(rcfg, pcfg, seed=11)
    reng, peng = _engines(rcfg, pcfg, graph, use_kernel=use_kernel)
    x = graph.features
    reng.begin_forward()
    peng.begin_forward()
    ref = np.asarray(ref_api.gnn_apply(rcfg, rp, reng, jnp.asarray(x)))
    port = port_api.gnn_apply(pcfg, pp, peng, torch.from_numpy(x)).numpy()
    assert_mixed_close(port, ref)


def test_gat_full_widths_forward_matches_reference():
    """FULL ample-gat widths (300 → 256 → 100, 4 heads) on a 180-node graph."""
    g = make_dataset("yelp", max_nodes=180, max_feature_dim=300, seed=2)
    rcfg, pcfg = cfg_pair("gat", reduced=False)
    assert pcfg.gnn_heads == 4
    rp, pp = params_pair(rcfg, pcfg, seed=2)
    assert tuple(pp["layers"][1]["w"].shape) == (256, 400)
    ref, _ = ref_api.gnn_forward(rp, rcfg, {"graph": g, "features": g.features})
    port, aux = port_api.gnn_forward(pp, pcfg, {"graph": _port_graph(g), "features": g.features})
    assert port.shape == (180, 100) and float(aux) == 0.0
    assert_mixed_close(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["gcn", "gat"])
@pytest.mark.parametrize("reduced", [True, False])
def test_param_shapes_match_reference_init(arch, reduced):
    """Each arch's ``param_shapes`` is the tree of the reference's own params,
    so ``params_from_numpy`` accepts exactly what the reference makes."""
    rcfg, pcfg = cfg_pair(arch, reduced=reduced)
    rp, pp = params_pair(rcfg, pcfg, seed=0)
    want = port_api.get_arch(arch).param_shapes(pcfg)
    assert want == jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert want == jax.tree_util.tree_map(lambda a: tuple(a.shape), pp)
    own = port_api.gnn_init(pcfg, device="cpu")
    assert want == jax.tree_util.tree_map(lambda a: tuple(a.shape), own)


def test_gat_shape_and_head_checks():
    _, pcfg = _small(heads=2)
    with pytest.raises(ValueError, match="divisible"):
        port_api.gnn_init(dataclasses.replace(pcfg, gnn_heads=5), device="cpu")
    params = port_api.gnn_init(pcfg, device="cpu")
    tree = {"layers": [{k: v.numpy() for k, v in lyr.items()} for lyr in params["layers"]]}
    port_api.params_from_numpy(pcfg, tree, device="cpu")
    tree["layers"][0]["a_src"] = tree["layers"][0]["a_src"][:, :-1]
    with pytest.raises(ValueError, match="weights must be"):
        port_api.params_from_numpy(pcfg, tree, device="cpu")
    spec = port_api.get_arch("gat")
    assert spec.default_agg == "runtime" and spec.needs_self_loops
    assert "gat" in port_api.list_archs()


# ------------------------------------------------------------------ serving
def _serve_pair(buckets=(0, 0)):
    rcfg, pcfg = cfg_pair("gat", d_model=24, d_ff=16, vocab_size=8, gnn_edges_per_tile=64,
                          gnn_union_node_bucket=buckets[0], gnn_union_edge_bucket=buckets[1])
    rp, pp = params_pair(rcfg, pcfg, seed=7)
    return RefServe(rcfg, rp), GNNServeEngine(pcfg, pp, device="cpu")


@pytest.mark.parametrize("buckets", [(0, 0), (256, 2048)])
def test_gat_served_warm_equals_cold_and_matches_reference(pool, buckets):
    ref, port = _serve_pair(buckets)
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
def test_gat_infer_batch_matches_reference(pool, buckets):
    ref, port = _serve_pair(buckets)
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
        # the padded union's edge ids are relabelled into union edge space
        _, plan, eng = next(iter(port._cache.values()))
        n_real = sum(g.num_nodes for g in pool)
        assert plan.num_nodes % 256 == 0 and plan.num_nodes > n_real
        for p in plan.mode_plans["runtime"].values():
            live = p.edge_ids[p.edge_ids >= 0]
            assert live.size == p.total_edges and live.max() < plan.num_edges
        x = np.zeros((plan.num_nodes, 24), np.float32)
        x[:n_real] = np.concatenate([g.features for g in pool])
        eng.begin_forward()
        y = port_api.gnn_apply(port.cfg, port.params, eng, torch.from_numpy(x))
        assert not y[n_real:].any()  # padding rows stay zero


def test_gat_forward_makes_no_tile_layout_copy_of_the_scores(pool, graph, monkeypatch):
    """The served GAT layer and the aggregate with per-edge coefficients
    (``[E, H]``, or 1-D as one head) read them through ``edge_ids``: nothing
    builds a [T, E(, H)] copy with ``tile_edge_coeff`` (which raises here)."""
    ref, port = _serve_pair()
    rcfg, pcfg = _small(precision="mixed", heads=3)
    _, peng = _engines(rcfg, pcfg, graph)
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.standard_normal((graph.num_nodes, 3, 4)).astype(np.float32))
    alpha = peng.edge_softmax(torch.from_numpy(
        rng.standard_normal((peng.graph.num_edges, 3)).astype(np.float32)))

    def refuse(*args, **kwargs):
        raise AssertionError("tile_edge_coeff called")

    monkeypatch.setattr(port_aggregation, "tile_edge_coeff", refuse)
    g = pool[0]
    got = port.infer(_port_graph(g), g.features).outputs
    assert got.shape == (g.num_nodes, 8) and np.isfinite(got).all()
    assert_mixed_close(got, ref.infer(g, g.features).outputs)
    assert torch.isfinite(peng.aggregate(z, mode="runtime", edge_coeff=alpha)).all()
    assert torch.isfinite(peng.aggregate(z.reshape(graph.num_nodes, 12), mode="runtime",
                                         edge_coeff=alpha[:, 0].contiguous())).all()
