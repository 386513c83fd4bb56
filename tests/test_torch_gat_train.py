"""The GAT training path and QAT through the int8 FTE, against ``jax.grad`` of
the reference, on the CPU.

The port's gradients of ``attention_aggregate``, ``aggregate(edge_coeff=…)``,
``edge_softmax``, ``gat.apply`` and ``transform_int8`` come from its own
backward (the plain ``attend_tiles_bwd_ref`` and ``edge_dot_ref``, the walk on
the transposed runtime plan, the int8 dequant's Function); the reference's
from ``jax.grad`` of its jnp path (``use_kernel`` off). Inputs are made with
numpy. Float engines: atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46);
mixed engines: the mixed tolerance (tests/test_gnn_models.py:66-80); the
plain backward against autograd of the plain forward: atol 1e-5, rtol 1e-4
(one f32 exp and division per edge, sums in another order).
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
from repro.core import quantization as ref_q
from repro.core import transformation as ref_tf
from repro.graphs import csr as ref_csr
from repro.graphs.datasets import make_lognormal_graph
from repro.models.gnn import api as ref_api
from repro.models.gnn import gat as ref_gat
from repro_torch.core import message_passing as port_mp
from repro_torch.core import quantization as port_q
from repro_torch.core import scheduler as port_sched
from repro_torch.core import transformation as port_tf
from repro_torch.core.aggregation import to_device_plan
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.segment_agg import attn_ops
from repro_torch.kernels.segment_agg import ref as port_ref
from repro_torch.models.gnn import api as port_api
from repro_torch.models.gnn import gat as port_gat

ATOL, RTOL = 5e-4, 1e-3
PLAIN_ATOL, PLAIN_RTOL = 1e-5, 1e-4
EPT = 16  # lanes a tile: hubs split across tiles


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _graph(kind: str, seed: int = 0):
    """A directed graph (reference ``Graph``): ``directed`` lognormal;
    ``hub`` random with one node of in-degree 90 (split over tiles of 16
    lanes); ``isolated`` random with node 7 given no in-edges."""
    if kind == "directed":
        return make_lognormal_graph(160, 5.0, seed=21 + seed)
    rng = np.random.default_rng(5 + seed)
    n = 110
    src = rng.integers(0, n, 420)
    dst = rng.integers(0, n, 420)
    if kind == "hub":
        src = np.concatenate([src, np.arange(10, 100)])
        dst = np.concatenate([dst, np.zeros(90, np.int64)])
    else:
        keep = dst != 7
        src, dst = src[keep], dst[keep]
    return ref_csr.from_edge_list(src, dst, n)


def _engines(g, mixed):
    reng = ref_mp.AmpleEngine(g, ref_mp.EngineConfig(edges_per_tile=EPT, mixed_precision=mixed))
    peng = port_mp.AmpleEngine(_port_graph(g),
                               port_mp.EngineConfig(edges_per_tile=EPT, mixed_precision=mixed))
    return reng, peng


def _close(got, want, mixed=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if mixed:
        assert_mixed_close(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def _scores(rng, e, h):
    """Raw scores with exact zeros on every 7th edge (LeakyReLU's kink)."""
    s = rng.standard_normal((e, h)).astype(np.float32) * 2
    s[::7] = 0.0
    return s


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kind", ["directed", "hub", "isolated"])
def test_attention_aggregate_grad_matches_jax(kind, mixed):
    g = _graph(kind)
    reng, peng = _engines(g, mixed)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((g.num_nodes, 3, 5)).astype(np.float32)
    s = _scores(rng, g.num_edges, 3)
    r = rng.standard_normal(z.shape).astype(np.float32)

    def loss(sc, zz):
        return jnp.sum(reng.attention_aggregate(sc, zz) * r)

    want_s, want_z = jax.grad(loss, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(z))
    st = torch.from_numpy(s).requires_grad_()
    zt = torch.from_numpy(z).requires_grad_()
    y = peng.attention_aggregate(st, zt)
    (y * torch.from_numpy(r)).sum().backward()
    assert torch.isfinite(st.grad).all() and torch.isfinite(zt.grad).all()
    _close(st.grad, want_s, mixed)
    _close(zt.grad, want_z, mixed)
    with torch.no_grad():  # the forward under grad is the serving forward
        assert torch.equal(y.detach(), peng.attention_aggregate(torch.from_numpy(s),
                                                                torch.from_numpy(z)))
    assert set(peng._tplans) == ({("runtime", "float")} if "float" in peng.plans("runtime")
                                 else set())
    if kind == "isolated":  # no in-edges: a zero row, and no gradient from it
        assert not y[7].any()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("heads", [0, 3])  # 0: one coefficient an edge
def test_aggregate_edge_coeff_grad_matches_jax(heads, mixed):
    g = _graph("hub")
    reng, peng = _engines(g, mixed)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((g.num_nodes, heads, 4) if heads else (g.num_nodes, 6))
    c = rng.uniform(0.1, 1.0, (g.num_edges, heads) if heads else (g.num_edges,))
    r = rng.standard_normal(x.shape)
    x, c, r = (a.astype(np.float32) for a in (x, c, r))

    def loss(xx, cc):
        return jnp.sum(reng.aggregate(xx, mode="runtime", edge_coeff=cc) * r)

    want_x, want_c = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    y = peng.aggregate(xt, mode="runtime", edge_coeff=ct)
    (y * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, want_x, mixed)
    _close(ct.grad, want_c, mixed)
    with torch.no_grad():
        assert torch.equal(y.detach(), peng.aggregate(torch.from_numpy(x), mode="runtime",
                                                      edge_coeff=torch.from_numpy(c)))


@pytest.mark.parametrize("heads", [0, 3])
def test_edge_softmax_grad_matches_jax(heads):
    g = _graph("directed")
    reng, peng = _engines(g, True)
    rng = np.random.default_rng(6)
    shape = (g.num_edges, heads) if heads else (g.num_edges,)
    s = rng.standard_normal(shape).astype(np.float32) * 3
    r = rng.standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(reng.edge_softmax(v) * r))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    (peng.edge_softmax(st) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_edge_scores_forward_bitwise_and_grad():
    """The scores' gather onto the edges: bitwise the plain indexing, and its
    per-node sums of the gradient equal indexing's backward."""
    g = _graph("hub")
    _, peng = _engines(g, True)
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((g.num_nodes, 2)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((g.num_edges, 2)).astype(np.float32))
    src, dst = peng.edge_endpoints("cpu")
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = peng.edge_scores(at, bt)
    assert torch.equal(got.detach(), a[src] + b[dst])
    (got * r).sum().backward()
    ai, bi = a.clone().requires_grad_(), b.clone().requires_grad_()
    ((ai[src] + bi[dst]) * r).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), ai.grad.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), bi.grad.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- model
def _gat_case(kind, precision, heads=2, d_in=12):
    g = _graph(kind, seed=1)
    feats = np.random.default_rng(10).standard_normal((g.num_nodes, d_in)).astype(np.float32)
    g = g.with_features(feats)
    rcfg, pcfg = cfg_pair("gat", d_model=d_in, d_ff=16, vocab_size=6, gnn_precision=precision,
                          gnn_edges_per_tile=EPT, gnn_heads=heads)
    rp, pp = params_pair(rcfg, pcfg, seed=3)
    rg = ref_api.prepare_graph(rcfg, g)
    reng = ref_mp.AmpleEngine(rg, ref_api.engine_config(rcfg))
    peng = port_api.make_engine(pcfg, port_api.prepare_graph(pcfg, _port_graph(g)))
    return g, rcfg, pcfg, rp, pp, reng, peng


def _port_grads(pcfg, pp, peng, x, r, layer_input=None):
    params = {"layers": [{k: v.detach().requires_grad_() for k, v in lyr.items()}
                         for lyr in pp["layers"]]}
    y = port_gat.apply(pcfg, params, peng, x, layer_input=layer_input)
    leaves = [lyr[k] for lyr in params["layers"] for k in sorted(lyr)]
    return y, torch.autograd.grad((y * r).sum(), leaves)


@pytest.mark.parametrize("precision", ["float", "mixed"])
@pytest.mark.parametrize("kind", ["directed", "hub", "isolated"])
def test_gat_apply_grads_match_jax(kind, precision):
    g, rcfg, pcfg, rp, pp, reng, peng = _gat_case(kind, precision)
    r = np.random.default_rng(11).standard_normal((g.num_nodes, 6)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(ref_gat.apply(rcfg, p, reng, jnp.asarray(g.features)) * r))(rp)
    y, got = _port_grads(pcfg, pp, peng, torch.from_numpy(g.features), torch.from_numpy(r))
    mixed = precision == "mixed"
    _close(y, ref_gat.apply(rcfg, rp, reng, jnp.asarray(g.features)), mixed)
    wants = [lyr[k] for lyr in want["layers"] for k in sorted(lyr)]
    assert len(got) == len(wants) == 6
    for gl, wl in zip(got, wants):
        assert torch.isfinite(gl).all()
        _close(gl, wl, mixed)
        assert float(np.abs(np.asarray(wl)).max()) > 0


def test_gat_qat_layer_input_matches_jax():
    """Degree-Quant QAT through gat.apply: unprotected rows of each layer's
    input fake-quantized (the STE), on a float engine, against the same
    loss in the reference written out layer by layer."""
    g, rcfg, pcfg, rp, pp, reng, peng = _gat_case("directed", "float")
    protect = np.zeros(g.num_nodes, bool)
    protect[::5] = True
    r = np.random.default_rng(12).standard_normal((g.num_nodes, 6)).astype(np.float32)

    def ref_fq(h):
        hq = ref_q.fake_quant(h, ref_q.compute_scale_zp(h, symmetric=True))
        return jnp.where(jnp.asarray(protect)[:, None], h, hq)

    def ref_loss(p):  # repro/models/gnn/gat.py:84-114 with ref_fq before each FTE
        x = jnp.asarray(g.features)
        src, dst = reng.edge_endpoints()
        n = reng.graph.num_nodes
        for i, lyr in enumerate(p["layers"]):
            x = ref_fq(x)
            h, dh = lyr["a_src"].shape
            zh = reng.transform(x, lyr["w"]).reshape(n, h, dh)
            sc = (jnp.einsum("nhd,hd->nh", zh, lyr["a_src"])[src]
                  + jnp.einsum("nhd,hd->nh", zh, lyr["a_dst"])[dst])
            out = reng.attention_aggregate(sc, zh, leaky_slope=port_gat.LEAKY_SLOPE)
            x = jax.nn.elu(out.reshape(n, h * dh)) if i == 0 else out.sum(axis=1) / float(h)
        return jnp.sum(x * r)

    want = jax.grad(ref_loss)(rp)
    pmask = torch.from_numpy(protect)

    def fq(h):
        hq = port_q.fake_quant(h, port_q.compute_scale_zp(h, symmetric=True))
        return torch.where(pmask[:, None], h, hq)

    _, got = _port_grads(pcfg, pp, peng, torch.from_numpy(g.features), torch.from_numpy(r), fq)
    for gl, wl in zip(got, [lyr[k] for lyr in want["layers"] for k in sorted(lyr)]):
        _close(gl, wl)


# ----------------------------------------------------------------- int8 FTE
def test_transform_int8_grad_matches_jax():
    """h, the weight and both scales, as jax.grad of the reference's jnp
    path gives them: the codes pass nothing, the scales carry it all."""
    rng = np.random.default_rng(13)
    h = rng.standard_normal((37, 20)).astype(np.float32)
    w = rng.standard_normal((20, 9)).astype(np.float32)
    r = rng.standard_normal((37, 9)).astype(np.float32)

    def ref_loss(hh, ww):
        w_q, w_qp = ref_q.quantize_per_channel(ww, axis=-1)
        return jnp.sum(ref_tf.transform_int8(hh, w_q, w_qp) * r)

    want_h, want_w = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = port_tf.transform_int8(ht, *port_q.quantize_per_channel(wt, axis=-1))
    (y * torch.from_numpy(r)).sum().backward()
    _close(ht.grad, want_h)
    _close(wt.grad, want_w)
    assert np.abs(np.asarray(want_h)).max() > 0 and np.abs(np.asarray(want_w)).max() > 0

    # the scales themselves, the codes fixed
    rq, rqp = ref_q.quantize_per_channel(jnp.asarray(w), axis=-1)
    ra = ref_q.compute_scale_zp(jnp.asarray(h), symmetric=True)

    def scale_loss(sa, sw):
        return jnp.sum(ref_tf.transform_int8(
            jnp.asarray(h), rq, ref_q.QuantParams(sw, rqp.zero_point), a_qp=ref_q.QuantParams(
                sa, ra.zero_point)) * r)

    want_sa, want_sw = jax.grad(scale_loss, argnums=(0, 1))(ra.scale, rqp.scale)
    pq, pqp = port_q.quantize_per_channel(torch.from_numpy(w), axis=-1)
    pa = port_q.compute_scale_zp(torch.from_numpy(h), symmetric=True)
    sa, sw = pa.scale.clone().requires_grad_(), pqp.scale.clone().requires_grad_()
    y = port_tf.transform_int8(torch.from_numpy(h), pq, port_q.QuantParams(sw, pqp.zero_point),
                               a_qp=port_q.QuantParams(sa, pa.zero_point))
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(sa.grad.numpy(), np.asarray(want_sa), rtol=1e-4)
    np.testing.assert_allclose(sw.grad.numpy(), np.asarray(want_sw), rtol=1e-4)
    with torch.no_grad():  # the forward is the serving forward, bitwise
        assert torch.equal(y.detach(), port_tf.transform_int8(
            torch.from_numpy(h), pq, pqp, a_qp=pa))


def test_mixed_transform_grad_matches_jax():
    """The engine's mixed FTE under grad: the weight's int8 copy and scale
    are formed in the graph, as under jax.grad (the reference's id(w) cache
    sees a new tracer each call)."""
    g = _graph("directed").with_features(
        np.random.default_rng(14).standard_normal((160, 10)).astype(np.float32))
    reng, peng = _engines(g, True)
    w = np.random.default_rng(15).standard_normal((10, 7)).astype(np.float32)
    r = np.random.default_rng(16).standard_normal((160, 7)).astype(np.float32)
    x = g.features
    want_x, want_w = jax.grad(lambda xx, ww: jnp.sum(reng.transform(xx, ww) * r),
                              argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (peng.transform(xt, wt) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, want_x, mixed=True)
    _close(wt.grad, want_w, mixed=True)
    assert not peng._wq_cache


# ----------------------------------------------------- plans and plain bwd
def _transpose_as_before(plan):
    """``transpose_plan_graph`` on static plans as the port wrote it before
    it carried edge ids (coefficient-0 lanes dropped)."""
    n = plan.num_nodes
    dst = np.take_along_axis(plan.out_node, plan.seg_ids, axis=1)
    live = (dst < n) & (plan.coeff != 0)
    src = plan.gather_idx[live].astype(np.int64)
    dst = dst[live].astype(np.int64)
    coeff = plan.coeff[live]
    order = np.lexsort((dst, src))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst[order].astype(np.int32), np.ascontiguousarray(coeff[order], np.float32)


@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("mixed", [False, True])
def test_transpose_plan_graph_static_arrays_unchanged(mode, mixed):
    g = _port_graph(ref_csr.add_self_loops(_graph("hub")))
    eng = port_mp.AmpleEngine(g, port_mp.EngineConfig(edges_per_tile=EPT, mixed_precision=mixed))
    for plan in eng.plans(mode).values():
        gt, coeff, tags, eids = port_sched.transpose_plan_graph(plan)
        indptr, indices, want_coeff = _transpose_as_before(plan)
        assert gt.indptr.dtype == indptr.dtype and np.array_equal(gt.indptr, indptr)
        assert gt.indices.dtype == indices.dtype and np.array_equal(gt.indices, indices)
        assert coeff.dtype == want_coeff.dtype and np.array_equal(coeff, want_coeff)
        assert (tags == "float").all() and eids.shape == indices.shape


@pytest.mark.parametrize("mixed", [False, True])
def test_transposed_runtime_plan_keeps_every_edge_in_forward_edge_space(mixed):
    g = _port_graph(_graph("isolated"))
    eng = port_mp.AmpleEngine(g, port_mp.EngineConfig(edges_per_tile=EPT, mixed_precision=mixed))
    real = []
    for tag, plan in eng.plans("runtime").items():
        gt, _, _, eids = port_sched.transpose_plan_graph(plan, runtime=True)
        assert gt.num_edges == plan.total_edges
        np.testing.assert_array_equal(np.sort(eids), np.sort(plan.edge_ids[plan.edge_ids >= 0]))
        tp = eng._transposed_plan("runtime", tag, torch.device("cpu"))
        lanes = tp.edge_ids.numpy()
        live = lanes >= 0
        # a lane of the transposed plan gathers the forward edge's destination
        # and writes its source
        fwd_dst = np.repeat(np.arange(g.num_nodes), g.degrees)
        np.testing.assert_array_equal(tp.gather_idx.numpy()[live], fwd_dst[lanes[live]])
        real.append(lanes[live])
    assert np.array_equal(np.sort(np.concatenate(real)), np.arange(g.num_edges))


def _tile_case(heads, dh, seed, codes):
    g = _port_graph(_graph("hub", seed=seed))
    eng = port_mp.AmpleEngine(g, port_mp.EngineConfig(edges_per_tile=EPT, mixed_precision=False))
    dp = eng._device_plans("runtime", eng.plans("runtime"), torch.device("cpu"))["float"]
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((g.num_nodes, heads, dh)).astype(np.float32))
    s = torch.from_numpy(_scores(rng, g.num_edges, heads))
    r = torch.from_numpy(rng.standard_normal((g.num_nodes, heads, dh)).astype(np.float32))
    qp = None
    if codes:
        qp = port_q.compute_scale_zp(z, symmetric=True)
        qp = port_q.QuantParams(qp.scale.clone().requires_grad_(), qp.zero_point)
    return eng, dp, z, s, r, qp


@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("heads,dh", [(1, 8), (4, 5)])
def test_attend_tiles_backward_matches_autograd_of_the_plain_forward(heads, dh, codes):
    """The Function's backward (plain bwd + transposed walk) against torch
    autograd through ``attend_tiles_ref``; on codes, the scale's gradient."""
    eng, dp, z, s, r, qp = _tile_case(heads, dh, 2 + heads, codes)
    n = eng.graph.num_nodes
    tiles = (dp.gather_idx, dp.edge_ids)
    rest = (dp.coeff, dp.seg_ids, dp.out_node, dp.split)
    x = z if qp is None else port_q.quantize(z, qp)
    grad = eng._tile_grad("runtime", "float", torch.device("cpu"))

    def run(fn, **kw):
        st = s.clone().requires_grad_()
        zt = x.clone().requires_grad_() if qp is None else x
        if qp is not None:
            qp.scale.grad = None
        y = fn(zt, *tiles, st, *rest, num_nodes=n, leaky_slope=0.2, qp=qp, **kw)
        (y * r).sum().backward()
        return y.detach(), st.grad, (zt.grad if qp is None else qp.scale.grad.clone())

    got = run(attn_ops.attend_tiles, grad=grad)
    want = run(port_ref.attend_tiles_ref)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PLAIN_ATOL, rtol=PLAIN_RTOL)


def test_attend_tiles_lse_is_the_destinations_logsumexp():
    """The log-sum-exp beside the output, split nodes combined, against a
    dense per-node logsumexp of the activated scores; the output is
    bitwise the one without it."""
    eng, dp, z, s, _, _ = _tile_case(3, 4, 7, False)
    n = eng.graph.num_nodes
    args = (z, dp.gather_idx, dp.edge_ids, s, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
    lse = torch.full((n, 3), float("nan"))
    out = attn_ops.attend_tiles(*args, num_nodes=n, leaky_slope=0.2, lse=lse)
    assert torch.equal(out, attn_ops.attend_tiles(*args, num_nodes=n, leaky_slope=0.2))
    assert dp.split.num_slots > 0  # the hub is split
    act = torch.where(s >= 0, s, 0.2 * s)
    g = eng.graph
    for i in range(n):
        lo, hi = int(g.indptr[i]), int(g.indptr[i + 1])
        if hi > lo:
            want = torch.logsumexp(act[lo:hi], dim=0)
            np.testing.assert_allclose(lse[i].numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("codes", [False, True])
def test_aggregate_tiles_mh_backward_matches_autograd_of_the_plain_forward(codes):
    eng, dp, z, _, r, qp = _tile_case(3, 4, 8, codes)
    n, e = eng.graph.num_nodes, eng.graph.num_edges
    c = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 1, (e, 3)).astype(np.float32))
    x = z if qp is None else port_q.quantize(z, qp)
    grad = eng._tile_grad("runtime", "float", torch.device("cpu"))
    tiles = (dp.gather_idx, dp.edge_ids)

    def run(fn, **kw):
        ct = c.clone().requires_grad_()
        xt = x.clone().requires_grad_() if qp is None else x
        if qp is not None:
            qp.scale.grad = None
        y = fn(xt, *tiles, ct, dp.coeff, dp.seg_ids, dp.out_node, dp.split, num_nodes=n, qp=qp,
               **kw)
        (y * r).sum().backward()
        return y.detach(), ct.grad, (xt.grad if qp is None else qp.scale.grad.clone())

    got = run(attn_ops.aggregate_tiles_mh, grad=grad)
    want = run(port_ref.aggregate_tiles_mh_ref)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PLAIN_ATOL, rtol=PLAIN_RTOL)


def test_grad_calls_refuse_what_they_cannot_differentiate():
    eng, dp, z, s, _, _ = _tile_case(2, 4, 9, False)
    n = eng.graph.num_nodes
    zt = z.clone().requires_grad_()
    args = (zt, dp.gather_idx, dp.edge_ids, s, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
    with pytest.raises(ValueError, match="needs grad="):
        attn_ops.attend_tiles(*args, num_nodes=n, leaky_slope=0.2)
    grad = eng._tile_grad("runtime", "float", torch.device("cpu"))
    with pytest.raises(ValueError, match="pass no out="):
        attn_ops.attend_tiles(*args, num_nodes=n, leaky_slope=0.2, grad=grad,
                              out=torch.zeros(z.shape))
    q = port_q.compute_scale_zp(z)
    qp = port_q.QuantParams(q.scale, q.zero_point.clone().requires_grad_())
    with pytest.raises(ValueError, match="zero point"):
        attn_ops.attend_tiles(port_q.quantize(z, q), *args[1:], num_nodes=n, leaky_slope=0.2,
                              qp=qp, grad=grad)
    with torch.no_grad():  # serving needs none of it
        attn_ops.attend_tiles(*args, num_nodes=n, leaky_slope=0.2)


def test_gat_train_step_uses_the_engine_caches_once():
    """Two backward passes plan each transposed group once, and the caches
    hold no autograd graph."""
    g, rcfg, pcfg, rp, pp, reng, peng = _gat_case("directed", "mixed")
    r = torch.ones((g.num_nodes, 6))
    for _ in range(2):
        _port_grads(pcfg, pp, peng, torch.from_numpy(g.features), r)
    assert set(peng._tplans) == {("runtime", t) for t in peng.plans("runtime")}
    assert not peng._wq_cache
    assert not any(qp.scale.requires_grad for qp in peng._act_qp.values())
    with torch.no_grad():
        y = port_gat.apply(pcfg, pp, peng, torch.from_numpy(g.features))
    assert torch.isfinite(y).all()
    assert dataclasses.is_dataclass(peng.cfg)


def test_row_items_cut_hubs_into_runs():
    """The backward's work items cover each row's in-edges once, in runs of
    at most ITEM_EDGES edges, and leave out rows with none."""
    g = _port_graph(_graph("isolated"))
    rows = np.arange(g.num_nodes)
    items = attn_ops.row_items(g.indptr, rows, chunk=8)
    assert items.dtype == np.int32 and (items[:, 2] - items[:, 1] <= 8).all()
    assert (items[:, 2] > items[:, 1]).all() and 7 not in items[:, 0]
    covered = np.zeros(g.num_edges, int)
    for i, lo, hi in items:
        assert g.indptr[i] <= lo < hi <= g.indptr[i + 1]
        covered[lo:hi] += 1
    assert (covered == 1).all()
    hub = _port_graph(_graph("hub"))
    big = attn_ops.row_items(hub.indptr, np.array([0]))
    assert len(big) == -(-int(hub.degrees[0]) // attn_ops.ITEM_EDGES) > 1
