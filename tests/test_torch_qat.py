"""Degree-Quant QAT in the port against the reference, on the CPU.

The training half of ``core/degree_quant.py``, ``fake_quant``'s STE,
``optim/{adamw,schedule}.py``, the gradient of ``AmpleEngine.aggregate``
(the AGE on the transposed plan) and the QAT example
(``examples/train_gcn_degreequant_torch.py``) against
``examples/train_gcn_degreequant.py`` and ``jax.grad`` of the reference.
Inputs are made with numpy. f32 paths: atol 5e-4, rtol 1e-3
(tests/test_gnn_models.py:46); the optimiser at atol 1e-6; mixed precision
at the mixed tolerance (tests/test_gnn_models.py:66-80).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close

from repro.configs.base import get_config as ref_config
from repro.core import degree_quant as ref_dq
from repro.core import message_passing as ref_mp
from repro.core import quantization as ref_q
from repro.graphs import csr as ref_csr
from repro.graphs import datasets as ref_data
from repro.models.gnn import gcn as ref_gcn
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch.configs.base import get_config as port_config
from repro_torch.core import degree_quant as port_dq
from repro_torch.core import message_passing as port_mp
from repro_torch.core import quantization as port_q
from repro_torch.core import scheduler as port_sched
from repro_torch.graphs import csr as port_csr
from repro_torch.graphs import datasets as port_data
from repro_torch.kernels import build
from repro_torch.models.gnn import api as port_api
from repro_torch.models.gnn import gcn as port_gcn
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import schedule as port_schedule
from repro_torch.serve.gnn_engine import GNNServeEngine

ATOL, RTOL = 5e-4, 1e-3
_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_example():
    return _load_example("train_gcn_degreequant")


@pytest.fixture(scope="module")
def port_example():
    return _load_example("train_gcn_degreequant_torch")


def _port_graph(g):
    return port_csr.Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                          features=g.features, name=g.name)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ------------------------------------------------------------- fake_quant
@pytest.mark.parametrize("case", ["clipping", "calibrated"])
def test_fake_quant_value_bitwise_and_ste_gradient(case):
    rng = np.random.default_rng(11)
    if case == "clipping":  # tests/test_quantization.py:57-68: clips at ±1
        x = np.linspace(-3.0, 3.0, 61).astype(np.float32)
        calib = np.asarray([-1.0, 1.0], np.float32)
    else:
        x = (rng.standard_normal((40, 9)) * 3).astype(np.float32)
        calib = x
    rqp = ref_q.compute_scale_zp(jnp.asarray(calib), symmetric=True)
    want_y = ref_q.fake_quant(jnp.asarray(x), rqp)
    want_g = jax.grad(lambda v: jnp.sum(ref_q.fake_quant(v, rqp) ** 2))(jnp.asarray(x))

    pqp = port_q.compute_scale_zp(torch.from_numpy(calib), symmetric=True)
    scale = pqp.scale.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = port_q.fake_quant(xt, port_q.QuantParams(scale, pqp.zero_point))
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    inside = np.abs(x / float(pqp.scale)) <= 127
    assert (xt.grad.numpy()[~inside] == 0).all() and (xt.grad.numpy()[inside] != 0).any()
    assert scale.grad is None  # the STE gives the scale no gradient


# ------------------------------------------------------------ degree quant
@pytest.mark.parametrize("p_min,p_max", [(0.0, 0.2), (0.1, 0.1), (0.05, 0.5)])
def test_protection_probabilities_and_masks_bitwise(p_min, p_max):
    rg = ref_data.make_lognormal_graph(600, 6.0, seed=5)
    pg = port_data.make_lognormal_graph(600, 6.0, seed=5)
    rcfg = ref_dq.DegreeQuantConfig(p_min=p_min, p_max=p_max)
    pcfg = port_dq.DegreeQuantConfig(p_min=p_min, p_max=p_max)
    want = ref_dq.protection_probabilities(rg, rcfg)
    got = port_dq.protection_probabilities(pg, pcfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):  # successive steps draw from one generator
        np.testing.assert_array_equal(port_dq.sample_protection_mask(pg, pcfg, pr),
                                      ref_dq.sample_protection_mask(rg, rcfg, rr))


@pytest.mark.parametrize("budget,cost", [
    ({"float": {"LUT": 1000, "DSP": 40}, "int8": {"LUT": 9000, "DSP": 360}},
     {"float": {"LUT": 900, "DSP": 35}, "int8": {"LUT": 150, "DSP": 6}}),
    ({"float": {"LUT": 10, "FF": 7, "BRAM": 3}}, {"float": {"LUT": 3, "FF": 0, "BRAM": 2}}),
])
def test_allocate_nodeslots_matches_reference(budget, cost):
    assert port_dq.allocate_nodeslots(budget, cost) == ref_dq.allocate_nodeslots(budget, cost)


def test_allocate_nodeslots_refuses_disjoint_resources():
    with pytest.raises(ValueError, match="no overlapping"):
        port_dq.allocate_nodeslots({"float": {"LUT": 1}}, {"float": {"DSP": 1}})


# ------------------------------------------------------------------ optim
def _tree(rng):
    return {"layers": [{"w": rng.standard_normal((6, 4)).astype(np.float32),
                        "b": rng.standard_normal(4).astype(np.float32)},
                       {"w": rng.standard_normal((4, 3)).astype(np.float32)}],
            "eps": np.float32(0.25) * np.ones((), np.float32)}


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _np_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _np_leaves(x)]
    return [np.asarray(tree)]


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_five_steps_match_reference(scheduled):
    rng = np.random.default_rng(4)
    p0 = _tree(rng)
    rcfg = ref_adamw.AdamWConfig(lr=5e-3, weight_decay=5e-3, clip_norm=1.0)
    pcfg = port_adamw.AdamWConfig(lr=5e-3, weight_decay=5e-3, clip_norm=1.0)
    rp, rs = jax.tree_util.tree_map(jnp.asarray, p0), None
    pp = _to_torch(p0)
    rs, ps = ref_adamw.adamw_init(rp), port_adamw.adamw_init(pp)
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: a * (3.0 if step == 1 else 0.3),
                                   _tree(rng))  # step 1 clips
        rlr = plr = None
        if scheduled:
            rlr = ref_schedule.warmup_cosine(step, peak_lr=5e-3, warmup=2, total=5)
            plr = port_schedule.warmup_cosine(step, peak_lr=5e-3, warmup=2, total=5)
        rp, rs, rm = ref_adamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp,
                                            rcfg, lr=rlr)
        pp, ps, pm = port_adamw.adamw_update(_to_torch(g), ps, pp, pcfg, lr=plr)
        _close(pm["grad_norm"], rm["grad_norm"], atol=1e-6, rtol=0)
        _close(pm["lr"], rm["lr"], atol=1e-6, rtol=0)
        for got, want in zip(_np_leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(), pp)),
                             _np_leaves(rp)):
            _close(got, want, atol=1e-6, rtol=0)
        for got, want in zip(_np_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), ps.m)),
                             _np_leaves(rs.m)):
            _close(got, want, atol=1e-6, rtol=0)
    assert int(ps.step) == int(rs.step) == 5
    assert all(t.requires_grad for t in port_adamw._leaves(pp))


def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 130)
    want = ref_schedule.warmup_cosine(steps, peak_lr=3e-4, warmup=10, total=120)
    got = port_schedule.warmup_cosine(torch.from_numpy(steps), peak_lr=3e-4, warmup=10,
                                      total=120)
    _close(got, want, atol=1e-6, rtol=0)
    assert float(port_schedule.warmup_cosine(5, peak_lr=1.0, warmup=10, total=20)) == 0.5


# -------------------------------------------------------- transposed plans
def _dense(g, coeff):
    a = np.zeros((g.num_nodes, g.num_nodes), np.float64)
    rows = np.repeat(np.arange(g.num_nodes), g.degrees)
    np.add.at(a, (rows, g.indices.astype(np.int64)), coeff)
    return a


@pytest.fixture(scope="module")
def directed_graph():
    """A directed lognormal graph with self-loops: its GCN-normalised
    adjacency is not symmetric, so the backward needs the transpose."""
    return ref_csr.add_self_loops(ref_data.make_lognormal_graph(240, 5.0, seed=21))


@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("mixed", [False, True])
def test_transpose_plan_graph_is_the_reversed_group(directed_graph, mode, mixed):
    g = _port_graph(directed_graph)
    eng = port_mp.AmpleEngine(g, port_mp.EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    a = _dense(g, port_mp.aggregation_coefficients(g, mode))
    assert np.abs(a - a.T).max() > 0.1  # directed: A is not its own transpose
    for tag, plan in eng.plans(mode).items():
        gt, coeff, tags, eids = port_sched.transpose_plan_graph(plan)
        assert gt.num_nodes == g.num_nodes and (tags == "float").all()
        assert gt.num_edges == plan.total_edges
        group = np.zeros((g.num_nodes, 1))
        group[eng.node_groups[tag]] = 1.0  # the rows the group's plan writes
        np.testing.assert_array_equal(_dense(gt, coeff), (a * group).T)
        again, _, _, again_eids = port_sched.transpose_plan_graph(plan)  # deterministic
        np.testing.assert_array_equal(again.indices, gt.indices)
        np.testing.assert_array_equal(again_eids, eids)
        # each reversed edge carries its forward edge: src of gt row j is the
        # forward edge's source j, its destination the forward edge's
        src = np.repeat(np.arange(g.num_nodes), gt.degrees)
        fwd_dst = np.repeat(np.arange(g.num_nodes), g.degrees)
        np.testing.assert_array_equal(g.indices[eids], src)
        np.testing.assert_array_equal(fwd_dst[eids], gt.indices)


def test_undirected_gcn_adjacency_is_symmetric():
    """The property that would let a plan serve as its own transpose holds
    only for symmetric graphs: undirected with self-loops under GCN."""
    rg = ref_data.make_dataset("cora", max_nodes=150, max_feature_dim=8, seed=0)
    g = port_csr.add_self_loops(_port_graph(rg))
    a = _dense(g, port_mp.aggregation_coefficients(g, "gcn"))
    sym = np.abs(a - a.T).max() == 0.0
    eng = port_mp.AmpleEngine(g, port_mp.EngineConfig(edges_per_tile=64, mixed_precision=False))
    gt, coeff, _, _ = port_sched.transpose_plan_graph(eng.plans("gcn")["float"])
    np.testing.assert_array_equal(_dense(gt, coeff), a.T)
    assert sym == np.array_equal(_dense(gt, coeff), a)


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("mixed", [False, True])
def test_aggregate_grad_matches_jax(directed_graph, mode, mixed):
    g = directed_graph
    rng = np.random.default_rng(31)
    x = rng.standard_normal((g.num_nodes, 12)).astype(np.float32)
    r = rng.standard_normal((g.num_nodes, 12)).astype(np.float32)
    reng = ref_mp.AmpleEngine(g, ref_mp.EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    want = jax.grad(lambda v: jnp.sum(reng.aggregate(v, mode=mode) * r))(jnp.asarray(x))

    peng = port_mp.AmpleEngine(_port_graph(g),
                               port_mp.EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    xt = torch.from_numpy(x).requires_grad_()
    y = peng.aggregate(xt, mode=mode)
    (y * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, want)
    assert set(peng._tplans) == {(mode, "float")}  # the backward ran on a transposed plan
    with torch.no_grad():  # the forward under grad is the serving forward, bitwise
        assert torch.equal(y.detach(), peng.aggregate(torch.from_numpy(x), mode=mode))


def test_mixed_scale_gradient_matches_jax(directed_graph):
    """The int8 group passes its scale d out_I / d scale = out_I / scale."""
    g = directed_graph
    rng = np.random.default_rng(32)
    x = rng.standard_normal((g.num_nodes, 10)).astype(np.float32)
    r = rng.standard_normal((g.num_nodes, 10)).astype(np.float32)
    reng = ref_mp.AmpleEngine(g, ref_mp.EngineConfig(edges_per_tile=64, mixed_precision=True))
    rplans = reng.plans("gcn")

    def ref_loss(scale):
        from repro.core.aggregation import aggregate_mixed_precision
        qp = ref_q.QuantParams(scale, jnp.zeros_like(scale))
        y = aggregate_mixed_precision(jnp.asarray(x), rplans, num_nodes=g.num_nodes, qp=qp)
        return jnp.sum(y * r)

    s0 = ref_q.compute_scale_zp(jnp.asarray(x)).scale
    want = jax.grad(ref_loss)(s0)

    from repro_torch.core.aggregation import aggregate_autograd
    peng = port_mp.AmpleEngine(_port_graph(g),
                               port_mp.EngineConfig(edges_per_tile=64, mixed_precision=True))
    dplans = peng._device_plans("gcn", peng.plans("gcn"), torch.device("cpu"))
    scale = torch.from_numpy(np.asarray(s0)).requires_grad_()
    qp = port_q.QuantParams(scale, torch.zeros_like(scale.detach()))
    y = aggregate_autograd(torch.from_numpy(x), dplans,
                           lambda: peng._transposed_plan("gcn", "float", torch.device("cpu")),
                           num_nodes=g.num_nodes, qp=qp)
    (y * torch.from_numpy(r)).sum().backward()
    _close(scale.grad, want)
    with pytest.raises(ValueError, match="zero point"):
        aggregate_autograd(torch.from_numpy(x), dplans, None, num_nodes=g.num_nodes,
                           qp=port_q.QuantParams(scale, torch.zeros((), requires_grad=True)))


def test_engine_reuse_across_trace_and_eager():
    """tests/test_sharded_engine.py:282-297 in the port: an engine used
    under grad (training) and then eagerly (serving/eval) keeps working, and
    no cached activation scale carries an autograd graph."""
    rg = ref_data.make_dataset("cora", max_nodes=160, max_feature_dim=20, seed=2)
    eng = port_mp.AmpleEngine(_port_graph(rg),
                              port_mp.EngineConfig(edges_per_tile=64, mixed_precision=True))
    x = torch.from_numpy(rg.features)

    xg = x.clone().requires_grad_()
    eng.begin_forward()
    eng.aggregate(xg, mode="sum").sum().backward()
    assert torch.isfinite(xg.grad).all()
    assert not any(qp.scale.requires_grad for qp in eng._act_qp.values())
    eng.begin_forward()
    y = eng.aggregate(x, mode="sum")  # eager reuse after the graph
    assert torch.isfinite(y).all()
    y2 = eng.aggregate(x.clone().requires_grad_(), mode="sum")
    np.testing.assert_allclose(y2.detach().numpy(), y.numpy(), atol=1e-5)
    assert not any(qp.scale.requires_grad for qp in eng._act_qp.values())

    # the reference's gradient of the same loss
    reng = ref_mp.AmpleEngine(rg, ref_mp.EngineConfig(edges_per_tile=64, mixed_precision=True))

    def loss(v):
        reng.begin_forward()
        return reng.aggregate(v, mode="sum").sum()

    _close(xg.grad, jax.grad(loss)(jnp.asarray(rg.features)))


def test_weight_quant_cache_keeps_no_graph():
    rg = ref_data.make_dataset("cora", max_nodes=80, max_feature_dim=12, seed=1)
    eng = port_mp.AmpleEngine(_port_graph(rg), port_mp.EngineConfig(edges_per_tile=64))
    w = torch.randn(12, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    eng._weight_q(w)
    assert not eng._wq_cache
    with torch.no_grad():
        eng._weight_q(w)
    assert len(eng._wq_cache) == 1


def test_require_no_grad_raises_only_under_grad():
    """Only the AGE's bare wrapper, whose launch has no backward of its own
    (the engines differentiate it through ``aggregate_autograd``), raises,
    and only under grad; the streamed FTE, the GAT kernels, the int8 GEMM,
    flash and the SSD have a backward."""
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="segment_agg: .*aggregate_autograd"):
        build.require_no_grad("segment_agg", torch.ones(2), t)
    assert set(build._BACKWARD) == {"segment_agg"}
    build.require_no_grad("streamed_fte", t)
    for name in ("attention", "segment_agg_mh", "quant_matmul", "ssd_intra_chunk"):
        assert name not in build._BACKWARD
        build.require_no_grad(name, torch.ones(2), t)
    with torch.no_grad():
        build.require_no_grad("segment_agg", t)
    build.require_no_grad("segment_agg", torch.ones(2), None)


def test_serving_with_params_that_require_grad():
    rcfg = dataclasses.replace(ref_config("ample-gcn", reduced=True), d_model=20)
    pcfg = dataclasses.replace(port_config("ample-gcn", reduced=True), d_model=20)
    rp = ref_gcn.init(rcfg, jax.random.PRNGKey(0))
    params = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp),
                                        device="cpu")
    plain = GNNServeEngine(pcfg, params, device="cpu")
    grad_params = {"layers": [{"w": lyr["w"].clone().requires_grad_()}
                              for lyr in params["layers"]]}
    srv = GNNServeEngine(pcfg, grad_params, device="cpu")
    rg = ref_data.make_dataset("cora", max_nodes=120, max_feature_dim=20, seed=3)
    g = _port_graph(rg)
    np.testing.assert_array_equal(srv.infer(g, rg.features).outputs,
                                  plain.infer(g, rg.features).outputs)


# ---------------------------------------------------------------- example
NODES, STEPS = 200, 5


@pytest.fixture(scope="module")
def example_case(ref_example, port_example):
    """The example's data and weights in both packages, at NODES nodes."""
    base = ref_data.make_dataset("cora", max_nodes=NODES, max_feature_dim=128, seed=0)
    rg = ref_csr.add_self_loops(base).with_features(base.features)
    pg = port_example.example_graph(NODES)
    np.testing.assert_array_equal(pg.indices, rg.indices)
    np.testing.assert_array_equal(pg.features, rg.features)
    labels = ref_example.planted_labels(rg, 7, seed=1)
    train = np.zeros(rg.num_nodes, bool)
    train[np.random.default_rng(2).permutation(rg.num_nodes)[: rg.num_nodes // 2]] = True
    rcfg = dataclasses.replace(ref_config("ample-gcn", reduced=True), d_model=rg.feature_dim,
                               d_ff=32, vocab_size=7)
    pcfg = port_example.example_model(pg)
    rp = ref_gcn.init(rcfg, jax.random.PRNGKey(0))
    pp = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return dict(rg=rg, pg=pg, labels=labels, train=train, rcfg=rcfg, pcfg=pcfg, rp=rp, pp=pp)


def _ref_loss_fn(eng, x, labels, train_m):
    """examples/train_gcn_degreequant.py:70-85, verbatim."""
    def loss_fn(p, protect_mask):
        def fq(h):
            qp = ref_q.compute_scale_zp(h, symmetric=True)
            hq = ref_q.fake_quant(h, qp)
            return jnp.where(protect_mask[:, None], h, hq)

        h = fq(x)
        m = eng.aggregate(h, mode="gcn")
        h = jax.nn.relu(m @ p["layers"][0]["w"])
        h = fq(h)
        m = eng.aggregate(h, mode="gcn")
        logits = m @ p["layers"][1]["w"]
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], 1)[:, 0]
        return jnp.where(train_m, nll, 0.0).sum() / train_m.sum()
    return loss_fn


def _port_inputs(case):
    return (torch.from_numpy(case["pg"].features), torch.from_numpy(case["labels"]).long(),
            torch.from_numpy(case["train"]))


def test_example_planted_labels_equal_reference(ref_example, port_example):
    for nodes, classes in ((200, 7), (800, 7), (500, 100)):
        base = ref_data.make_dataset("cora", max_nodes=nodes, max_feature_dim=128, seed=0)
        rg = ref_csr.add_self_loops(base).with_features(base.features)
        want = ref_example.planted_labels(rg, classes, seed=1)
        got = port_example.planted_labels(_port_graph(rg), classes, seed=1)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    labels, train = port_example.node_task(_port_graph(rg), 100)
    assert train.sum() == rg.num_nodes // 2 and np.array_equal(labels, want)


def test_example_loss_and_grads_at_step0_match_jax(example_case, port_example):
    c = example_case
    reng = ref_mp.AmpleEngine(c["rg"], ref_mp.EngineConfig(mixed_precision=False))
    loss_fn = _ref_loss_fn(reng, jnp.asarray(c["rg"].features), jnp.asarray(c["labels"]),
                           jnp.asarray(c["train"]))
    mask = port_dq.sample_protection_mask(c["pg"], port_example.DQ, np.random.default_rng(3))
    assert mask.any() and not mask.all()
    want_loss, want_g = jax.value_and_grad(loss_fn)(c["rp"], jnp.asarray(mask))

    peng = port_mp.AmpleEngine(c["pg"], port_mp.EngineConfig(mixed_precision=False))
    x, labels, train = _port_inputs(c)
    loss, grads = port_example.qat_grads(port_example.trainable(c["pp"]), peng, x, labels,
                                         train, torch.from_numpy(mask))
    _close(loss.detach(), want_loss)
    for got, want in zip(grads["layers"], want_g["layers"]):
        _close(got["w"], want["w"])
        assert float(np.abs(np.asarray(want["w"])).max()) > 0


def test_example_params_after_five_steps_match_jax(example_case, port_example):
    c = example_case
    reng = ref_mp.AmpleEngine(c["rg"], ref_mp.EngineConfig(mixed_precision=False))
    grad_fn = jax.value_and_grad(_ref_loss_fn(
        reng, jnp.asarray(c["rg"].features), jnp.asarray(c["labels"]), jnp.asarray(c["train"])))
    opt_cfg = ref_adamw.AdamWConfig(lr=5e-3, weight_decay=5e-3)
    params, opt, rng = c["rp"], ref_adamw.adamw_init(c["rp"]), np.random.default_rng(3)
    want_losses = []
    for _ in range(STEPS):  # examples/train_gcn_degreequant.py:88-92
        mask = jnp.asarray(ref_dq.sample_protection_mask(c["rg"], ref_dq.DegreeQuantConfig(
            p_min=0.0, p_max=0.2), rng))
        loss, grads = grad_fn(params, mask)
        params, opt, _ = ref_adamw.adamw_update(grads, opt, params, opt_cfg)
        want_losses.append(float(loss))

    peng = port_mp.AmpleEngine(c["pg"], port_mp.EngineConfig(mixed_precision=False))
    x, labels, train = _port_inputs(c)
    got, losses = port_example.train(c["pp"], peng, x, labels, train, steps=STEPS, lr=5e-3)
    _close(losses, want_losses)
    for g_l, w_l in zip(got["layers"], params["layers"]):
        _close(g_l["w"].detach(), w_l["w"])
    # three AGE calls a step: two forward, one backward on the transposed plan
    assert set(peng._tplans) == {("gcn", "float")}


def test_example_deployed_int8_logits_match_reference(example_case, port_example):
    c = example_case
    reng = ref_mp.AmpleEngine(c["rg"], ref_mp.EngineConfig(mixed_precision=True))
    want = ref_gcn.apply(c["rcfg"], c["rp"], reng, jnp.asarray(c["rg"].features))
    peng = port_mp.AmpleEngine(c["pg"], port_mp.EngineConfig(mixed_precision=True))
    params = port_example.trainable(c["pp"])
    with torch.no_grad():
        got = port_gcn.apply(c["pcfg"], params, peng, torch.from_numpy(c["pg"].features))
    assert_mixed_close(got.numpy(), want)
    x, labels, train = _port_inputs(c)
    acc_float, acc_mixed = port_example.evaluate(c["pcfg"], params, peng, x, labels, ~train)
    ref_pred = np.argmax(np.asarray(want), -1)
    assert abs(acc_mixed - float((ref_pred == c["labels"])[~c["train"]].mean())) <= 0.02
    assert 0.0 <= acc_float <= 1.0


def test_example_runs_end_to_end_on_cpu(port_example):
    res = port_example.run(steps=4, nodes=120, lr=5e-3, device="cpu")
    assert np.isfinite([res["first_loss"], res["last_loss"]]).all()
    assert 0.0 <= res["acc_mixed"] <= 1.0 and 0.0 <= res["acc_float"] <= 1.0
