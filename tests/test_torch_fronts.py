"""The port's serving fronts against the reference's: async, tenancy, telemetry.

``serve/async_gnn.py``, ``serve/tenancy/`` and ``serve/telemetry.py`` are
copies of the reference's bound to the port's engine, so the tests hold them
to the reference's contracts on the CPU (``device="cpu"``, where the kernels'
plain versions run):

* async == sync bitwise for the same admitted composition; completion order
  equals submission order; window timeout, bounded retries and ``queue_ms``;
* DWRR weight share, priority classes, preemption, token-bucket rate limits,
  and routed == direct replay bitwise;
* parity with the reference: the same scripted submissions (rate limits on
  an injected clock) give the same admitted compositions and the same
  ``window_log``, and the served outputs agree at the mixed tolerance of
  tests/test_gnn_models.py:66-80;
* the telemetry histogram's percentiles equal the reference's on the same
  stream, and the metrics registry exports histograms as the reference does.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.graphs.datasets import make_dataset
from repro.observe import metrics as ref_metrics
from repro.serve import telemetry as ref_telemetry
from repro.serve.async_gnn import AsyncGNNEngine as RefAsync
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro.serve.tenancy import TenantRouter as RefRouter
from repro.serve.tenancy import registry as ref_registry
from repro_torch.graphs.csr import Graph
from repro_torch.observe import metrics as ometrics
from repro_torch.serve import telemetry
from repro_torch.serve.async_gnn import AsyncGNNEngine, GNNTicket
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine, request_stamp
from repro_torch.serve.tenancy import (
    RateLimitExceeded,
    TenantRegistry,
    TenantRouter,
    TenantSpec,
    TokenBucket,
    UnknownTenant,
)
from repro_torch.serve.tenancy import registry as port_registry

ARCHS = ["gcn", "gin", "sage", "gat"]
SIZES = (20, 30, 45, 60, 75)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _pair(arch="gcn", seed=7, **overrides):
    """(reference engine, port engine) with the reference's params."""
    rcfg, pcfg = cfg_pair(arch, d_model=20, d_ff=12, vocab_size=6, gnn_edges_per_tile=64,
                          **overrides)
    rp, pp = params_pair(rcfg, pcfg, seed=seed)
    return RefServe(rcfg, rp), GNNServeEngine(pcfg, pp, device="cpu")


def _engine(arch="gcn", seed=7):
    return _pair(arch, seed)[1]


@pytest.fixture(scope="module")
def pool():
    """Reference graphs by node count (features 20 wide)."""
    return {n: make_dataset("cora", max_nodes=n, max_feature_dim=20, seed=n) for n in SIZES}


@pytest.fixture(scope="module")
def serve_engine():
    return _engine()


def _ppool(pool):
    return {n: _port_graph(g) for n, g in pool.items()}


# ------------------------------------------------------- registry / bucket
def test_registry_validation():
    reg = TenantRegistry(TenantSpec("a"))
    with pytest.raises(ValueError):
        reg.add("a")  # duplicate
    with pytest.raises(UnknownTenant):
        reg.get("ghost")
    with pytest.raises(ValueError):
        TenantSpec("bad", weight=0.0)
    with pytest.raises(ValueError):
        TenantSpec("")
    with pytest.raises(ValueError):
        TenantSpec("neg", rate_rps=-1.0)
    reg.add("b", weight=2.0, priority=1, rate_rps=5.0, slo_ms=50.0)
    assert set(reg.names) == {"a", "b"} and len(reg) == 2 and "b" in reg
    assert reg.get("b").effective_burst == 5.0
    assert TenantSpec("slow", rate_rps=0.2).effective_burst == 1.0


@pytest.mark.parametrize("rate,burst", [(2.0, 2.0), (0.5, 1.0), (10.0, 3.0), (0.0, 0.0)])
def test_token_bucket_is_deterministic_and_matches_reference(rate, burst):
    stamps = [1000.0, 1000.0, 1000.0, 1000.4, 1000.6, 1001.0, 1001.05, 1003.0, 1003.0]
    port, ref = TokenBucket(rate, burst), ref_registry.TokenBucket(rate, burst)
    got = [port.try_acquire(now=t) for t in stamps]
    assert got == [ref.try_acquire(now=t) for t in stamps]
    if rate == 2.0:  # the reference test's sequence
        assert got[:5] == [True, True, False, False, True]
    if rate == 0.0:
        assert all(got) and port.tokens == float("inf")


# --------------------------------------------------------------- telemetry
_STREAMS = {
    "lognormal": np.random.default_rng(0).lognormal(2.0, 1.0, 2000),
    "uniform": np.random.default_rng(1).uniform(0.5, 500.0, 999),
    "bimodal": np.concatenate([np.full(300, 3.0), np.full(30, 250.0)]),
    "tiny_and_huge": np.asarray([1e-6, 5e-4, 2.0, 7e5, 3e6]),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("q", [0, 25, 50, 90, 99, 100])
def test_histogram_percentiles_equal_the_reference(name, q):
    port, ref = telemetry.StreamingHistogram(), ref_telemetry.StreamingHistogram()
    for v in _STREAMS[name]:
        port.record(v)
        ref.record(v)
    assert port.percentile(q) == ref.percentile(q)
    assert port.snapshot() == ref.snapshot()
    if name != "tiny_and_huge":  # inside [low, high]: within the relative error
        want = np.percentile(_STREAMS[name], q, method="lower")
        assert abs(port.percentile(q) - want) <= 2 * port.rel_error * max(abs(want), 1e-9) + 1e-9


def test_tenant_telemetry_matches_reference_with_injected_time():
    port, ref = telemetry.TenantTelemetry(), ref_telemetry.TenantTelemetry()
    for t in (port, ref):
        t.record_submitted("gold", now=10.0)
        t.record_submitted("be", now=10.5)
        t.record_rejected("be")
        t.record_preempted("be")
        for i, (lat, qms) in enumerate(((12.0, 1.0), (80.0, 30.0), (40.0, 5.0))):
            t.record_completion("gold", latency_ms=lat, queue_ms=qms, nodes=100,
                                slo_ms=50.0, now=11.0 + i)
        t.record_completion("be", latency_ms=5.0, nodes=10, now=12.5)
        t.record_failure("be")
    got, want = port.snapshot({"idle": 0}), ref.snapshot({"idle": 0})
    assert got == want
    assert got["gold"]["slo_hits"] == 2 and got["gold"]["slo_violations"] == 1
    assert got["gold"]["throughput_rps"] == pytest.approx(3 / 3.0)
    assert got["idle"]["completed"] == 0


def test_registry_histograms_export_as_the_reference_does():
    port, ref = ometrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for reg, kind in ((port, telemetry), (ref, ref_telemetry)):
        fam = reg.histogram("latency_ms", help="request latency", labels=("arch",))
        for v in (3.0, 9.0, 27.0, 81.0):
            fam.labels(arch="gcn").record(v)
        shared = kind.StreamingHistogram()
        shared.record(5.0)
        assert reg.register_histogram("adopted_ms", shared, help="adopted", tenant="t") is shared
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()
    assert "# TYPE latency_ms summary" in port.prometheus_text()


def test_router_telemetry_lands_in_the_registry(serve_engine, pool):
    router = TenantRouter(AsyncGNNEngine(serve_engine, window=2))
    router.add_tenant("gold", slo_ms=1e6)
    g = _ppool(pool)[30]
    router.submit("gold", g, g.features)
    router.drain()
    rows = ometrics.get_registry().snapshot()["tenant_latency_ms"]["samples"]
    mine = [r for r in rows if r["labels"]["telemetry"] == router.telemetry.instance]
    assert mine and mine[0]["value"]["count"] == 1


# -------------------------------------------------------- async == sync
@pytest.mark.parametrize("arch", ARCHS)
def test_async_matches_sync_bitwise(arch, pool):
    eng = _engine(arch)
    async_eng = AsyncGNNEngine(eng, window=4)
    graphs = [_ppool(pool)[n] for n in (60, 45, 75, 30)]
    for g in graphs:
        async_eng.submit(g, g.features)
    got = async_eng.drain()
    want = eng.infer_batch([GNNRequest(graph=g, features=g.features) for g in graphs])
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.outputs, b.outputs)
        assert a.fingerprint == b.fingerprint
    assert async_eng.stats["steps"] == 1


def test_async_windows_are_bitwise_their_sync_batches(pool):
    """window=2 splits the stream into pairs; each pair is bitwise the
    synchronous infer_batch of that pair (cold engine or warm)."""
    eng = _engine()
    async_eng = AsyncGNNEngine(eng, window=2)
    graphs = [_ppool(pool)[n] for n in (60, 45, 75, 30)]
    for g in graphs:
        async_eng.submit(g, g.features)
    got = async_eng.drain()
    assert async_eng.stats["steps"] == 2
    fresh = _engine()
    for off in (0, 2):
        reqs = [GNNRequest(graph=g, features=g.features) for g in graphs[off:off + 2]]
        for replay in (eng.infer_batch(reqs), fresh.infer_batch(reqs)):
            for i, b in enumerate(replay):
                np.testing.assert_array_equal(got[off + i].outputs, b.outputs)


def test_async_outputs_match_the_reference(pool):
    ref, port = _pair("gcn")
    ra, pa = RefAsync(ref, window=2), AsyncGNNEngine(port, window=2)
    for n in (60, 45, 75):
        ra.submit(pool[n], pool[n].features)
        pa.submit(_ppool(pool)[n], pool[n].features)
    for r, p in zip(ra.drain(), pa.drain()):
        assert r.batch_size == p.batch_size
        assert_mixed_close(p.outputs, r.outputs)


def test_ticket_result_drives_loop(pool):
    async_eng = AsyncGNNEngine(_engine("gin"), window=2)
    pp = _ppool(pool)
    t1 = async_eng.submit(pp[60], pp[60].features)
    t2 = async_eng.submit(pp[45], pp[45].features)
    assert isinstance(t1, GNNTicket)
    assert not t1.done and not t2.done and async_eng.pending == 2
    r2 = t2.result()
    assert t1.done and t2.done and async_eng.pending == 0
    assert r2.outputs.shape == (45, 6) and r2.batch_size == 2


def test_fifo_order_and_straggler_isolation(pool):
    big = _port_graph(make_dataset("cora", max_nodes=150, max_feature_dim=20, seed=9))
    pp = _ppool(pool)
    async_eng = AsyncGNNEngine(_engine(), window=4, max_batch_nodes=160)
    tickets = [async_eng.submit(g, g.features) for g in (pp[60], big, pp[45], pp[75])]
    assert [t.seq for t in async_eng.step()] == [0]  # the 150 won't fit beside 60
    assert [t.seq for t in async_eng.step()] == [1]  # the straggler rides alone
    assert [t.seq for t in async_eng.step()] == [2, 3]
    assert async_eng.step() == []
    assert [t.response.batch_size for t in tickets] == [1, 1, 2, 2]


def test_completion_order_equals_submission_order(pool):
    pp = _ppool(pool)
    async_eng = AsyncGNNEngine(_engine("sage"), window=2, max_batch_nodes=100)
    for n in (20, 75, 30, 60, 45, 20):
        async_eng.submit(pp[n], pp[n].features)
    order, sizes = [], []
    while async_eng.pending:
        done = async_eng.step()
        order += [t.seq for t in done]
        sizes.append(len(done))
    assert order == list(range(6))
    assert async_eng.stats["completed"] == 6 and sum(sizes) == 6


def test_submit_rejects_bad_requests(pool):
    async_eng = AsyncGNNEngine(_engine(), window=2)
    g = _ppool(pool)[30]
    with pytest.raises(ValueError, match="rows"):
        async_eng.submit(g, g.features[:-1])
    with pytest.raises(ValueError, match="columns"):
        async_eng.submit(g, np.zeros((30, 7), np.float32))
    with pytest.raises(ValueError, match="holds"):
        async_eng.submit(g, g.features, arch="gat")
    assert async_eng.pending == 0
    with pytest.raises(TypeError):
        AsyncGNNEngine(object())
    with pytest.raises(ValueError):
        AsyncGNNEngine(_engine(), window=0)


def test_timeout_holds_partial_window_until_deadline(pool):
    g = _ppool(pool)[30]
    async_eng = AsyncGNNEngine(_engine(), window=4, window_timeout_ms=60_000.0)
    t = async_eng.submit(g, g.features)
    assert async_eng.step() == [] and not t.done  # held for late arrivals
    assert async_eng.stats["held_windows"] == 1
    with pytest.raises(TimeoutError):
        t.result(timeout=0.05)
    assert async_eng.drain()[0] is t.response  # drain flushes the hold
    short = AsyncGNNEngine(_engine(), window=4, window_timeout_ms=1.0)
    t2 = short.submit(g, g.features, arrival=request_stamp() - 1.0)  # waited 1 s already
    assert short.step() == [t2] and short.stats["deadline_closes"] == 1


def test_timeout_and_retries_default_from_config(pool):
    _, pcfg = cfg_pair("gcn", gnn_window_timeout_ms=7.5, gnn_window_retries=5)
    async_eng = AsyncGNNEngine(GNNServeEngine(pcfg, device="cpu"))
    assert async_eng.window_timeout_ms == 7.5 and async_eng.window_retries == 5
    assert async_eng.window == pcfg.gnn_batch_window == 4


def test_window_retries_exhaust_into_failed_tickets(pool):
    eng = _engine()
    calls = []
    boom = RuntimeError("device on fire")

    def explode(requests):
        calls.append(len(requests))
        raise boom

    eng.infer_batch = explode
    async_eng = AsyncGNNEngine(eng, window=2, window_retries=2)
    g = _ppool(pool)[20]
    t = async_eng.submit(g, g.features)
    with pytest.raises(RuntimeError):
        async_eng.step()  # failure 1: requeued and raised
    assert not t.done and async_eng.pending == 1 and t.failures == 1
    assert async_eng.step() == [t]  # failure 2: retries out
    assert t.done and t.error is boom and async_eng.stats["failed_tickets"] == 1
    with pytest.raises(RuntimeError, match="device on fire"):
        t.result()
    assert calls == [1, 1] and async_eng.drain() == []


def test_queue_ms_on_the_async_path_and_zero_on_direct_calls(pool):
    eng = _engine()
    g = _ppool(pool)[30]
    assert eng.infer(g, g.features).queue_ms == 0.0
    async_eng = AsyncGNNEngine(eng, window=2)
    t = async_eng.submit(g, g.features, arrival=request_stamp() - 0.25)
    resp = t.result()
    assert resp.queue_ms >= 250.0  # the explicit admission stamp is honoured
    t2 = async_eng.submit(g, g.features)
    time.sleep(0.01)
    assert t2.result().queue_ms >= 10.0


# ------------------------------------------------------------------- DWRR
def _router(serve_engine, *, window=4, max_batch_nodes=None, hold_ms=0.0, **kw):
    return TenantRouter(AsyncGNNEngine(serve_engine, window=window,
                                       max_batch_nodes=max_batch_nodes),
                        hold_ms=hold_ms, **kw)


def _schedule_only(router):
    """Fill staged windows without executing them until the queues drain."""
    windows = []
    while any(router._queues.values()) or router._staged:
        router._fill_staged()
        staged, router._staged, router._staged_nodes = router._staged, [], 0
        assert staged, "fill made no progress with backlog present"
        windows.append(staged)
        assert len(windows) <= router.stats["submitted"] + 1, "scheduler looping"
    return windows


def test_rate_limit_rejects_at_the_door(serve_engine, pool):
    router = _router(serve_engine)
    router.add_tenant("limited", rate_rps=0.001, burst=2.0)
    g = _ppool(pool)[20]
    results = []
    for _ in range(5):
        try:
            router.submit("limited", g, g.features)
            results.append(True)
        except RateLimitExceeded:
            results.append(False)
    assert results == [True, True, False, False, False]
    assert router.stats["rejected"] == 3 and router.pending == 2
    assert router.snapshot()["tenants"]["limited"]["rejected"] == 3
    with pytest.raises(UnknownTenant):
        router.submit("ghost", g, g.features)
    router.drain()


def test_dwrr_weight_share(serve_engine, pool):
    """Two equally sized backlogged tenants at weight 3:1 split each full
    window 3:1; once the heavy one drains, the light one gets whole windows."""
    router = _router(serve_engine, window=4)
    router.add_tenant("heavy", weight=3.0)
    router.add_tenant("light", weight=1.0)
    g = _ppool(pool)[30]
    for _ in range(12):
        router.submit("heavy", g, g.features)
    for _ in range(12):
        router.submit("light", g, g.features)
    windows = _schedule_only(router)
    for w in windows[:4]:
        assert {t: sum(rt.tenant == t for rt in w) for t in ("heavy", "light")} == {
            "heavy": 3, "light": 1}
    assert sum(rt.tenant == "light" for rt in windows[-2]) == 4


def test_dwrr_fairness_is_node_volume_not_request_count(serve_engine, pool):
    router = _router(serve_engine, window=8)
    router.add_tenant("big")
    router.add_tenant("small")
    pp = _ppool(pool)
    for _ in range(8):
        router.submit("big", pp[60], pp[60].features)
    for _ in range(24):
        router.submit("small", pp[20], pp[20].features)
    w = _schedule_only(router)[0]
    nodes = {t: sum(rt.graph.num_nodes for rt in w if rt.tenant == t) for t in ("big", "small")}
    assert nodes["big"] > 0 and nodes["small"] > 0
    assert 0.5 <= nodes["big"] / nodes["small"] <= 2.0


def test_priority_class_fills_first(serve_engine, pool):
    router = _router(serve_engine, window=4)
    router.add_tenant("gold", priority=1)
    router.add_tenant("be", priority=0)
    g = _ppool(pool)[30]
    for _ in range(8):
        router.submit("be", g, g.features)
    for _ in range(8):
        router.submit("gold", g, g.features)
    windows = _schedule_only(router)
    shared = [w for w in windows if {rt.tenant for rt in w} == {"gold", "be"}]
    assert shared
    for w in shared:
        assert w[0].tenant == "gold"
        assert sum(rt.tenant == "gold" for rt in w) == sum(rt.tenant == "be" for rt in w)
    be = [rt.seq for w in windows for rt in w if rt.tenant == "be"]
    assert be == sorted(be) and len(be) == 8


def test_preemption_evicts_lower_class_from_held_window(serve_engine, pool):
    router = _router(serve_engine, window=4, max_batch_nodes=120, hold_ms=60_000.0)
    router.add_tenant("gold", priority=1)
    router.add_tenant("be", priority=0)
    pp = _ppool(pool)
    t60 = router.submit("be", pp[60], pp[60].features)
    t45 = router.submit("be", pp[45], pp[45].features)
    assert router.step() == []  # partial window held for late arrivals
    assert [rt.tenant for rt in router._staged] == ["be", "be"]
    tg = router.submit("gold", pp[75], pp[75].features)  # 105 + 75 > 120
    assert [(rt.tenant, rt.graph.num_nodes) for rt in router._staged] == [
        ("be", 45), ("gold", 75)]
    assert t60.preemptions == 1 and t45.preemptions == 0
    assert router.stats["preempted"] == 1
    done = router.drain()
    assert [rt.seq for rt in done] == [t60.seq, t45.seq, tg.seq]
    assert list(router.window_log) == [
        (("be", t45.seq), ("gold", tg.seq)), (("be", t60.seq),)]
    assert router.snapshot()["tenants"]["be"]["preempted"] == 1


def test_no_preemption_within_a_class(serve_engine, pool):
    router = _router(serve_engine, window=4, max_batch_nodes=120, hold_ms=60_000.0)
    router.add_tenant("a", priority=1)
    router.add_tenant("b", priority=1)
    pp = _ppool(pool)
    router.submit("a", pp[60], pp[60].features)
    router.submit("a", pp[45], pp[45].features)
    assert router.step() == []
    router.submit("b", pp[75], pp[75].features)
    assert [rt.tenant for rt in router._staged] == ["a", "a"]
    assert router.stats["preempted"] == 0
    router.drain()


def test_single_tenant_routing_is_bitwise_direct_serving(pool):
    pp = _ppool(pool)
    graphs = [pp[60], pp[45], pp[75], pp[30]]
    router = TenantRouter(AsyncGNNEngine(_engine(), window=2))
    router.add_tenant("solo")
    for g in graphs:
        router.submit("solo", g, g.features)
    routed = router.drain()
    direct = AsyncGNNEngine(_engine(), window=2)
    for g in graphs:
        direct.submit(g, g.features)
    want = direct.drain()
    for rt, w in zip(routed, want):
        np.testing.assert_array_equal(rt.response.outputs, w.outputs)
    assert [len(w) for w in router.window_log] == [2, 2]


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_multi_tenant_windows_replay_bitwise(arch, pool):
    pp = _ppool(pool)
    router = TenantRouter(AsyncGNNEngine(_engine(arch), window=3))
    router.add_tenant("gold", weight=2.0, priority=1)
    router.add_tenant("be")
    tickets = {}
    for n in (60, 45, 30, 20):
        rt = router.submit("be", pp[n], pp[n].features)
        tickets[rt.seq] = rt
    for n in (75, 30):
        rt = router.submit("gold", pp[n], pp[n].features)
        tickets[rt.seq] = rt
    router.drain()
    replay = _engine(arch)
    assert len(router.window_log) >= 2
    for window in router.window_log:
        members = [tickets[seq] for _, seq in window]
        want = replay.infer_batch([GNNRequest(graph=rt.graph, features=rt.features)
                                   for rt in members])
        for rt, w in zip(members, want):
            np.testing.assert_array_equal(rt.response.outputs, w.outputs)


def test_failed_window_completes_routed_tickets_exceptionally(pool):
    eng = _engine()
    boom = RuntimeError("device on fire")

    def explode(requests):
        raise boom

    eng.infer_batch = explode
    router = TenantRouter(AsyncGNNEngine(eng, window=2, window_retries=2))
    router.add_tenant("t", slo_ms=10.0)
    g = _ppool(pool)[20]
    rt = router.submit("t", g, g.features)
    with pytest.raises(RuntimeError):
        router.step(flush=True)
    assert not rt.done and router.pending == 1
    assert router.step(flush=True) == [rt] and rt.error is boom
    assert router.stats["failed"] == 1 and router.pending == 0


# ------------------------------------------- parity with the reference fronts
_SCRIPTS = {
    # (tenant specs, [(tenant, size), ...], window, max_batch_nodes)
    "weights": ({"heavy": dict(weight=3.0, priority=1), "light": dict(weight=1.0)},
                [("heavy", 30), ("light", 45)] * 6 + [("light", 20)] * 3, 4, None),
    "budget": ({"a": dict(weight=2.0), "b": dict(weight=1.0), "c": dict(priority=2)},
               [("a", 75), ("b", 20), ("c", 60), ("a", 30), ("b", 45), ("c", 20),
                ("a", 60), ("b", 75)], 3, 120),
    "rates": ({"burst": dict(rate_rps=1.0, burst=1.0), "free": dict(weight=0.5)},
              [("burst", 20), ("free", 30), ("burst", 45), ("burst", 60), ("free", 20),
               ("burst", 30), ("free", 75)], 2, None),
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_window_compositions_and_log_equal_the_reference(name, pool, monkeypatch):
    """The same scripted submissions, with an injected token-bucket clock,
    admit the same compositions into the same windows in both packages."""
    specs, script, window, budget = _SCRIPTS[name]
    clock = {"t": 5000.0}
    for mod in (port_registry, ref_registry):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock["t"])
    ref_eng, port_eng = _pair("gcn")
    ref = RefRouter(RefAsync(ref_eng, window=window, max_batch_nodes=budget))
    port = TenantRouter(AsyncGNNEngine(port_eng, window=window, max_batch_nodes=budget))
    for r in (ref, port):
        for t, kw in specs.items():
            r.add_tenant(t, **kw)
    pp = _ppool(pool)
    outcome = []
    for i, (tenant, n) in enumerate(script):
        clock["t"] += 0.3 * (i % 3)
        got = []
        for r, g in ((ref, pool[n]), (port, pp[n])):
            try:
                got.append(r.submit(tenant, g, g.features).seq)
            except Exception as exc:  # each package raises its own RateLimitExceeded
                got.append(type(exc).__name__)
        assert got[0] == got[1]
        outcome.append(got[1])
    if name == "rates":
        assert "RateLimitExceeded" in outcome
    ref_done, port_done = ref.drain(), port.drain()
    assert list(port.window_log) == list(ref.window_log)
    assert [rt.seq for rt in port_done] == [rt.seq for rt in ref_done]
    assert port.stats["windows"] == ref.stats["windows"]
    for a, b in zip(port_done, ref_done):
        assert a.response.batch_size == b.response.batch_size
        assert_mixed_close(a.response.outputs, b.response.outputs)


def test_async_admissions_equal_the_reference(pool):
    """The async front alone: the same FIFO windows under a node budget."""
    ref_eng, port_eng = _pair("gin")
    ra = RefAsync(ref_eng, window=3, max_batch_nodes=110)
    pa = AsyncGNNEngine(port_eng, window=3, max_batch_nodes=110)
    pp = _ppool(pool)
    for n in (20, 60, 45, 75, 30, 20, 20, 60):
        ra.submit(pool[n], pool[n].features)
        pa.submit(pp[n], pp[n].features)
    while ra.pending or pa.pending:
        assert [t.seq for t in pa.step()] == [t.seq for t in ra.step()]
    assert pa.stats["steps"] == ra.stats["steps"]
