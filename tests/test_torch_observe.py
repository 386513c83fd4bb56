"""The port's observe copies and the serving engine's spans and stats.

``observe/trace.py`` and ``observe/metrics.py`` are stdlib-only copies of the
reference's, so their primitives are held to the reference's semantics: the
ring bounds memory, the disabled recorder is a shared no-op, the Chrome
export is well formed, ``StatsView`` reads and writes registry cells. The
serving engine's ``stats`` has the reference engine's keys, and a traced
request's spans (on the ``request_stamp`` clock) reconcile with its
response exactly where they share stamps, with the reference's names,
categories and args.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
from _torch_parity import cfg_pair, params_pair

from repro.graphs.datasets import make_dataset
from repro.observe import trace as ref_trace
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro_torch.graphs.csr import Graph
from repro_torch.observe import metrics as ometrics
from repro_torch.observe import trace as otrace
from repro_torch.observe.trace import NULL_SPAN, TraceRecorder
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine, request_stamp


@pytest.fixture()
def recorder():
    """A fresh enabled port recorder for the test, disabled after."""
    rec = otrace.enable(capacity=1 << 14)
    yield rec
    otrace.disable()


@pytest.fixture(scope="module")
def pool():
    return [make_dataset("cora", max_nodes=n, max_feature_dim=24, seed=s)
            for n, s in ((60, 1), (110, 2), (90, 3))]


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _pair(arch="gcn"):
    rcfg, pcfg = cfg_pair(arch, d_model=24, d_ff=16, vocab_size=8, gnn_edges_per_tile=64)
    rp, pp = params_pair(rcfg, pcfg, seed=7)
    return RefServe(rcfg, rp), GNNServeEngine(pcfg, pp, device="cpu")


# ------------------------------------------------------------- primitives
def test_ring_bounds_memory_and_counts_drops():
    rec = TraceRecorder(capacity=4)
    for i in range(10):
        rec.add_span(f"s{i}", 0.0, 1.0)
    assert [s.name for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_disabled_recorder_is_a_noop_singleton():
    rec = TraceRecorder(capacity=16, enabled=False)
    assert rec.span("a") is NULL_SPAN
    assert rec.span("b", cat="x", trace_id="t") is NULL_SPAN
    with rec.span("c") as sp:
        assert sp.set(k=1) is NULL_SPAN
    rec.add_span("d", 0.0, 1.0)
    rec.add_instant("e")
    assert rec.spans() == []
    assert not otrace.is_enabled() and otrace.get_recorder().span("x") is NULL_SPAN


def test_module_recorder_toggles_and_nests():
    rec = otrace.enable(capacity=64)
    try:
        assert otrace.is_enabled() and otrace.get_recorder() is rec
        with rec.span("outer", trace_id="req-x"):
            time.sleep(0.001)
            with rec.span("inner", trace_id="req-x") as sp:
                sp.set(k=2)
    finally:
        otrace.disable()
    assert not otrace.is_enabled()
    inner, outer = rec.spans()
    assert (inner.name, outer.name) == ("inner", "outer") and inner.args == {"k": 2}
    assert outer.t0 <= inner.t0 and inner.t1 <= outer.t1
    assert rec.total_ms("outer") >= rec.total_ms("inner") > 0.0
    assert rec.total_ms("outer", trace_id="other") == 0.0


def test_chrome_trace_export_matches_the_reference(tmp_path):
    recs = (TraceRecorder(), ref_trace.TraceRecorder())
    for rec in recs:
        rec.epoch = 0.5
        rec.add_span("work", 1.0, 1.5, cat="c", lane="laneA", trace_id="req-1", args={"k": 2})
        rec.add_span("work2", 1.5, 1.7, lane="laneB")
        rec.add_instant("mark", t=1.2, lane="laneA")
    doc = recs[0].chrome_trace()
    assert doc == recs[1].chrome_trace()
    events = doc["traceEvents"]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {"laneA", "laneB"}
    work = next(e for e in events if e["name"] == "work")
    assert work["ph"] == "X" and work["dur"] == pytest.approx(0.5e6)
    assert work["ts"] == pytest.approx(0.5e6) and work["args"] == {"k": 2, "trace_id": "req-1"}
    assert next(e for e in events if e["name"] == "mark")["ph"] == "i"
    with open(recs[0].export(str(tmp_path / "trace.json"))) as f:
        assert json.load(f) == doc


def test_new_trace_ids_are_unique():
    ids = {otrace.new_trace_id() for _ in range(100)}
    assert len(ids) == 100 and all(i.startswith("req-") for i in ids)


def test_registry_counters_gauges_and_exposition():
    reg = ometrics.MetricsRegistry()
    fam = reg.counter("reqs_total", help="h", labels=("engine",))
    fam.labels(engine="a").inc(3)
    fam.labels(engine="b").inc()
    with pytest.raises(ValueError):
        fam.labels(wrong="a")
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")
    reg.gauge("depth").labels().set(2.5)
    text = reg.prometheus_text()
    assert 'reqs_total{engine="a"} 3' in text and 'reqs_total{engine="b"} 1' in text
    assert "# HELP reqs_total h" in text and "# TYPE reqs_total counter" in text
    assert "# TYPE depth gauge" in text and "depth 2.5" in text
    assert reg.snapshot()["depth"] == {"kind": "gauge", "samples": [{"labels": {}, "value": 2.5}]}


def test_stats_view_value_semantics():
    reg = ometrics.MetricsRegistry()
    sv = ometrics.StatsView(reg, "eng", {"engine": "e0"}, keys=("hits", "stall_ms"),
                            float_keys=("stall_ms",))
    sv["hits"] += 1
    sv["stall_ms"] += 1.25
    assert sv["hits"] == 1 and isinstance(sv["hits"], int)
    assert sv["stall_ms"] == 1.25 and isinstance(sv["stall_ms"], float)
    assert dict(sv) == {"hits": 1, "stall_ms": 1.25}
    sv["hits"] = 7
    assert reg.get("eng_hits").labels(engine="e0").value == 7.0


# ------------------------------------------------------- serving: stats
def test_engine_stats_have_the_reference_keys_and_registry_cells(pool):
    ref, port = _pair()
    assert list(port.stats) == list(ref.stats)
    assert {k for k, v in port.stats.items() if isinstance(v, float)} == {
        k for k, v in ref.stats.items() if isinstance(v, float)}
    other = GNNServeEngine(port.cfg, port.params, device="cpu")
    g = _port_graph(pool[0])
    port.infer(g, pool[0].features)
    port.infer(g, pool[0].features)
    cell = ometrics.get_registry().get("gnn_serve_requests").labels(engine=port.instance)
    assert port.stats["requests"] == 2 == int(cell.value)
    assert other.stats["requests"] == 0 and other.instance != port.instance
    info = port.cache_info()
    assert info["size"] == 1 and all(info[k] == v for k, v in port.stats.items())
    assert f'gnn_serve_requests{{engine="{port.instance}"}} 2' in (
        ometrics.get_registry().prometheus_text())


# ------------------------------------------------------- serving: spans
def _spans_by_name(spans, tid):
    return {s.name: s for s in spans if s.trace_id == tid}


def test_untraced_request_records_nothing(pool):
    _, port = _pair()
    g = pool[0]
    before = len(otrace.get_recorder().spans())
    r = port.infer(_port_graph(g), g.features, admitted_at=request_stamp() - 0.01)
    assert r.trace_id == "" and len(otrace.get_recorder().spans()) == before


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_direct_request_spans_reconcile_with_response(recorder, pool, arch):
    _, port = _pair(arch)
    g = pool[1]
    cold = port.infer(_port_graph(g), g.features)
    warm = port.infer(_port_graph(g), g.features, admitted_at=request_stamp() - 0.05)
    assert cold.trace_id and warm.trace_id and cold.trace_id != warm.trace_id
    assert np.array_equal(cold.outputs, warm.outputs)
    c = _spans_by_name(recorder.spans(), cold.trace_id)
    assert set(c) == {"plan", "execute"}  # never queued
    assert c["plan"].dur_ms >= cold.plan_ms > 0.0 and not c["plan"].args["cache_hit"]
    by = _spans_by_name(recorder.spans(), warm.trace_id)
    assert set(by) == {"queue", "plan", "execute"}
    assert all(s.cat == "serve" for s in by.values())
    assert by["execute"].dur_ms == pytest.approx(warm.run_ms, rel=1e-9)
    assert by["execute"].args == {"arch": arch, "streamed": False}
    assert by["queue"].dur_ms == pytest.approx(warm.queue_ms, rel=1e-9)
    assert warm.queue_ms >= 50.0
    assert by["plan"].args == {"cache_hit": True, "plan_ms": 0.0}
    assert by["queue"].t1 == by["plan"].t0 and by["plan"].t1 <= by["execute"].t0
    given = port.infer(_port_graph(g), g.features, trace_id="req-given")
    assert given.trace_id == "req-given"
    assert set(_spans_by_name(recorder.spans(), "req-given")) == {"plan", "execute"}


def test_batch_spans_per_member_queue_and_scatter(recorder, pool):
    _, port = _pair()
    at = request_stamp() - 0.02
    reqs = [GNNRequest(graph=_port_graph(g), features=g.features, admitted_at=at,
                       trace_id=f"req-batch-{i}") for i, g in enumerate(pool)]
    out = port.infer_batch(reqs)
    assert [r.trace_id for r in out] == [r.trace_id for r in reqs]
    spans = recorder.spans()
    queues = sorted((s for s in spans if s.name == "queue"), key=lambda s: s.trace_id)
    assert [s.trace_id for s in queues] == [r.trace_id for r in reqs]
    for r, q in zip(out, queues):
        assert q.dur_ms == pytest.approx(r.queue_ms, rel=1e-9)
    lead = {s.name: s for s in spans if s.trace_id == "req-batch-0"}
    assert set(lead) == {"queue", "plan", "execute", "scatter"}
    assert lead["plan"].args["batch"] == 3 and lead["scatter"].args == {"batch": 3}
    assert lead["execute"].dur_ms == pytest.approx(out[0].run_ms, rel=1e-9)


def test_span_names_categories_and_args_match_the_reference(pool):
    """The same traffic through both engines records the same span kinds."""
    ref, port = _pair()

    def kinds(spans):
        return sorted((s.name, s.cat, tuple(sorted(s.args or {}))) for s in spans)

    got, want = otrace.enable(), ref_trace.enable()
    try:
        at = request_stamp() - 0.01
        for eng, req_cls, conv in ((port, GNNRequest, _port_graph), (ref, RefRequest, None)):
            g = pool[2]
            gg = conv(g) if conv else g
            eng.infer(gg, g.features, admitted_at=at)
            eng.infer_batch([req_cls(graph=conv(h) if conv else h, features=h.features,
                                     admitted_at=at) for h in pool])
    finally:
        otrace.disable()
        ref_trace.disable()
    assert kinds(got.spans()) == kinds(want.spans())
