"""The port's out-of-core path against the reference's, and against itself.

``memory/feature_store.py`` and the chunk-schedule functions of
``core/scheduler.py`` are numpy copies, so their arrays are held bitwise to
the reference's. ``memory/prefetcher.py`` runs the reference's cache state
machine in numpy over the whole schedule: its counters must equal the
reference's ``ChunkPrefetcher``'s for the same graph, budget, chunk rows and
settings. The load-bearing guarantee is the reference's: a request served
under a feature budget is **bitwise** the in-memory request, for every arch,
at budgets that force eviction and sparse residue, with the staging worker on
or off. Served on the CPU, where the kernels' plain versions run.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_mixed_close, cfg_pair, params_pair

from repro.core import scheduler as ref_sched
from repro.core.quantization import compute_scale_zp as ref_scale_zp
from repro.graphs.csr import Graph as RefGraph
from repro.graphs.datasets import make_dataset, make_lognormal_graph
from repro.memory import feature_store as ref_fs
from repro.memory.prefetcher import ChunkPrefetcher as RefPrefetcher
from repro.memory.prefetcher import StreamStats as RefStats
from repro.serve.gnn_engine import GNNRequest as RefRequest
from repro.serve.gnn_engine import GNNServeEngine as RefServe
from repro_torch.configs.base import get_config
from repro_torch.core import scheduler as sched
from repro_torch.core.message_passing import AmpleEngine, EngineConfig
from repro_torch.core.quantization import compute_scale_zp, quantize
from repro_torch.graphs.csr import Graph
from repro_torch.memory import feature_store as fs
from repro_torch.memory import prefetcher
from repro_torch.memory.feature_store import FeatureStore, default_chunk_rows
from repro_torch.memory.prefetcher import (
    ChunkPrefetcher,
    StreamedFeatures,
    StreamStats,
    build_stream_program,
    make_device_tile_stream,
)
from repro_torch.serve.gnn_engine import GNNRequest, GNNServeEngine

_COUNTERS = ("chunk_hits", "chunk_misses", "prefetched", "evictions", "waves", "tiles",
             "sparse_rows")


def _graph(n=600, deg=5.0, seed=0, dim=32):
    """(reference graph with features, the port's graph, the features)."""
    g = make_lognormal_graph(n, deg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, dim)).astype(np.float32)
    return g.with_features(x), Graph(indptr=g.indptr, indices=g.indices, num_nodes=n), x


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes,
                 features=g.features, name=g.name)


def _banded(n=512, k=3, dim=16):
    """Neighbours within ±k — real source locality (cache hits, prefetches)."""
    src = np.asarray([(i + o) % n for i in range(n) for o in range(1, k + 1)])
    dst = np.repeat(np.arange(n), k)
    order = np.lexsort((src, dst))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    x = np.random.default_rng(0).standard_normal((n, dim)).astype(np.float32)
    ref = RefGraph(indptr=indptr, indices=src[order].astype(np.int32), num_nodes=n)
    port = Graph(indptr=indptr, indices=src[order].astype(np.int32), num_nodes=n)
    return ref, port, x


def _plans(ref_g, port_g, ept):
    return (ref_sched.build_edge_tile_plan(ref_g, edges_per_tile=ept),
            sched.build_edge_tile_plan(port_g, edges_per_tile=ept))


# ------------------------------------------------------------ feature store
@pytest.mark.parametrize("chunk_rows", [64, 128, 1000])
def test_store_scale_and_chunks_bitwise_the_reference(chunk_rows, tmp_path):
    ref_g, _, x = _graph(n=300)
    want = ref_fs.FeatureStore.from_array(x, chunk_rows=chunk_rows)
    mem = FeatureStore.from_array(x, chunk_rows=chunk_rows, memmap_dir=str(tmp_path))
    for got in (FeatureStore.from_array(x, chunk_rows=chunk_rows), mem):
        assert got.agg_scale == want.agg_scale and got.agg_scale.dtype == np.float32
        assert (got.num_chunks, got.chunk_rows, got.shape) == (
            want.num_chunks, want.chunk_rows, want.shape)
        for c in range(want.num_chunks):
            np.testing.assert_array_equal(np.asarray(got.chunk_f32(c)), want.chunk_f32(c))
            np.testing.assert_array_equal(np.asarray(got.chunk_i8(c)), want.chunk_i8(c))
    assert (tmp_path / "features.f32.bin").exists() and (tmp_path / "features.i8.bin").exists()
    # and the port's own calibration and quantize on the CPU
    qp = compute_scale_zp(torch.from_numpy(x), symmetric=True)
    assert float(qp.scale) == float(want.agg_scale) == float(ref_scale_zp(jnp.asarray(x)).scale)
    xq = quantize(torch.from_numpy(x), qp).numpy()
    store = FeatureStore.from_array(x, chunk_rows=chunk_rows)
    for c in range(store.num_chunks):
        lo, hi = store.chunk_range(c)
        np.testing.assert_array_equal(store.chunk_i8(c)[: hi - lo], xq[lo:hi])
    np.testing.assert_array_equal(store.stream_rows("i8")[:300], xq)


def test_store_requantizes_under_another_scale_as_quantize_does():
    _, _, x = _graph(n=200, dim=8)
    store = FeatureStore.from_array(x, chunk_rows=64)
    scale = np.float32(store.agg_scale * np.float32(0.37))
    rows = store.stream_rows("i8", scale)
    qp = compute_scale_zp(torch.from_numpy(x))
    qp = dataclasses.replace(qp, scale=torch.tensor(scale))
    np.testing.assert_array_equal(rows[:200], quantize(torch.from_numpy(x), qp).numpy())
    assert store.stream_rows("i8", scale) is rows  # cached for the last scale
    assert store.stream_rows("i8", store.agg_scale) is store.stream_rows("i8")


def test_store_roundtrip_gather_and_amax():
    _, _, x = _graph(n=200, dim=8)
    store = FeatureStore.from_array(x, chunk_rows=64)
    np.testing.assert_array_equal(store.dense(), x)
    ids = np.asarray([0, 63, 64, 150, 199])
    np.testing.assert_array_equal(store.gather_rows_f32(ids), x[ids])
    assert store.amax_rows(ids) == ref_fs.FeatureStore.from_array(x, chunk_rows=64).amax_rows(ids)
    sel = store.chunk_row_selection(1, np.asarray([3, 64, 70, 127, 128]))
    np.testing.assert_array_equal(sel[0], [1, 2, 3])
    np.testing.assert_array_equal(sel[1], [0, 6, 63])


@pytest.mark.parametrize("n,d,budget", [(100_000, 256, 1 << 20), (100_000, 256, 1 << 28),
                                        (716_847, 300, 716_847 * 1200 // 8), (300, 32, 0)])
def test_default_chunk_rows_matches_reference(n, d, budget):
    assert default_chunk_rows(n, d, budget) == ref_fs.default_chunk_rows(n, d, budget)


# ----------------------------------------------------------- chunk schedule
_PLANS = [(0, 5.0, 64, 64), (1, 12.0, 32, 128), (2, 3.0, 16, 32), (3, 8.0, 128, 64)]


@pytest.mark.parametrize("seed,deg,ept,chunk_rows", _PLANS)
@pytest.mark.parametrize("reorder", [True, False])
def test_chunk_schedule_arrays_bitwise_the_reference(seed, deg, ept, chunk_rows, reorder):
    ref_g, port_g, _ = _graph(n=400, deg=deg, seed=seed, dim=8)
    rp, pp = _plans(ref_g, port_g, ept)
    np.testing.assert_array_equal(sched.tile_runs(pp), ref_sched.tile_runs(rp))
    want = ref_sched.build_chunk_schedule(rp, chunk_rows, reorder=reorder)
    got = sched.build_chunk_schedule(pp, chunk_rows, reorder=reorder)
    assert (got.chunk_rows, got.num_chunks, got.num_tiles, got.num_runs) == (
        want.chunk_rows, want.num_chunks, want.num_tiles, want.num_runs)
    for f in ("order", "runs", "lane_chunk", "lane_off"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got.tile_chunks) == len(want.tile_chunks)
    for a, b in zip(got.tile_chunks, want.tile_chunks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,deg,ept,chunk_rows", _PLANS)
def test_pack_tiles_by_chunk_bitwise_the_reference(seed, deg, ept, chunk_rows):
    ref_g, port_g, _ = _graph(n=400, deg=deg, seed=seed, dim=8)
    rp, pp = _plans(ref_g, port_g, ept)
    want, got = ref_sched.pack_tiles_by_chunk(rp, chunk_rows), sched.pack_tiles_by_chunk(
        pp, chunk_rows)
    for f in ("gather_idx", "coeff", "seg_ids", "out_node", "node_ids", "edge_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.total_edges == want.total_edges == pp.total_edges


@pytest.mark.parametrize("lengths,capacity", [([5, 3, 9, 1, 4], 8), ([20, 2, 2], 6),
                                              ([1] * 10, 4), ([7], 7)])
def test_pack_segments_matches_reference(lengths, capacity):
    for a, b in zip(sched.pack_segments(lengths, capacity),
                    ref_sched.pack_segments(lengths, capacity)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- prefetcher vs reference
def _ref_counts(store, schedule, plan, slots, depth, stream="f32", qp=None):
    stats = RefStats()
    budget = slots * (store.chunk_bytes_f32 if stream == "f32" else store.chunk_bytes_i8)
    out = RefPrefetcher(store, schedule, stream=stream, budget_bytes=budget,
                        prefetch_depth=depth, stats=stats, async_stage=False).aggregate(
        plan, qp=qp)
    return stats, np.asarray(out)


@pytest.mark.parametrize("graph", ["uniform", "banded"])
@pytest.mark.parametrize("slots", [1, 2, 3, 7])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("arm", ["reorder", "plan-order", "packed"])
def test_stream_stats_equal_the_reference(graph, slots, depth, arm, monkeypatch):
    """Accesses, uploads, hits, prefetches, evictions, sparse rows and
    bytes_streamed equal the reference's. The reference uploads each tile's
    sparse rows padded to a power of two; the port copies the rows alone, so
    its bytes are the reference's less that padding."""
    if graph == "uniform":
        ref_g, port_g, x = _graph(n=800, deg=8.0, seed=11, dim=16)
    else:
        ref_g, port_g, x = _banded()
    rp, pp = _plans(ref_g, port_g, 64)
    if arm == "packed":
        rp, pp = ref_sched.pack_tiles_by_chunk(rp, 64), sched.pack_tiles_by_chunk(pp, 64)
    reorder = arm == "reorder"
    rstore = ref_fs.FeatureStore.from_array(x, chunk_rows=64)
    want, want_out = _ref_counts(rstore, ref_sched.build_chunk_schedule(rp, 64, reorder=reorder),
                                 rp, slots, depth)
    monkeypatch.setattr(prefetcher, "BATCH_LANES", 512)  # many AGE launches
    store = FeatureStore.from_array(x, chunk_rows=64)
    schedule = sched.build_chunk_schedule(pp, 64, reorder=reorder)
    stats = StreamStats()
    pf = ChunkPrefetcher(store, schedule, stream="f32", prefetch_depth=depth, stats=stats,
                         budget_bytes=slots * store.chunk_bytes_f32)
    out = pf.aggregate(pp).numpy()
    for k in _COUNTERS:
        assert getattr(stats, k) == getattr(want, k), k
    assert (stats.accesses, stats.uploads, stats.hit_rate) == (
        want.accesses, want.uploads, want.hit_rate)
    prog = build_stream_program(pp, schedule, num_slots=pf.num_slots, prefetch_depth=depth,
                                chunk_bytes=store.chunk_bytes_f32, row_bytes=64)
    k = prog.tile_sparse[prog.tile_sparse > 0]
    pad_rows = int(np.sum((1 << np.ceil(np.log2(k)).astype(np.int64)) - k))
    assert stats.bytes_streamed == want.bytes_streamed - pad_rows * 16 * 4
    np.testing.assert_array_equal(out, want_out)  # f32 stream: bitwise the reference too


def test_int8_stream_stats_equal_the_reference():
    ref_g, port_g, x = _graph(n=800, deg=8.0, seed=11, dim=16)
    rp, pp = _plans(ref_g, port_g, 64)
    rstore = ref_fs.FeatureStore.from_array(x, chunk_rows=64)
    rqp = ref_scale_zp(jnp.asarray(x))
    want, want_out = _ref_counts(rstore, ref_sched.build_chunk_schedule(rp, 64), rp, 5, 2,
                                 stream="i8", qp=rqp)
    store = FeatureStore.from_array(x, chunk_rows=64)
    stats = StreamStats()
    qp = compute_scale_zp(torch.from_numpy(x))
    out = ChunkPrefetcher(store, sched.build_chunk_schedule(pp, 64), stream="i8",
                          budget_bytes=5 * store.chunk_bytes_i8, prefetch_depth=2,
                          stats=stats).aggregate(pp, qp=qp).numpy()
    for k in _COUNTERS:
        assert getattr(stats, k) == getattr(want, k), k
    np.testing.assert_allclose(out, want_out, atol=1e-4)


# ------------------------------------------------------ streamed == in-memory
@pytest.mark.parametrize("mode", ["gcn", "sum", "mean"])
@pytest.mark.parametrize("frac", [10, 3])
def test_engine_aggregate_streamed_bitwise(mode, frac):
    _, g, x = _graph(n=500, deg=6.0, seed=2)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=True))
    want = eng.aggregate(torch.from_numpy(x), mode=mode)
    store = FeatureStore.from_array(x, chunk_rows=64)
    sf = StreamedFeatures(store, store.nbytes // frac, device="cpu")
    assert torch.equal(eng.aggregate(sf, mode=mode), want)
    assert sf.stats.bytes_streamed > 0 and sf.stats.sparse_rows > 0


def test_engine_aggregate_streamed_float_policy_bitwise():
    _, g, x = _graph(n=400, deg=5.0, seed=4)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=False))
    want = eng.aggregate(torch.from_numpy(x), mode="sum")
    store = FeatureStore.from_array(x, chunk_rows=64)
    sf = StreamedFeatures(store, store.nbytes // 4, device="cpu")
    assert torch.equal(eng.aggregate(sf, mode="sum"), want)


@pytest.mark.parametrize("mixed", [True, False])
def test_engine_transform_streamed_bitwise(mixed):
    _, g, x = _graph(n=400, deg=5.0, seed=5, dim=24)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=mixed))
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))
    want = eng.transform(torch.from_numpy(x), w, b, torch.relu)
    store = FeatureStore.from_array(x, chunk_rows=64)
    sf = StreamedFeatures(store, store.nbytes // 4, device="cpu")
    assert torch.equal(eng.transform(sf, w, b, torch.relu), want)
    # float policy: the store is materialized, counted as a fallback
    assert (sf.stats.bytes_streamed > 0, sf.stats.fallbacks) == ((True, 0) if mixed else (False, 1))


def test_streamed_paths_refuse_what_they_cannot_serve():
    _, g, x = _graph(n=200, deg=4.0, seed=1, dim=8)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64))
    sf = StreamedFeatures(FeatureStore.from_array(x, chunk_rows=64), 1, device="cpu")
    with pytest.raises(ValueError, match="dense embeddings"):
        eng.aggregate(sf, mode="runtime", edge_coeff=torch.ones(g.num_edges))
    with pytest.raises(ValueError, match="dense embeddings"):
        eng.attention_aggregate(torch.zeros(g.num_edges, 1), sf)
    short = StreamedFeatures(FeatureStore.from_array(x[:100], chunk_rows=64), 1, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        eng.aggregate(short, mode="sum")


@pytest.mark.parametrize("batch_lanes", [64, 256, 1 << 16])
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_batches_and_segments_cover_every_lane_once(batch_lanes, depth, monkeypatch):
    """Batches hold whole runs; segments partition each batch's lanes, end
    before any upload that would overwrite a row a pending lane reads, and
    write each slot at most once; every replay is bitwise the in-memory one."""
    monkeypatch.setattr(prefetcher, "BATCH_LANES", batch_lanes)
    _, g, x = _graph(n=600, deg=10.0, seed=3, dim=8)
    plan = sched.build_edge_tile_plan(g, edges_per_tile=32)
    schedule = sched.build_chunk_schedule(plan, 64)
    prog = build_stream_program(plan, schedule, num_slots=3, prefetch_depth=depth,
                                chunk_bytes=64 * 8 * 4, row_bytes=32)
    e = plan.edges_per_tile
    runs = schedule.runs
    pos_of = np.empty(plan.num_tiles, np.int64)
    pos_of[schedule.order] = np.arange(plan.num_tiles)
    run_starts = set(pos_of[runs[:-1]].tolist())
    assert set(prog.batch_pos[:-1].tolist()) <= run_starts | {0}
    assert prog.batch_pos[-1] == plan.num_tiles
    for b in range(prog.num_batches):
        segs = prog.segments(b)
        assert prog.seg_lane[segs.start] == prog.batch_pos[b] * e
        assert prog.seg_lane[segs.stop] == prog.batch_pos[b + 1] * e
        for j in segs:
            ups = prog.up_slot[prog.seg_up[j]:prog.seg_up[j + 1]]
            assert ups.size == np.unique(ups).size
    np.testing.assert_array_equal(np.diff(prog.seg_lane) >= 0, True)
    ts = make_device_tile_stream(plan, schedule, store=FeatureStore.from_array(x, chunk_rows=64),
                                 stream="f32", budget_bytes=3 * 64 * 8 * 4, prefetch_depth=depth,
                                 device="cpu")
    store = FeatureStore.from_array(x, chunk_rows=64)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=32, mixed_precision=False))
    want = eng.aggregate(torch.from_numpy(x), mode="sum")
    plan_sum = eng.plans("sum")["float"]
    sched_sum = sched.build_chunk_schedule(plan_sum, 64)
    for staged in (False, True):
        out = ChunkPrefetcher(store, sched_sum, stream="f32", budget_bytes=3 * 64 * 8 * 4,
                              prefetch_depth=depth, async_stage=staged).aggregate(plan_sum)
        assert torch.equal(out, want)
    assert ts.nbytes > 0 and len(ts.splits) == ts.program.num_batches


# ------------------------------------------------------------ served paths
def _served(arch, seed=0, n=700):
    rcfg, pcfg = cfg_pair(arch)
    rp, pp = params_pair(rcfg, pcfg, seed=seed)
    g = make_dataset("cora", max_nodes=n, max_feature_dim=pcfg.d_model, seed=0)
    return rcfg, pcfg, rp, pp, g


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
@pytest.mark.parametrize("frac", [10, 3])
def test_served_outofcore_bitwise_in_memory(arch, frac):
    """Streamed serving == in-memory serving, bit for bit, every arch, at two
    budgets that force eviction; warm repeats too."""
    _, pcfg, _, pp, g = _served(arch)
    pg = _port_graph(g)
    want = GNNServeEngine(pcfg, pp, device="cpu").infer(pg, g.features)
    assert not want.streamed
    eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=g.features.nbytes // frac,
                         feature_chunk_rows=64, device="cpu")
    r = eng.infer(pg, g.features)
    assert r.streamed and r.bytes_streamed > 0
    np.testing.assert_array_equal(r.outputs, want.outputs)
    info = eng.cache_info()
    assert info["streamed_requests"] == 1
    if arch in ("gcn", "gin"):  # the chunk cache ran: misses beyond one cold pass
        assert info["chunk_misses"] > 700 // 64 + 1
    r2 = eng.infer(pg, g.features)
    assert r2.cache_hit and r2.streamed
    np.testing.assert_array_equal(r2.outputs, want.outputs)


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage", "gat"])
def test_served_streamed_matches_reference_streamed(arch):
    rcfg, pcfg, rp, pp, g = _served(arch, n=500)
    budget = g.features.nbytes // 4
    ref = RefServe(rcfg, rp, feature_budget_bytes=budget, feature_chunk_rows=64)
    port = GNNServeEngine(pcfg, pp, feature_budget_bytes=budget, feature_chunk_rows=64,
                          device="cpu")
    want = ref.infer(g, g.features)
    got = port.infer(_port_graph(g), g.features)
    assert want.streamed and got.streamed
    assert_mixed_close(got.outputs, want.outputs)
    rc, pc = ref.cache_info(), port.cache_info()
    for k in ("chunk_hits", "chunk_misses", "prefetched_uploads", "streamed_requests"):
        assert pc[k] == rc[k], k


@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_depth_zero_equals_depth_two_and_sync_overlap_is_zero(arch):
    _, pcfg, _, pp, g = _served(arch, n=600)
    pg = _port_graph(g)
    outs, infos = [], []
    for depth in (0, 2, 4):
        eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=g.features.nbytes // 4,
                             feature_chunk_rows=64, stream_prefetch_depth=depth, device="cpu")
        r = eng.infer(pg, g.features)
        outs.append(r.outputs)
        infos.append((r.copy_ms, r.stall_ms, r.prefetch_overlap))
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    assert infos[0] == (0.0, 0.0, 0.0)  # synchronous: no overlap claimed
    for copy_ms, stall_ms, overlap in infos[1:]:
        assert copy_ms > 0.0 and stall_ms >= 0.0 and 0.0 <= overlap <= 1.0


def test_async_off_reports_zero_and_same_bits():
    _, g, x = _graph(n=500, deg=6.0, seed=7, dim=16)
    plan = sched.build_edge_tile_plan(g, edges_per_tile=64)
    schedule = sched.build_chunk_schedule(plan, 64)
    store = FeatureStore.from_array(x, chunk_rows=64)
    runs = []
    for kw in ({"prefetch_depth": 0}, {"prefetch_depth": 2, "async_stage": False},
               {"prefetch_depth": 2}, {"prefetch_depth": 4}):
        stats = StreamStats()
        out = ChunkPrefetcher(store, schedule, stream="f32", stats=stats,
                              budget_bytes=3 * store.chunk_bytes_f32, **kw).aggregate(plan)
        runs.append((out, stats))
    for out, _ in runs[1:]:
        assert torch.equal(out, runs[0][0])
    assert runs[0][1].copy_ms == runs[1][1].copy_ms == 0.0
    assert runs[1][1].prefetch_overlap == 0.0
    assert runs[2][1].copy_ms > 0.0


def test_stream_knobs_threaded_from_config():
    base = get_config("ample-gcn", reduced=True)
    cfg = dataclasses.replace(base, gnn_stream_packing=True, gnn_stream_reorder=False,
                              gnn_feature_budget_bytes=12345, gnn_feature_chunk_rows=256)
    eng = GNNServeEngine(cfg, device="cpu")
    assert eng.stream_packing is True and eng.stream_reorder is False
    assert (eng.feature_budget_bytes, eng.feature_chunk_rows) == (12345, 256)
    eng2 = GNNServeEngine(cfg, stream_packing=False, stream_reorder=True,
                          feature_budget_bytes=0, stream_prefetch_depth=0, device="cpu")
    assert eng2.stream_packing is False and eng2.stream_reorder is True
    assert eng2.feature_budget_bytes == 0 and eng2.stream_prefetch_depth == 0
    eng3 = GNNServeEngine(base, device="cpu")
    assert eng3.stream_packing is False and eng3.stream_reorder is True
    assert eng3.feature_budget_bytes == 0 and eng3.stream_prefetch_depth == 2


@pytest.mark.parametrize("packing,reorder", [(True, False), (False, False)])
def test_packed_and_plan_order_streams_bitwise(packing, reorder):
    _, pcfg, _, pp, g = _served("gcn", n=600)
    pg = _port_graph(g)
    want = GNNServeEngine(pcfg, pp, device="cpu").infer(pg, g.features).outputs
    eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=g.features.nbytes // 4,
                         feature_chunk_rows=64, stream_packing=packing,
                         stream_reorder=reorder, device="cpu")
    r = eng.infer(pg, g.features)
    assert r.streamed
    np.testing.assert_array_equal(r.outputs, want)


def test_warm_streamed_requests_reupload_zero_plan_bytes():
    _, g, x = _graph(n=500, deg=5.0, seed=2, dim=16)
    eng = AmpleEngine(g, EngineConfig(edges_per_tile=64, mixed_precision=True))
    store = FeatureStore.from_array(x, chunk_rows=64)
    cold = StreamedFeatures(store, store.nbytes // 4, device="cpu")
    y1 = eng.aggregate(cold, mode="sum")
    assert cold.stats.instr_bytes > 0
    warm = StreamedFeatures(store, store.nbytes // 4, device="cpu")
    y2 = eng.aggregate(warm, mode="sum")
    assert warm.stats.instr_bytes == 0 and warm.stats.bytes_streamed > 0
    assert torch.equal(y1, y2)
    # serve level
    _, pcfg, _, pp, gd = _served("gcn", n=600)
    srv = GNNServeEngine(pcfg, pp, feature_budget_bytes=gd.features.nbytes // 4,
                         feature_chunk_rows=64, device="cpu")
    pg = _port_graph(gd)
    r1 = srv.infer(pg, gd.features)
    assert srv._last_stream.instr_bytes > 0
    r2 = srv.infer(pg, gd.features)
    assert r2.cache_hit and srv._last_stream.instr_bytes == 0
    np.testing.assert_array_equal(r1.outputs, r2.outputs)


def test_direct_prefetcher_charges_plan_bytes_per_call():
    _, g, x = _graph(n=300, deg=4.0, seed=1, dim=8)
    store = FeatureStore.from_array(x, chunk_rows=64)
    plan = sched.build_edge_tile_plan(g, edges_per_tile=64)
    stats = StreamStats()
    ChunkPrefetcher(store, sched.build_chunk_schedule(plan, 64), stream="f32",
                    budget_bytes=2 * store.chunk_bytes_f32, stats=stats).aggregate(plan)
    assert stats.instr_bytes > 0


def test_warm_engine_different_features_bitwise():
    """A warm engine serves new features under the first request's cached
    activation scale; the int8 stream must quantize under that scale."""
    _, pcfg, _, pp, g = _served("gcn", n=500)
    pg = _port_graph(g)
    x2 = (3.0 * np.random.default_rng(9).standard_normal(g.features.shape)).astype(np.float32)
    ref = GNNServeEngine(pcfg, pp, device="cpu")
    ref.infer(pg, g.features)
    want = ref.infer(pg, x2).outputs
    eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=g.features.nbytes // 4,
                         feature_chunk_rows=64, device="cpu")
    eng.infer(pg, g.features)
    r2 = eng.infer(pg, x2)
    assert r2.streamed
    np.testing.assert_array_equal(r2.outputs, want)


def test_padded_union_path_reuses_store_across_warm_requests(monkeypatch):
    _, pcfg, _, pp, g = _served("gcn", n=500)
    eng = GNNServeEngine(pcfg, pp, union_node_bucket=512, union_edge_bucket=2048,
                         feature_budget_bytes=g.features.nbytes // 4, feature_chunk_rows=64,
                         device="cpu")
    assert eng.padded_unions
    builds = []
    orig = fs.FeatureStore.from_array.__func__

    def counting(cls, x, **kw):
        builds.append(x.shape)
        return orig(cls, x, **kw)

    monkeypatch.setattr(fs.FeatureStore, "from_array", classmethod(counting))
    pg = _port_graph(g)
    first = eng.infer(pg, g.features)
    warm = eng.infer(pg, g.features)
    assert first.streamed and warm.streamed
    np.testing.assert_array_equal(warm.outputs, first.outputs)
    assert len(builds) == 1 and builds[0][0] == 512 and len(eng._stores) == 1


def test_served_within_budget_takes_inmemory_path():
    _, pcfg, _, pp, g = _served("gcn", n=300)
    eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=g.features.nbytes * 10, device="cpu")
    assert not eng.infer(_port_graph(g), g.features).streamed
    assert eng.cache_info()["streamed_requests"] == 0


def test_streamed_batch_and_telemetry():
    rcfg, pcfg, rp, pp, _ = _served("gcn")
    members = [make_dataset("cora", max_nodes=250, max_feature_dim=pcfg.d_model, seed=s)
               for s in (0, 1)]
    reqs = [GNNRequest(graph=_port_graph(m), features=m.features) for m in members]
    want = GNNServeEngine(pcfg, pp, device="cpu").infer_batch(reqs)
    total = sum(m.features.nbytes for m in members)
    eng = GNNServeEngine(pcfg, pp, feature_budget_bytes=total // 4, feature_chunk_rows=64,
                         device="cpu")
    out = eng.infer_batch(reqs)
    for a, b in zip(out, want):
        assert a.streamed
        np.testing.assert_array_equal(a.outputs, b.outputs)
        assert a.bytes_streamed_per_member == a.bytes_streamed / 2
    assert len(eng._stores) == 0  # per-call union matrices are not cached
    info = eng.cache_info()
    assert info["bytes_streamed"] == out[0].bytes_streamed > 0
    assert info["streamed_requests"] == 2
    assert 0.0 <= info["chunk_hit_rate"] <= 1.0 and 0.0 <= info["prefetch_overlap"] <= 1.0
    assert info["copy_ms"] == pytest.approx(eng.stats["copy_ms"])
    ref_out = RefServe(rcfg, rp, feature_budget_bytes=total // 4, feature_chunk_rows=64
                       ).infer_batch([RefRequest(graph=m, features=m.features) for m in members])
    for a, b in zip(out, ref_out):
        assert_mixed_close(a.outputs, b.outputs)


def test_staging_worker_under_thread_switch_pressure_and_failure(monkeypatch):
    """The worker and the consumer share a queue and the copy total: with
    the interpreter switching threads as often as it can, every staged
    replay is bitwise the synchronous one and leaves no thread behind; a
    copy that raises in the worker raises in the consumer."""
    import sys
    import threading

    _, g, x = _graph(n=600, deg=8.0, seed=13, dim=16)
    plan = sched.build_edge_tile_plan(g, edges_per_tile=32)
    schedule = sched.build_chunk_schedule(plan, 64)
    store = FeatureStore.from_array(x, chunk_rows=64)
    monkeypatch.setattr(prefetcher, "BATCH_LANES", 256)

    def run(depth):
        return ChunkPrefetcher(store, schedule, stream="f32", prefetch_depth=depth,
                               budget_bytes=2 * store.chunk_bytes_f32).aggregate(plan)

    want = run(0)
    threads = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 2, 3, 5) * 3:
            assert torch.equal(run(depth), want)
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == threads

    def broken(rows_np, prog, b, out=None):
        raise OSError("host gather failed")

    monkeypatch.setattr(ChunkPrefetcher, "_sparse", staticmethod(broken))
    with pytest.raises(OSError, match="host gather failed"):
        run(2)
    assert threading.active_count() == threads
