"""Plan-driven chunk prefetcher + streamed executors (out-of-core serving).

``ChunkPrefetcher`` executes a ``core.scheduler.ChunkSchedule`` against a
fixed-budget device chunk cache, as the reference's
(``repro/memory/prefetcher.py``) does, with the same decisions:

* **budget** — the cache is ``num_slots`` slots of ``chunk_rows`` feature
  rows; ``num_slots = budget_bytes // chunk_bytes`` (min 1, at most the
  chunk count).
* **reuse-distance eviction** — the schedule is known ahead of time, so
  eviction is Belady-optimal: the resident chunk with the farthest next use
  goes first, and only for a chunk needed sooner.
* **sparse residue** — a visit whose chunk loses the Belady comparison
  bypasses the cache: only the rows the tile gathers move.
* **prefetch** — after each tile, chunks of the next ``prefetch_depth``
  tiles are admitted ahead of their visits.

The decisions are the reference's state machine (``_CacheState``), run on
the host in numpy over the whole schedule once per (plan, chunking, slots,
depth): they depend on the schedule alone, never on timing or data. They
become a ``StreamProgram``: the uploads in order, and for every lane of
every tile the row of the device buffer it reads (a cache slot's row, or a
row of the tile batch's sparse block). A request replays the program:

* tiles run in **batches of whole runs** (``scheduler.tile_runs``: no node
  spans two runs); per batch the sparse block is copied in, the uploads go
  into their slots, the lanes are gathered from the slots into a gather
  buffer in *segments* (a segment ends where an upload would overwrite a
  slot that a lane not yet gathered reads), and one launch of the AGE
  kernel (``kernels/segment_agg``) sums the batch into the shared output.
  Each output row is summed over the same lanes in the same order as the
  in-memory launch sums it, so the result is **bitwise** the in-memory one.
* **staging** — with ``prefetch_depth > 0`` a worker thread builds the
  copies ``prefetch_depth`` steps ahead: on the card it gathers sparse rows
  into page-locked buffers and issues every host-to-device copy on a side
  CUDA stream, each fenced by an event the consumer's stream waits on;
  ``copy_ms`` is the side stream's copy time from CUDA events and
  ``stall_ms`` the wall time the consumer waited for the worker, so
  ``prefetch_overlap = 1 - stall/copy``. On the CPU the copies are host
  copies timed by the wall clock, as the reference times its own. With
  ``prefetch_depth == 0`` (or ``async_stage=False``) the consumer copies
  inline and both stay 0: no overlap is claimed.

The int8 stream gathers codes under the aggregation scale and hands the
kernel its ``QuantParams``, as the in-memory int8 group does. The FTE stream
(``transform_streamed``) runs each chunk's int8 block through the int8 GEMM
kernel (``kernels/quant_matmul``): int32 accumulation is exact, so
chunk-blocked equals the monolithic matmul, while the small float-protected
block is gathered and transformed in one piece. On a CUDA device every step
launches the kernels or raises; nothing runs a plain version there.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.quantization import INT8_MAX, QuantParams
from repro_torch.core.transformation import transform_dense
from repro_torch.kernels.quant_matmul import ops as qm_ops
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.memory.feature_store import FeatureStore
from repro_torch.observe import trace as otrace

__all__ = [
    "StreamStats",
    "StreamedFeatures",
    "StreamProgram",
    "build_stream_program",
    "DeviceTileStream",
    "make_device_tile_stream",
    "stream_slots",
    "ChunkPrefetcher",
    "aggregate_streamed",
    "transform_streamed",
    "scale_add_streamed",
]

_INF = np.iinfo(np.int64).max
# Lanes of one AGE launch on the streamed path (whole runs, at least one):
# 65,536 lanes are 256 tiles of 256, a 79 MB f32 gather buffer at D 300.
# Read when a program is built (tests lower it to get many batches).
BATCH_LANES = 1 << 16


@dataclasses.dataclass
class StreamStats:
    """Telemetry of one (or several merged) streamed executions.

    ``accesses = chunk_hits + chunk_misses`` counts tile→chunk visits;
    ``uploads = chunk_misses + prefetched`` counts non-hit servings (full
    chunk copies plus sparse-residue visits). ``bytes_streamed`` counts the
    feature bytes copied host to device: whole chunks and sparse rows.
    ``stall_ms``/``copy_ms`` are the staging measurements (module docstring);
    both stay 0 on the synchronous path.
    """

    bytes_streamed: int = 0  # feature bytes moved host->device
    instr_bytes: int = 0  # per-tile plan arrays (the instruction stream)
    chunk_hits: int = 0
    chunk_misses: int = 0  # demand servings (visit found chunk absent)
    prefetched: int = 0  # uploads issued ahead of their first visit
    evictions: int = 0
    waves: int = 0
    tiles: int = 0
    fallbacks: int = 0  # dense materializations (budget violated, loud)
    fallback_bytes: int = 0
    sparse_rows: int = 0  # rows served as sparse residue (cache bypassed)
    stall_ms: float = 0.0  # consumer wall time blocked on staged copies
    copy_ms: float = 0.0  # time of the staged copies themselves

    @property
    def accesses(self) -> int:
        return self.chunk_hits + self.chunk_misses

    @property
    def uploads(self) -> int:
        return self.chunk_misses + self.prefetched

    @property
    def hit_rate(self) -> float:
        return self.chunk_hits / self.accesses if self.accesses else 0.0

    @property
    def prefetch_overlap(self) -> float:
        """Fraction of copy time the consumer did not wait for."""
        if self.copy_ms <= 0.0:
            return 0.0
        return min(max(1.0 - self.stall_ms / self.copy_ms, 0.0), 1.0)

    def as_dict(self) -> Dict[str, float]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["hit_rate"] = self.hit_rate
        d["prefetch_overlap"] = self.prefetch_overlap
        return d


class StreamedFeatures:
    """Handle standing in for a dense feature matrix on the streamed path.

    Carries the host store, the device feature budget, the device the
    stream runs on and the telemetry the serving layer reads back. The
    engine's ``aggregate``/``transform`` accept it wherever they accept a
    dense tensor; arithmetic consumers use :func:`scale_add_streamed`.
    """

    def __init__(
        self,
        store: FeatureStore,
        budget_bytes: int,
        *,
        prefetch_depth: int = 1,
        reorder: bool = True,
        packing: bool = False,
        async_stage: bool = True,
        device="cuda",
    ):
        self.store = store
        self.budget_bytes = int(budget_bytes)
        self.prefetch_depth = int(prefetch_depth)
        self.reorder = bool(reorder)
        # packing: serve through chunk-packed tile plans
        # (scheduler.pack_tiles_by_chunk) instead of only reordering runs.
        self.packing = bool(packing)
        # async_stage: build the copies on the staging worker; False keeps
        # the synchronous path (same outputs bit for bit).
        self.async_stage = bool(async_stage)
        self.device = torch.device(device)
        self.stats = StreamStats()
        # Per-request correlation id (observe.trace), stamped by the serving
        # engine before the forward pass.
        self.trace_id = ""

    @property
    def shape(self) -> Tuple[int, int]:
        return self.store.shape

    @property
    def ndim(self) -> int:
        return 2

    @property
    def nbytes(self) -> int:
        return self.store.nbytes

    def agg_qp(self) -> QuantParams:
        """The aggregation-stream QuantParams on the stream's device —
        bitwise-equal to ``compute_scale_zp(dense_x, symmetric=True)``. On
        the card they must be device tensors: a CPU scalar divisor would
        make ``quantize`` multiply by its reciprocal instead of dividing."""
        scale = torch.tensor(self.store.agg_scale, dtype=torch.float32, device=self.device)
        return QuantParams(scale=scale, zero_point=torch.zeros_like(scale))


def stream_slots(store: FeatureStore, stream: str, budget_bytes: int, num_chunks: int) -> int:
    """Cache slots a stream gets under ``budget_bytes`` (min 1, at most the
    schedule's chunk count)."""
    chunk = store.chunk_bytes_f32 if stream == "f32" else store.chunk_bytes_i8
    return int(min(max(int(budget_bytes) // chunk, 1), max(num_chunks, 1)))


# --------------------------------------------------------- cache state model
class _CacheState:
    """Host model of the chunk cache: slot map + Belady next uses (numpy).

    The reference's state machine (``repro/memory/prefetcher.py``), with the
    per-chunk visit cursors kept as one array of next-use positions. Its
    decisions are a deterministic function of the schedule, so staging on or
    off gives the same slots and the same bits.
    """

    def __init__(self, num_slots: int, first_use: np.ndarray):
        self.chunk_in = np.full(num_slots, -1, np.int64)
        self.slot_of = np.full(first_use.size, -1, np.int64)
        self.n_free = int(num_slots)  # free slots are taken from the top down
        self.next_use = first_use.copy()  # position of each chunk's next visit
        self.evictions = 0
        self._mark = np.zeros(first_use.size, np.int64)
        self._stamp = 0

    def _admit(self, c: int, slot: int) -> None:
        self.slot_of[c] = slot
        self.chunk_in[slot] = c

    def _evict(self, slot: int) -> None:
        self.slot_of[self.chunk_in[slot]] = -1
        self.chunk_in[slot] = -1
        self.evictions += 1

    def decide_tile(self, chunks: np.ndarray, after: np.ndarray):
        """Serve one tile's chunk visits (sorted chunk ids; ``after`` each
        one's next visit position after this one); commits the state.

        Missing chunks take free slots, else a Belady victim among the
        resident chunks this tile does not visit whose next use is strictly
        beyond the chunk's own next use after this visit; the others are
        served as sparse residue. Returns (hits, uploads [(chunk, slot)],
        sparse chunks).
        """
        hit = self.slot_of[chunks] >= 0
        hits = chunks[hit]
        miss, thr = chunks[~hit], after[~hit]
        uploads: List[Tuple[int, int]] = []
        k = min(self.n_free, miss.size)
        for c in miss[:k].tolist():
            self.n_free -= 1
            self._admit(c, self.n_free)
            uploads.append((c, self.n_free))
        sparse = miss[k:]
        if sparse.size:
            # The cache is full: the candidates are the residents off this tile.
            self._stamp += 1
            self._mark[chunks] = self._stamp
            cand = np.flatnonzero(self._mark[self.chunk_in] != self._stamp)
            if cand.size:
                uses = self.next_use[self.chunk_in[cand]]
                thr_s = thr[k:]
                if uses.max() > thr_s.min():
                    o = np.lexsort((cand, -uses))  # farthest use first, low slot on ties
                    cs, cu = cand[o].tolist(), uses[o].tolist()
                    kept, j = [], 0
                    for c, m in zip(sparse.tolist(), thr_s.tolist()):
                        if j < len(cs) and cu[j] > m:
                            self._evict(cs[j])
                            self._admit(c, cs[j])
                            uploads.append((c, cs[j]))
                            j += 1
                        else:
                            kept.append(c)
                    sparse = np.asarray(kept, np.int64)
        self.next_use[chunks] = after
        return hits, uploads, sparse

    def prefetch_moves(self, pos: int, order: np.ndarray, tile_chunks, depth: int):
        """Admissions for the next ``depth`` tiles' chunks; commits state.

        Free slots first, else a victim among all residents whose next use
        is strictly beyond the prefetched chunk's; stops at the first chunk
        no slot will take."""
        moves: List[Tuple[int, int]] = []
        for p in range(pos + 1, min(pos + 1 + depth, order.size)):
            ch = tile_chunks[int(order[p])]
            i = 0
            while True:
                absent = np.flatnonzero(self.slot_of[ch[i:]] < 0)
                if not absent.size:
                    break
                i += int(absent[0])
                c = int(ch[i])
                i += 1
                if self.n_free:
                    self.n_free -= 1
                    slot = self.n_free
                else:
                    uses = self.next_use[self.chunk_in]
                    slot = int(np.argmax(uses))
                    if uses[slot] <= self.next_use[c]:
                        return moves
                    self._evict(slot)
                self._admit(c, slot)
                moves.append((c, slot))
        return moves


def _visits(schedule: sched.ChunkSchedule):
    """(chunk visits in schedule order, offsets per position, each visit's
    next visit position of the same chunk, each chunk's first visit)."""
    per_pos = [schedule.tile_chunks[int(t)] for t in schedule.order]
    counts = np.fromiter((c.size for c in per_pos), np.int64, len(per_pos))
    ptr = np.zeros(len(per_pos) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    vc = np.concatenate(per_pos) if per_pos else np.zeros(0, np.int64)
    vp = np.repeat(np.arange(len(per_pos), dtype=np.int64), counts)
    o = np.lexsort((vp, vc))
    nxt = np.full(vc.size, _INF, np.int64)
    same = vc[o][1:] == vc[o][:-1]
    nxt[o[:-1][same]] = vp[o][1:][same]
    first = np.full(schedule.num_chunks, _INF, np.int64)
    np.minimum.at(first, vc, vp)
    return per_pos, ptr, nxt, first


@dataclasses.dataclass(frozen=True)
class StreamProgram:
    """Every host decision of one stream over one schedule, as device ops.

    Positions are in schedule order. Lanes are numbered ``pos · E + lane``.
    A batch ``b`` is tiles ``[batch_pos[b], batch_pos[b + 1])`` (whole runs);
    a segment ``j`` first does uploads ``[seg_up[j], seg_up[j + 1])`` into
    their slots (each slot at most once), then gathers lanes
    ``[seg_lane[j], seg_lane[j + 1])`` of its batch ``seg_batch[j]``.
    ``lane_src`` is the row of the device buffer a lane reads:
    ``slot · chunk_rows + offset`` for a cached chunk, ``num_slots ·
    chunk_rows + k`` for the k-th sparse row of its batch, whose global row
    is ``sparse_rows[batch_sparse[b] + k]``.
    """

    num_slots: int
    chunk_rows: int
    edges_per_tile: int
    batch_pos: np.ndarray  # int64[B + 1]
    batch_sparse: np.ndarray  # int64[B + 1]
    sparse_rows: np.ndarray  # int64[K]
    lane_src: np.ndarray  # int32[T·E]
    up_chunk: np.ndarray  # int64[U]
    up_slot: np.ndarray  # int64[U]
    seg_up: np.ndarray  # int64[J + 1]
    seg_lane: np.ndarray  # int64[J + 1]
    seg_batch: np.ndarray  # int64[J]
    tile_sparse: np.ndarray  # int64[T] sparse rows of each tile
    counts: Mapping[str, int]  # the StreamStats counters one replay adds

    @property
    def num_batches(self) -> int:
        return int(self.batch_pos.size) - 1

    @property
    def max_sparse(self) -> int:
        return int(np.max(np.diff(self.batch_sparse), initial=0))

    @property
    def max_batch_tiles(self) -> int:
        return int(np.max(np.diff(self.batch_pos), initial=0))

    def segments(self, b: int) -> range:
        """The segments of batch ``b``."""
        lo, hi = np.searchsorted(self.seg_batch, [b, b + 1])
        return range(int(lo), int(hi))


def _batches(schedule: sched.ChunkSchedule, edges_per_tile: int) -> np.ndarray:
    """Batch boundaries (schedule positions): consecutive whole runs up to
    ``BATCH_LANES`` lanes, at least one run each."""
    order = schedule.order
    if not order.size:
        return np.zeros(1, np.int64)
    run_of = np.searchsorted(schedule.runs, order, side="right") - 1
    starts = np.flatnonzero(np.r_[True, run_of[1:] != run_of[:-1]]).tolist() + [order.size]
    cap = max(BATCH_LANES // max(edges_per_tile, 1), 1)
    bounds = [0]
    for lo, hi in zip(starts[:-1], starts[1:]):
        if hi - bounds[-1] > cap and lo > bounds[-1]:
            bounds.append(lo)
    bounds.append(order.size)
    return np.asarray(bounds, np.int64)


def build_stream_program(
    plan: sched.EdgeTilePlan,
    schedule: sched.ChunkSchedule,
    *,
    num_slots: int,
    prefetch_depth: int,
    chunk_bytes: int,
    row_bytes: int,
) -> StreamProgram:
    """Run the cache state machine over ``schedule`` (the reference's
    decisions, tile by tile) and lay out what a replay does on the device.
    ``chunk_bytes``/``row_bytes`` size the stream's copies for the
    ``bytes_streamed`` count."""
    E, R = plan.edges_per_tile, schedule.chunk_rows
    order, T = schedule.order, schedule.num_tiles
    per_pos, ptr, nxt, first = _visits(schedule)
    state = _CacheState(num_slots, first)
    batch_pos = _batches(schedule, E)
    base = num_slots * R
    lane_src = np.empty(T * E, np.int32)
    sparse_parts: List[np.ndarray] = []
    batch_sparse = [0]
    tile_sparse = np.zeros(T, np.int64)
    up_chunk: List[int] = []
    up_slot: List[int] = []
    seg_up, seg_lane, seg_batch = [0], [0], []
    pending = np.zeros(num_slots, bool)  # slots read by lanes not yet gathered
    written = np.zeros(num_slots, bool)  # slots this segment uploads into
    cnt = dict(chunk_hits=0, chunk_misses=0, prefetched=0, waves=0, tiles=T)
    b, k = 0, 0  # current batch, its sparse rows so far

    def flush(lane: int) -> None:
        if lane > seg_lane[-1] or len(up_chunk) > seg_up[-1]:
            seg_up.append(len(up_chunk))
            seg_lane.append(lane)
            seg_batch.append(b)
        pending[:] = False
        written[:] = False

    def upload(c: int, slot: int, lane: int) -> None:
        # A segment uploads each slot once (one index_copy_ writes them all)
        # and never over a row a pending lane still has to read.
        if pending[slot] or written[slot]:
            flush(lane)
        up_chunk.append(c)
        up_slot.append(slot)
        written[slot] = True

    for pos in range(T):
        t = int(order[pos])
        lane0 = pos * E
        if pos == batch_pos[b + 1]:
            flush(lane0)
            b += 1
            batch_sparse.append(batch_sparse[-1] + k)
            k = 0
        hits, ups, sparse = state.decide_tile(per_pos[pos], nxt[ptr[pos]:ptr[pos + 1]])
        for c, slot in ups:
            upload(c, slot, lane0)
        cnt["chunk_hits"] += int(hits.size)
        cnt["chunk_misses"] += len(ups) + int(sparse.size)
        cnt["waves"] += int(hits.size + len(ups) > 0)
        slot = state.slot_of[schedule.lane_chunk[t]]
        hit = slot >= 0
        src = slot * R + schedule.lane_off[t]
        ns = int(E - np.count_nonzero(hit))
        if ns:
            src[~hit] = base + k + np.arange(ns)
            sparse_parts.append(plan.gather_idx[t][~hit].astype(np.int64))
            tile_sparse[pos] = ns
            k += ns
        lane_src[lane0 : lane0 + E] = src
        pending[slot[hit]] = True
        for c, s in state.prefetch_moves(pos, order, schedule.tile_chunks, prefetch_depth):
            upload(c, s, lane0 + E)
            cnt["prefetched"] += 1
    flush(T * E)
    batch_sparse.append(batch_sparse[-1] + k)
    sparse_rows = np.concatenate(sparse_parts) if sparse_parts else np.zeros(0, np.int64)
    cnt["evictions"] = state.evictions
    cnt["sparse_rows"] = int(sparse_rows.size)
    cnt["bytes_streamed"] = len(up_chunk) * chunk_bytes + int(sparse_rows.size) * row_bytes
    return StreamProgram(
        num_slots=int(num_slots), chunk_rows=R, edges_per_tile=E,
        batch_pos=batch_pos, batch_sparse=np.asarray(batch_sparse, np.int64),
        sparse_rows=sparse_rows, lane_src=lane_src,
        up_chunk=np.asarray(up_chunk, np.int64), up_slot=np.asarray(up_slot, np.int64),
        seg_up=np.asarray(seg_up, np.int64), seg_lane=np.asarray(seg_lane, np.int64),
        seg_batch=np.asarray(seg_batch, np.int64), tile_sparse=tile_sparse, counts=cnt,
    )


class DeviceTileStream(NamedTuple):
    """One stream's program and its device-resident instruction stream.

    The tile arrays in schedule order, a split map per batch, the lanes'
    source rows and the upload slots, uploaded once: an engine caches one
    per (mode, tag, chunking, stream, slots, depth, device), so warm
    streamed requests move feature bytes only (``StreamStats.instr_bytes``).
    """

    program: StreamProgram
    coeff: torch.Tensor  # f32[T, E]
    seg_ids: torch.Tensor  # int32[T, E]
    out_node: torch.Tensor  # int32[T, S]
    splits: Tuple[seg_ops.SplitMap, ...]  # one per batch
    lane_src: torch.Tensor  # int32[T·E]
    up_slot: torch.Tensor  # int64[U]
    ident: torch.Tensor  # int32[max batch tiles, E]: lane j reads row j
    nbytes: int  # host->device bytes the upload cost (charged once, by owner)


def make_device_tile_stream(
    plan: sched.EdgeTilePlan,
    schedule: sched.ChunkSchedule,
    *,
    store: FeatureStore,
    stream: str,
    budget_bytes: int,
    prefetch_depth: int,
    device,
) -> DeviceTileStream:
    """Build the program of one stream and upload its instruction stream."""
    device = torch.device(device)
    slots = stream_slots(store, stream, budget_bytes, schedule.num_chunks)
    elem = 4 if stream == "f32" else 1
    prog = build_stream_program(
        plan, schedule, num_slots=slots, prefetch_depth=max(int(prefetch_depth), 0),
        chunk_bytes=schedule.chunk_rows * store.dim * elem, row_bytes=store.dim * elem,
    )
    order = schedule.order
    coeff, seg_ids, out_node = (a[order] for a in (plan.coeff, plan.seg_ids, plan.out_node))
    splits = tuple(
        seg_ops.split_segment_map(out_node[lo:hi], seg_ids[lo:hi], plan.num_nodes).to(device)
        for lo, hi in zip(prog.batch_pos[:-1].tolist(), prog.batch_pos[1:].tolist())
    )
    ident = np.arange(prog.max_batch_tiles * plan.edges_per_tile, dtype=np.int32).reshape(
        prog.max_batch_tiles, plan.edges_per_tile)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    host = (coeff, seg_ids, out_node, prog.lane_src, prog.up_slot, ident)
    nbytes = sum(a.nbytes for a in host) + sum(
        s.slot_of.numel() * 4 + s.split_ptr.numel() * 4 + s.split_node.numel() * 4
        for s in splits)
    return DeviceTileStream(
        program=prog,
        coeff=up(coeff, torch.float32),
        seg_ids=up(seg_ids, torch.int32),
        out_node=up(out_node, torch.int32),
        splits=splits,
        lane_src=up(prog.lane_src, torch.int32),
        up_slot=up(prog.up_slot, torch.int64),
        ident=up(ident, torch.int32),
        nbytes=int(nbytes),
    )


# ------------------------------------------------------------ staging worker
class _Staged(NamedTuple):
    """One staged copy: its tensor on the stream's device, the events that
    fence it on the side stream (None on the CPU) and its build time."""

    value: torch.Tensor
    start: Optional[object]
    end: Optional[object]
    build_ms: float


class _Stager:
    """Worker thread building a stream's copies in program order, at most
    ``depth`` ahead of the consumer (a bounded queue) and, on the card, at
    most ``depth`` copies ahead of the side stream.

    On the card: sparse rows are gathered into page-locked buffers (a
    buffer is reused only after the event of its last copy completed) and
    every copy is issued on the side stream; chunk copies start from the
    store's page-locked memory. The consumer's stream waits on each item's
    end event before it reads the item. An exception in the worker reaches
    the consumer when it takes the failed item."""

    def __init__(self, jobs: Sequence[Callable[[], _Staged]], depth: int, device: torch.device):
        self._jobs = jobs
        self._depth = max(depth, 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        # The worker's current device is its own: set it to the consumer's.
        self._index = None
        if device.type == "cuda":
            self._index = device.index if device.index is not None else torch.cuda.current_device()
        self.copy_ms = 0.0  # the copies' time, summed by the worker
        self._thread = threading.Thread(target=self._run, name="chunk-stage", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self._index is not None:
                torch.cuda.set_device(self._index)
            issued: "collections.deque" = collections.deque()  # copies in flight
            for job in self._jobs:
                # On the card the copies are asynchronous: hold at most
                # ``depth`` of them in flight, so the staged tensors stay few.
                while len(issued) >= self._depth:
                    self._retire(issued.popleft())
                item = job()
                if item.end is None:
                    self.copy_ms += item.build_ms
                else:
                    issued.append(item)
                if not self._put(item):
                    return
            while issued:
                self._retire(issued.popleft())
        except BaseException as exc:  # handed to the consumer, which raises it
            self._put(exc)

    def _retire(self, item: _Staged) -> None:
        """Wait for a copy on the side stream; add its time to ``copy_ms``."""
        item.end.synchronize()
        self.copy_ms += item.start.elapsed_time(item.end)

    def _put(self, item) -> bool:
        """Queue ``item``, waiting for room; False once the consumer stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def take(self) -> Tuple[_Staged, float]:
        """The next item and the wall time (ms) the consumer waited for it."""
        t0 = time.perf_counter()
        item = self._q.get()
        wait_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(item, BaseException):
            raise item
        return item, wait_ms

    def stop(self) -> None:
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()


# ------------------------------------------------------------- chunk cache
class ChunkPrefetcher:
    """Fixed-budget device chunk cache executing one plan stream.

    One instance serves one precision stream of one aggregation call; the
    float and int8 streams run one after the other, so each gets the full
    budget. ``stream`` selects the representation: ``"f32"`` gathers raw
    rows, ``"i8"`` gathers int8 codes under ``quant_scale`` (the store's
    aggregation scale by default). ``tiles`` is the caller's cached
    ``DeviceTileStream`` for this stream; without it the program is built
    and uploaded per call and charged to ``instr_bytes``.
    """

    def __init__(
        self,
        store: FeatureStore,
        schedule: sched.ChunkSchedule,
        *,
        stream: str,
        budget_bytes: int,
        prefetch_depth: int = 1,
        stats: Optional[StreamStats] = None,
        quant_scale=None,
        tiles: Optional[DeviceTileStream] = None,
        async_stage: bool = True,
        trace_id: str = "",
        device="cpu",
    ):
        if schedule.chunk_rows != store.chunk_rows:
            raise ValueError(
                f"schedule chunk_rows {schedule.chunk_rows} != store {store.chunk_rows}"
            )
        if stream not in ("f32", "i8"):
            raise ValueError(f"unknown stream {stream!r}")
        self.store = store
        self.schedule = schedule
        self.stream = stream
        self.quant_scale = (
            np.float32(store.agg_scale) if quant_scale is None else np.float32(quant_scale)
        )
        self.prefetch_depth = max(int(prefetch_depth), 0)
        self.async_stage = bool(async_stage)
        self.stats = stats if stats is not None else StreamStats()
        self.trace_id = trace_id
        self.device = torch.device(device)
        self.budget_bytes = int(budget_bytes)
        self.tiles = tiles
        self.num_slots = stream_slots(store, stream, budget_bytes, schedule.num_chunks)

    # ------------------------------------------------------------ plumbing
    def _host(self):
        """(rows as an array, the same as a tensor) in this stream's
        representation: f32, or codes under ``quant_scale``."""
        scale = None if self.stream == "f32" else self.quant_scale
        return (self.store.stream_rows(self.stream, scale),
                self.store.stream_tensor(self.stream, scale))

    def _chunk(self, rows_np, rows_t, c: int) -> torch.Tensor:
        """Chunk ``c`` of the representation, ``chunk_rows`` rows (zeros
        past the matrix's end)."""
        r = self.store.chunk_rows
        lo = c * r
        if rows_t.shape[0] >= lo + r:
            return rows_t[lo : lo + r]
        blk = np.zeros((r, self.store.dim), rows_np.dtype)
        blk[: rows_np.shape[0] - lo] = rows_np[lo:]
        return torch.from_numpy(blk)

    def _sparse(self, rows_np, prog: StreamProgram, b: int, out: Optional[np.ndarray] = None):
        """The sparse rows of batch ``b`` gathered on the host."""
        ids = prog.sparse_rows[prog.batch_sparse[b] : prog.batch_sparse[b + 1]]
        if out is None:
            return np.take(rows_np, ids, axis=0)
        # mode="clip" writes into ``out`` unbuffered (the ids are in range).
        return np.take(rows_np, ids, axis=0, out=out[: ids.size], mode="clip")

    def _jobs(self, prog: StreamProgram, rows_np, chunks: Sequence[torch.Tensor]
              ) -> List[Callable[[], _Staged]]:
        """The staging worker's copies, in the order the replay takes them:
        per batch its sparse block (if any), then per segment its uploads
        (if any)."""
        dev, d = self.device, self.store.dim
        on_card = dev.type == "cuda"
        dtype = torch.float32 if self.stream == "f32" else torch.int8
        side = torch.cuda.Stream(device=dev) if on_card else None
        pool: List[list] = []  # [pinned tensor, its numpy view, last copy's event]
        if on_card and prog.max_sparse:
            for _ in range(max(self.prefetch_depth, 1) + 2):
                t = torch.empty((prog.max_sparse, d), dtype=dtype, pin_memory=True)
                pool.append([t, t.numpy(), None])
        jobs: List[Callable[[], _Staged]] = []

        def timed(fill: Callable[[], torch.Tensor]) -> _Staged:
            t0 = time.perf_counter()
            if not on_card:
                value = fill()
                return _Staged(value, None, None, (time.perf_counter() - t0) * 1e3)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                value = fill()
                end.record(side)
            return _Staged(value, start, end, (time.perf_counter() - t0) * 1e3)

        def sparse_job(b: int, slot: int) -> Callable[[], _Staged]:
            def run() -> _Staged:
                if not on_card:
                    return timed(lambda: torch.from_numpy(self._sparse(rows_np, prog, b)))
                buf = pool[slot]
                if buf[2] is not None:
                    buf[2].synchronize()  # its previous copy has left the buffer
                k = int(prog.batch_sparse[b + 1] - prog.batch_sparse[b])
                self._sparse(rows_np, prog, b, out=buf[1])

                def fill():
                    dst = torch.empty((k, d), dtype=dtype, device=dev)
                    return dst.copy_(buf[0][:k], non_blocking=True)
                item = timed(fill)
                buf[2] = item.end
                return item
            return run

        def chunk_job(u0: int, u1: int) -> Callable[[], _Staged]:
            def fill() -> torch.Tensor:
                src = [chunks[c] for c in prog.up_chunk[u0:u1].tolist()]
                if not on_card:
                    return torch.stack(src)
                dst = torch.empty((u1 - u0, self.store.chunk_rows, d), dtype=dtype, device=dev)
                for to, c in zip(dst.unbind(0), src):
                    to.copy_(c, non_blocking=True)
                return dst
            return lambda: timed(fill)

        n_sparse = 0
        for b in range(prog.num_batches):
            if prog.batch_sparse[b + 1] > prog.batch_sparse[b]:
                jobs.append(sparse_job(b, n_sparse % max(len(pool), 1)))
                n_sparse += 1
            for j in prog.segments(b):
                if prog.seg_up[j + 1] > prog.seg_up[j]:
                    jobs.append(chunk_job(int(prog.seg_up[j]), int(prog.seg_up[j + 1])))
        return jobs

    # ----------------------------------------------------------- execution
    def aggregate(
        self,
        plan: sched.EdgeTilePlan,
        *,
        qp: Optional[QuantParams] = None,
        out: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Stream one plan's tiles through the cache: f32[N, D].

        Bitwise the in-memory ``aggregate_edge_tiles`` of the dense matrix
        (f32 stream) or of its codes under ``qp`` (i8 stream). With ``out``
        (f32 [N, D] on the stream's device) the rows of the plan's nodes are
        written into it and every other row is left as it is.
        """
        if self.stream == "i8" and qp is None:
            raise ValueError("int8 stream needs the aggregation QuantParams")
        dev, d, n = self.device, self.store.dim, plan.num_nodes
        ts = self.tiles
        if ts is None:
            ts = make_device_tile_stream(
                plan, self.schedule, store=self.store, stream=self.stream,
                budget_bytes=self.budget_bytes, prefetch_depth=self.prefetch_depth,
                device=dev)
            self.stats.instr_bytes += ts.nbytes
        prog = ts.program
        if prog.num_slots != self.num_slots or ts.lane_src.device.type != dev.type:
            raise ValueError("device tile stream was built for another budget or device")
        if out is None:
            out = torch.zeros((n, d), dtype=torch.float32, device=dev)
        dtype = torch.float32 if self.stream == "f32" else torch.int8
        rows_np, rows_t = self._host()
        chunks = [self._chunk(rows_np, rows_t, c) for c in range(self.schedule.num_chunks)]
        r, e = self.store.chunk_rows, prog.edges_per_tile
        base = self.num_slots * r
        buf = torch.empty((base + prog.max_sparse, d), dtype=dtype, device=dev)
        slots = buf[:base].view(self.num_slots, r, d)
        gathered = torch.empty((prog.max_batch_tiles * e, d), dtype=dtype, device=dev)
        staged = (self.async_stage and self.prefetch_depth > 0
                  and prog.up_chunk.size + prog.sparse_rows.size > 0)
        stager = (_Stager(self._jobs(prog, rows_np, chunks), self.prefetch_depth, dev)
                  if staged else None)
        main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        rec = otrace.get_recorder()
        t_start = time.perf_counter() if rec.enabled else 0.0

        def take() -> torch.Tensor:
            item, wait_ms = stager.take()
            self.stats.stall_ms += wait_ms
            if rec.enabled and wait_ms > 0.0:
                t1 = time.perf_counter()
                rec.add_span("stall", t1 - wait_ms / 1e3, t1, cat="stream",
                             trace_id=self.trace_id, args={"stream": self.stream})
            if main is not None:
                main.wait_event(item.end)
                item.value.record_stream(main)
            return item.value

        try:
            for b in range(prog.num_batches):
                k = int(prog.batch_sparse[b + 1] - prog.batch_sparse[b])
                if k:
                    rows = take() if stager else torch.from_numpy(self._sparse(rows_np, prog, b))
                    buf[base : base + k].copy_(rows)
                p0, p1 = int(prog.batch_pos[b]), int(prog.batch_pos[b + 1])
                for j in prog.segments(b):
                    u0, u1 = int(prog.seg_up[j]), int(prog.seg_up[j + 1])
                    if u1 > u0 and stager:
                        slots.index_copy_(0, ts.up_slot[u0:u1], take())
                    else:
                        for slot, c in zip(prog.up_slot[u0:u1].tolist(),
                                           prog.up_chunk[u0:u1].tolist()):
                            slots[slot].copy_(chunks[c], non_blocking=self.store.pinned)
                    l0, l1 = int(prog.seg_lane[j]), int(prog.seg_lane[j + 1])
                    if l1 > l0:
                        torch.index_select(buf, 0, ts.lane_src[l0:l1],
                                           out=gathered[l0 - p0 * e : l1 - p0 * e])
                seg_ops.aggregate_tiles(
                    gathered[: (p1 - p0) * e], ts.ident[: p1 - p0], ts.coeff[p0:p1],
                    ts.seg_ids[p0:p1], ts.out_node[p0:p1], ts.splits[b], num_nodes=n,
                    qp=None if self.stream == "f32" else qp, out=out)
        finally:
            if stager is not None:
                stager.stop()
        for key in ("chunk_hits", "chunk_misses", "prefetched", "evictions", "waves", "tiles",
                    "sparse_rows", "bytes_streamed"):
            setattr(self.stats, key, getattr(self.stats, key) + prog.counts[key])
        if stager is not None:
            self.stats.copy_ms += stager.copy_ms
        if rec.enabled:
            rec.add_span(
                f"stream:{self.stream}", t_start, time.perf_counter(), cat="stream",
                trace_id=self.trace_id,
                args={"tiles": int(prog.counts["tiles"]), "staged": bool(staged)},
            )
        return out


# -------------------------------------------------------- streamed executors
def aggregate_streamed(
    sf: StreamedFeatures,
    plans: Mapping[str, sched.EdgeTilePlan],
    schedules: Mapping[str, sched.ChunkSchedule],
    *,
    num_nodes: int,
    mixed: bool,
    qp: Optional[QuantParams] = None,
    tiles: Optional[Mapping[Tuple[str, str], DeviceTileStream]] = None,
) -> torch.Tensor:
    """Chunk-streamed mirror of the engine's aggregation dispatch.

    ``mixed`` runs the float stream then the int8 stream into one
    zero-filled output, each writing its own nodes' rows, as
    ``aggregate_mixed_precision`` does; non-mixed runs the float stream
    alone. ``tiles`` carries the caller's device-cached instruction streams
    keyed by (tag, stream) (warm requests then re-upload zero plan bytes).
    """
    for tag in plans:
        if tag not in ("float", "int8"):
            raise ValueError(f"unknown precision tag {tag!r}")
    out = torch.zeros((num_nodes, sf.store.dim), dtype=torch.float32, device=sf.device)

    def run(tag: str, stream: str, qp_: Optional[QuantParams]) -> None:
        pf = ChunkPrefetcher(
            sf.store,
            schedules[tag],
            stream=stream,
            budget_bytes=sf.budget_bytes,
            prefetch_depth=sf.prefetch_depth,
            stats=sf.stats,
            quant_scale=None if qp_ is None else np.float32(qp_.scale.item()),
            tiles=None if tiles is None else tiles.get((tag, stream)),
            async_stage=sf.async_stage,
            trace_id=sf.trace_id,
            device=sf.device,
        )
        pf.aggregate(plans[tag], qp=qp_, out=out)

    if not mixed:
        run("float", "f32", None)
        return out
    if "float" in plans:
        run("float", "f32", None)
    if "int8" in plans:
        run("int8", "i8", qp if qp is not None else sf.agg_qp())
    return out


def _host_fte_qp(amax: np.float32, device) -> QuantParams:
    """Host mirror of ``compute_scale_zp(rows, symmetric=True)`` given the
    exact row-set amax (max never rounds, the scalar ops are IEEE-exact),
    as tensors on ``device``."""
    scale = np.maximum(np.float32(amax / np.float32(INT8_MAX)), np.float32(1e-8))
    scale_t = torch.tensor(scale, dtype=torch.float32, device=device)
    return QuantParams(scale=scale_t, zero_point=torch.zeros_like(scale_t))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _dequant(acc, deq, b, activation) -> torch.Tensor:
    """The int8 FTE's epilogue on the GEMM's int32 rows, transform_int8's."""
    y = acc.to(torch.float32) * deq
    if b is not None:
        y = y + b
    return y if activation is None else activation(y)


def transform_streamed(
    sf: StreamedFeatures,
    node_group_ids: Mapping[str, np.ndarray],
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    w_qp: QuantParams,
    w_packed: qm_ops.RepackedWeight,
    a_qp: Optional[QuantParams] = None,
) -> torch.Tensor:
    """Mixed-precision FTE over stored features, bitwise-equal to
    ``transform_mixed_precision`` on the dense matrix.

    The float-protected block (a few % of nodes under Degree-Quant) is
    host-gathered and transformed in one matmul — identical shape and values
    to the in-memory group matmul. The int8 block streams chunk by chunk:
    each chunk's rows are quantized on the host under ``a_qp`` and move as
    1-byte elements, and the int8 GEMM kernel accumulates them exactly in
    int32, so per-chunk blocks equal the monolithic matmul row for row.
    Under grad the weight (through its scale) and the bias receive the
    in-memory path's gradient; the stored features receive none.
    """
    store, dev = sf.store, sf.device
    rec = otrace.get_recorder()
    fte_t0 = time.perf_counter() if rec.enabled else 0.0
    out = torch.zeros((store.num_rows, w.shape[1]), dtype=torch.float32, device=dev)
    for tag, ids in node_group_ids.items():
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            continue
        if tag == "float":
            rows = _to_device(store.gather_rows_f32(ids), dev)
            sf.stats.bytes_streamed += int(rows.numel()) * 4
            out[_to_device(ids, dev)] = transform_dense(rows, w, b, activation)
        elif tag == "int8":
            if a_qp is None:
                a_qp = _host_fte_qp(store.amax_rows(ids), dev)
            scale_np = np.float32(a_qp.scale.item())
            # Same expression as transform_int8's dequant coefficient.
            deq = a_qp.scale * w_qp.scale.reshape(1, -1)
            # Under grad the chunks' int32 rows are kept, in chunk order, and
            # dequantized in one product, as transform_int8 dequantizes the
            # group's: the same rows, values and gradient (the scales'
            # through acc, summed by one reduction over the rows).
            train = torch.is_grad_enabled() and (deq.requires_grad or (
                b is not None and b.requires_grad))
            accs, targets = [], []
            for c in np.unique(ids // store.chunk_rows).tolist():
                _, local = store.chunk_row_selection(c, ids)
                lo, hi = store.chunk_range(c)
                # Whole-chunk rows keep the shapes stable; rows outside the
                # group are computed and dropped (matmul rows are independent).
                hq = _to_device(FeatureStore._quantize_block(
                    store.chunk_f32(c)[: hi - lo], scale_np), dev)
                sf.stats.bytes_streamed += int(hq.numel())
                acc = qm_ops.quant_matmul_repacked(hq, w_packed)
                sel = _to_device(local, dev)
                if train:
                    accs.append(acc[sel])
                    targets.append(sel + lo)
                else:
                    out[sel + lo] = _dequant(acc, deq, b, activation)[sel]
            if train:
                out[torch.cat(targets)] = _dequant(torch.cat(accs), deq, b, activation)
        else:
            raise ValueError(f"unknown precision tag {tag!r}")
    if rec.enabled:
        rec.add_span("stream:fte", fte_t0, time.perf_counter(), cat="stream",
                     trace_id=sf.trace_id)
    return out


def scale_add_streamed(sf: StreamedFeatures, alpha, m: torch.Tensor) -> torch.Tensor:
    """Chunk-streamed ``alpha * x + m`` (GIN's aggregation-side residual).

    Elementwise per row, so the chunk blocks are the dense result's rows
    exactly; streams the f32 representation once.
    """
    store = sf.store
    if m.shape[0] != store.num_rows:
        raise ValueError(f"residual rows {m.shape[0]} != store rows {store.num_rows}")
    rows = store.stream_tensor("f32")
    train = torch.is_grad_enabled() and (m.requires_grad or (
        torch.is_tensor(alpha) and alpha.requires_grad))
    out = torch.empty_like(m)
    parts = []
    for c in range(store.num_chunks):
        lo, hi = store.chunk_range(c)
        blk = rows[lo:hi].to(m.device, non_blocking=store.pinned)
        sf.stats.bytes_streamed += int(blk.numel()) * 4
        if train:  # the chunks' blocks joined, so autograd reaches alpha and m
            parts.append(alpha * blk + m[lo:hi])
        else:
            torch.add(alpha * blk, m[lo:hi], out=out[lo:hi])
    return torch.cat(parts) if train else out
