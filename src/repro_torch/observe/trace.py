"""Thread-safe span recorder with Chrome-trace-event export.

The recorder collects *spans* — named ``[t0, t1)`` intervals stamped with
``time.perf_counter()`` — into a bounded ring buffer and exports them in the
Chrome trace-event JSON format, which loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``. Spans carry:

- ``lane``: the horizontal track the span renders on. Defaults to the
  recording thread's name, so context-manager spans nest naturally per
  thread; workers recording on behalf of a pipeline stage pass an explicit
  lane (e.g. the prefetcher's staging thread records on ``"copy"``).
- ``trace_id``: the per-request correlation id threaded through
  ``GNNRequest`` / ``GNNTicket`` / ``RoutedTicket`` / ``GNNResponse``, so
  one request's queue → plan → copy/stall → execute lifecycle can be
  filtered out of a busy timeline.

Design constraints (these are load-bearing for the serving hot path):

- **Disabled is free.** The module-level default recorder is disabled; call
  sites guard with ``rec.enabled`` and :meth:`TraceRecorder.span` returns a
  shared no-op singleton, so a disabled trace point costs one attribute
  read and no allocation.
- **One clock.** All stamps are ``time.perf_counter()`` — the same clock
  the serving stack uses for every lifecycle stamp and duration — so spans
  recorded from any thread land on a single consistent timeline and
  trace-derived sums reconcile with the reported ``*_ms`` fields.
- **Bounded.** The ring buffer (``collections.deque(maxlen=...)``) evicts
  the oldest spans; ``dropped`` reports how many were lost.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    """One recorded interval (times are raw ``perf_counter`` seconds)."""

    name: str
    cat: str
    lane: str
    trace_id: str
    t0: float
    t1: float
    args: Optional[Dict[str, Any]]

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class _NullSpan:
    """Shared no-op context manager for the disabled path (zero alloc)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **_kw) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager that stamps enter/exit and commits to the ring."""

    __slots__ = ("_rec", "name", "cat", "lane", "trace_id", "args", "t0")

    def __init__(self, rec, name, cat, lane, trace_id, args):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.lane = lane
        self.trace_id = trace_id
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_LiveSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec.add_span(
            self.name,
            self.t0,
            time.perf_counter(),
            cat=self.cat,
            lane=self.lane,
            trace_id=self.trace_id,
            args=self.args,
        )
        return False

    def set(self, **kw) -> "_LiveSpan":
        """Attach args discovered mid-span (e.g. cache_hit after lookup)."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self


class TraceRecorder:
    """Bounded, thread-safe span ring with Chrome-trace JSON export."""

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.epoch = time.perf_counter()
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._added = 0

    # ------------------------------------------------------------- record
    def span(
        self,
        name: str,
        *,
        cat: str = "",
        lane: Optional[str] = None,
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
    ):
        """Context manager recording ``[enter, exit)`` as one span."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, cat, lane, trace_id, args)

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "",
        lane: Optional[str] = None,
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record an interval from explicit ``perf_counter`` stamps.

        This is the after-the-fact form used when the duration was already
        measured for accounting (e.g. the prefetcher's fenced copy/stall
        timings) — recording the *same* stamps guarantees the trace
        reconciles with the reported ``*_ms`` sums by construction.
        """
        if not self.enabled:
            return
        if lane is None:
            lane = threading.current_thread().name
        with self._lock:
            self._added += 1
            self._ring.append(Span(name, cat, lane, trace_id, t0, t1, args))

    def add_instant(
        self,
        name: str,
        *,
        t: Optional[float] = None,
        cat: str = "",
        lane: Optional[str] = None,
        trace_id: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a zero-duration marker (admission, preemption, ...)."""
        if not self.enabled:
            return
        t0 = time.perf_counter() if t is None else t
        self.add_span(
            name, t0, t0, cat=cat, lane=lane, trace_id=trace_id, args=args
        )

    # -------------------------------------------------------------- query
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._added - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._added = 0

    def total_ms(
        self, name: str, *, trace_id: Optional[str] = None
    ) -> float:
        """Sum of span durations matching ``name`` (and ``trace_id``)."""
        out = 0.0
        for s in self.spans():
            if s.name != name:
                continue
            if trace_id is not None and s.trace_id != trace_id:
                continue
            out += s.t1 - s.t0
        return out

    # ------------------------------------------------------------- export
    def chrome_trace(self) -> Dict[str, Any]:
        """The span ring as a Chrome trace-event JSON object.

        Each lane becomes a ``tid`` with a ``thread_name`` metadata record;
        spans become ``ph:"X"`` complete events with microsecond ``ts``
        (relative to the recorder's epoch) and ``dur``. Zero-duration spans
        export as ``ph:"i"`` instant events.
        """
        spans = self.spans()
        lanes: Dict[str, int] = {}
        for s in spans:
            if s.lane not in lanes:
                lanes[s.lane] = len(lanes)
        events: List[Dict[str, Any]] = []
        for lane, tid in lanes.items():
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 0,
                    "tid": tid,
                    "args": {"name": lane},
                }
            )
        for s in spans:
            args = dict(s.args) if s.args else {}
            if s.trace_id:
                args["trace_id"] = s.trace_id
            ev: Dict[str, Any] = {
                "name": s.name,
                "cat": s.cat or "span",
                "pid": 0,
                "tid": lanes[s.lane],
                "ts": (s.t0 - self.epoch) * 1e6,
            }
            if s.t1 > s.t0:
                ev["ph"] = "X"
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped},
        }

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# -------------------------------------------------- module-level recorder
_RECORDER = TraceRecorder(capacity=0, enabled=False)
_ID_COUNTER = itertools.count(1)


def get_recorder() -> TraceRecorder:
    """The process-wide recorder (disabled no-op unless :func:`enable`\\ d)."""
    return _RECORDER


def set_recorder(rec: TraceRecorder) -> TraceRecorder:
    global _RECORDER
    _RECORDER = rec
    return rec


def enable(capacity: int = 1 << 18) -> TraceRecorder:
    """Install a fresh enabled recorder and return it."""
    return set_recorder(TraceRecorder(capacity=capacity, enabled=True))


def disable() -> TraceRecorder:
    """Install a disabled recorder (the zero-overhead default)."""
    return set_recorder(TraceRecorder(capacity=0, enabled=False))


def is_enabled() -> bool:
    return _RECORDER.enabled


def new_trace_id() -> str:
    """A process-unique request correlation id (``req-000001``, ...)."""
    return f"req-{next(_ID_COUNTER):06d}"
