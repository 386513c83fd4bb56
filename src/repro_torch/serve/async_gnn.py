"""Event-driven continuous batching for GNN serving — AMPLE at the queue.

AMPLE's core move is replacing the synchronous double-buffering barrier with
event-driven nodeslots: a slot frees the moment its node finishes, so short
nodes never wait behind stragglers. ``GNNServeEngine.infer_batch`` still has
exactly that barrier at the serving layer — every request up front, one
exact-shape union, everyone waits for everyone. ``AsyncGNNEngine`` removes
it:

  * **admission queue** — ``submit`` validates a request immediately (clear
    errors at the door, not deep in a union concatenate) and enqueues a
    ticket; the caller keeps the ticket and reads its result whenever it
    completes;
  * **micro-batch window** — each ``step`` admits up to ``window`` queued
    requests (bounded by a node budget) into the next disjoint-union batch,
    exactly the slot-recycling loop of continuous-batching LLM engines:
    slots freed by a completed batch are refilled from the queue head on the
    very next tick;
  * **slot recycling without starvation** — admission is strictly FIFO: an
    oversized request closes the current window rather than being skipped,
    so completion order equals submission order and no request starves;
  * **padded size classes** — when the underlying engine has union buckets
    configured, each window's union is padded to a node/edge size class and
    its plan assembled from cached per-member pieces, so the ever-changing
    batch composition stops churning the plan cache and device shapes.

The engine is deterministic and loop-agnostic: ``submit`` is O(1), ``step``
is the event-loop tick, and ``GNNTicket.result()`` drives the loop until its
request completes. A window served by ``step`` goes through the very same
``_plan_for_batch`` + ``_run`` steps as the synchronous ``infer_batch``, so
async outputs are **bitwise-identical** to the synchronous engine given the
same admitted composition.

The port of the reference's ``repro/serve/async_gnn.py``, bound to the port's
``GNNServeEngine``; the window runs on the engine's device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs.csr import Graph
from repro_torch.observe import metrics as ometrics
from repro_torch.observe import trace as otrace
from repro_torch.serve.gnn_engine import (
    GNNRequest,
    GNNResponse,
    GNNServeEngine,
    request_stamp,
)

__all__ = ["GNNTicket", "AsyncGNNEngine", "MESH_FRONTS"]

MESH_FRONTS = (
    "the fronts over a mesh are not ported (ROADMAP queue 1, item 14): every rank "
    "must admit the same windows, and a window that closes on the wall clock does "
    "not guarantee that; call the engine's infer/infer_batch on every rank"
)


@dataclasses.dataclass
class GNNTicket:
    """A submitted request's handle: pending until its micro-batch ran.

    Completion is signalled through a ``threading.Event``: a caller blocked
    in ``result()`` wakes the moment its window executes — whoever drives the
    loop — instead of sleeping out a held window's full deadline remainder.
    A ticket completes either with a ``response`` or, when its window
    exhausted the engine's execution retries, with the ``error`` attached
    (``result()`` re-raises it).
    """

    seq: int  # admission order, assigned by submit()
    request: GNNRequest
    response: Optional[GNNResponse] = None
    arrival: float = 0.0  # request_stamp() at submit; drives the SLO close
    trace_id: str = ""  # per-request correlation id (observe.trace)
    error: Optional[BaseException] = None  # terminal failure, attached after
    # the window's execution retries were exhausted (see window_retries)
    failures: int = 0  # executions of this ticket's window that raised
    _engine: Optional["AsyncGNNEngine"] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False
    )

    @property
    def done(self) -> bool:
        return self.response is not None or self.error is not None

    def _complete(self, response: Optional[GNNResponse] = None,
                  error: Optional[BaseException] = None) -> None:
        self.response = response
        self.error = error
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> GNNResponse:
        """The response; drives the owning engine's loop until completion.

        With a ``window_timeout_ms`` configured, a partially filled window
        is held open for late arrivals — this call waits out the remaining
        deadline on the completion event (so a concurrent driver executing
        the window wakes it immediately, it never oversleeps) and then steps
        again. ``timeout`` bounds the total wait in seconds
        (``TimeoutError`` when exceeded); a ticket whose window exhausted
        its execution retries re-raises the attached error.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self.done:
            if self._engine is None:
                raise RuntimeError(
                    f"ticket {self.seq} is pending but has no engine — was "
                    "it detached?"
                )
            if self._engine.step():
                continue
            if self.done:  # a concurrent driver completed us mid-step
                break
            wait = self._engine._deadline_wait()
            if wait is None:
                raise RuntimeError(
                    f"ticket {self.seq} is pending but its engine has no "
                    "admissible work — was it detached?"
                )
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        f"ticket {self.seq} still pending after {timeout}s"
                    )
                wait = min(wait, remaining)
            if wait > 0:
                # Event, not sleep: wakes the instant the window executes.
                self._event.wait(wait)
        if self.error is not None:
            raise self.error
        return self.response


class AsyncGNNEngine:
    """Continuous-batching front end over a ``GNNServeEngine``.

    Parameters
    ----------
    engine: a configured ``GNNServeEngine`` — or a ``family="gnn"``
        ModelConfig, from which one is built (``engine_kwargs`` forwarded,
        e.g. ``union_node_bucket``/``num_shards``/``halo_overlap``/``device``).
    window: max requests admitted into one micro-batch; defaults to
        ``cfg.gnn_batch_window``. The window is the slot count: a completed
        batch frees all its slots for the next tick's admissions.
    max_batch_nodes: optional node budget per micro-batch. A queued request
        that would overflow the budget closes the window (it is served first
        next tick) — stragglers delay nobody behind them beyond their own
        batch, and nobody overtakes them.
    window_timeout_ms: latency-aware window close. 0 (the historical
        behaviour) admits whatever is queued on every tick; > 0 holds a
        *partially* filled window open — ``step`` returns nothing — until
        either the window fills (count or node budget closes it) or the
        oldest queued request has waited this long, at which point the
        partial window admits at the deadline. Defaults to
        ``cfg.gnn_window_timeout_ms``. ``drain`` always flushes.
    window_retries: how many times one ticket's window may fail execution
        before the ticket is **failed** — the error is attached and
        ``result()`` re-raises it — instead of being requeued again.
        Failures 1..N-1 requeue the window at the queue head (retryable,
        the error propagates to the loop driver); failure N completes the
        tickets exceptionally so a poisoned window can never wedge the
        queue forever. Defaults to ``cfg.gnn_window_retries``.

    An engine with a ``mesh`` is refused (``MESH_FRONTS``), and so by the
    tenancy router, which serves through this front.
    """

    def __init__(
        self,
        engine,
        params=None,
        *,
        window: Optional[int] = None,
        max_batch_nodes: Optional[int] = None,
        window_timeout_ms: Optional[float] = None,
        window_retries: Optional[int] = None,
        **engine_kwargs,
    ):
        if isinstance(engine, GNNServeEngine):
            if params is not None or engine_kwargs:
                raise ValueError(
                    "pass params/engine kwargs only when constructing from a "
                    "ModelConfig, not when wrapping an existing engine"
                )
            self.engine = engine
        elif isinstance(engine, ModelConfig):
            self.engine = GNNServeEngine(engine, params, **engine_kwargs)
        else:
            raise TypeError(
                f"engine must be a GNNServeEngine or a ModelConfig, got "
                f"{type(engine).__name__}"
            )
        if self.engine.mesh is not None:
            raise ValueError(MESH_FRONTS)
        w = self.engine.cfg.gnn_batch_window if window is None else window
        if w < 1:
            raise ValueError("window must be >= 1")
        self.window = int(w)
        self.max_batch_nodes = max_batch_nodes
        wt = (
            self.engine.cfg.gnn_window_timeout_ms
            if window_timeout_ms is None
            else window_timeout_ms
        )
        if wt < 0:
            raise ValueError("window_timeout_ms must be >= 0")
        self.window_timeout_ms = float(wt)
        wr = (
            self.engine.cfg.gnn_window_retries
            if window_retries is None
            else window_retries
        )
        if wr < 1:
            raise ValueError("window_retries must be >= 1")
        self.window_retries = int(wr)
        self._queue: Deque[GNNTicket] = deque()
        self._seq = 0
        self._held_head: Optional[int] = None  # seq of the last held window head
        # Serializes the event-loop tick: result() may be driven from several
        # waiter threads at once; only one executes a window at a time, the
        # rest wake on their ticket's completion event.
        self._drive_lock = threading.RLock()
        # Registry-backed counters behind the historical dict API; see
        # GNNServeEngine.stats for the rationale.
        self.instance = ometrics.next_instance("gnn_async")
        self.stats: ometrics.StatsView = ometrics.StatsView(
            ometrics.get_registry(),
            "gnn_async",
            {"engine": self.instance},
            keys=(
                "submitted",
                "completed",
                "steps",
                "max_queue_depth",
                "held_windows",  # partial windows held open for late arrivals
                "deadline_closes",  # partial windows admitted at the deadline
                "window_failures",  # executions that raised (requeued or fatal)
                "failed_tickets",  # tickets completed exceptionally (retries out)
            ),
        )

    # ------------------------------------------------------------ admission
    def submit(
        self, graph: Graph, features, *, arch: str = "",
        arrival: Optional[float] = None, trace_id: str = "",
    ) -> GNNTicket:
        """Admit one request into the queue; returns its ticket immediately.

        Validation happens here, at the admission boundary: a mismatched
        feature matrix or an empty graph raises now, before the request can
        poison a union batch other members are riding in. ``arrival`` lets
        an upstream front (the tenancy router) carry its own admission
        timestamp through (a ``request_stamp()``/``perf_counter`` value), so
        ``queue_ms`` covers the full wait from the moment the caller handed
        the request over, not just this queue. ``trace_id`` likewise carries
        an upstream correlation id; one is minted here when tracing is
        enabled and none was passed.
        """
        arch = self.engine._arch(arch)
        features = self.engine._validate_request(graph, features)
        at = request_stamp() if arrival is None else float(arrival)
        rec = otrace.get_recorder()
        if rec.enabled and not trace_id:
            trace_id = otrace.new_trace_id()
        ticket = GNNTicket(
            seq=self._seq,
            request=GNNRequest(
                graph=graph, features=features, arch=arch, admitted_at=at,
                trace_id=trace_id,
            ),
            arrival=at,
            trace_id=trace_id,
            _engine=self,
        )
        if rec.enabled:
            rec.add_instant(
                "submit", cat="serve", trace_id=trace_id,
                args={"seq": ticket.seq, "nodes": graph.num_nodes},
            )
        self._seq += 1
        self._queue.append(ticket)
        self.stats["submitted"] += 1
        self.stats["max_queue_depth"] = max(
            self.stats["max_queue_depth"], len(self._queue)
        )
        return ticket

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ event loop
    def _deadline_wait(self) -> Optional[float]:
        """Seconds until the oldest queued request's deadline; None when no
        timeout applies (idle queue, or no timeout configured)."""
        if self.window_timeout_ms <= 0 or not self._queue:
            return None
        age = request_stamp() - self._queue[0].arrival
        return max(self.window_timeout_ms / 1e3 - age, 0.0)

    def _admit(self, *, flush: bool = False) -> List[GNNTicket]:
        """Pop the next micro-batch off the queue head (FIFO, budgeted).

        With a window timeout, a *partial* window (queue drained before the
        count/node budget closed it) is held back until the oldest member
        has waited out the deadline; ``flush`` overrides (drain/shutdown).
        """
        batch: List[GNNTicket] = []
        nodes = 0
        while self._queue and len(batch) < self.window:
            nxt = self._queue[0]
            n = nxt.request.graph.num_nodes
            if (
                batch
                and self.max_batch_nodes is not None
                and nodes + n > self.max_batch_nodes
            ):
                break  # close the window; nxt leads the next batch
            batch.append(self._queue.popleft())
            nodes += n
        # A window is "closed" — never held — when the count or node budget
        # can admit nothing more: full by count, a successor already waiting
        # (the budget break fired), or the budget itself saturated (nothing
        # that arrives later could ever join this window).
        budget_full = (
            self.max_batch_nodes is not None and nodes >= self.max_batch_nodes
        )
        partial = (
            bool(batch)
            and len(batch) < self.window
            and not self._queue
            and not budget_full
        )
        if partial and not flush and self.window_timeout_ms > 0:
            age_ms = (request_stamp() - batch[0].arrival) * 1e3
            if age_ms < self.window_timeout_ms:
                # Hold the window open for late arrivals; the admission
                # order is untouched (back at the head, in order). Counted
                # once per distinct window head, not per polling tick.
                self._queue.extendleft(reversed(batch))
                if self._held_head != batch[0].seq:
                    self._held_head = batch[0].seq
                    self.stats["held_windows"] += 1
                    rec = otrace.get_recorder()
                    if rec.enabled:
                        rec.add_instant(
                            "window_hold", cat="serve",
                            trace_id=batch[0].trace_id,
                            args={"head_seq": batch[0].seq,
                                  "size": len(batch)},
                        )
                return []
            self.stats["deadline_closes"] += 1
            rec = otrace.get_recorder()
            if rec.enabled:
                # The hold interval as a span: the head waited [arrival,
                # now] for a window that never filled.
                t1 = request_stamp()
                rec.add_span(
                    "window_hold", t1 - age_ms / 1e3, t1, cat="serve",
                    trace_id=batch[0].trace_id,
                    args={"head_seq": batch[0].seq, "deadline_close": True},
                )
        return batch

    def step(self, *, flush: bool = False) -> List[GNNTicket]:
        """One event-loop tick: admit a window, run its union, complete it.

        Returns the completed tickets (empty when the queue was idle, or a
        partial window is being held for its ``window_timeout_ms`` deadline;
        ``flush=True`` admits regardless — the drain/shutdown path). The
        union call is ``GNNServeEngine.infer_batch`` — plan assembly + one
        device call — so everything the synchronous engine guarantees
        (per-member Degree-Quant tags, plan/size-class caching, bitwise
        warm repeats) holds per micro-batch.

        Execution failure is **bounded** by ``window_retries``: the first
        N-1 failures requeue the window at the queue head (in order) and
        re-raise, so the driver observes a retryable fault; the Nth failure
        completes every ticket exceptionally (error attached, events set)
        and returns them — a poisoned window fails loudly instead of
        re-raising to the loop driver forever.
        """
        with self._drive_lock:
            batch = self._admit(flush=flush)
            if not batch:
                return []
            try:
                responses = self.engine.infer_batch([t.request for t in batch])
            except Exception as exc:
                self.stats["window_failures"] += 1
                for t in batch:
                    t.failures += 1
                if batch[0].failures >= self.window_retries:
                    # Retries exhausted: fail the window's tickets instead of
                    # wedging the queue. They complete (done == True) with
                    # the error attached; result() re-raises it.
                    for t in batch:
                        t._complete(error=exc)
                    self.stats["failed_tickets"] += len(batch)
                    return batch
                # Never strand admitted tickets: put the window back at the
                # queue head in order, so the failure propagates to whoever
                # is driving the loop while every request stays observable
                # and retryable.
                self._queue.extendleft(reversed(batch))
                raise
            self.stats["steps"] += 1
            for ticket, resp in zip(batch, responses):
                ticket._complete(response=resp)
            self.stats["completed"] += len(batch)
            return batch

    def drain(self) -> List[GNNResponse]:
        """Run the loop until the queue is empty; responses in admission
        order. Flushes held partial windows — drain is the shutdown path,
        so nothing waits out a deadline here. A ticket that exhausted its
        execution retries contributes ``None`` (its error is attached to
        the ticket itself); transient failures below the retry bound
        propagate as exceptions exactly like ``step``."""
        done: List[GNNTicket] = []
        while self._queue:
            done.extend(self.step(flush=True))
        return [t.response for t in sorted(done, key=lambda t: t.seq)]

    def serve(self, requests: Sequence[GNNRequest]) -> List[GNNResponse]:
        """Submit a request stream and drain it — the offered-load benchmark
        entry point. Unlike ``infer_batch`` this never builds one giant
        union: requests flow through ``window``-sized micro-batches."""
        for r in requests:
            self.submit(r.graph, r.features, arch=r.arch)
        return self.drain()

    # ------------------------------------------------------------- metrics
    def cache_info(self) -> Dict[str, int]:
        return {**self.engine.cache_info(), **self.stats}
