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

Over a mesh (an engine with ``mesh``: one process a shard, every rank
submitting the same requests in the same order) **rank 0 decides** every
window: its ``_admit`` picks the requests, their order, and flush or hold,
and it broadcasts the window's request ids over the mesh's group before any
rank runs it (``_MeshWindows``). The other ranks follow: they never close a
window on their own clock. A follower that has not yet seen a request rank 0
admitted waits for it up to the window timeout (``FOLLOWER_WAIT_MS`` when
windows close at once); past that the window fails
on every rank (its tickets complete with the error, and a request that
arrives later completes with it at once). Whether a window ran and whether a
failed one is requeued or failed is agreed by an all-reduce, so every rank
takes the same decision and their collectives pair the same windows.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

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

__all__ = ["GNNTicket", "AsyncGNNEngine", "FOLLOWER_WAIT_MS", "failed_ticket"]

#: how long a follower waits for a request of rank 0's window when windows
#: close at once (``window_timeout_ms`` 0); otherwise it waits the timeout
FOLLOWER_WAIT_MS = 1000.0


class _MeshWindows:
    """Rank 0's window decisions over a mesh's ``("shard",)`` group.

    ``share`` broadcasts rank 0's message (the window's request ids in
    order, and what the front adds) to every rank; ``collect`` waits on a
    follower for the requests it has not seen yet, up to ``wait_s``;
    ``agree`` is true on every rank only when it is true on all of them.
    Requests arrive under ``arrived`` (a condition: submit notifies it)."""

    def __init__(self, mesh, wait_ms: float):
        self.group = mesh.get_group("shard")
        self.leader = mesh.get_local_rank("shard") == 0
        self.src = torch.distributed.get_global_rank(self.group, 0)
        self.wait_s = wait_ms / 1e3
        self.arrived = threading.Condition()

    def share(self, msg):
        box = [msg]
        torch.distributed.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def agree(self, ok: bool) -> bool:
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def collect(self, ids: Sequence[int], pending: Callable[[], Dict[int, object]]
                ) -> Tuple[List[object], List[int]]:
        """(the requests of ``ids`` this rank holds, in order; the ids it
        still lacks after ``wait_s``). ``pending()`` maps id -> request and
        is read under ``arrived``; the caller removes what it takes."""
        deadline = time.monotonic() + self.wait_s
        with self.arrived:
            while True:
                have = pending()
                missing = [i for i in ids if i not in have]
                left = deadline - time.monotonic()
                if not missing or left <= 0:
                    return [have[i] for i in ids if i in have], missing
                self.arrived.wait(left)

    def missing_error(self, ids, missing) -> BaseException:
        """The error of a window some rank lacked requests of."""
        if missing:
            return TimeoutError(
                f"requests {missing} of rank 0's window {list(ids)} did not reach this rank "
                f"within {self.wait_s * 1e3:.0f} ms")
        return RuntimeError(f"another rank lacked requests of rank 0's window {list(ids)}")


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


def failed_ticket(error: BaseException) -> GNNTicket:
    """A ticket that completed with ``error`` and ran nothing."""
    ticket = GNNTicket(seq=-1, request=None)
    ticket._complete(error=error)
    return ticket


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

    On a mesh engine every rank builds this front and submits the same
    requests in the same order; rank 0 decides the windows (the module's
    last paragraph). A follower waits ``window_timeout_ms`` (or
    ``FOLLOWER_WAIT_MS`` when windows close at once) for a request of rank
    0's window before the window fails. ``drain`` runs until rank 0's queue
    is empty, on every rank.
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
        self._mesh = (None if self.engine.mesh is None else _MeshWindows(
            self.engine.mesh, self.window_timeout_ms or FOLLOWER_WAIT_MS))
        self._mesh_more = False  # rank 0's queue held more after the last window
        self._mesh_failed: Dict[int, BaseException] = {}  # seq -> error, not yet arrived
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
        if self._mesh is None:
            self._seq += 1
            self._queue.append(ticket)
        else:
            with self._mesh.arrived:  # followers read the queue in another thread
                ticket.seq = self._seq
                self._seq += 1
                error = self._mesh_failed.pop(ticket.seq, None)
                if error is None:
                    self._queue.append(ticket)
                    self._mesh.arrived.notify_all()
            if error is not None:  # its window failed before it arrived
                ticket._complete(error=error)
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
        timeout applies (idle queue, or no timeout configured). On a mesh a
        follower steps again at once: its step waits for rank 0's."""
        if self._mesh is not None and not self._mesh.leader:
            return 0.0
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
            if self._mesh is None:
                batch = self._admit(flush=flush)
            else:
                batch, failed = self._mesh_admit(flush)
                if failed:
                    return batch
            if not batch:
                return []
            exc = None
            try:
                responses = self.engine.infer_batch([t.request for t in batch])
            except Exception as e:
                exc = e
            if self._mesh is not None and not self._mesh.agree(exc is None) and exc is None:
                exc = RuntimeError(f"window {[t.seq for t in batch]} failed on another rank")
            if exc is not None:
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
                raise exc
            self.stats["steps"] += 1
            for ticket, resp in zip(batch, responses):
                ticket._complete(response=resp)
            self.stats["completed"] += len(batch)
            return batch

    def _mesh_admit(self, flush: bool) -> Tuple[List[GNNTicket], bool]:
        """(the window rank 0 admitted, failed): rank 0 runs ``_admit`` and
        broadcasts the window's seqs; a follower takes them from its queue,
        waiting for late ones. A window some rank lacks requests of fails on
        every rank (its tickets complete with the error)."""
        m = self._mesh
        if m.leader:
            batch = self._admit(flush=flush)
            seqs, self._mesh_more = m.share(([t.seq for t in batch], bool(self._queue)))
            missing = []
        else:
            seqs, self._mesh_more = m.share(None)
            batch, missing = m.collect(seqs, lambda: {t.seq: t for t in self._queue})
            with m.arrived:
                for t in batch:
                    self._queue.remove(t)
        if not seqs or m.agree(not missing):
            return batch, False
        error = m.missing_error(seqs, missing)
        with m.arrived:
            self._mesh_failed.update((s, error) for s in missing)
        self.stats["window_failures"] += 1
        for t in batch:
            t.failures += 1
            t._complete(error=error)
        self.stats["failed_tickets"] += len(seqs)
        return batch, True

    def drain(self) -> List[GNNResponse]:
        """Run the loop until the queue is empty; responses in admission
        order. Flushes held partial windows — drain is the shutdown path,
        so nothing waits out a deadline here. A ticket that exhausted its
        execution retries contributes ``None`` (its error is attached to
        the ticket itself); transient failures below the retry bound
        propagate as exceptions exactly like ``step``."""
        done: List[GNNTicket] = []
        if self._mesh is None:
            while self._queue:
                done.extend(self.step(flush=True))
        else:  # every rank steps until rank 0's queue is empty
            done.extend(self.step(flush=True))
            while self._mesh_more:
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
