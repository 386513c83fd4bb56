"""Multi-tenant serving front: DWRR admission over per-tenant queues.

``AsyncGNNEngine`` gave the serving stack continuous batching, but its
admission is one strict-FIFO queue — every caller is the same caller, so a
batch backfill flooding the queue adds its whole backlog to an interactive
request's latency. ``TenantRouter`` is the front door that fixes that,
modeled on the engine/scheduler split of LLM serving engines:

  * **per-tenant queues** — ``submit(tenant, graph, features)`` goes through
    the tenant's token bucket (admission control: over-rate requests are
    rejected at the door, never queued) into that tenant's own FIFO queue;
  * **deficit-weighted round robin** — each micro-batch window is filled by
    DWRR over the backlogged tenants: every service round grants each tenant
    ``quantum x weight`` node-credits, and a tenant admits queue-head
    requests while its credit covers their node cost. Under contention every
    tenant's admitted node-volume converges to its weight share — a flood of
    small graphs and a trickle of huge ones are both held to the same
    currency (nodes, the unit of engine work);
  * **priority classes** — higher classes fill first within every round
    (latency ordering, at equal long-run weight share: credits, not class,
    bound each tenant's volume — so a saturating high class cannot starve
    best-effort, it can only get ahead of it in line), and a high-class
    arrival that finds the staged window full may **preempt** strictly
    lower-class members back to their queue heads before the window runs;
  * **telemetry** — every completion lands in ``serve.telemetry``: per-tenant
    streaming p50/p99 end-to-end latency and queue-wait histograms, queue
    depth, throughput (requests/s and nodes/s), and admission / rejection /
    preemption / failure counters.

Routing changes *when* a request executes and *who* shares its window —
never the numbers: an executed window flows through the same
``AsyncGNNEngine.step`` -> ``GNNServeEngine.infer_batch`` path as direct
serving, so routed outputs are bitwise-identical to driving the engine
directly with the same window compositions (``window_log`` records them).

The port of the reference's ``repro/serve/tenancy/router.py`` over the port's
``AsyncGNNEngine``.

Over a mesh (an engine with ``mesh``, every rank submitting the same requests
in the same order) the tenant scheduling runs on rank 0 alone: its token
buckets, preemption, DWRR fill and hold decide each window, and rank 0
broadcasts the window (each request's submission index and router seq, in
order) and the submissions it rejected since the last window before any rank
runs it. A follower admits every submission into one pending map, takes the
window's requests from it (waiting for late ones as the engine's followers
do; past that the window fails on every rank), and learns
of a rejection at the next window: that ticket completes with
``RateLimitExceeded``. Every rank's ``window_log`` is rank 0's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs.csr import Graph
from repro_torch.observe import metrics as ometrics
from repro_torch.observe import trace as otrace
from repro_torch.serve.async_gnn import AsyncGNNEngine, GNNTicket, failed_ticket
from repro_torch.serve.gnn_engine import GNNResponse, GNNServeEngine, request_stamp
from repro_torch.serve.telemetry import TenantTelemetry
from repro_torch.serve.tenancy.registry import TenantRegistry, TenantSpec, TokenBucket

__all__ = ["RateLimitExceeded", "RoutedTicket", "TenantRouter"]


class RateLimitExceeded(RuntimeError):
    """A tenant's token bucket is empty: the request was rejected, not queued."""

    def __init__(self, tenant: str):
        super().__init__(
            f"tenant {tenant!r} is over its rate limit; request rejected at "
            "admission"
        )
        self.tenant = tenant


@dataclasses.dataclass
class RoutedTicket:
    """One routed request's handle: queued -> staged -> executing -> done."""

    seq: int  # router-wide admission order
    tenant: str
    graph: Graph
    features: object  # validated f32[N, D]
    arch: str
    arrival: float  # request_stamp() at router admission
    preemptions: int = 0  # times bumped out of a staged window by a higher class
    trace_id: str = ""  # per-request correlation id (observe.trace)
    key: int = -1  # on a mesh: the index of its submit call on this rank
    _router: Optional["TenantRouter"] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _ticket: Optional[GNNTicket] = dataclasses.field(
        default=None, repr=False, compare=False
    )  # engine-side ticket, set when the window is handed to the engine

    @property
    def done(self) -> bool:
        return self._ticket is not None and self._ticket.done

    @property
    def response(self) -> Optional[GNNResponse]:
        return self._ticket.response if self._ticket is not None else None

    @property
    def error(self) -> Optional[BaseException]:
        return self._ticket.error if self._ticket is not None else None

    def result(self, timeout: Optional[float] = None) -> GNNResponse:
        """The response; drives the router's loop until this completes.

        Mirrors ``GNNTicket.result``: a held partial window is waited out
        (bounded by its ``hold_ms`` deadline) and re-stepped; ``timeout``
        bounds the total wait; a ticket whose window exhausted execution
        retries re-raises the attached error.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self.done:
            if self._router is None:
                raise RuntimeError(
                    f"routed ticket {self.seq} is pending but has no router"
                )
            if self._router.step():
                continue
            if self.done:
                break
            wait = self._router._hold_wait()
            if wait is None:
                raise RuntimeError(
                    f"routed ticket {self.seq} is pending but its router has "
                    "no admissible work"
                )
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        f"routed ticket {self.seq} still pending after "
                        f"{timeout}s"
                    )
                wait = min(wait, remaining)
            if wait > 0:
                time.sleep(wait)
        if self.error is not None:
            raise self.error
        return self.response


class TenantRouter:
    """DWRR admission front over an ``AsyncGNNEngine``.

    Parameters
    ----------
    engine: an ``AsyncGNNEngine``, or anything its constructor accepts (a
        ``GNNServeEngine`` or a ``family="gnn"`` ModelConfig, with
        ``params``/``engine_kwargs``/``window``/``max_batch_nodes``
        forwarded). The router owns the engine's queue: submit requests
        through the router only.
    registry: the ``TenantRegistry``; defaults to a fresh one (populate with
        ``add_tenant``). Submitting under an unregistered name raises.
    hold_ms: router-level latency-aware window close, the analogue of the
        engine's ``window_timeout_ms`` (which the router bypasses — it
        always flushes exactly the window it composed): a *partial* staged
        window is held open for late arrivals until its oldest member has
        waited this long. 0 executes whatever is staged on every step.
    quantum_nodes: DWRR credit granted per service round is
        ``quantum_nodes x weight``. 0 (default) adapts the quantum each
        round to the largest backlogged queue-head cost, the classic choice
        that guarantees at least one admission per round for every tenant
        whose turn comes with credit banked.
    telemetry: a ``TenantTelemetry`` to record into (default: fresh).
    window_log_size: how many executed window compositions to keep in
        ``window_log`` (each entry is a tuple of (tenant, seq) pairs) — the
        replay record for bitwise parity checks against direct serving.

    On a mesh engine rank 0 schedules and the other ranks follow (the
    module's last paragraph); a follower's ``submit`` never raises
    ``RateLimitExceeded`` and its ticket's ``seq`` is rank 0's once the
    request is in a window.
    """

    def __init__(
        self,
        engine,
        params=None,
        *,
        registry: Optional[TenantRegistry] = None,
        window: Optional[int] = None,
        max_batch_nodes: Optional[int] = None,
        hold_ms: float = 0.0,
        quantum_nodes: int = 0,
        telemetry: Optional[TenantTelemetry] = None,
        window_log_size: int = 256,
        **engine_kwargs,
    ):
        if isinstance(engine, AsyncGNNEngine):
            if params is not None or engine_kwargs:
                raise ValueError(
                    "pass params/engine kwargs only when constructing from a "
                    "config, not when wrapping an existing AsyncGNNEngine"
                )
            if window is not None or max_batch_nodes is not None:
                raise ValueError(
                    "window/max_batch_nodes come from the wrapped engine"
                )
            self.engine = engine
        else:
            # The router owns window composition; the engine must admit each
            # staged window in one flushed step, so its own hold is disabled.
            self.engine = AsyncGNNEngine(
                engine,
                params,
                window=window,
                max_batch_nodes=max_batch_nodes,
                window_timeout_ms=0.0,
                **engine_kwargs,
            )
        if hold_ms < 0:
            raise ValueError("hold_ms must be >= 0")
        if quantum_nodes < 0:
            raise ValueError("quantum_nodes must be >= 0")
        self.window = self.engine.window
        self.max_batch_nodes = self.engine.max_batch_nodes
        self.hold_ms = float(hold_ms)
        self.quantum_nodes = int(quantum_nodes)
        self.registry = registry if registry is not None else TenantRegistry()
        self.telemetry = telemetry if telemetry is not None else TenantTelemetry()
        self._queues: Dict[str, Deque[RoutedTicket]] = {}
        self._deficit: Dict[str, float] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._rr: Dict[int, int] = {}  # per-priority-class rotation offset
        self._staged: List[RoutedTicket] = []
        self._staged_nodes = 0
        self._inflight: List[RoutedTicket] = []  # handed to the engine
        self._held_head: Optional[int] = None
        self._seq = 0
        self._mesh = self.engine._mesh  # rank 0's decisions, on the engine's group
        self._keys = 0  # submit calls on a mesh, rejected ones too
        self._rejected: List[Tuple[int, str]] = []  # rank 0: (key, tenant) since the last window
        self._follow: Dict[int, RoutedTicket] = {}  # a follower's submissions by key
        self._mesh_failed: Dict[int, BaseException] = {}  # key -> error, not yet arrived
        self._mesh_more = False
        self.window_log: Deque[Tuple[Tuple[str, int], ...]] = deque(
            maxlen=window_log_size
        )
        # Registry-backed counters behind the historical dict API; see
        # GNNServeEngine.stats for the rationale.
        self.instance = ometrics.next_instance("gnn_router")
        self.stats: ometrics.StatsView = ometrics.StatsView(
            ometrics.get_registry(),
            "gnn_router",
            {"router": self.instance},
            keys=(
                "submitted",
                "completed",
                "rejected",  # token-bucket rejections at the door
                "preempted",  # staged members bumped by a higher class
                "windows",  # executed window count
                "held_windows",
                "deadline_closes",
                "failed",  # tickets whose window exhausted execution retries
            ),
        )

    # --------------------------------------------------------------- tenants
    def add_tenant(self, name: str, **kwargs) -> TenantSpec:
        """Register a tenant (convenience passthrough to the registry)."""
        return self.registry.add(name, **kwargs)

    def _queue(self, tenant: str) -> Deque[RoutedTicket]:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
        return q

    def _bucket(self, spec: TenantSpec) -> TokenBucket:
        b = self._buckets.get(spec.name)
        if b is None:
            b = self._buckets[spec.name] = spec.make_bucket()
        return b

    # ------------------------------------------------------------- admission
    def submit(
        self, tenant: str, graph: Graph, features, *, arch: str = ""
    ) -> RoutedTicket:
        """Admit one request under a tenant; returns its ticket immediately.

        Admission control happens at the door: an unknown tenant or invalid
        request raises, an over-rate one raises ``RateLimitExceeded`` (and
        is counted as rejected — rejected requests consume no queue space
        and no engine work). A high-priority admission may preempt
        strictly-lower-class members out of a full staged window.
        """
        spec = self.registry.get(tenant)
        rec = otrace.get_recorder()
        key = self._keys
        if self._mesh is not None:
            self._keys += 1
            if not self._mesh.leader:
                return self._follower_submit(key, tenant, graph, features, arch)
        if not self._bucket(spec).try_acquire():
            if self._mesh is not None:
                self._rejected.append((key, tenant))
            self.stats["rejected"] += 1
            self.telemetry.record_rejected(tenant)
            if rec.enabled:
                rec.add_instant("reject", cat="tenancy",
                                args={"tenant": tenant})
            raise RateLimitExceeded(tenant)
        serve_engine = self.engine.engine
        arch = serve_engine._arch(arch)
        features = serve_engine._validate_request(graph, features)
        trace_id = otrace.new_trace_id() if rec.enabled else ""
        ticket = RoutedTicket(
            seq=self._seq,
            tenant=tenant,
            graph=graph,
            features=features,
            arch=arch,
            arrival=request_stamp(),
            trace_id=trace_id,
            key=key,
            _router=self,
        )
        if rec.enabled:
            rec.add_instant(
                "admit", t=ticket.arrival, cat="tenancy", trace_id=trace_id,
                args={"tenant": tenant, "seq": ticket.seq,
                      "nodes": graph.num_nodes},
            )
        self._seq += 1
        self._queue(tenant).append(ticket)
        self.stats["submitted"] += 1
        self.telemetry.record_submitted(tenant, now=ticket.arrival)
        self._maybe_preempt(spec)
        return ticket

    def _follower_submit(self, key, tenant, graph, features, arch) -> RoutedTicket:
        """A follower's submit: validated and held by ``key`` until rank 0
        names it in a window (or fails it)."""
        serve_engine = self.engine.engine
        ticket = RoutedTicket(
            seq=-1, tenant=tenant, graph=graph, arch=serve_engine._arch(arch),
            features=serve_engine._validate_request(graph, features),
            arrival=request_stamp(), key=key, _router=self,
        )
        with self._mesh.arrived:
            error = self._mesh_failed.pop(key, None)
            if error is None:
                self._follow[key] = ticket
                self._mesh.arrived.notify_all()
        if error is not None:
            self._fail(ticket, error)
        return ticket

    def _admitted(self, rt: RoutedTicket) -> None:
        """A follower counts a submission once rank 0 admitted it, so its
        counters are rank 0's."""
        self.stats["submitted"] += 1
        self.telemetry.record_submitted(rt.tenant, now=rt.arrival)

    def _fail(self, rt: RoutedTicket, error: BaseException) -> None:
        """Complete a follower's ``rt`` with ``error``: rejected by rank 0,
        or in a window some rank lacked requests of."""
        rt._ticket = failed_ticket(error)
        if isinstance(error, RateLimitExceeded):
            self.stats["rejected"] += 1
            self.telemetry.record_rejected(rt.tenant)
        else:
            self._admitted(rt)
            self._on_complete(rt)

    @property
    def pending(self) -> int:
        queued = sum(len(q) for q in self._queues.values()) + len(self._follow)
        return queued + len(self._staged) + len(self._inflight)

    def queue_depths(self) -> Dict[str, int]:
        """Live queued+staged depth per tenant (executing windows excluded)."""
        depths = {t: len(q) for t, q in self._queues.items()}
        for rt in self._staged:
            depths[rt.tenant] = depths.get(rt.tenant, 0) + 1
        return depths

    # ------------------------------------------------------------ preemption
    def _room_for(self, nodes: int, *, exclude: Sequence[RoutedTicket] = ()) -> bool:
        """Would the staged window (minus ``exclude``) admit one more request
        of this node cost, under the same rules as engine admission (an
        oversized request riding an otherwise empty window is admitted)?"""
        slots = len(self._staged) - len(exclude)
        if slots >= self.window:
            return False
        if slots == 0 or self.max_batch_nodes is None:
            return True
        staged_nodes = self._staged_nodes - sum(
            rt.graph.num_nodes for rt in exclude
        )
        return staged_nodes + nodes <= self.max_batch_nodes

    def _maybe_preempt(self, spec: TenantSpec) -> None:
        """Bump strictly-lower-class members out of a full staged window.

        Only a *staged* (held, not yet executing) window is preemptible —
        an executing window is never interrupted. Victims leave largest
        first within the lowest class, go back to their own queue heads in
        original order, and keep their arrival stamps (their queue wait
        honestly includes the preemption). No room even after evicting
        every lower-class member means no preemption happens at all.
        """
        if not self._staged:
            return
        q = self._queues.get(spec.name)
        if not q:
            return
        head = q[0]
        n = head.graph.num_nodes
        if self._room_for(n):
            return  # the next fill tops the held window up; nothing to bump
        victims = [
            rt
            for rt in self._staged
            if self.registry.get(rt.tenant).priority < spec.priority
        ]
        if not victims:
            return
        victims.sort(
            key=lambda rt: (
                self.registry.get(rt.tenant).priority,
                -rt.graph.num_nodes,
            )
        )
        evicted: List[RoutedTicket] = []
        for v in victims:
            if self._room_for(n, exclude=evicted):
                break
            evicted.append(v)
        if not self._room_for(n, exclude=evicted):
            return  # even a clean sweep of lower classes can't make room
        # Requeue evicted members at their queue heads, preserving their
        # original staged order (reverse iteration + appendleft).
        rec = otrace.get_recorder()
        for v in sorted(evicted, key=lambda rt: self._staged.index(rt), reverse=True):
            self._staged.remove(v)
            self._staged_nodes -= v.graph.num_nodes
            v.preemptions += 1
            self._queues[v.tenant].appendleft(v)
            self.stats["preempted"] += 1
            self.telemetry.record_preempted(v.tenant)
            if rec.enabled:
                rec.add_instant(
                    "preempt", cat="tenancy", trace_id=v.trace_id,
                    args={"tenant": v.tenant, "by": spec.name},
                )
        q.popleft()
        self._staged.append(head)
        self._staged_nodes += n

    # ------------------------------------------------------- DWRR window fill
    def _backlogged(self) -> List[str]:
        return [t for t, q in self._queues.items() if q]

    def _fill_staged(self) -> None:
        """Fill the staged window by deficit-weighted round robin.

        Every round: each backlogged tenant — higher priority classes first,
        rotating the start position within a class — banks ``quantum x
        weight`` node-credits (clamped so idle banking can't turn into an
        unbounded burst: at most its queue-head cost plus one round's
        grant), then admits queue-head requests while the credit covers
        their cost and the window has room. Deficits persist while a tenant
        stays backlogged (an oversized head accumulates credit across
        rounds and windows until it fits) and reset when its queue empties.
        A round with no admissions closes the window — unless it is still
        empty, in which case the highest-priority, largest-credit head is
        force-admitted (charging its full cost, going into debt that later
        rounds repay) so an oversized straggler rides alone rather than
        stalling the queue.
        """
        while len(self._staged) < self.window:
            backlogged = self._backlogged()
            if not backlogged:
                break
            quantum = self.quantum_nodes or max(
                self._queues[t][0].graph.num_nodes for t in backlogged
            )
            progressed = False
            by_prio: Dict[int, List[str]] = {}
            for t in backlogged:
                by_prio.setdefault(self.registry.get(t).priority, []).append(t)
            for prio in sorted(by_prio, reverse=True):
                tenants = sorted(by_prio[prio])
                off = self._rr.get(prio, 0)
                self._rr[prio] = off + 1
                for i in range(len(tenants)):
                    t = tenants[(off + i) % len(tenants)]
                    q = self._queues[t]
                    if not q:
                        continue
                    w = self.registry.get(t).weight
                    grant = quantum * w
                    head_cost = q[0].graph.num_nodes
                    self._deficit[t] = min(
                        self._deficit.get(t, 0.0) + grant, head_cost + grant
                    )
                    while (
                        q
                        and len(self._staged) < self.window
                        and q[0].graph.num_nodes <= self._deficit[t]
                        and self._room_for(q[0].graph.num_nodes)
                    ):
                        rt = q.popleft()
                        self._staged.append(rt)
                        self._staged_nodes += rt.graph.num_nodes
                        self._deficit[t] -= rt.graph.num_nodes
                        progressed = True
                    if not q:
                        self._deficit[t] = 0.0  # no banking while idle
                    if len(self._staged) >= self.window:
                        break
                if len(self._staged) >= self.window:
                    break
            if not progressed:
                if self._staged:
                    break  # budget/credit closed a non-empty window
                # Empty window, backlog present: force the best head through
                # (highest class, then largest banked credit) so an
                # oversized straggler rides alone instead of wedging.
                t = max(
                    self._backlogged(),
                    key=lambda t: (
                        self.registry.get(t).priority,
                        self._deficit.get(t, 0.0),
                        -self._queues[t][0].seq,
                    ),
                )
                rt = self._queues[t].popleft()
                self._staged.append(rt)
                self._staged_nodes += rt.graph.num_nodes
                self._deficit[t] = self._deficit.get(t, 0.0) - rt.graph.num_nodes
                if not self._queues[t]:
                    self._deficit[t] = 0.0

    # ------------------------------------------------------------ event loop
    def _budget_full(self) -> bool:
        return (
            self.max_batch_nodes is not None
            and self._staged_nodes >= self.max_batch_nodes
        )

    def _hold_wait(self) -> Optional[float]:
        """Seconds until the staged window's hold deadline; None when no
        hold applies (no hold configured, nothing staged or queued). On a
        mesh a follower steps again at once: its step waits for rank 0's."""
        if self._mesh is not None and not self._mesh.leader:
            return 0.0
        if self.hold_ms <= 0:
            return None
        oldest = None
        if self._staged:
            oldest = min(rt.arrival for rt in self._staged)
        else:
            heads = [q[0].arrival for q in self._queues.values() if q]
            if heads:
                oldest = min(heads)
        if oldest is None:
            return None
        return max(self.hold_ms / 1e3 - (request_stamp() - oldest), 0.0)

    def step(self, *, flush: bool = False) -> List[RoutedTicket]:
        """One router tick: fill a window by DWRR, execute it, complete it.

        Returns the completed routed tickets (empty when idle or when a
        partial window is held for its ``hold_ms`` deadline; ``flush=True``
        executes regardless). A window that failed execution below the
        engine's retry bound stays in flight — the error propagates, and the
        next step retries it before composing anything new.
        """
        if self._inflight:
            return self._run_engine()  # retry the failed window first
        if self._mesh is None:
            staged = self._compose(flush)
        else:
            staged, failed = self._mesh_compose(flush)
            if failed:
                return staged
        if not staged:
            return []
        self.window_log.append(tuple((rt.tenant, rt.seq) for rt in staged))
        for rt in staged:
            rt._ticket = self.engine.submit(
                rt.graph, rt.features, arch=rt.arch, arrival=rt.arrival,
                trace_id=rt.trace_id,
            )
        self._inflight = staged
        return self._run_engine()

    def _compose(self, flush: bool) -> List[RoutedTicket]:
        """The next window by DWRR (emptied from ``_staged``), or nothing
        when idle or when a partial window is held."""
        rec = otrace.get_recorder()
        fill_t0 = time.perf_counter()
        self._fill_staged()
        if rec.enabled and self._staged:
            rec.add_span(
                "dwrr_fill", fill_t0, time.perf_counter(), cat="tenancy",
                trace_id=self._staged[0].trace_id,
                args={"staged": len(self._staged),
                      "nodes": self._staged_nodes},
            )
        if not self._staged:
            return []
        partial = (
            len(self._staged) < self.window
            and not self._backlogged()
            and not self._budget_full()
        )
        if partial and not flush and self.hold_ms > 0:
            oldest = min(rt.arrival for rt in self._staged)
            if (request_stamp() - oldest) * 1e3 < self.hold_ms:
                if self._held_head != self._staged[0].seq:
                    self._held_head = self._staged[0].seq
                    self.stats["held_windows"] += 1
                    if rec.enabled:
                        rec.add_instant(
                            "window_hold", cat="tenancy",
                            trace_id=self._staged[0].trace_id,
                            args={"head_seq": self._staged[0].seq,
                                  "size": len(self._staged)},
                        )
                return []
            self.stats["deadline_closes"] += 1
            if rec.enabled:
                t1 = request_stamp()
                rec.add_span(
                    "window_hold", oldest, t1, cat="tenancy",
                    trace_id=self._staged[0].trace_id,
                    args={"head_seq": self._staged[0].seq,
                          "deadline_close": True},
                )
        staged, self._staged, self._staged_nodes = self._staged, [], 0
        return staged

    def _mesh_compose(self, flush: bool) -> Tuple[List[RoutedTicket], bool]:
        """(the window rank 0 composed, failed): rank 0 composes and
        broadcasts the window's (key, seq) pairs with the submissions it
        rejected; a follower fails those, takes the window's requests from
        its pending map (waiting for late ones) and gives them rank 0's
        seqs. A window some rank lacks requests of fails on every rank."""
        m = self._mesh
        if m.leader:
            staged = self._compose(flush)
            msg = m.share(dict(window=[(rt.key, rt.seq) for rt in staged],
                               rejected=self._rejected,
                               more=bool(self._staged or self._backlogged())))
            self._rejected, missing = [], []
        else:
            msg = m.share(None)
            for key, tenant in msg["rejected"]:
                with m.arrived:
                    rt = self._follow.pop(key, None)
                    if rt is None:
                        self._mesh_failed[key] = RateLimitExceeded(tenant)
                if rt is not None:
                    self._fail(rt, RateLimitExceeded(tenant))
            keys = [k for k, _ in msg["window"]]
            staged, missing = m.collect(keys, lambda: self._follow)
            with m.arrived:
                for rt in staged:
                    del self._follow[rt.key]
            seqs = dict(msg["window"])
            for rt in staged:
                rt.seq = seqs[rt.key]
                self._admitted(rt)
        self._mesh_more = msg["more"]
        if not msg["window"] or m.agree(not missing):
            return staged, False
        keys = [k for k, _ in msg["window"]]
        error = m.missing_error(keys, missing)
        with m.arrived:
            self._mesh_failed.update((k, error) for k in missing)
        for rt in staged:
            rt._ticket = failed_ticket(error)
            self._on_complete(rt)
        return staged, True

    def _run_engine(self) -> List[RoutedTicket]:
        """Drive the engine through the in-flight window; complete tickets.

        Transient execution failures (below the engine's retry bound)
        propagate after the engine requeued the window internally — the
        tickets stay in flight and the next call retries them. Tickets the
        engine failed permanently complete exceptionally here.
        """
        self.engine.step(flush=True)  # raises on transient failure
        done: List[RoutedTicket] = []
        still: List[RoutedTicket] = []
        for rt in self._inflight:
            (done if rt.done else still).append(rt)
        self._inflight = still
        if done and not still:
            self.stats["windows"] += 1
        for rt in done:
            self._on_complete(rt)
        return done

    def _on_complete(self, rt: RoutedTicket) -> None:
        spec = self.registry.get(rt.tenant)
        if rt.error is not None:
            self.stats["failed"] += 1
            self.telemetry.record_failure(rt.tenant)
            return
        resp = rt.response
        latency_ms = (request_stamp() - rt.arrival) * 1e3
        self.stats["completed"] += 1
        self.telemetry.record_completion(
            rt.tenant,
            latency_ms=latency_ms,
            queue_ms=resp.queue_ms,
            nodes=rt.graph.num_nodes,
            slo_ms=spec.slo_ms,
        )

    def drain(self) -> List[RoutedTicket]:
        """Run the loop until nothing is queued, staged or in flight;
        tickets back in router admission order. Flushes held windows."""
        done: List[RoutedTicket] = []
        if self._mesh is None:
            while self.pending:
                done.extend(self.step(flush=True))
        else:  # every rank steps until rank 0 has nothing left
            done.extend(self.step(flush=True))
            while self._inflight or self._mesh_more:
                done.extend(self.step(flush=True))
        return sorted(done, key=lambda rt: rt.seq)

    def serve(
        self, requests: Sequence[Tuple[str, Graph, object]]
    ) -> List[RoutedTicket]:
        """Submit a (tenant, graph, features) stream and drain it — the
        offered-load entry point. Rate-limited submissions raise; catch
        ``RateLimitExceeded`` upstream to shed load instead."""
        for tenant, graph, features in requests:
            self.submit(tenant, graph, features)
        return self.drain()

    # -------------------------------------------------------------- metrics
    def snapshot(self) -> Dict[str, object]:
        """Router counters + per-tenant telemetry + engine cache economics."""
        return {
            **self.stats,
            "pending": self.pending,
            "tenants": self.telemetry.snapshot(self.queue_depths()),
            "engine": self.engine.cache_info(),
        }
