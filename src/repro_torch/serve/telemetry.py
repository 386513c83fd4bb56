"""Serving telemetry: streaming latency histograms + per-tenant rollups.

The multi-tenant front (``serve/tenancy``) needs latency *distributions*,
not averages — an SLO is a statement about p99, and a mean hides exactly the
tail the admission scheduler exists to protect. Keeping every sample would
grow without bound under production traffic, so latencies stream into a
**log-bucketed histogram**: geometric bucket edges give a fixed relative
error (``rel_error``, default 2.5%) at O(1) memory and O(log B) record cost,
the same trade HDR-histogram-style serving telemetry makes in LLM engines.

``TenantTelemetry`` is the per-tenant rollup the router feeds: two
histograms per tenant (end-to-end latency and admission→execution queue
wait), admission / rejection / preemption / failure counters, SLO
hit-or-violation accounting against the tenant's target, and throughput in
both requests/s and served nodes/s (node-throughput is the unit DWRR
fairness is measured in — a tenant of few huge graphs and a tenant of many
small ones can both hold their weight share). ``snapshot()`` exports the
whole thing as plain dicts for logs, benches and the launcher.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["StreamingHistogram", "TenantTelemetry"]


class StreamingHistogram:
    """Fixed-memory latency histogram with bounded relative quantile error.

    Bucket edges grow geometrically by ``1 + 2 * rel_error`` between ``low``
    and ``high`` (values clamp into the end buckets), so any quantile read
    back by linear interpolation inside its bucket is within ``rel_error``
    of the true sample quantile — verified against the numpy percentile
    oracle in ``tests/test_telemetry.py``. Exact min/max/sum/count ride
    along, and quantiles clamp into [min, max] so the extremes are exact.
    """

    def __init__(
        self,
        low: float = 1e-3,
        high: float = 1e6,
        rel_error: float = 0.025,
    ):
        if not (0 < low < high):
            raise ValueError("need 0 < low < high")
        if not (0 < rel_error < 1):
            raise ValueError("rel_error must be in (0, 1)")
        self.low = float(low)
        self.high = float(high)
        self.rel_error = float(rel_error)
        growth = 1.0 + 2.0 * rel_error
        n = int(math.ceil(math.log(high / low) / math.log(growth)))
        # edges[0]=low … edges[n]=high; bucket i covers [edges[i], edges[i+1])
        # plus one underflow bucket below low and one overflow above high.
        self._edges = low * np.power(growth, np.arange(n + 1))
        self._edges[-1] = high
        self._counts = np.zeros(n + 2, np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            raise ValueError("cannot record NaN")
        # searchsorted over the interior edges; 0 is the underflow bucket.
        self._counts[int(np.searchsorted(self._edges, v, side="right"))] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]), linearly interpolated.

        Matches ``np.percentile(samples, q, method="lower")``-style rank
        selection to within the histogram's relative error; returns 0.0
        when empty.
        """
        if not 0 <= q <= 100:
            raise ValueError("q must be in [0, 100]")
        if self.count == 0:
            return 0.0
        if q == 0:
            return self.min  # extremes are tracked exactly
        if q == 100:
            return self.max
        rank = q / 100.0 * (self.count - 1)
        target = math.floor(rank) + 1  # 1-based count of samples <= answer
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                # interpolate inside the bucket by rank position
                lo = self._edges[i - 1] if 0 < i <= len(self._edges) else self.min
                hi = (
                    self._edges[i]
                    if i < len(self._edges)
                    else self.max
                )
                frac = (target - cum) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


@dataclasses.dataclass
class _TenantStats:
    """One tenant's rollup (histograms + counters); see TenantTelemetry."""

    latency: StreamingHistogram
    queue_wait: StreamingHistogram
    submitted: int = 0
    rejected: int = 0  # rate-limit rejections at the admission door
    preempted: int = 0  # staged-window evictions by a higher priority class
    completed: int = 0
    failed: int = 0  # windows that exhausted their retries
    slo_hits: int = 0
    slo_violations: int = 0
    completed_nodes: int = 0
    first_event: float = 0.0  # perf_counter time of the first admission
    last_completion: float = 0.0


class TenantTelemetry:
    """Per-tenant serving telemetry the ``TenantRouter`` feeds.

    All record_* methods create the tenant's rollup on first touch, so the
    telemetry layer never needs the registry — it observes whatever tenant
    names flow through the router.
    """

    def __init__(self, rel_error: float = 0.025):
        from repro_torch.observe import metrics as ometrics

        self.rel_error = rel_error
        self._tenants: Dict[str, _TenantStats] = {}
        # Each tenant's histograms are *adopted* by the process-wide metrics
        # registry (one shared object, no second copy), so the Prometheus
        # dump carries per-tenant latency quantiles without the router doing
        # anything. The instance label keeps concurrent telemetry objects
        # (common in tests) from aliasing each other's tenants.
        self._registry = ometrics.get_registry()
        self.instance = ometrics.next_instance("tenant_telemetry")

    def _get(self, tenant: str) -> _TenantStats:
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = _TenantStats(
                latency=StreamingHistogram(rel_error=self.rel_error),
                queue_wait=StreamingHistogram(rel_error=self.rel_error),
            )
            self._tenants[tenant] = ts
            self._registry.register_histogram(
                "tenant_latency_ms", ts.latency,
                help="end-to-end latency per tenant",
                tenant=tenant, telemetry=self.instance,
            )
            self._registry.register_histogram(
                "tenant_queue_wait_ms", ts.queue_wait,
                help="admission->execution wait per tenant",
                tenant=tenant, telemetry=self.instance,
            )
        return ts

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._tenants

    # ------------------------------------------------------------- recording
    def record_submitted(self, tenant: str, *, now: Optional[float] = None) -> None:
        ts = self._get(tenant)
        ts.submitted += 1
        if ts.first_event == 0.0:
            # perf_counter: the serving stack's one lifecycle clock (see
            # serve.gnn_engine.request_stamp) — router-passed `now` stamps
            # and the default must come from the same clock.
            ts.first_event = time.perf_counter() if now is None else now

    def record_rejected(self, tenant: str) -> None:
        self._get(tenant).rejected += 1

    def record_preempted(self, tenant: str) -> None:
        self._get(tenant).preempted += 1

    def record_failure(self, tenant: str) -> None:
        self._get(tenant).failed += 1

    def record_completion(
        self,
        tenant: str,
        *,
        latency_ms: float,
        queue_ms: float = 0.0,
        nodes: int = 0,
        slo_ms: float = 0.0,
        now: Optional[float] = None,
    ) -> bool:
        """Record one served request; returns True iff it met its SLO
        (vacuously True when the tenant has no SLO target)."""
        ts = self._get(tenant)
        ts.latency.record(latency_ms)
        ts.queue_wait.record(queue_ms)
        ts.completed += 1
        ts.completed_nodes += nodes
        ts.last_completion = time.perf_counter() if now is None else now
        ok = slo_ms <= 0 or latency_ms <= slo_ms
        if slo_ms > 0:
            if ok:
                ts.slo_hits += 1
            else:
                ts.slo_violations += 1
        return ok

    # -------------------------------------------------------------- export
    def tenant_snapshot(
        self, tenant: str, *, queue_depth: int = 0
    ) -> Dict[str, object]:
        ts = self._get(tenant)
        elapsed = max(ts.last_completion - ts.first_event, 0.0)
        slo_total = ts.slo_hits + ts.slo_violations
        return {
            "submitted": ts.submitted,
            "completed": ts.completed,
            "rejected": ts.rejected,
            "preempted": ts.preempted,
            "failed": ts.failed,
            "queue_depth": queue_depth,
            "latency_ms": ts.latency.snapshot(),
            "queue_wait_ms": ts.queue_wait.snapshot(),
            "slo_hits": ts.slo_hits,
            "slo_violations": ts.slo_violations,
            "slo_hit_rate": (ts.slo_hits / slo_total) if slo_total else 1.0,
            "throughput_rps": (ts.completed / elapsed) if elapsed > 0 else 0.0,
            "node_throughput": (
                ts.completed_nodes / elapsed if elapsed > 0 else 0.0
            ),
            "completed_nodes": ts.completed_nodes,
        }

    def snapshot(
        self, queue_depths: Optional[Dict[str, int]] = None
    ) -> Dict[str, Dict[str, object]]:
        """Per-tenant rollups as plain dicts (p50/p90/p99, counters, rates).

        ``queue_depths`` lets the router stamp its live per-tenant queue
        depth into the export; tenants present there but never recorded
        still appear (all-zero), so an idle tenant is visible, not absent.
        """
        depths = queue_depths or {}
        for t in depths:
            self._get(t)
        return {
            t: self.tenant_snapshot(t, queue_depth=depths.get(t, 0))
            for t in sorted(self._tenants)
        }
