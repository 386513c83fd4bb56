"""Tenant registry: who may submit, how fast, at what priority, to what SLO.

A **tenant** is a traffic class with an identity: an interactive product
surface, a batch backfill job, a free-tier API key. The registry holds one
``TenantSpec`` per tenant — DWRR weight (capacity share under contention),
priority class (who goes first when both are backlogged, and who may preempt
whom out of a staged window), a token-bucket rate limit (admission control at
the door), and an SLO target the telemetry scores end-to-end latency against.

Specs are frozen; runtime state (token buckets, deficit counters, queues)
lives in the router so one registry can front many routers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterator, Optional

__all__ = ["TokenBucket", "TenantSpec", "TenantRegistry", "UnknownTenant"]


class UnknownTenant(KeyError):
    """Raised when a request names a tenant the registry has never seen."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_acquire`` is O(1) and lazy — tokens accrue on read, no timer
    thread. A zero rate disables limiting (always admits). ``now`` is
    injectable for deterministic tests.
    """

    def __init__(self, rate: float, burst: float):
        if rate < 0 or burst < 0:
            raise ValueError("rate and burst must be >= 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        # Clock origin is set by the first acquire, so an injected test
        # clock is fully deterministic (never mixed with time.monotonic()).
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elif now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now

    def try_acquire(self, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True
        t = time.monotonic() if now is None else now
        self._refill(t)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens if self.rate > 0 else math.inf


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract with the serving front.

    weight: DWRR share under contention; a weight-4 tenant is granted 4x the
        admitted node-volume of a weight-1 tenant while both are backlogged.
    priority: class ordering. Higher classes are admitted first within a
        window and may preempt strictly-lower-class members back out of a
        staged (held, not yet executed) window. Equal-priority tenants never
        preempt each other — fairness between them is DWRR's job.
    rate_rps: token-bucket admission limit in requests/s (0 = unlimited);
        ``burst`` is the bucket depth (0 derives ceil(rate), min 1).
    slo_ms: end-to-end latency target the telemetry scores completions
        against (0 = no SLO; nothing is enforced either way — the SLO is an
        observability contract, the scheduler's knobs are weight/priority).
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    rate_rps: float = 0.0
    burst: float = 0.0
    slo_ms: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.rate_rps < 0 or self.burst < 0 or self.slo_ms < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate_rps/burst/slo_ms must be >= 0"
            )

    @property
    def effective_burst(self) -> float:
        """Bucket depth: explicit, else ceil(rate) (min 1 so rps<1 admits)."""
        if self.burst > 0:
            return self.burst
        return max(math.ceil(self.rate_rps), 1.0)

    def make_bucket(self) -> TokenBucket:
        return TokenBucket(self.rate_rps, self.effective_burst)


class TenantRegistry:
    """Name -> TenantSpec mapping with a convenience ``add`` constructor."""

    def __init__(self, *specs: TenantSpec):
        self._specs: Dict[str, TenantSpec] = {}
        for s in specs:
            self.register(s)

    def register(self, spec: TenantSpec) -> TenantSpec:
        if spec.name in self._specs:
            raise ValueError(f"tenant {spec.name!r} is already registered")
        self._specs[spec.name] = spec
        return spec

    def add(self, name: str, **kwargs) -> TenantSpec:
        return self.register(TenantSpec(name=name, **kwargs))

    def get(self, name: str) -> TenantSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise UnknownTenant(
                f"unknown tenant {name!r}; registered: {sorted(self._specs)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self) -> Iterator[TenantSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    @property
    def names(self):
        return tuple(self._specs)
