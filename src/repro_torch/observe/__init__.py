"""Observability: request tracing (Perfetto export) + unified metrics.

Two host-side facilities with zero accelerator-path footprint:

- :mod:`repro_torch.observe.trace` — a thread-safe span recorder with a bounded
  ring buffer and Chrome-trace-event JSON export (loadable in Perfetto /
  ``chrome://tracing``). Disabled by default; the disabled hot path is a
  single attribute check returning a shared no-op span.
- :mod:`repro_torch.observe.metrics` — a process-wide labeled metrics registry
  (counters, gauges, streaming histograms) with a Prometheus-style text
  dump. The serving engines' historical ``stats`` dicts are live views over
  this registry (:class:`repro_torch.observe.metrics.StatsView`), so there is one
  copy of every counter.
"""
from repro_torch.observe.trace import (  # noqa: F401
    NULL_SPAN,
    TraceRecorder,
    disable,
    enable,
    get_recorder,
    is_enabled,
    new_trace_id,
    set_recorder,
)
from repro_torch.observe.metrics import (  # noqa: F401
    MetricsRegistry,
    StatsView,
    get_registry,
    set_registry,
)
