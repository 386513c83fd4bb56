"""Process-wide labeled metrics registry with a Prometheus-style dump.

One registry holds every serving counter/gauge/histogram, keyed by metric
name + label values — the single sink the engines' historical ``stats``
dicts now feed. Three metric kinds:

- **counter / gauge** — a single float cell (:class:`MetricValue`). The
  distinction is exposition-only (``# TYPE``): counters are monotonically
  increasing by convention, gauges move both ways.
- **histogram** — a :class:`repro_torch.serve.telemetry.StreamingHistogram`
  child per label set (O(1) memory, bounded relative quantile error).
  Existing histogram objects can be *adopted* via
  :meth:`MetricsRegistry.register_histogram`, so ``TenantTelemetry``'s
  per-tenant latency histograms appear in the registry dump without a
  second copy being maintained.

:class:`StatsView` is the compatibility bridge: a ``MutableMapping`` with
the exact shape and value semantics of the old ad-hoc ``stats`` dicts
(integer counters read back as ``int``; keys listed in ``float_keys`` stay
``float``) whose storage *is* registry cells. ``engine.stats["cache_hits"]``
and the Prometheus dump can never disagree because they read the same cell.
"""
from __future__ import annotations

import itertools
import threading
from collections.abc import MutableMapping
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "MetricValue",
    "MetricFamily",
    "MetricsRegistry",
    "StatsView",
    "get_registry",
    "set_registry",
    "next_instance",
]


class MetricValue:
    """One counter/gauge cell. Mutations are GIL-atomic float ops."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)

    def __repr__(self) -> str:
        return f"MetricValue({self.value!r})"


class MetricFamily:
    """All children of one metric name, one child per label-value tuple."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str,
        label_names: Tuple[str, ...],
        make_child,
    ):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._make_child = make_child
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: Any) -> Any:
        """The child cell for this label set (created on first touch)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def adopt(self, child: Any, **labels: Any) -> Any:
        """Install an externally-owned child object for a label set."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            self._children[key] = child
        return child

    def samples(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.label_names, key)), child) for key, child in items
        ]


def _fmt_value(v: float) -> str:
    # Prometheus text format: integers without a trailing .0 read cleaner.
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Name → :class:`MetricFamily` map with text/dict exports."""

    def __init__(self) -> None:
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------ register
    def _family(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Iterable[str],
        make_child,
    ) -> MetricFamily:
        label_names = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, label_names, make_child)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != label_names:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.label_names}; asked for {kind} {label_names}"
            )
        return fam

    def counter(
        self, name: str, help: str = "", labels: Iterable[str] = ()
    ) -> MetricFamily:
        return self._family(name, "counter", help, labels, MetricValue)

    def gauge(
        self, name: str, help: str = "", labels: Iterable[str] = ()
    ) -> MetricFamily:
        return self._family(name, "gauge", help, labels, MetricValue)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        rel_error: float = 0.025,
    ) -> MetricFamily:
        # Lazy import: observe sits below serve in the layering; only the
        # histogram kind reaches up for the shared implementation.
        from repro_torch.serve.telemetry import StreamingHistogram

        return self._family(
            name,
            "histogram",
            help,
            labels,
            lambda: StreamingHistogram(rel_error=rel_error),
        )

    def register_histogram(
        self, name: str, hist: Any, help: str = "", **labels: Any
    ) -> Any:
        """Adopt an existing ``StreamingHistogram`` as a registry child."""
        fam = self._family(
            name, "histogram", help, tuple(sorted(labels)), lambda: None
        )
        return fam.adopt(hist, **labels)

    # --------------------------------------------------------------- query
    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # -------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Any]:
        """Everything as plain dicts (histograms via their snapshot())."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            rows = []
            for labels, child in fam.samples():
                if fam.kind == "histogram":
                    value = child.snapshot() if child is not None else {}
                else:
                    value = child.value
                rows.append({"labels": labels, "value": value})
            out[fam.name] = {"kind": fam.kind, "samples": rows}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as quantile summaries)."""
        lines: List[str] = []
        for fam in self.families():
            samples = fam.samples()
            if not samples:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            kind = "summary" if fam.kind == "histogram" else fam.kind
            lines.append(f"# TYPE {fam.name} {kind}")
            for labels, child in samples:
                if fam.kind == "histogram":
                    if child is None or child.count == 0:
                        continue
                    for q in (0.5, 0.9, 0.99):
                        ql = dict(labels)
                        ql["quantile"] = repr(q)
                        lines.append(
                            f"{fam.name}{_fmt_labels(ql)} "
                            f"{_fmt_value(child.percentile(q * 100))}"
                        )
                    lab = _fmt_labels(labels)
                    lines.append(
                        f"{fam.name}_sum{lab} {_fmt_value(child.total)}"
                    )
                    lines.append(f"{fam.name}_count{lab} {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{_fmt_labels(labels)} "
                        f"{_fmt_value(child.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


class StatsView(MutableMapping):
    """Dict-shaped live view over registry counter cells.

    The engines' historical ``stats`` dicts (``self.stats["cache_hits"] +=
    1``, ``cache_info()`` merges, exact-value test assertions) keep working
    unchanged, but the storage is the registry: key ``k`` reads/writes the
    cell of metric ``{prefix}_{k}`` under this view's label set. Values
    read back as ``int`` unless the key is in ``float_keys`` — the old
    dicts held ints for counters and floats for the ``*_ms`` accumulators,
    and tests assert on that distinction.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        prefix: str,
        labels: Dict[str, str],
        keys: Iterable[str],
        float_keys: Iterable[str] = (),
    ):
        self._registry = registry
        self._prefix = prefix
        self._labels = dict(labels)
        self._float = frozenset(float_keys)
        self._cells: Dict[str, MetricValue] = {}
        for k in keys:
            self._cell(k)

    def _cell(self, key: str) -> MetricValue:
        cell = self._cells.get(key)
        if cell is None:
            fam = self._registry.counter(
                f"{self._prefix}_{key}", labels=tuple(sorted(self._labels))
            )
            cell = fam.labels(**self._labels)
            self._cells[key] = cell
        return cell

    def __getitem__(self, key: str):
        v = self._cells[key].value
        return v if key in self._float else int(v)

    def __setitem__(self, key: str, value) -> None:
        self._cell(key).value = float(value)

    def __delitem__(self, key: str) -> None:
        del self._cells[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cells)

    def __len__(self) -> int:
        return len(self._cells)

    def __repr__(self) -> str:
        return repr(dict(self))


# ------------------------------------------------- module-level registry
_REGISTRY = MetricsRegistry()
_INSTANCE_COUNTERS: Dict[str, Any] = {}
_INSTANCE_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every serving component records into."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = registry
    return registry


def next_instance(prefix: str) -> str:
    """A process-unique instance label (``gnn_serve-0``, ``gnn_serve-1``...).

    Engines label their registry cells with this so concurrent engine
    instances (common in tests) never alias each other's counters.
    """
    with _INSTANCE_LOCK:
        c = _INSTANCE_COUNTERS.get(prefix)
        if c is None:
            c = _INSTANCE_COUNTERS[prefix] = itertools.count()
        return f"{prefix}-{next(c)}"
