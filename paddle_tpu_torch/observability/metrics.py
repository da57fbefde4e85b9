"""Process-wide metrics registry: labeled Counter / Gauge / Histogram.

The serving HTTP front-end records from handler threads while the engine
thread records from step()/_admit(), so every mutation and every render
takes the registry's ONE lock — per-metric locks would still need a
registry-wide hold for a consistent exposition snapshot, so one lock is
both simpler and sufficient (the critical sections are a dict update or
a bisect, microseconds against a multi-ms decode step).
The port's copy of ``paddle_tpu/observability/metrics.py``.

Rendering follows the Prometheus text exposition format 0.0.4
(histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` and
``_count``; counters end in ``_total`` by convention). Latency
histograms default to fixed log-spaced buckets spanning 100 µs .. 60 s —
wide enough for both a single fused decode dispatch and a cold-bucket
prefill compile.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "DEFAULT_LATENCY_BUCKETS", "DEFAULT_MAX_SERIES",
    "PROMETHEUS_CONTENT_TYPE", "set_exemplar_provider",
]

# Optional cross-link to the tracing subsystem: when a provider is set
# (tracing.Tracer.enable does), every histogram observation asks it for
# the active trace_id and stores the latest one on the series as an
# exemplar — so a latency outlier on /metrics points at the exact trace
# that produced it. None (the default) costs one predicate per observe.
_exemplar_provider = None


def set_exemplar_provider(fn) -> None:
    """``fn(metric_name, value) -> Optional[trace_id]``; None unhooks."""
    global _exemplar_provider
    _exemplar_provider = fn

# log-spaced 1-2.5-5 decades, 100 µs .. 60 s (le upper bounds)
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INF = float("inf")

#: default cap on distinct label-value sets per metric family. A label
#: mistake (a per-request id leaking into a label) must never OOM a
#: long-running worker: past the cap, new label sets collapse into ONE
#: ``{overflow="true"}`` series and ``metrics_series_dropped_total``
#: counts the updates that landed there.
DEFAULT_MAX_SERIES = 256

#: sentinel child key for the overflow bucket (never collides with a
#: real label-values tuple, which is always a tuple of strings)
_OVERFLOW_KEY = ("__overflow__",)


def _fmt(v: float) -> str:
    """Exposition number formatting: integral values print as integers
    (Prometheus parses either; integers keep counter lines exact)."""
    f = float(v)
    if f == _INF:
        return "+Inf"
    if f != f:  # NaN
        return "NaN"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


class _MetricFamily:
    """One named metric with a fixed label-name schema; children are the
    per-label-value time series. All state mutations go through the
    REGISTRY lock (shared, so one exposition render is one snapshot)."""

    kind = "untyped"

    # overflow-routed updates are counted through the registry's
    # metrics_series_dropped_total family — except ON that family
    # itself, where counting a drop would recurse into another drop
    _count_drops = True

    def __init__(self, name: str, help_str: str,
                 label_names: Sequence[str], lock: threading.RLock,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.name = name
        self.help = help_str
        self.label_names = tuple(label_names)
        self.max_series = int(max_series)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _label_key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _child(self, labels: Dict[str, str]):
        key = self._label_key(labels)
        child = self._children.get(key)
        if child is None:
            # label-cardinality guard: the overflow child does not count
            # against the cap, so a family is bounded at max_series + 1
            # children however many distinct label sets arrive
            n_real = len(self._children) - (_OVERFLOW_KEY in self._children)
            if key != _OVERFLOW_KEY and n_real >= self.max_series:
                child = self._children.get(_OVERFLOW_KEY)
                if child is None:
                    child = self._new_child()
                    self._children[_OVERFLOW_KEY] = child
                if self._count_drops:
                    self._count_dropped()
                return child
            child = self._new_child()
            self._children[key] = child
        return child

    def _count_dropped(self):
        """One overflow-routed update (under the registry RLock — the
        drop counter lives in the same registry, and re-entrancy is
        exactly why the registry lock is an RLock). Lazy import: this
        module cannot import catalog at module scope (catalog imports
        metrics)."""
        from .catalog import METRICS_SERIES_DROPPED

        METRICS_SERIES_DROPPED.inc(metric=self.name)

    def labels(self, **labels) -> "_BoundMetric":
        """Pre-resolve one label combination (the engines bind their
        children once at construction — no per-token dict hashing)."""
        with self._lock:
            return _BoundMetric(self, self._child(labels))

    def _render_series(self, key: Tuple[str, ...], child) -> list:
        raise NotImplementedError

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        if key == _OVERFLOW_KEY:
            # the cardinality-guard bucket renders with the ONE reserved
            # label instead of the family's schema — the values that
            # would have gone here are exactly what must not be kept
            parts = ['overflow="true"']
        else:
            parts = [f'{n}="{_escape_label(v)}"'
                     for n, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        if key == _OVERFLOW_KEY:
            return {"overflow": "true"}
        return dict(zip(self.label_names, key))

    def render(self) -> list:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._children):
            lines.extend(self._render_series(key, self._children[key]))
        return lines

    def reset(self):
        for child in self._children.values():
            child.reset()


class _BoundMetric:
    """A (family, child) pair: the per-label-values handle hot paths hold."""

    __slots__ = ("_family", "_child")

    def __init__(self, family, child):
        self._family = family
        self._child = child

    def inc(self, amount: float = 1.0):
        with self._family._lock:
            self._child.inc(amount)

    def set(self, value: float):
        with self._family._lock:
            self._child.set(value)

    def observe(self, value: float):
        ex = (_exemplar_provider(self._family.name, value)
              if _exemplar_provider is not None else None)
        with self._family._lock:
            self._child.observe(value, ex)

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._child.value

    @property
    def count(self) -> int:
        with self._family._lock:
            return self._child.count

    @property
    def sum(self) -> float:
        with self._family._lock:
            return self._child.sum


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def reset(self):
        self.value = 0.0


class Counter(_MetricFamily):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            self._child(labels).inc(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return self._child(labels).value

    def _render_series(self, key, child):
        return [f"{self.name}{self._label_str(key)} {_fmt(child.value)}"]


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value):
        self.value = float(value)

    def inc(self, amount=1.0):
        self.value += amount

    def reset(self):
        self.value = 0.0


class Gauge(_MetricFamily):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels):
        with self._lock:
            self._child(labels).set(value)

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            self._child(labels).inc(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return self._child(labels).value

    def _render_series(self, key, child):
        return [f"{self.name}{self._label_str(key)} {_fmt(child.value)}"]


class _HistogramChild:
    __slots__ = ("bucket_counts", "sum", "count", "exemplar", "_edges")

    def __init__(self, edges):
        self._edges = edges
        self.reset()

    def observe(self, value, exemplar=None):
        v = float(value)
        # le semantics: bisect_left finds the first edge >= v
        self.bucket_counts[bisect.bisect_left(self._edges, v)] += 1
        self.sum += v
        self.count += 1
        if exemplar is not None:
            # latest-wins: one (value, trace_id, ts) per series bounds
            # memory regardless of observation rate
            self.exemplar = (v, str(exemplar), time.time())

    def reset(self):
        self.bucket_counts = [0] * (len(self._edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.exemplar = None


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name, help_str, label_names, lock,
                 buckets: Optional[Sequence[float]] = None,
                 max_series: int = DEFAULT_MAX_SERIES):
        super().__init__(name, help_str, label_names, lock,
                         max_series=max_series)
        edges = tuple(sorted(float(b) for b in
                             (buckets or DEFAULT_LATENCY_BUCKETS)))
        if not edges or any(e != e or e == _INF for e in edges):
            raise ValueError("histogram buckets must be finite and non-empty")
        self.buckets = edges

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels):
        ex = (_exemplar_provider(self.name, value)
              if _exemplar_provider is not None else None)
        with self._lock:
            self._child(labels).observe(value, ex)

    def count(self, **labels) -> int:
        with self._lock:
            return self._child(labels).count

    def sum(self, **labels) -> float:
        with self._lock:
            return self._child(labels).sum

    def bucket_counts(self, **labels) -> list:
        """Per-bucket (non-cumulative) counts; trailing slot is +Inf."""
        with self._lock:
            return list(self._child(labels).bucket_counts)

    def _render_series(self, key, child):
        lines, cum = [], 0
        for edge, n in zip(self.buckets, child.bucket_counts):
            cum += n
            le = 'le="%s"' % _fmt(edge)
            lines.append(f"{self.name}_bucket{self._label_str(key, le)} "
                         f"{cum}")
        inf = 'le="+Inf"'
        lines.append(f"{self.name}_bucket{self._label_str(key, inf)} "
                     f"{child.count}")
        lines.append(f"{self.name}_sum{self._label_str(key)} "
                     f"{_fmt(child.sum)}")
        lines.append(f"{self.name}_count{self._label_str(key)} "
                     f"{child.count}")
        if child.exemplar is not None:
            # exemplar cross-link rendered as a comment: text exposition
            # 0.0.4 has no exemplar syntax (that's OpenMetrics), and a
            # comment keeps every 0.0.4 parser happy while a human (or
            # the JSONL snapshot) can still follow the trace_id
            v, tid, ts = child.exemplar
            lines.append(f"# exemplar {self.name}{self._label_str(key)} "
                         f'trace_id="{tid}" value={_fmt(v)} ts={ts:.3f}')
        return lines


class MetricsRegistry:
    """Name -> metric family, one lock for everything (see module doc).

    Registration is idempotent: re-declaring a name returns the existing
    family when kind/labels/buckets agree and raises when they don't (two
    modules silently disagreeing on a schema is exactly the drift this
    subsystem exists to prevent)."""

    def __init__(self, max_series_per_metric: int = DEFAULT_MAX_SERIES):
        # one lock for the registry AND every family (the shared-lock
        # idiom passes this object into each metric)
        self._lock = threading.RLock()
        self._families: Dict[str, _MetricFamily] = {}
        self.max_series_per_metric = int(max_series_per_metric)

    def _register(self, cls, name, help_str, labels, **kw):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                same = (type(existing) is cls
                        and existing.label_names == tuple(labels))
                if same and cls is Histogram:
                    want = tuple(sorted(
                        float(b) for b in (kw.get("buckets")
                                           or DEFAULT_LATENCY_BUCKETS)))
                    same = existing.buckets == want
                if not same:
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        "different schema")
                return existing
            fam = cls(name, help_str, tuple(labels), self._lock,
                      max_series=self.max_series_per_metric, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_str: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help_str, labels)

    def gauge(self, name: str, help_str: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help_str, labels)

    def histogram(self, name: str, help_str: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help_str, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._families)

    def describe(self) -> Dict[str, dict]:
        """{name: {kind, help, labels}} — the catalog the docs lint
        (scripts/check_metrics_catalog.py) checks against."""
        with self._lock:
            return {n: {"kind": f.kind, "help": f.help,
                        "labels": list(f.label_names)}
                    for n, f in self._families.items()}

    def render_prometheus(self) -> str:
        """One consistent snapshot in text exposition format 0.0.4."""
        with self._lock:
            lines = []
            for name in sorted(self._families):
                lines.extend(self._families[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """Nested-dict snapshot (the JSONL writer's payload): per family,
        {labels-tuple-as-str: value | {sum, count, buckets}}."""
        with self._lock:
            out = {}
            for name, fam in self._families.items():
                series = {}
                for key, child in fam._children.items():
                    skey = ",".join(f"{n}={v}" for n, v
                                    in fam._labels_dict(key).items())
                    if fam.kind == "histogram":
                        series[skey] = {"sum": child.sum,
                                        "count": child.count,
                                        "buckets": list(child.bucket_counts)}
                        if child.exemplar is not None:
                            v, tid, ts = child.exemplar
                            series[skey]["exemplar"] = {
                                "value": v, "trace_id": tid, "ts": ts}
                    else:
                        series[skey] = child.value
                out[name] = {"kind": fam.kind, "series": series}
            return out

    def collect(self) -> list:
        """One consistent flat sample of every series for the
        time-series store: ``[(name, kind, labels_dict, value, edges)]``
        where ``value`` is a float for counter/gauge and ``(count, sum,
        bucket_counts)`` for a histogram (``edges`` is None for scalar
        kinds). The overflow bucket samples as ``{overflow: "true"}``."""
        with self._lock:
            out = []
            for name, fam in self._families.items():
                for key, child in fam._children.items():
                    labels = fam._labels_dict(key)
                    if fam.kind == "histogram":
                        out.append((name, "histogram", labels,
                                    (child.count, float(child.sum),
                                     tuple(child.bucket_counts)),
                                    fam.buckets))
                    else:
                        out.append((name, fam.kind, labels,
                                    float(child.value), None))
            return out

    def reset(self):
        """Zero every series, keep registrations (test isolation)."""
        with self._lock:
            for fam in self._families.values():
                fam.reset()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what /metrics renders)."""
    return _DEFAULT
