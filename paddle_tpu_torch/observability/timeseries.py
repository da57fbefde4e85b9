"""In-process time-series store: bounded history over the metrics registry.

Every earlier observability surface answers "what is happening RIGHT
NOW" — ``/metrics`` is a point-in-time exposition, ``stats()`` a
snapshot, the flight recorder a ring of discrete events. None of them
can say that TTFT p99 has been climbing for five minutes, or that the
deadline-miss ratio is burning the error budget 10x too fast — the
judgments SRE-style alerting (alerts.py) is built on. This module adds
the missing axis: a :class:`TimeSeriesStore` samples the process-wide
:class:`~.metrics.MetricsRegistry` on a background ``ts-sampler`` thread
at a configurable interval and keeps a bounded ring of points per
series (counters as raw cumulative values, gauges as-is, histograms as
(count, sum, bucket) snapshots), answering the Prometheus-shaped window
queries the alert rules need:
The port's copy of ``paddle_tpu/observability/timeseries.py``.

- ``increase(name, window_s)`` / ``rate(name, window_s)`` — counter
  growth over a window, counter-reset aware (a restarted worker's
  series restarting from zero contributes its new value, never a
  negative delta), summed across matching label sets;
- ``avg_over_time`` / ``last`` — gauge aggregation;
- ``quantile_over_time(name, q, window_s)`` — histogram quantile over
  exactly the observations that landed inside the window (bucket-count
  deltas, linear interpolation within the winning bucket — the
  ``histogram_quantile`` estimate).

Design rules carried over from the tracer/flight recorder: DISABLED is
the default and free (no thread, no sampling, one attribute guard);
memory is bounded whatever the uptime (``capacity`` points per series,
series count bounded by the registry's own label-cardinality cap); the
clock is injectable (``clock=``) so window/burn-rate math is unit
testable against a fake clock; and the dump schema is pinned
(``paddle_tpu.timeseries/1``) so the recent window riding incident
bundles can't drift from its readers.

Federation hooks: extra ``collectors`` let the cluster router feed
pool/supervisor-derived series (per-replica worker counters, live-worker
count, breaker state) into the same store, and ``listeners`` run after
every sample — that is how the :class:`~.alerts.AlertManager` evaluates
its objectives on the sampler's cadence without a second thread.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore", "get_store", "TS_SCHEMA_VERSION"]

#: the pinned dump schema: readers (incident bundles, /timeseries,
#: scripts/watch_cluster.py) and producers validate against this string
TS_SCHEMA_VERSION = "paddle_tpu.timeseries/1"

_INF = float("inf")


class _Series:
    """One (metric name, label set) line: a bounded ring of samples.

    Point shapes by kind — counter/gauge: ``(t, value)``; histogram:
    ``(t, count, sum, bucket_counts)`` where ``bucket_counts`` is the
    per-bucket (non-cumulative) tuple with the trailing +Inf slot."""

    __slots__ = ("name", "kind", "labels", "points", "edges")

    def __init__(self, name: str, kind: str, labels: Dict[str, str],
                 capacity: int, edges: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.labels = dict(labels)
        self.points: deque = deque(maxlen=capacity)
        self.edges = edges

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        if not labels:
            return True
        return all(self.labels.get(k) == str(v) for k, v in labels.items())


class TimeSeriesStore:
    """Bounded in-memory TSDB over metric samples (see module doc).

    ``interval_s`` is the background sampler's cadence; ``capacity``
    bounds points kept per series (default: ten minutes of history at a
    2 s interval). ``clock`` defaults to ``time.monotonic`` and is the
    ONE clock every point and query uses — inject a fake for tests.
    """

    def __init__(self, interval_s: float = 2.0, capacity: int = 300,
                 registry=None, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        if registry is None:
            from .metrics import get_registry

            registry = get_registry()
        self._registry = registry
        self._clock = clock or time.monotonic
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        self._collectors: List[Callable[[], list]] = []
        self._listeners: List[Callable[[float], None]] = []
        self._n_samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.enabled = False

    # ---- clock (shared with the AlertManager riding this store) --------
    def now(self) -> float:
        return self._clock()

    # ---- lifecycle -----------------------------------------------------
    def enable(self) -> "TimeSeriesStore":
        self.enabled = True
        return self

    def disable(self) -> "TimeSeriesStore":
        self.enabled = False
        return self

    def start(self, interval_s: Optional[float] = None
              ) -> "TimeSeriesStore":
        """Enable and start the background ``ts-sampler`` thread
        (idempotent — a second server in the same process reuses the
        running sampler; the smallest requested interval wins)."""
        if interval_s is not None:
            with self._lock:
                self.interval_s = min(self.interval_s, float(interval_s)) \
                    if self._thread is not None else float(interval_s)
        self.enabled = True
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ts-sampler")
            self._thread.start()
        return self

    def set_interval(self, interval_s: float) -> "TimeSeriesStore":
        """Set the sampler cadence outright (the scoped-override
        restore path — ``start(interval_s=)`` only ever shrinks)."""
        with self._lock:
            self.interval_s = float(interval_s)
        return self

    def stop(self):
        """Stop sampling and the background thread (test teardown)."""
        self.enabled = False
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def clear(self):
        """Drop every stored point (test isolation); collectors,
        listeners and the running sampler stay wired."""
        with self._lock:
            self._series.clear()
            self._n_samples = 0

    def _run(self):
        while True:
            with self._lock:
                interval = self.interval_s
            if self._stop.wait(interval):
                return
            if not self.enabled:
                continue
            try:
                self.sample_once()
            except Exception as e:
                # a failed sample loses one point, never the sampler
                _logger().warning("ts-sampler: sample failed (%s: %s)",
                                  type(e).__name__, e)

    # ---- collection -----------------------------------------------------
    def add_collector(self, fn: Callable[[], list]) -> "TimeSeriesStore":
        """Register an extra sample source: ``fn() -> [(name, kind,
        labels, value, edges)]`` where ``value`` is a float for
        counter/gauge and ``(count, sum, bucket_counts)`` for a
        histogram. The cluster router federates pool/supervisor-derived
        series through this."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return self

    def remove_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def add_listener(self, fn: Callable[[float], None]
                     ) -> "TimeSeriesStore":
        """``fn(now)`` runs after every sample (outside the lock) — the
        AlertManager's evaluation hook."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)
        return self

    def remove_listener(self, fn):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _collect_registry(self) -> list:
        return self._registry.collect()

    def sample_once(self, now: Optional[float] = None) -> float:
        """Take one sample of every collector (the registry first) and
        notify listeners. Explicit calls work even while disabled — the
        flag gates the background thread, not a deliberate caller (a
        fake-clock test IS a deliberate caller)."""
        now = self._clock() if now is None else float(now)
        samples: list = []
        with self._lock:
            collectors = list(self._collectors)
        for fn in [self._collect_registry] + collectors:
            try:
                samples.extend(fn())
            except Exception as e:
                _logger().warning("ts-sampler: collector %r failed "
                                  "(%s: %s)", fn, type(e).__name__, e)
        with self._lock:
            self._n_samples += 1
            for name, kind, labels, value, edges in samples:
                key = (name, tuple(sorted(
                    (str(k), str(v)) for k, v in labels.items())))
                s = self._series.get(key)
                if s is None:
                    s = _Series(name, kind, dict(labels), self.capacity,
                                edges=tuple(edges) if edges else None)
                    self._series[key] = s
                if kind == "histogram":
                    count, total, buckets = value
                    s.points.append((now, int(count), float(total),
                                     tuple(buckets)))
                else:
                    s.points.append((now, float(value)))
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(now)
            except Exception as e:
                _logger().warning("ts-sampler: listener %r failed "
                                  "(%s: %s)", fn, type(e).__name__, e)
        return now

    # ---- query helpers ---------------------------------------------------
    def _matching(self, name: str, labels: Optional[Dict[str, str]]
                  ) -> List[_Series]:
        return [s for (n, _k), s in self._series.items()  # pdlint: disable=thread-shared-state -- helper called only with self._lock held (every query wraps it)
                if n == name and s.matches(labels)]

    @staticmethod
    def _window_points(s: _Series, t0: float) -> list:
        """Points with ``t >= t0`` plus ONE baseline point before the
        window start when available — a sparse sampler must still
        measure growth across the window boundary."""
        pts = list(s.points)
        inside = [p for p in pts if p[0] >= t0]
        before = [p for p in pts if p[0] < t0]
        if before:
            return [before[-1]] + inside
        return inside

    # ---- window queries --------------------------------------------------
    def increase(self, name: str, window_s: float,
                 labels: Optional[Dict[str, str]] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Counter growth inside the window, summed across matching
        series, counter-reset aware (a value drop restarts the count
        from the new value — the Prometheus ``increase`` convention).
        None when no series has two usable points yet."""
        now = self._clock() if now is None else float(now)
        t0 = now - float(window_s)
        total, seen = 0.0, False
        with self._lock:
            series = self._matching(name, labels)
            windows = [self._window_points(s, t0) for s in series]
        for pts in windows:
            if len(pts) < 2:
                continue
            seen = True
            prev_t, prev = pts[0][0], pts[0][1]
            for p in pts[1:]:
                t, v = p[0], p[1]
                if v >= prev:
                    delta = v - prev
                    if prev_t < t0 <= t and t > prev_t:
                        # the segment from the baseline point crosses
                        # the window start: charge only the in-window
                        # fraction (linear interpolation at t0) — a
                        # sparse sampler still measures, but a window
                        # is never silently widened by a whole interval
                        delta *= (t - t0) / (t - prev_t)
                else:
                    delta = v       # counter reset: count the new life
                total += delta
                prev_t, prev = t, v
        return total if seen else None

    def rate(self, name: str, window_s: float,
             labels: Optional[Dict[str, str]] = None,
             now: Optional[float] = None) -> Optional[float]:
        """``increase`` divided by the window length (per-second)."""
        inc = self.increase(name, window_s, labels=labels, now=now)
        return None if inc is None else inc / float(window_s)

    def avg_over_time(self, name: str, window_s: float,
                      labels: Optional[Dict[str, str]] = None,
                      now: Optional[float] = None) -> Optional[float]:
        """Mean of every gauge point inside the window across matching
        series; None when the window is empty."""
        now = self._clock() if now is None else float(now)
        t0 = now - float(window_s)
        vals: List[float] = []
        with self._lock:
            for s in self._matching(name, labels):
                vals.extend(p[1] for p in s.points if p[0] >= t0)
        return sum(vals) / len(vals) if vals else None

    def last(self, name: str, labels: Optional[Dict[str, str]] = None
             ) -> Optional[float]:
        """The newest stored value across matching series (scalar kinds;
        multiple matches return the freshest point)."""
        best = None
        with self._lock:
            for s in self._matching(name, labels):
                if s.kind == "histogram" or not s.points:
                    continue
                p = s.points[-1]
                if best is None or p[0] > best[0]:
                    best = p
        return None if best is None else best[1]

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           labels: Optional[Dict[str, str]] = None,
                           now: Optional[float] = None) -> Optional[float]:
        """Histogram quantile over exactly the observations that landed
        inside the window: per-series bucket-count deltas (reset-aware),
        summed across matching series, then the ``histogram_quantile``
        linear interpolation inside the winning bucket. The +Inf bucket
        clamps to the highest finite edge. None without data."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        now = self._clock() if now is None else float(now)
        t0 = now - float(window_s)
        edges: Optional[Tuple[float, ...]] = None
        deltas: Optional[List[float]] = None
        with self._lock:
            for s in self._matching(name, labels):
                if s.kind != "histogram" or s.edges is None:
                    continue
                pts = self._window_points(s, t0)
                if not pts:
                    continue
                first, end = pts[0], pts[-1]
                if end[1] >= first[1] and len(pts) >= 2:
                    d = [max(0, e - b)
                         for b, e in zip(first[3], end[3])]
                elif len(pts) >= 2:
                    d = list(end[3])     # counter reset: the new life
                else:
                    continue
                if edges is None:
                    edges = s.edges
                    deltas = d
                elif s.edges == edges:
                    deltas = [a + b for a, b in zip(deltas, d)]
        if deltas is None or edges is None:
            return None
        total = sum(deltas)
        if total <= 0:
            return None
        target = q * total
        cum = 0.0
        for i, n in enumerate(deltas):
            cum += n
            if cum >= target and n > 0:
                if i >= len(edges):          # the +Inf bucket
                    return float(edges[-1])
                lo = edges[i - 1] if i > 0 else 0.0
                hi = edges[i]
                frac = (target - (cum - n)) / n
                return float(lo + (hi - lo) * frac)
        return float(edges[-1])

    def ratio(self, bad: Tuple[str, Optional[dict]],
              total: Tuple[str, Optional[dict]], window_s: float,
              now: Optional[float] = None,
              bad_in_total: bool = True) -> Optional[float]:
        """``increase(bad) / denominator`` over one window — the SLO
        burn-rate numerator. ``bad_in_total=False`` adds the bad count
        into the denominator (for pairs like deadline misses vs admitted
        requests, where a shed request was never admitted). None when
        the denominator has no traffic."""
        b = self.increase(bad[0], window_s, labels=bad[1], now=now)
        t = self.increase(total[0], window_s, labels=total[1], now=now)
        if b is None or t is None:
            return None
        denom = t if bad_in_total else t + b
        if denom <= 0:
            return None
        return b / denom

    # ---- views / dumps ---------------------------------------------------
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "interval_s": self.interval_s,
                    "capacity": self.capacity,
                    "series": len(self._series),
                    "samples": self._n_samples,
                    "collectors": 1 + len(self._collectors),
                    "listeners": len(self._listeners)}

    def dump(self, window_s: Optional[float] = None,
             name: Optional[str] = None,
             labels: Optional[Dict[str, str]] = None) -> dict:
        """The pinned-schema dump (``paddle_tpu.timeseries/1``): what
        rides incident bundles and answers ``GET /timeseries``. Scalar
        series dump ``[t, value]`` points; histograms dump
        ``[t, count, sum]`` plus the LAST bucket snapshot and edges (the
        full per-point bucket history would dominate a bundle)."""
        now = self._clock()
        t0 = now - float(window_s) if window_s is not None else -_INF
        out = {"schema": TS_SCHEMA_VERSION, "captured_at": now,
               "series": []}
        with self._lock:
            out["interval_s"] = self.interval_s
            for (n, _k), s in sorted(self._series.items()):
                if name is not None and n != name:
                    continue
                if not s.matches(labels):
                    continue
                pts = [p for p in s.points if p[0] >= t0]
                if not pts:
                    continue
                rec = {"name": s.name, "kind": s.kind,
                       "labels": dict(s.labels)}
                if s.kind == "histogram":
                    rec["points"] = [[p[0], p[1], p[2]] for p in pts]
                    rec["edges"] = list(s.edges or ())
                    rec["buckets_last"] = list(pts[-1][3])
                else:
                    rec["points"] = [[p[0], p[1]] for p in pts]
                out["series"].append(rec)
        return out

    def dump_jsonl(self, path: str, window_s: Optional[float] = None
                   ) -> int:
        """Write the dump as JSONL: one header line (schema, capture
        time, interval), then one line per series — greppable and
        tail-able next to an incident bundle's ``.events.jsonl``
        sidecar. Returns the number of series written."""
        d = self.dump(window_s=window_s)
        series = d.pop("series")
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(d) + "\n")
            for rec in series:
                f.write(json.dumps(rec) + "\n")
        return len(series)


def _logger():
    from logging import getLogger as get_logger

    return get_logger("paddle_tpu_torch.observability")


_STORE = TimeSeriesStore()


def get_store() -> TimeSeriesStore:
    """The process-wide time-series store (what the serving front-ends
    start and ``GET /timeseries`` serves)."""
    return _STORE
