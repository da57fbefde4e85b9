"""Request-scoped tracing: explicit spans through the serving pipeline.
The port's copy of ``paddle_tpu/observability/tracing.py``.

The metrics answer "how is the fleet doing"; this module answers
"where did THIS request spend its time". A process-wide :class:`Tracer`
records explicit spans (``trace_id``/``span_id``/``parent_id``, name,
attrs, start/end ns) into a thread-safe ring buffer with bounded memory.
The serving engines open one root span per request (queue-wait, prefill,
sampled decode steps, prefix-cache lookup and slot-free as children),
the HTTP front-end correlates with external callers through W3C
``traceparent`` headers, and the train side (StepTimer, the profiler's
throughput timer) emits per-step spans — all onto ONE timeline that
exports as chrome://tracing JSON or as JSONL lines through the
SnapshotWriter.

Disabled is the default and it is FREE on the hot path: every entry
point checks one attribute (``tracer.enabled``) and returns a no-op —
an engine decoding with no subscriber pays one predicate per step, not
per-span bookkeeping. The HTTP server enables tracing when it starts
(it subscribes via ``GET /trace``).

Clock: spans use ``time.perf_counter_ns()``, the clock the engines'
latency metrics read, so a span's bounds come from the timestamps the
metric already took.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "get_tracer", "trace",
    "parse_traceparent", "format_traceparent",
    "SPAN_CATALOG", "TRACEPARENT_HEADER",
]

TRACEPARENT_HEADER = "traceparent"

# ---- span catalog -----------------------------------------------------------
# The contract surface, mirroring the metric catalog: docs/SERVING.md
# documents exactly these names (scripts/check_span_catalog.py asserts
# both directions). Emit spans through these constants — an ad-hoc
# string would dodge the lint and drift out of the docs.

SPAN_CATALOG: Dict[str, str] = {}


def _register(name: str, desc: str) -> str:
    SPAN_CATALOG[name] = desc
    return name


SPAN_REQUEST = _register(
    "serving.request",
    "per-request root: submission to retirement (attrs: rid, engine, "
    "prompt_tokens, max_new_tokens, slot, generated_tokens; status "
    "ok|cancelled|error)")
SPAN_QUEUE_WAIT = _register(
    "serving.queue_wait",
    "child of serving.request: submission to slot admission")
SPAN_PREFILL = _register(
    "serving.prefill",
    "child of serving.request: admission prefill (bucketed jitted "
    "prefill + page scatter; encoder+seed prefill on the seq2seq "
    "engine)")
SPAN_PREFIX_LOOKUP = _register(
    "serving.prefix_lookup",
    "child of serving.prefill: shared-prefix scan over active slots "
    "(only with enable_prefix_cache)")
SPAN_DECODE_STEP = _register(
    "serving.decode_step",
    "child of serving.request: one fused decode dispatch, SAMPLED — "
    "recorded at the request's first token and every Nth after "
    "(trace_decode_every) to bound overhead")
SPAN_SLOT_FREE = _register(
    "serving.slot_free",
    "child of serving.request: instant marker when the request's slot "
    "is released (finish or cancel)")
SPAN_HTTP_REQUEST = _register(
    "http.request",
    "HTTP handler span; parents serving.request and carries the "
    "inbound traceparent context when the caller sent one")
SPAN_ROUTER_REQUEST = _register(
    "router.request",
    "cluster-router handler span around one proxied completion "
    "(continues the caller's traceparent; parents router.upstream and, "
    "across the process boundary, the worker's http.request)")
SPAN_ROUTER_UPSTREAM = _register(
    "router.upstream",
    "child of router.request: ONE placement attempt against one worker "
    "(attrs: replica_id, role, attempt; a retried request records one "
    "per attempt)")
SPAN_ALERT = _register(
    "alert.transition",
    "instant marker dropped by the AlertManager when an alert fires or "
    "resolves (attrs: alert, from, to, severity) — the alerting "
    "layer's judgments land on the same timeline as the signals that "
    "caused them")
SPAN_TRAIN_STEP = _register(
    "train.step",
    "one train-loop step (observability StepTimer begin/end, and the "
    "profiler throughput timer's batch window)")
SPAN_TRAIN_EPOCH = _register(
    "train.epoch",
    "one train epoch (hapi StepTimer callback); parents that epoch's "
    "train.step spans")


# ---- ids / W3C trace context ------------------------------------------------

def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """W3C trace-context: ``00-<32 hex trace>-<16 hex span>-<2 hex flags>``
    -> ``(trace_id, parent_span_id)``; None for anything malformed
    (all-zero ids included — the spec says treat them as absent)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    ver, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or not _is_hex(ver) or ver.lower() == "ff":
        return None
    if ver == "00" and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or set(trace_id) == {"0"}:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or set(span_id) == {"0"}:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return trace_id.lower(), span_id.lower()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """Emit the header for OUR context (always sampled: flags=01)."""
    return f"00-{trace_id}-{span_id}-01"


# ---- spans ------------------------------------------------------------------

class Span:
    """One timed operation. ``end()`` freezes it into the tracer's ring
    buffer; attrs may be set any time before that (single-writer per
    span — the owning thread)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "start_ns", "end_ns", "status", "tid", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Optional[dict],
                 start_ns: Optional[int] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.start_ns = (time.perf_counter_ns() if start_ns is None
                         else int(start_ns))
        self.end_ns = None
        self.status = None
        self.tid = threading.get_ident()

    def set_attr(self, key: str, value):
        self.attrs[key] = value
        return self

    def end(self, status: str = "ok", end_ns: Optional[int] = None):
        """Idempotent: the first end wins (a span double-ended by an
        exception path must not appear twice in the buffer)."""
        if self.end_ns is not None:
            return
        self.end_ns = (time.perf_counter_ns() if end_ns is None
                       else int(end_ns))
        self.status = status
        self._tracer._finish(self)

    def __bool__(self):
        return True

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}…, "
                f"span={self.span_id})")


class _NoopSpan:
    """The disabled-path span: every operation is a no-op, truthiness is
    False so call sites can guard with ``if span:``."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = None
    attrs: dict = {}
    start_ns = 0
    end_ns = 0
    status = None
    tid = 0

    def set_attr(self, key, value):
        return self

    def end(self, status="ok", end_ns=None):
        pass

    def __bool__(self):
        return False


NOOP_SPAN = _NoopSpan()

_NULL_CM = contextlib.nullcontext()


class _SpanUse:
    """Plain-object context manager for Tracer.use (cheaper than a
    generator on per-token call sites)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer, span):
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, *exc):
        self._tracer._pop(self._span)
        return False


# ---- tracer -----------------------------------------------------------------

class Tracer:
    """Process-wide span recorder.

    Storage is a ring buffer of FINISHED spans (``deque(maxlen=...)`` —
    bounded memory whatever the request rate) plus a small live-span
    index so ``/trace?rid=`` can resolve in-flight requests. The
    current-span stack is thread-local; cross-thread parenting is
    explicit (pass ``parent=`` or enter ``use(span)``), which is how
    the HTTP handler thread's context reaches the engine thread.
    """

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(capacity))
        self._live: Dict[str, Span] = {}
        self._local = threading.local()
        self._n_dropped = 0
        self._m_dropped = None  # bound lazily on first overflow
        self.enabled = False

    # ---- lifecycle -----------------------------------------------------
    def enable(self):
        """Turn recording on and hook histogram exemplars (observations
        made inside an active span tag the trace_id onto the series)."""
        self.enabled = True
        from . import metrics as _metrics

        _metrics.set_exemplar_provider(self._exemplar)
        return self

    def disable(self):
        self.enabled = False
        from . import metrics as _metrics

        _metrics.set_exemplar_provider(None)
        return self

    def clear(self):
        """Drop every recorded and live span (test isolation)."""
        with self._lock:
            self._buf.clear()
            self._live.clear()
            self._n_dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def __len__(self):
        with self._lock:
            return len(self._buf)

    # ---- current-span stack (thread-local) -----------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def _push(self, span: Span):
        self._stack().append(span)

    def _pop(self, span: Span):
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:          # tolerate mis-nested pops
            st.remove(span)

    # ---- span creation -------------------------------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None,
                   attrs: Optional[dict] = None,
                   start_ns: Optional[int] = None):
        """Start a span WITHOUT making it current. Parent resolution:
        explicit ``parent`` span > explicit ``(trace_id, parent_id)``
        context (the W3C inbound path) > this thread's current span >
        a fresh root trace."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None and trace_id is None:
            parent = self.current()
        if parent is not None and parent.trace_id:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        elif trace_id is None:
            trace_id = _new_trace_id()
        span = Span(self, name, trace_id, parent_id, attrs,
                    start_ns=start_ns)
        with self._lock:
            self._live[span.span_id] = span
        return span

    def add_span(self, name: str, start_ns: int, end_ns: int,
                 parent: Optional[Span] = None,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[dict] = None, status: str = "ok"):
        """Record an already-timed span (the engines time a fused decode
        dispatch first, then attach it to sampled requests)."""
        if not self.enabled:
            return NOOP_SPAN
        span = self.start_span(name, parent=parent, trace_id=trace_id,
                               parent_id=parent_id, attrs=attrs,
                               start_ns=start_ns)
        span.end(status, end_ns=end_ns)
        return span

    @property
    def dropped(self) -> int:
        """Finished spans evicted by ring overflow (lifetime count —
        mirrored on /metrics as ``tracing_spans_dropped_total``)."""
        with self._lock:
            return self._n_dropped

    def _finish(self, span: Span):
        with self._lock:
            self._live.pop(span.span_id, None)
            overflowed = len(self._buf) == self._buf.maxlen
            if overflowed:
                # the ring evicts silently otherwise — an operator
                # debugging a sparse trace must be able to SEE overflow
                self._n_dropped += 1
            self._buf.append({
                "name": span.name,
                "trace_id": span.trace_id,
                "span_id": span.span_id,
                "parent_id": span.parent_id,
                "start_ns": span.start_ns,
                "end_ns": span.end_ns,
                "tid": span.tid,
                "status": span.status,
                "attrs": dict(span.attrs),
            })
        if overflowed:
            if self._m_dropped is None:
                from . import catalog as _cat

                self._m_dropped = _cat.TRACING_SPANS_DROPPED.labels()
            self._m_dropped.inc()

    # ---- context-manager / decorator APIs ------------------------------
    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             attrs: Optional[dict] = None):
        """Start a span, make it current for the block, end it on exit
        (status=error when the block raises). No-op when disabled."""
        sp = self.start_span(name, parent=parent, attrs=attrs)
        if not sp:
            yield sp
            return
        try:
            # inside the try: if _push itself fails the span still ends
            # (status=error) instead of leaking — _pop tolerates a span
            # that never made it onto the stack
            self._push(sp)
            yield sp
        except BaseException:
            # end before pop: ending is what delivers the span to the
            # buffer, popping only maintains the current-span stack
            sp.end("error")
            self._pop(sp)
            raise
        else:
            sp.end()
            self._pop(sp)

    def use(self, span: Optional[Span]):
        """Make an EXISTING span current for the block without ending it
        — how per-request observations on the engine thread attach
        exemplars to the request's root span. None/noop spans get a
        shared null context (this runs per generated token on the
        serving hot path, so the disabled branch allocates nothing)."""
        if span is None or not span:
            return _NULL_CM
        return _SpanUse(self, span)

    # ---- metric exemplars ----------------------------------------------
    def _exemplar(self, metric_name: str, value: float):
        """metrics.set_exemplar_provider hook: a histogram observation
        inside an active span returns the trace_id (stored on the
        series) and notes the observation on the span — metrics and
        traces cross-link in both directions."""
        sp = self.current()
        if sp is None or not sp.trace_id:
            return None
        sp.attrs[metric_name] = value
        return sp.trace_id

    # ---- queries --------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None,
              include_live: bool = False) -> List[dict]:
        """Finished spans (oldest first), optionally one trace only.

        ``include_live=True`` appends snapshots of still-open spans
        (``end_ns: None``, ``status: "in_flight"``) — a trace queried
        while its request is mid-flight must not silently drop the
        spans that haven't ended yet (e.g. the HTTP handler's
        ``http.request`` span ends only after the response bytes are
        written, so an immediate ``/trace`` query would race it)."""
        with self._lock:
            recs = list(self._buf)
            live = list(self._live.values()) if include_live else []
        if trace_id is not None:
            recs = [r for r in recs if r["trace_id"] == trace_id]
            live = [s for s in live if s.trace_id == trace_id]
        for span in live:
            recs.append({
                "name": span.name,
                "trace_id": span.trace_id,
                "span_id": span.span_id,
                "parent_id": span.parent_id,
                "start_ns": span.start_ns,
                "end_ns": None,
                "tid": span.tid,
                "status": "in_flight",
                "attrs": dict(span.attrs),
            })
        return recs

    def find_request_trace(self, rid: int,
                           engine: Optional[str] = None) -> Optional[str]:
        """trace_id of the serving root span for a request id — newest
        first, in-flight (live) requests included."""
        with self._lock:
            live = list(self._live.values())
            recs = list(self._buf)
        for sp in reversed(live):
            if (sp.name == SPAN_REQUEST and sp.attrs.get("rid") == rid
                    and (engine is None
                         or sp.attrs.get("engine") == engine)):
                return sp.trace_id
        for rec in reversed(recs):
            if (rec["name"] == SPAN_REQUEST
                    and rec["attrs"].get("rid") == rid
                    and (engine is None
                         or rec["attrs"].get("engine") == engine)):
                return rec["trace_id"]
        return None

    # ---- exporters -------------------------------------------------------
    def export_chrome(self, trace_id: Optional[str] = None,
                      path: Optional[str] = None) -> dict:
        """chrome://tracing JSON of the recorded spans. (The JAX package
        also merges its host profiler's events into an unfiltered dump;
        the port has no such profiler, so the dump holds the spans
        only.)"""
        events = []
        pid = os.getpid()
        for rec in self.spans(trace_id):
            events.append({
                "name": rec["name"],
                "cat": "tracing",
                "ph": "X",
                "pid": pid,
                "tid": rec["tid"],
                "ts": rec["start_ns"] / 1000.0,
                "dur": max(rec["end_ns"] - rec["start_ns"], 0) / 1000.0,
                "args": {
                    "trace_id": rec["trace_id"],
                    "span_id": rec["span_id"],
                    "parent_id": rec["parent_id"],
                    "status": rec["status"],
                    **rec["attrs"],
                },
            })
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def export_jsonl(self, writer, trace_id: Optional[str] = None) -> str:
        """Append one rank-aware JSONL line through the
        SnapshotWriter: the registry snapshot plus this tracer's spans
        (``{"spans": [...]}``) — one record correlates metrics and
        traces at a point in time."""
        return writer.write(extra={"spans": self.spans(trace_id)})


def _logger():
    """The package's logger."""
    from logging import getLogger as get_logger

    return get_logger("paddle_tpu_torch.observability")


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (what the engines and /trace serve)."""
    return _TRACER


def trace(name: Optional[str] = None, **attrs):
    """Decorator form: ``@trace("my.op")`` wraps the call in a span
    (function qualname when unnamed). Free when tracing is disabled."""

    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tr = _TRACER
            if not tr.enabled:
                return fn(*args, **kwargs)
            with tr.span(span_name, attrs=dict(attrs) if attrs else None):
                return fn(*args, **kwargs)

        return wrapper

    return deco
