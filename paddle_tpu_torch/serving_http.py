"""OpenAI-style HTTP front-end over the continuous-batching engine: the
port's copy of ``paddle_tpu/serving_http.py``, with the same routes,
status codes, headers and JSON / SSE bodies, over the port's
``ContinuousBatchEngine`` on the card. Stdlib only (no web framework):

- ``POST /v1/completions`` — OpenAI completions shape: ``prompt`` (string,
  needs a ``tokenizer``) or ``prompt_token_ids`` (list of ints, no
  tokenizer needed), ``max_tokens``, ``temperature`` / ``top_k`` /
  ``top_p`` (per-request sampling rides the engine's per-row program),
  ``stop_token_ids``, ``logprobs``, ``n`` (sampled sibling completions
  batch in-flight on the engine), ``stream`` (SSE chunks per token,
  ``data: [DONE]`` terminator) and ``priority`` / ``slo_ms`` (SLO-aware
  admission). ``pixel_values`` answers 400: the port serves text models
  only (multimodal serving is not ported). A bounded engine queue
  (``max_queue``) answers ``429 Too Many Requests`` + ``Retry-After``
  when full;
- ``GET /v1/models`` and ``GET /health``;
- ``GET /metrics`` — Prometheus text exposition of the process-wide
  registry (``paddle_tpu_torch.observability``, the JAX package's metric
  catalog name for name): latency histograms
  (queue-wait, TTFT, inter-token, prefill, decode-step), request/token
  counters, occupancy gauges. Scrape it next to /health.
- ``GET /trace?rid=N`` (or ``?trace_id=...``) — the request's recorded
  spans as JSON, and ``GET /trace/chrome`` — a chrome://tracing JSON
  download (optionally filtered the same way). ``POST
  /v1/completions`` accepts an inbound W3C ``traceparent`` header
  (continuing the caller's trace) and always answers with one, so
  external callers correlate their spans with the engine's.
- ``GET /debug/dump`` — the incident bundle (flight-recorder event
  ring, spans, metrics snapshot, engine slot/queue state, thread
  stacks) as JSON on demand; ``?write=1`` persists it rank-suffixed to
  the incident directory. ``GET /debug/events?since=N`` tails the
  flight-recorder ring incrementally.
- ``GET /audit`` — the correctness sentinel's state (verdict counts,
  skip reasons, canary fingerprint, recent verdicts, sealed divergence
  bundles). ``POST /v1/completions`` accepts an ``X-Audit: 1`` header
  or body ``audit=true`` for a GUARANTEED shadow audit whose verdict
  block rides the response next to ``usage``; sampled shadow audits
  and pinned canary probes run on the named audit-worker thread.

Single-engine-thread design: device state (page pool, slot buffers, the
step units' CUDA graphs) is touched ONLY by the engine thread; HTTP
handler threads touch no CUDA tensor (the engine hands them host ints and
floats: ``stats()``, ``finish_reason``, ``request_usage`` and the token
events), enqueue submissions and wait on per-request queues fed by the
engine's ``on_token`` streaming callbacks. The engine thread interleaves
admission and decode exactly like ``run_until_done`` — in-flight batching
across concurrent HTTP clients is the whole point. The sentinel's audit
worker replays on the device under ``cuda_graph.DEVICE_LOCK``, which the
engine holds across each step (``observability/sentinel.py``), so a
replay never overlaps a capture.

The handler skeleton (:class:`ServingHandlerBase`: observability GETs,
traceparent echo, chunked SSE plumbing, POST span wiring) is the one the
JAX package's disaggregated tier (``serving_cluster``, not ported) builds
its router and role workers on.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from .observability import PROMETHEUS_CONTENT_TYPE, get_registry
from .observability import flightrecorder as _frec
from .observability import kvatlas as _kvatlas
from .observability import perf as _perf
from .observability import sentinel as _sentinel
from .observability import tracing as _tracing
from .observability.catalog import HTTP_REQUESTS
from .serving import DeadlineExceeded, QueueFull

__all__ = ["CompletionServer", "ServingHandlerBase", "serve",
           "DEADLINE_HEADER", "AUDIT_HEADER", "timeseries_payload",
           "alerts_payload", "profile_payload", "kvstate_payload"]

#: end-to-end deadline propagation: the cluster router stamps each
#: upstream hop with the request's REMAINING budget in milliseconds, so
#: the worker's admission deadline is the router's minus elapsed time —
#: never a second, fresh budget. A non-positive value answers 504
#: (code=deadline_exceeded) before the engine is touched.
DEADLINE_HEADER = "X-Request-Deadline"

# known routes for the http counter — anything else buckets under
# "other" so a scanner can't explode the label cardinality
_KNOWN_ROUTES = ("/health", "/metrics", "/metrics/cluster", "/v1/models",
                 "/v1/completions", "/v1/prefill", "/trace",
                 "/trace/chrome", "/debug/dump", "/debug/events",
                 "/timeseries", "/alerts", "/profile", "/profile/cluster",
                 "/kvstate", "/kvstate/cluster", "/audit", "/audit/cluster")

#: ``X-Audit: 1`` on a completions POST forces a shadow audit of that
#: request (the on-demand contract): the response's ``audit`` block
#: carries the verdict. Equivalent to body ``audit=true``.
AUDIT_HEADER = "X-Audit"


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def timeseries_payload(query: str) -> dict:
    """``GET /timeseries`` body: the process store's pinned-schema dump
    (optionally ``?metric=``-filtered and ``?window=``-bounded seconds)
    plus the store's own stats — the sparkline feed for
    scripts/watch_cluster.py."""
    from .observability import timeseries as _ts

    store = _ts.get_store()
    q = parse_qs(query)
    window = None
    if q.get("window"):
        try:
            window = float(q["window"][0])
        except ValueError:
            window = None
    metric = (q.get("metric") or [None])[0]
    payload = store.dump(window_s=window, name=metric)
    payload["stats"] = store.stats()
    return payload


def profile_payload(query: str = "") -> dict:
    """``GET /profile`` body: every registered engine's step anatomy —
    per-phase p50/p99/share over the recent window, roofline ratios and
    MFU, and the top-K slowest steps with their flight-recorder seqs
    (``?top=`` bounds K; docs/SERVING.md 'Step anatomy & roofline
    accounting')."""
    q = parse_qs(query)
    top_k = 5
    if q.get("top"):
        try:
            top_k = max(0, min(int(q["top"][0]), 64))
        except ValueError:
            top_k = 5
    return _perf.profile_payload(top_k)


def kvstate_payload(query: str = "") -> dict:
    """``GET /kvstate`` body: every registered engine's KV & memory
    atlas — pool occupancy/headroom, the per-slot page ledger, the
    prefix-reuse index, host-parked preemption bytes, the
    measured-vs-preflight capacity join, and the time-to-full forecast
    (docs/SERVING.md 'KV & memory atlas')."""
    del query  # no parameters yet; signature matches the payload peers
    return _kvatlas.kvstate_payload()


def alerts_payload(manager) -> dict:
    """``GET /alerts`` body for one AlertManager (None renders the
    disabled shape — same keys, so pollers never branch)."""
    if manager is None:
        return {"enabled": False, "manager": None, "firing": [],
                "alerts": [], "transitions": [], "transitions_total": 0}
    payload = manager.state()
    payload["enabled"] = True
    return payload


class _Submission:
    """One completions request on its way to the engine thread. (The JAX
    server's disaggregated tier also carries a KV bundle here; that tier,
    ``serving_cluster``, is not ported.)"""

    __slots__ = ("ids", "params", "events", "rid", "n", "rids",
                 "trace_ctx")

    def __init__(self, ids, params, n=1, trace_ctx=None):
        self.ids = ids
        self.params = params
        self.events: "queue.Queue" = queue.Queue()
        self.rid = None
        self.n = n          # OpenAI "n": sibling completions of one prompt
        self.rids = []
        self.trace_ctx = trace_ctx  # (trace_id, parent_span_id) | None


def _deadline_response(miss_note: str = "") -> dict:
    """The ONE body shape every deadline 504 answers with: ``code`` is
    how the cluster router tells a deadline-504 (terminal — forward
    verbatim, the budget is global) from a transport/handoff 504
    (retryable on another worker)."""
    return {"error": "request deadline exceeded" + miss_note,
            "code": "deadline_exceeded"}


def apply_deadline_header(handler, params) -> Optional[tuple]:
    """Fold an inbound X-Request-Deadline header (remaining budget, ms)
    into the request params: the header WINS over any body ``slo_ms``
    because it already accounts for time spent upstream. Returns a
    ``(status, body)`` error response when the header is malformed or
    the budget is already spent, else None."""
    hdr = handler.headers.get(DEADLINE_HEADER)
    if hdr is None:
        return None
    try:
        remaining_ms = float(hdr)
    except (TypeError, ValueError):
        return (400, {"error": f"invalid {DEADLINE_HEADER} header "
                               f"{hdr!r}: want remaining budget in ms"})
    if remaining_ms <= 0:
        return (504, _deadline_response(
            f" (budget spent {-remaining_ms:.0f}ms before admission)"))
    params["slo_ms"] = remaining_ms
    return None


class _Cancel:
    """Engine-thread command: cancel every engine request of a
    submission (a streaming client disconnected). Queued AFTER the
    submission it refers to, so by the time the engine thread sees it
    the rids are assigned (FIFO) — and cancel() ends the request's root
    span with status=cancelled."""

    __slots__ = ("sub",)

    def __init__(self, sub: _Submission):
        self.sub = sub


class EngineCommand:
    """A unit of work executed ON the engine thread (the only device-state
    toucher), with its result posted back to the waiting handler thread —
    how the cluster worker runs prefill exports without a second thread
    ever touching the page pool. Subclasses implement ``execute``."""

    def __init__(self):
        self.events: "queue.Queue" = queue.Queue()

    def execute(self, engine):
        raise NotImplementedError


class ServingHandlerBase(BaseHTTPRequestHandler):
    """The shared front-door handler skeleton: observability GET routes
    (/health, /metrics, /trace, /trace/chrome, /debug/*), W3C traceparent
    parse/echo around POSTs, the http counter, and chunked-SSE plumbing.

    Concrete servers subclass per instance (``class Handler(
    ServingHandlerBase): server_obj = self``) and customize through the
    ``server_obj`` hooks: ``_refresh_metrics`` / ``_health_payload`` /
    ``_models_payload`` / ``_post_handler`` / ``_extra_get`` — the
    CompletionServer serves an engine behind them, the cluster
    RouterServer a whole worker pool."""

    protocol_version = "HTTP/1.1"
    server_obj = None           # the owning server (set by the factory)
    known_routes = _KNOWN_ROUTES
    post_span_name = None       # default: http.request

    # the handler's POST span (None on GETs / when tracing is off);
    # responses echo its traceparent
    _trace_span = None

    def log_message(self, *a):  # silence request logging
        pass

    # ---- small shared plumbing ----------------------------------------
    def _count(self, code):
        route = urlsplit(self.path).path
        if route not in self.known_routes:
            route = "other"
        HTTP_REQUESTS.inc(path=route, code=str(code))

    def _send_traceparent(self):
        sp = self._trace_span
        if sp is not None and sp.trace_id:
            self.send_header(
                _tracing.TRACEPARENT_HEADER,
                _tracing.format_traceparent(sp.trace_id, sp.span_id))

    def _json(self, code, obj, headers=()):
        self._count(code)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self._send_traceparent()
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, payload: bytes):
        """One HTTP/1.1 chunked-encoding frame (the SSE write primitive)."""
        self.wfile.write(f"{len(payload):X}\r\n".encode()
                         + payload + b"\r\n")

    def _begin_sse(self):
        """Status + SSE headers for a streaming response; after this only
        ``_chunk`` writes are legal on the connection."""
        self._count(200)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self._send_traceparent()
        self.end_headers()

    def _trace_query(self, query):
        """?trace_id=... | ?rid=N[&engine=...] -> trace_id or
        None (unknown rid / malformed query)."""
        q = parse_qs(query)
        if q.get("trace_id"):
            return q["trace_id"][0]
        if q.get("rid"):
            try:
                rid = int(q["rid"][0])
            except ValueError:
                return None
            engine = (q.get("engine") or [None])[0]
            return self.server_obj._tracer.find_request_trace(
                rid, engine=engine)
        return None

    # ---- GET -----------------------------------------------------------
    def do_GET(self):
        # one handler instance serves a whole keep-alive
        # connection: drop any previous POST's span so GETs
        # don't echo a stale traceparent
        self._trace_span = None
        route, _, query = self.path.partition("?")
        if self._common_get(route, query):
            return
        if self.server_obj._extra_get(self, route, query):
            return
        self._json(404, {"error": "not found"})

    def _common_get(self, route, query) -> bool:
        srv = self.server_obj
        if route == "/trace":
            tid = self._trace_query(query)
            if tid is None:
                self._json(404, {
                    "error": "no trace: pass ?rid=<request id> "
                             "(finished or in flight) or "
                             "?trace_id=<32-hex id>"})
                return True
            # include_live: the POST handler's span ends only after its
            # response bytes hit the socket, so a caller chaining POST ->
            # GET /trace would otherwise race the handler thread and see
            # a tree missing its http.request node
            self._json(200, {
                "trace_id": tid,
                "spans": srv._tracer.spans(tid, include_live=True)})
            return True
        if route == "/trace/chrome":
            # chrome://tracing download
            tid = self._trace_query(query) if query else None
            if query and tid is None:
                self._json(404, {"error": "no such trace"})
                return True
            trace = srv._tracer.export_chrome(trace_id=tid)
            self._json(200, trace, headers=(
                ("Content-Disposition",
                 'attachment; filename="paddle_tpu_trace.json"'),))
            return True
        if route == "/debug/dump":
            # the incident bundle ON DEMAND (no crash needed):
            # event ring, spans, metrics, engine slot/queue
            # state, config, thread stacks. ?write=1 persists it
            # to the reporter's incident directory instead.
            rep = _frec.get_reporter()
            if parse_qs(query).get("write"):
                path = rep.dump("manual",
                                context="GET /debug/dump?write=1")
                self._json(200, {"path": path})
                return True
            _frec.RECORDER.record(_frec.EV_INCIDENT,
                                  reason="manual", path=None)
            self._json(200, rep.bundle("manual", context="GET /debug/dump"))
            return True
        if route == "/debug/events":
            q = parse_qs(query)
            try:
                since = int((q.get("since") or ["0"])[0])
                limit = int((q.get("limit") or ["500"])[0])
            except ValueError:
                self._json(400, {"error": "since/limit must be integers"})
                return True
            kind = (q.get("kind") or [None])[0]
            rec = _frec.get_recorder()
            evs = rec.events(since=since, kind=kind, limit=limit)
            self._json(200, {
                "events": evs,
                # resume cursor: pass back as ?since= to tail the
                # ring incrementally
                "next_since": (evs[-1]["seq"] if evs else since),
                "stats": rec.stats(),
            })
            return True
        if route == "/metrics":
            # refresh the occupancy gauges off ONE stats() snapshot,
            # then render the whole registry; counted BEFORE the render
            # so a scrape sees itself
            srv._refresh_metrics()
            self._count(200)
            body = get_registry().render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return True
        if route == "/timeseries":
            # the TSDB window dump: history for sparklines/debugging,
            # where /metrics is the point-in-time exposition
            self._json(200, srv._timeseries_payload(query))
            return True
        if route == "/alerts":
            self._json(200, srv._alerts_payload())
            return True
        if route == "/health":
            self._json(200, srv._health_payload())
            return True
        if route == "/v1/models":
            self._json(200, srv._models_payload())
            return True
        return False

    # ---- POST ----------------------------------------------------------
    def do_POST(self):
        # one span per POST (http.request here; router.request on the
        # cluster router), continuing the caller's trace when an inbound
        # W3C traceparent header is present; its context parents the
        # engine's serving.request root span
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_HTTP_REQUEST, method="POST",
                       path=self.path)
        ctx = _tracing.parse_traceparent(
            self.headers.get(_tracing.TRACEPARENT_HEADER))
        sp = self.server_obj._tracer.start_span(
            self.post_span_name or _tracing.SPAN_HTTP_REQUEST,
            trace_id=ctx[0] if ctx else None,
            parent_id=ctx[1] if ctx else None,
            attrs={"method": "POST", "path": self.path})
        self._trace_span = sp if sp else None
        try:
            self._post_inner()
        except BaseException:
            sp.end("error")
            raise
        sp.end()

    def _post_inner(self):
        # drain the body FIRST: replying without reading it would
        # desync a keep-alive connection (HTTP/1.1 is on), making
        # the next request parse the unread bytes as a request line
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
        except Exception:
            return self._json(400, {"error": "unreadable body"})
        route = urlsplit(self.path).path
        fn = self.server_obj._post_handler(route)
        if fn is None:
            return self._json(404, {"error": "not found"})
        try:
            req = json.loads(body or b"{}")
        except Exception:
            return self._json(400, {"error": "invalid JSON body"})
        return fn(self, req)


class CompletionServer:
    """HTTP wrapper around one ContinuousBatchEngine.

    ``tokenizer`` is optional and duck-typed (``encode(str) -> ids``,
    ``decode(ids) -> str`` — a transformers tokenizer works); without one
    the server speaks token ids (``prompt_token_ids`` in,
    ``token_ids`` out).
    """

    def __init__(self, engine, tokenizer=None, model_name: str = "paddle-tpu",
                 host: str = "127.0.0.1", port: int = 0,
                 enable_tracing: bool = True,
                 enable_flight_recorder: bool = True,
                 enable_timeseries: bool = True,
                 ts_interval_s: Optional[float] = None,
                 audit_rate: Optional[float] = None,
                 canary_interval_s: Optional[float] = None,
                 divergence_dir: Optional[str] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # the server IS a tracing subscriber (it serves /trace), so it
        # enables the process-wide tracer; pass enable_tracing=False to
        # keep the engine's guarded no-trace fast path
        if enable_tracing:
            _tracing.get_tracer().enable()
        self._tracer = _tracing.get_tracer()
        # likewise a flight-recorder subscriber (it serves /debug/*):
        # turn the black box on and let incident bundles see this
        # engine's slot/queue state
        if enable_flight_recorder:
            _frec.get_recorder().enable()
        # and a time-series subscriber (it serves /timeseries + /alerts):
        # start the process-wide ts-sampler and attach the default
        # SLO/burn-rate AlertManager — both process singletons, shared
        # by every server in the process like the tracer/recorder
        self._alert_mgr = None
        if enable_timeseries:
            from .observability import alerts as _alerts
            from .observability import timeseries as _ts

            _ts.get_store().start(interval_s=ts_interval_s)
            self._alert_mgr = _alerts.default_manager()
        _frec.get_reporter().register_engine(
            getattr(engine, "_engine_label", "engine"), engine)
        # and a step-anatomy subscriber (it serves /profile): enable the
        # engine's profiler — the guarded fast path only pays once a
        # subscriber exists, exactly like the tracer/recorder
        prof = getattr(engine, "profiler", None)
        if prof is not None:
            prof.enable()
        # the server also serves /kvstate: the KV & memory atlas gets a
        # subscriber the moment an HTTP front-end wraps the engine
        atlas = getattr(engine, "kvatlas", None)
        if atlas is not None:
            atlas.enable()
        # and /audit: the correctness sentinel wakes with the front-end.
        # audit_rate=0.0 (the default) still serves the on-demand
        # X-Audit contract — only SAMPLED shadow audits are off; the env
        # knobs let the cluster launcher arm sampling/canaries without
        # plumbing kwargs through every process entry
        self._sentinel = getattr(engine, "sentinel", None)
        if self._sentinel is not None:
            if audit_rate is None:
                audit_rate = _env_float("PDTPU_AUDIT_RATE")
            if canary_interval_s is None:
                canary_interval_s = _env_float("PDTPU_CANARY_INTERVAL_S")
            if divergence_dir is None:
                divergence_dir = os.environ.get("PDTPU_DIVERGENCE_DIR")
            self._sentinel.enable(audit_rate=audit_rate,
                                  canary_interval_s=canary_interval_s,
                                  divergence_dir=divergence_dir)
            self._sentinel.submitter = self._canary_submit
            self._sentinel.start()
        self._subs: "queue.Queue[_Submission]" = queue.Queue()
        self._stop = threading.Event()
        # the crash boundary: incident_scope writes the forensics bundle
        # and the death is visible (waiters time out against _stop)
        self._thread = threading.Thread(target=self._engine_loop,
                                        daemon=True, name="engine-loop")
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-loop")

    # ---- lifecycle ----------------------------------------------------
    @property
    def address(self):
        return self._httpd.server_address  # (host, port) — port resolved

    def start(self):
        self._thread.start()
        self._http_thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._sentinel is not None:
            # stop the audit worker FIRST: a canary submitted after the
            # engine loop exits would wait out its full timeout
            self._sentinel.stop()
            # and drop the canary runner: the process-wide sentinel
            # registry would otherwise keep this server and its engine
            self._sentinel.submitter = None
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ---- engine thread -------------------------------------------------
    def submit_command(self, cmd: EngineCommand, timeout: float = 120.0):
        """Run ``cmd`` on the engine thread and wait for its result;
        raises the error classes the POST paths map to 400/500."""
        self._subs.put(cmd)
        while True:
            try:
                kind, payload, _ = cmd.events.get(timeout=1.0)
            except queue.Empty:
                timeout -= 1.0
                if self._stop.is_set():
                    raise RuntimeError("engine stopped")
                if timeout <= 0:
                    raise TimeoutError("engine command timed out")
                continue
            if kind == "error":
                raise ValueError(payload)
            if kind == "fault":
                raise RuntimeError(payload)
            return payload

    def _handle_submission(self, sub):
        """Process one queue item ON the engine thread: a cancel command
        frees its submission's slots; an EngineCommand executes and posts
        its result; a submission becomes engine requests (add_request
        allocates host-side, admission happens inside step())."""
        eng = self.engine
        if isinstance(sub, _Cancel):
            for rid in sub.sub.rids:
                try:
                    eng.cancel(rid)
                except Exception:
                    # cancel() refills the freed slot (_admit): a failed
                    # refill must stop the loop like a failed step —
                    # waiting handlers time out against _stop, not hang
                    self._stop.set()
                    raise
            return
        if isinstance(sub, EngineCommand):
            try:
                sub.events.put(("ok", sub.execute(eng), True))
            except (ValueError, TypeError, NotImplementedError) as e:
                sub.events.put(("error", str(e), True))
            except Exception as e:    # engine fault -> HTTP 500
                sub.events.put(("fault", str(e), True))
            return
        ev = sub.events

        def on_token(rid, tok, done, logprob, _ev=ev):
            _ev.put(("token", (rid, tok, logprob), done))

        def on_shed(rid, info, _ev=ev):
            # the engine dropped a QUEUED request (deadline expired /
            # displaced at capacity): a typed event, so the waiting
            # handler answers 504/429 instead of stalling silently
            _ev.put(("shed", info, True))

        try:
            for _ in range(sub.n):
                sub.rids.append(
                    eng.add_request(sub.ids, on_token=on_token,
                                    trace_ctx=sub.trace_ctx,
                                    on_shed=on_shed, **sub.params))
            sub.rid = sub.rids[0]
        except DeadlineExceeded as e:
            # the budget was spent before submission (a deadline header
            # that expired in transit): typed 504, siblings cancelled
            for rid in sub.rids:
                eng.cancel(rid)
            ev.put(("shed", {"where": "expired", "error": str(e),
                             "miss_ms": e.miss_ms}, True))
        except QueueFull as e:
            # bounded admission queue -> HTTP 429 + Retry-After; siblings
            # of an n>1 request admitted before the bound hit are
            # cancelled (the client sees ONE atomic rejection)
            for rid in sub.rids:
                eng.cancel(rid)
            ev.put(("busy", {"error": str(e),
                             "retry_after": max(1, round(e.retry_after_s))},
                    True))
        except (ValueError, TypeError, NotImplementedError) as e:
            # client error (bad params, pixel_values to a
            # non-multimodal model, ...) -> HTTP 400
            ev.put(("error", str(e), True))
        except Exception as e:      # engine fault -> HTTP 500
            ev.put(("fault", str(e), True))

    def _engine_loop(self):
        # crash boundary: an escaping engine fault writes an incident
        # bundle (when a reporter is active) before the thread dies, and
        # a CUDA out-of-memory error re-raises enriched with the bundle
        # path — the operator gets forensics, not a bare traceback
        with _frec.incident_scope("serving.engine_loop"):
            self._engine_loop_inner()

    def _engine_loop_inner(self):
        eng = self.engine
        while not self._stop.is_set():
            # drain submissions (engine thread is the ONLY device-state
            # toucher)
            drained = False
            while True:
                try:
                    sub = self._subs.get_nowait()
                except queue.Empty:
                    break
                drained = True
                self._handle_submission(sub)
            if (eng.num_active or getattr(eng, "_queue", None)
                    or getattr(eng, "_chunking", None)):
                try:
                    eng.step()
                except Exception:
                    # a failed step (poisoned engine, device fault) must
                    # not hang clients: stop the loop; waiting handlers
                    # time out against _stop and answer 500
                    self._stop.set()
                    raise
            elif not drained:
                # idle: block briefly, then handle the submission
                # DIRECTLY — re-enqueueing at the tail would let a
                # steady trickle of newer submissions starve it
                try:
                    self._handle_submission(self._subs.get(timeout=0.05))
                except queue.Empty:
                    pass

    # ---- handler hooks --------------------------------------------------
    def _make_handler(server_self):
        class Handler(ServingHandlerBase):
            server_obj = server_self

        return Handler

    def _refresh_metrics(self):
        # one stats() snapshot refreshes the occupancy gauges
        self.engine.stats()

    def _health_payload(self) -> dict:
        eng = self.engine
        stats = eng.stats()
        # legacy top-level keys alias the SAME stats read (one
        # snapshot — a monitor must never see them disagree)
        payload = {
            "status": "ok",
            "active": stats["requests_active"],
            "queued": stats["requests_queued"],
            "max_batch": eng.max_batch,
            # the LIVE admission budget — < max_batch after an OOM
            # degrade (sched.degrade), so a balancer sees the reduced
            # capacity directly on /health
            "max_active_slots": stats.get("max_active_slots",
                                          eng.max_batch),
            "max_len": eng.max_len,
            "stats": stats,
        }
        payload.update(self.health_extra())
        return payload

    def health_extra(self) -> dict:
        """Extra /health keys (cluster workers add role / replica_id /
        lease age here)."""
        return {}

    def _models_payload(self) -> dict:
        return {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model"}],
        }

    def _timeseries_payload(self, query: str) -> dict:
        return timeseries_payload(query)

    def _alerts_payload(self) -> dict:
        return alerts_payload(self._alert_mgr)

    def _extra_get(self, handler, route, query) -> bool:
        if route == "/profile":
            handler._json(200, profile_payload(query))
            return True
        if route == "/kvstate":
            handler._json(200, kvstate_payload(query))
            return True
        if route == "/audit":
            handler._json(200, _sentinel.audit_payload())
            return True
        return False

    def _canary_submit(self, ids, max_new):
        """Sentinel-injected canary runner (audit-worker thread): the
        pinned prompt rides the REAL submission path — engine thread,
        live decode, every feature under test — with its own audit off;
        the sentinel compares against the pinned baseline itself.
        Returns (tokens, logprobs), or None when the engine can't take
        it right now (canaries only ever spend idle capacity)."""
        if self._stop.is_set():
            return None
        sub = _Submission([int(t) for t in np.asarray(ids).reshape(-1)],
                          dict(max_new_tokens=int(max_new), audit=False,
                               logprobs=True))
        self._subs.put(sub)
        toks, lps = [], []
        deadline = time.time() + 60.0
        while True:
            try:
                kind, payload, done = sub.events.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set() or time.time() > deadline:
                    return None
                continue
            if kind != "token":
                return None     # busy/shed/error: defer, never crash
            _rid, tok, lp = payload
            toks.append(int(tok))
            lps.append(float(lp))
            if done:
                return toks, lps

    def _post_handler(self, route):
        return self._complete if route == "/v1/completions" else None

    # ---- the completions POST -------------------------------------------
    def _parse_completion(self, req):
        """Request JSON -> (ids, params, n, want_logprobs); raises
        ValueError/TypeError on client errors (the 400 path)."""
        ids = self._prompt_ids(req)
        max_tokens = int(req.get("max_tokens", 16))
        if max_tokens < 1:
            # the engine checks budgets only post-append, so
            # max_tokens=0 would come back with ONE token —
            # reject here instead (OpenAI also 400s it)
            raise ValueError("max_tokens must be >= 1")
        params = dict(max_new_tokens=max_tokens)
        if ("temperature" in req or "top_p" in req
                or "top_k" in req or req.get("do_sample")):
            params.update(
                do_sample=True,
                temperature=float(req.get("temperature", 1.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 1.0)))
        stop = req.get("stop_token_ids")
        if stop is not None:
            params["stop_token_ids"] = [int(s) for s in stop]
        # SLO-aware scheduling: priority class (lower = more important)
        # and a per-request latency target, straight through to the
        # engine's admission queue (docs/SERVING.md "Scheduling & SLOs")
        if req.get("priority") is not None:
            params["priority"] = int(req["priority"])
        if req.get("slo_ms") is not None:
            slo = float(req["slo_ms"])
            if slo <= 0:
                raise ValueError("slo_ms must be > 0")
            params["slo_ms"] = slo
        # the caller's request identity (the cluster router stamps one
        # on every placement): what the engine's deathnote names, so a
        # poison request is blamed consistently across workers/retries
        if req.get("request_id") is not None:
            params["request_id"] = str(req["request_id"])
        # OpenAI "logprobs" is an int 0-5 (0 = chosen-token
        # logprobs, no alternatives) or a bool — False means
        # OFF, any other non-None value (0 included) is ON
        lp_req = req.get("logprobs")
        want_logprobs = (lp_req is not None and lp_req is not False)
        if want_logprobs:
            params["logprobs"] = True
        n = int(req.get("n", 1))
        if n < 1:
            raise ValueError("n must be >= 1")
        if n > 1 and req.get("stream"):
            raise ValueError("n > 1 does not combine with stream")
        if n > 1:
            # validate the EFFECTIVE sampling config (engine
            # defaults merged with request overrides) — n
            # deterministic completions would be identical
            eng_s, eng_t, _, _ = self.engine._sample_cfg
            eff_s = params.get("do_sample", eng_s)
            eff_t = params.get("temperature", eng_t)
            if not eff_s or eff_t <= 0:
                raise ValueError(
                    "n > 1 needs effective sampling "
                    "(do_sample with temperature > 0) — n "
                    "deterministic completions would be "
                    "identical")
        px = req.get("pixel_values")
        if px is not None:
            # a multimodal request: the same checks and the same 400 the
            # JAX engine gives a text model; the port serves text only
            arr = np.asarray(px, np.float32)
            if arr.ndim != 4:
                raise ValueError(
                    "pixel_values must be a nested list of "
                    "shape [n_images, C, H, W]")
            raise TypeError(
                f"{type(self.engine.model).__name__} is not multimodal — "
                "pixel_values needs a model implementing "
                "merge_multimodal / multimodal_token_index / "
                "features_per_image (LLaVA)")
        return ids, params, n, want_logprobs

    def _complete(self, handler, req):
        try:
            ids, params, n, want_logprobs = self._parse_completion(req)
        except (ValueError, TypeError) as e:
            # wrong-typed fields answer 400, not a dropped socket
            return handler._json(400, {"error": str(e)})
        # the on-demand audit contract: X-Audit: 1 (or body audit=true)
        # guarantees a shadow audit whose verdict block rides the
        # response next to usage — docs/SERVING.md "Correctness sentinel"
        hdr = (handler.headers.get(AUDIT_HEADER) or "").strip().lower()
        want_audit = bool(req.get("audit")) or hdr in ("1", "true")
        if want_audit:
            params["audit"] = True
        err = apply_deadline_header(handler, params)
        if err is not None:
            return handler._json(*err)
        sp = handler._trace_span
        sub = _Submission(ids, params, n=n,
                          trace_ctx=((sp.trace_id, sp.span_id)
                                     if sp is not None else None))
        self._subs.put(sub)
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if req.get("stream"):
            return self._stream(handler, sub, cid, want_logprobs,
                                want_audit=want_audit)
        return self._collect(handler, sub, cid, len(ids), want_logprobs,
                             want_audit=want_audit)

    def _collect(self, handler, sub, cid, n_prompt, want_logprobs,
                 want_audit=False):
        """Batch (non-stream) response: wait for every token event, then
        answer one completion object."""
        by_rid, lps_by_rid, err = {}, {}, None
        finished = 0
        while True:
            try:
                kind, payload, done = sub.events.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    return handler._json(500, {"error": "engine stopped"})
                continue
            if kind == "busy":
                # bounded admission queue: backpressure, not failure —
                # the client should retry after the hinted delay
                return handler._json(
                    429, {"error": payload["error"]},
                    headers=(("Retry-After", str(payload["retry_after"])),))
            if kind == "shed":
                # the engine dropped this request from its queue:
                # siblings of an n>1 submission are cancelled (one
                # atomic answer), and the status is typed — 429 for a
                # capacity displacement or an OOM degrade (both
                # retryable backpressure; the degrade 429 carries
                # code=engine_degraded), 504 for a spent deadline
                # (terminal)
                self._subs.put(_Cancel(sub))
                if payload.get("where") in ("capacity", "oom"):
                    ra = max(1, round(float(payload.get("retry_after",
                                                        1.0))))
                    body = {"error": payload["error"]}
                    if payload["where"] == "oom":
                        body["code"] = "engine_degraded"
                    return handler._json(
                        429, body,
                        headers=(("Retry-After", str(ra)),))
                return handler._json(
                    504, {"error": payload["error"],
                          "code": "deadline_exceeded"})
            if kind in ("error", "fault"):
                err = (kind, payload)
                break
            rid, tok, lp = payload
            by_rid.setdefault(rid, []).append(int(tok))
            lps_by_rid.setdefault(rid, []).append(float(lp))
            if done:
                finished += 1
                if finished == sub.n:
                    break
        if err is not None:
            kind, msg = err
            return handler._json(400 if kind == "error" else 500,
                                 {"error": msg})
        choices = []
        total_completion = 0
        for i, rid in enumerate(sub.rids):
            toks = by_rid.get(rid, [])
            total_completion += len(toks)
            # single source of truth: the ENGINE records why each
            # request retired (recorded before its done event)
            choice = {"index": i,
                      "finish_reason": (self.engine.finish_reason(rid)
                                        or "length"),
                      "token_ids": toks}
            if want_logprobs:
                choice["logprobs"] = {
                    "token_logprobs": lps_by_rid.get(rid, [])}
            if self.tokenizer is not None:
                choice["text"] = self.tokenizer.decode(toks)
            choices.append(choice)
        usage = {"prompt_tokens": n_prompt,
                 "completion_tokens": total_completion,
                 "total_tokens": n_prompt + total_completion}
        usage.update(self._usage_extras(sub.rids))
        body = {
            "id": cid, "object": "text_completion",
            "model": self.model_name,
            "choices": choices,
            "usage": usage,
        }
        if want_audit:
            body["audit"] = self._audit_block(sub.rids)
        return handler._json(200, body)

    def _audit_block(self, rids) -> dict:
        """The ``audit`` response field of a force-audited request:
        block (bounded) for each rid's verdict and report the worst —
        diverged beats skipped beats pass. An on-demand audit is never
        silently absent: a disabled sentinel or a timed-out wait still
        answers a typed ``skipped`` verdict."""
        sn = self._sentinel
        if sn is None or not sn.enabled:
            return {"verdict": "skipped", "reason": "disabled"}
        vs = [v for v in (sn.wait_verdict(r) for r in rids)
              if v is not None]
        if not vs:
            return {"verdict": "skipped", "reason": "timeout"}
        worst = next((v for v in vs if v["verdict"] == "diverged"),
                     next((v for v in vs if v["verdict"] == "skipped"),
                          vs[0]))
        out = {k: worst.get(k)
               for k in ("verdict", "reason", "source",
                         "first_divergence", "logprob_drift")}
        if worst.get("bundle"):
            out["bundle"] = worst["bundle"]
        return out

    def _usage_extras(self, rids) -> dict:
        """Per-request cost accounting from the engine's retention
        window (queue vs compute milliseconds, fused dispatches ridden,
        tokens retired per dispatch). Across an n>1 submission the
        dispatches sum and the wall-clock fields take the max — the
        siblings decode concurrently. Empty when every rid already left
        the engine's retention window."""
        rows = [u for u in (self.engine.request_usage(r) for r in rids)
                if u is not None]
        if not rows:
            return {}
        disp = sum(u["dispatches"] for u in rows)
        n_tok = sum(u["completion_tokens"] for u in rows)
        return {
            "queue_ms": round(max(u["queue_ms"] for u in rows), 3),
            "compute_ms": round(max(u["compute_ms"] for u in rows), 3),
            "dispatches": disp,
            "accepted_tokens_per_dispatch": round(
                n_tok / disp if disp else 0.0, 4),
        }

    def _stream(self, handler, sub, cid, want_logprobs=False,
                want_audit=False):
        # the SSE status line is DEFERRED to the first event: a rejected
        # admission (bounded queue -> 429 + Retry-After) or a client
        # error (-> 400) still gets a real status code instead of an
        # error chunk inside a 200 stream. Once token bytes are on the
        # wire, failures become in-stream error events (no [DONE]).
        try:
            started = False
            clean = True
            while True:
                try:
                    kind, payload, done = sub.events.get(timeout=1.0)
                except queue.Empty:
                    if self._stop.is_set():
                        if not started:
                            return handler._json(
                                500, {"error": "engine stopped"})
                        handler._chunk(b'data: '
                                       b'{"error": "engine stopped"}\n\n')
                        clean = False
                        break
                    continue
                if kind == "busy":
                    # admission precedes tokens, so busy only ever
                    # arrives before the stream starts
                    return handler._json(
                        429, {"error": payload["error"]},
                        headers=(("Retry-After",
                                  str(payload["retry_after"])),))
                if kind == "shed":
                    # usually pre-admission (real 429/504 status line);
                    # a preempted-then-requeued stream can shed AFTER
                    # tokens flowed — then it ends with a typed error
                    # chunk and no [DONE]
                    if not started:
                        if payload.get("where") in ("capacity", "oom"):
                            ra = max(1, round(float(
                                payload.get("retry_after", 1.0))))
                            body = {"error": payload["error"]}
                            if payload["where"] == "oom":
                                body["code"] = "engine_degraded"
                            return handler._json(
                                429, body,
                                headers=(("Retry-After", str(ra)),))
                        return handler._json(
                            504, {"error": payload["error"],
                                  "code": "deadline_exceeded"})
                    handler._chunk(
                        b"data: "
                        + json.dumps(dict(_deadline_response(),
                                          shed=payload.get("where"))
                                     ).encode() + b"\n\n")
                    clean = False
                    break
                if kind in ("error", "fault"):
                    if not started:
                        return handler._json(
                            400 if kind == "error" else 500,
                            {"error": str(payload)})
                    handler._chunk(b'data: {"error": '
                                   + json.dumps(str(payload)).encode()
                                   + b"}\n\n")
                    clean = False
                    break
                if not started:
                    handler._begin_sse()
                    started = True
                _rid, tok, lp = payload
                piece = {"id": cid, "object": "text_completion",
                         "choices": [{"index": 0,
                                      "token_ids": [int(tok)]}]}
                if want_logprobs:
                    piece["choices"][0]["logprobs"] = {
                        "token_logprobs": [float(lp)]}
                if self.tokenizer is not None:
                    piece["choices"][0]["text"] = (
                        self.tokenizer.decode([int(tok)]))
                if done:
                    # the final pre-[DONE] payload carries the usage
                    # block (token counts + the engine's cost
                    # accounting, same shape as the non-stream
                    # response's usage field) ON the last token chunk
                    # rather than in an extra empty-choices event —
                    # clients that index choices[0] on every event
                    # keep working unmodified
                    rows = [u for u in (self.engine.request_usage(r)
                                        for r in sub.rids)
                            if u is not None]
                    if rows:
                        n_tok = sum(u["completion_tokens"] for u in rows)
                        piece["usage"] = {
                            "prompt_tokens": rows[0]["prompt_tokens"],
                            "completion_tokens": n_tok,
                            "total_tokens": (rows[0]["prompt_tokens"]
                                             + n_tok)}
                        piece["usage"].update(
                            self._usage_extras(sub.rids))
                    if want_audit:
                        # the final usage chunk carries the on-demand
                        # audit verdict, same shape as the non-stream
                        # response's audit field
                        piece["audit"] = self._audit_block(sub.rids)
                handler._chunk(b"data: " + json.dumps(piece).encode()
                               + b"\n\n")
                if done:
                    break
            if clean:
                # [DONE] signals CLEAN completion only — an SSE
                # client watching for it must not mistake a failed
                # stream for success
                handler._chunk(b"data: [DONE]\n\n")
            handler._chunk(b"")  # chunked-encoding terminator
        except OSError:
            # client went away mid-stream (BrokenPipeError /
            # reset): the engine must not keep decoding into a
            # dead socket — enqueue a cancel command to the
            # engine thread (it owns all device state), which
            # frees the slot(s) immediately and ends the
            # request's root span with status=cancelled
            self._subs.put(_Cancel(sub))
            if handler._trace_span is not None:
                handler._trace_span.set_attr("client_disconnected", True)
            handler.close_connection = True

    def _prompt_ids(self, req):
        if "prompt_token_ids" in req:
            ids = req["prompt_token_ids"]
            if (not isinstance(ids, list)
                    or not all(isinstance(i, int) for i in ids)):
                raise ValueError("prompt_token_ids must be a list of ints")
            return ids
        prompt = req.get("prompt")
        if prompt is None:
            raise ValueError("provide prompt or prompt_token_ids")
        if self.tokenizer is None:
            raise ValueError(
                "string prompts need the server constructed with a "
                "tokenizer; send prompt_token_ids instead")
        return list(self.tokenizer.encode(prompt))


def serve(model, *, max_batch=8, max_len=512, page_size=16, tokenizer=None,
          host="127.0.0.1", port=8000, **engine_kwargs):
    """One-call deployment: build the engine over ``model`` (on the card
    its weights lie on: ``device="cuda"`` when built, or ``"cpu"`` for the
    plain versions), start the server, block.

    >>> from paddle_tpu_torch.serving_http import serve
    >>> serve(model, tokenizer=tok, port=8000)      # doctest: +SKIP
    """
    from .serving import ContinuousBatchEngine

    eng = ContinuousBatchEngine(model, max_batch=max_batch, max_len=max_len,
                                page_size=page_size, **engine_kwargs)
    srv = CompletionServer(eng, tokenizer=tokenizer, host=host, port=port)
    srv.start()
    try:
        srv._http_thread.join()
    except KeyboardInterrupt:
        srv.close()
    return srv
