"""Flight recorder & incident forensics: the serving stack's black box.
The port's copy of ``paddle_tpu/observability/flightrecorder.py``: the
same event catalog and bundle schema, with a CUDA out-of-memory error
(``torch.cuda.OutOfMemoryError``) where the JAX package classifies XLA's
``RESOURCE_EXHAUSTED``.

The metrics say how the fleet is doing and the traces say where one
request spent its time — but both live in process memory, so when the
process OOMs, deadlocks, or is SIGTERM'd mid-decode they die with it and
the operator gets a bare traceback. This module is the post-mortem
layer (the "black box" pattern of large-scale serving systems — cf.
Orca's engine-state dumps and Megatron-LM's per-rank hang diagnostics):

- :class:`FlightRecorder` — a process-wide, lock-cheap bounded ring of
  timestamped structured events (engine admit/cancel/slot-free
  decisions, kv page pressure, queue depths, compile durations,
  collective begin/end, rank heartbeats, watchdog stalls). Cheap enough
  to be always-on: one dict build + deque append per event, and ZERO
  cost when disabled — every emit site guards on one attribute
  (``recorder.enabled``), exactly like the Tracer's fast path.
- :class:`IncidentReporter` — on unhandled exception, fatal signal
  (SIGTERM via a signal handler, SIGABRT via ``faulthandler``), a CUDA
  OOM (classified and re-raised enriched as :class:`CudaOom`), or a
  watchdog-declared stall, atomically writes a rank-suffixed incident
  bundle: the event ring, live+recent spans, a metrics snapshot, engine
  slot/queue state, config/versions, and every thread's stack.

The bundle is served live through ``GET /debug/dump`` and the ring
through ``GET /debug/events?since=`` on the HTTP server;
``scripts/read_incident.py`` pretty-prints a bundle on disk.

Event kinds are a catalog (``EVENT_CATALOG``) like the span catalog:
docs/SERVING.md documents exactly these names and the ``event-catalog``
pdlint rule asserts both directions plus that every kind is actually
emitted outside this module.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal as _signal
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Dict, List, Optional

import torch

__all__ = [
    "FlightRecorder", "IncidentReporter", "CudaOom",
    "get_recorder", "get_reporter", "install_reporter", "incident_scope",
    "classify_exception", "validate_bundle",
    "EVENT_CATALOG", "BUNDLE_SCHEMA_VERSION", "BUNDLE_SCHEMA",
]

# ---- event catalog ----------------------------------------------------------
# The contract surface, mirroring the span catalog: docs/SERVING.md
# documents exactly these kinds (the event-catalog pdlint rule asserts
# both directions and that each kind is emitted outside this module).
# Record events through these constants — an ad-hoc string would dodge
# the lint and drift out of the docs.

EVENT_CATALOG: Dict[str, str] = {}


def _register(kind: str, desc: str) -> str:
    EVENT_CATALOG[kind] = desc
    return kind


EV_SUBMIT = _register(
    "engine.submit",
    "request queued (rid, engine, prompt_tokens, max_new_tokens, "
    "queue_depth)")
EV_ADMIT = _register(
    "engine.admit",
    "request took a slot (rid, engine, slot, queue_wait_s, free_slots)")
EV_STEP = _register(
    "engine.step",
    "one fused decode dispatch for all active slots (engine, active, "
    "seconds) — 1 event per step, not per token")
EV_SLOT_FREE = _register(
    "engine.slot_free",
    "slot released at finish or cancel (rid, engine, slot, status, "
    "generated)")
EV_CANCEL = _register(
    "engine.cancel",
    "cancel processed by the engine (rid, engine, where=queued|active)")
EV_PAGE_PRESSURE = _register(
    "engine.page_pressure",
    "kv page-pool pressure sampled at admission (engine, pages_used, "
    "pages_total, free_slots)")
EV_HTTP_REQUEST = _register(
    "http.request",
    "inbound POST on the serving front-end (method, path)")
EV_COMPILE = _register(
    "jit.compile",
    "one XLA backend compile (event, seconds) — recorded via the "
    "jax.monitoring hook installed by paddle_tpu.jit when the recorder "
    "enables; start = mono_ns - seconds")
EV_COLLECTIVE_BEGIN = _register(
    "collective.begin",
    "host-side collective entered (op, multiprocess) — an unmatched "
    "begin in a bundle is the hang")
EV_COLLECTIVE_END = _register(
    "collective.end",
    "host-side collective returned (op, seconds)")
EV_HEARTBEAT = _register(
    "rank.heartbeat",
    "watchdog progress stamp (name, tag) — gaps localise the stall")
EV_STALL = _register(
    "watchdog.stall",
    "watchdog declared no-progress (name, age_s, timeout_s); triggers "
    "an incident bundle when a reporter is active")
EV_TRAIN_STEP = _register(
    "train.step",
    "one train-loop step recorded by StepTimer (step, seconds)")
EV_INCIDENT = _register(
    "incident.dump",
    "an incident bundle was written or served (reason, path)")
EV_ROUTER_PLACE = _register(
    "router.place",
    "the cluster router placed a request on a worker (replica_id, role, "
    "score, attempt, mode=direct|disagg)")
EV_ROUTER_RETRY = _register(
    "router.retry",
    "a placement failed and the request was requeued onto another "
    "worker (replica_id, attempt, delivered, reason)")
EV_ROUTER_WORKER_JOIN = _register(
    "router.worker_join",
    "a worker's lease + metadata appeared in the pool (replica_id, "
    "role, url)")
EV_ROUTER_WORKER_LOST = _register(
    "router.worker_lost",
    "a worker left the pool (replica_id, reason=lease|connection) — "
    "its in-flight requests requeue through router.retry")
EV_KV_HANDOFF_SEND = _register(
    "kv.handoff_send",
    "a prefill worker shipped a finished prompt's KV pages to a decode "
    "worker (handoff_id, channel, prompt_tokens, bytes)")
EV_KV_HANDOFF_RECV = _register(
    "kv.handoff_recv",
    "a decode worker received a prefilled-KV bundle off its handoff "
    "channel (handoff_id, channel, prompt_tokens, bytes)")
EV_AUTOTUNE_SWEEP = _register(
    "autotune.sweep",
    "one autotune geometry sweep completed (kernel, key, choice, ms, "
    "measured, failed, pruned) — the winner now persisted in the cost "
    "table")
EV_FUSED_STEP = _register(
    "kernel.fused_step",
    "the fused decode-tail Pallas path activated for a layer shape "
    "(kernel, batch, hidden, heads, kv_heads, head_dim, layout) — once "
    "per shape, not per step")
EV_AUTOSHARD = _register(
    "preflight.autoshard",
    "the auto-sharding solver chose a plan at engine preflight (model, "
    "feasible, cost, per_device_bytes, reshard_bytes, plans_considered, "
    "assignment) — the full plan + rejected ledger ride the "
    "PreflightReport")
EV_SCHED_CHUNK = _register(
    "sched.chunk",
    "the scheduler advanced one prefill chunk for an admitted request "
    "(rid, engine, slot, pos, tokens, final, seconds) — between chunks "
    "live slots run a normal decode step, so pos traces the bounded-"
    "stall interleave")
EV_SCHED_PREEMPT = _register(
    "sched.preempt",
    "the scheduler evicted a low-priority slot's KV pages to host "
    "memory and requeued the request with its generated tokens intact "
    "(rid, engine, slot, kv_len, generated, bytes, priority, "
    "by_priority)")
EV_SCHED_RESTORE = _register(
    "sched.restore",
    "a preempted request re-took a slot: its host-side KV bundle was "
    "scattered back into the page pool and decode resumed (rid, engine, "
    "slot, kv_len, generated)")
EV_SCHED_SHED = _register(
    "sched.shed",
    "admission shed a queued request (rid, engine, priority, "
    "where=expired|unmeetable|capacity, miss_ms, queue_depth) — "
    "expired/unmeetable deadlines count serving_deadline_misses_total "
    "and answer HTTP 504; capacity sheds displace the least-important "
    "queued work when a strictly more important request arrives at a "
    "full bounded queue (the victim answers 429)")
EV_SPEC_PROPOSE = _register(
    "sched.spec_propose",
    "the engine's host drafter proposed speculative tokens for one "
    "multi-token decode dispatch (engine, active, k, drafted) — drafted "
    "counts n-gram-lookup tokens actually proposed across slots; slots "
    "with no history match ride the dispatch with padding")
EV_SPEC_VERIFY = _register(
    "sched.spec_verify",
    "one batched speculative verify dispatch scored every active slot's "
    "proposal chunk (engine, active, k, seconds) — 1 event per dispatch "
    "like engine.step, not per token")
EV_SPEC_ACCEPT = _register(
    "sched.spec_accept",
    "acceptance outcome of one speculative verify dispatch (engine, "
    "accepted, emitted, rate) — accepted counts draft tokens that "
    "matched the target's greedy choice, emitted the tokens retired "
    "(accepted + one verified token per slot), rate = accepted / "
    "proposed")
EV_SCHED_MIGRATE_OUT = _register(
    "sched.migrate_out",
    "a live slot was exported for migration: KV pages + last-logit row "
    "+ sampling state + delivered-token count serialized to a checksummed "
    "host bundle and the slot freed (rid, engine, slot, kv_len, "
    "generated, bytes)")
EV_SCHED_MIGRATE_IN = _register(
    "sched.migrate_in",
    "a migrated request was admitted: the bundle's KV scattered back "
    "through the restore path and decode resumed mid-stream (rid, "
    "engine, generated, kv_len, prompt_tokens)")
EV_CHAOS = _register(
    "chaos.inject",
    "a planned fault fired at a chaos injection point (point, action, "
    "nth, scope, detail) — written by the injector itself, so incident "
    "bundles separate injected fault from observed symptom")
EV_SUP_RESTART = _register(
    "sup.restart",
    "the worker supervisor observed a worker process die and scheduled "
    "its restart (replica_id, incarnation, exit_code, delay_s) — the "
    "respawn reuses the same role/replica_id and registers a fresh "
    "lease, so the pool heals to full strength without an operator")
EV_SUP_BREAKER = _register(
    "sup.breaker_open",
    "a worker's restart circuit breaker tripped OPEN (replica_id, "
    "restarts, window_s): more than the budgeted restarts inside the "
    "sliding window — the supervisor holds the worker down and the "
    "router /health reports degraded capacity until an operator resets")
EV_SCHED_QUARANTINE = _register(
    "sched.quarantine",
    "a request id crossed the poison-quarantine threshold (rid, "
    "deaths, replicas): implicated by deathnote/journal blame in >= 2 "
    "distinct worker deaths — the router answers it 422 "
    "code=request_quarantined and never retries it")
EV_SCHED_DEGRADE = _register(
    "sched.degrade",
    "the engine caught a device OOM during admission/step and degraded "
    "instead of dying (engine, rid, where, max_active_slots, previous):"
    " the triggering request was shed typed and max_active_slots "
    "durably shrank (floor 1), so preflight admission sees the reduced "
    "budget")
EV_ALERT_FIRE = _register(
    "alert.fire",
    "an SLO alert crossed pending->firing (alert, manager, severity, "
    "state_from, detail) — the objective's condition held for its full "
    "for_s hold; detail carries the burn rates / threshold value that "
    "fired it")
EV_ALERT_RESOLVE = _register(
    "alert.resolve",
    "a firing SLO alert resolved (alert, manager, severity, "
    "state_from, detail): the condition stayed clean for the "
    "objective's resolve_s hold — flaps shorter than the hold never "
    "produce this pair")
EV_LOCK_ORDER = _register(
    "lock.order_violation",
    "the runtime lock-order witness (FLAGS_lock_witness) observed an "
    "acquisition order that inverts an earlier observation or "
    "contradicts the static lock graph "
    "(violation=inversion|static_conflict, held, acquired, thread) — "
    "the full stacks ride bundle['lock_witness']")
EV_PERF_ROOFLINE = _register(
    "perf.roofline",
    "the step-anatomy profiler persisted a roofline observation into "
    "the autotune cost table (engine, measured_ms, predicted_ms, ratio, "
    "mfu) — one (signature, measured, predicted) training row for a "
    "later learned cost-model fit; see docs/SERVING.md 'Step anatomy & "
    "roofline accounting'")
EV_AUDIT_PASS = _register(
    "audit.pass",
    "a correctness-sentinel audit replayed the request on the "
    "reference path and matched token-for-token (rid, source="
    "shadow|ondemand|canary, n_tokens, drift = max per-position "
    "logprob delta)")
EV_AUDIT_DIVERGE = _register(
    "audit.diverge",
    "a correctness-sentinel audit DIVERGED from the reference path "
    "(rid, source, first_divergence = token index of the first "
    "mismatch, drift) — a sealed paddle_tpu.divergence/1 bundle was "
    "captured; replay it with scripts/replay_divergence.py")
EV_AUDIT_SKIP = _register(
    "audit.skip",
    "a correctness-sentinel audit was shed instead of run (rid, "
    "reason=queue_full|load|headroom|sampling|reason|unsupported) — "
    "skips are counted, never silent, so audit coverage is auditable")


# ---- the ring ---------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of structured events with monotonically increasing
    ``seq`` numbers (so ``/debug/events?since=`` is well-defined).

    Disabled is the default and costs nothing: hot call sites guard on
    ``recorder.enabled`` (one attribute read) before building any
    kwargs; :meth:`record` itself re-checks so unguarded cold sites stay
    correct. Enabled cost is one dict build + deque append under a lock
    plus one counter inc — microseconds against a multi-ms decode step.
    """

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(capacity))
        self._seq = 0
        self._n_dropped = 0
        self._m_events: Dict[str, object] = {}
        self.enabled = False

    # ---- lifecycle -----------------------------------------------------
    def enable(self) -> "FlightRecorder":
        """Turn recording on. (The JAX package also hooks its compile
        events here; the port records no ``jit.compile`` event: a step
        unit's captures are counted on the unit, ``jit/cuda_graph.py``.)"""
        self.enabled = True
        return self

    def disable(self) -> "FlightRecorder":
        self.enabled = False
        return self

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def __len__(self):
        with self._lock:
            return len(self._buf)

    def clear(self):
        """Drop every event and reset drop accounting (test isolation);
        ``seq`` keeps counting so ``since=`` cursors stay valid."""
        with self._lock:
            self._buf.clear()
            self._n_dropped = 0

    # ---- recording -----------------------------------------------------
    def record(self, kind: str, **fields):
        """Append one event. Reserved keys (seq/ts/mono_ns/kind/tid) win
        over same-named fields. Returns the event's seq (0 if disabled)."""
        if not self.enabled:
            return 0
        rec = dict(fields)
        rec["kind"] = kind
        rec["ts"] = time.time()
        rec["mono_ns"] = time.perf_counter_ns()
        rec["tid"] = threading.get_ident()
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._buf) == self._buf.maxlen:
                self._n_dropped += 1
            self._buf.append(rec)
            m = self._m_events.get(kind)
        if m is None:
            from . import catalog as _cat

            m = _cat.FLIGHTRECORDER_EVENTS.labels(kind=kind)
            with self._lock:
                self._m_events[kind] = m
        m.inc()
        return rec["seq"]

    # ---- queries -------------------------------------------------------
    def events(self, since: int = 0, kind: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Events with ``seq > since`` (oldest first), optionally one
        kind or a ``subsystem.`` prefix (``kind="engine"`` matches every
        ``engine.*`` event); ``limit`` keeps the LAST n."""
        with self._lock:
            recs = list(self._buf)
        if since:
            recs = [r for r in recs if r["seq"] > int(since)]
        if kind is not None:
            recs = [r for r in recs
                    if r["kind"] == kind
                    or r["kind"].startswith(kind + ".")]
        if limit is not None and len(recs) > int(limit):
            recs = recs[-int(limit):]
        return recs

    def drain(self) -> List[dict]:
        """Remove and return every buffered event (oldest first)."""
        with self._lock:
            recs = list(self._buf)
            self._buf.clear()
        return recs

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "capacity": self._buf.maxlen,
                    "buffered": len(self._buf), "recorded": self._seq,
                    "dropped": self._n_dropped}


# ---- CUDA OOM classification ------------------------------------------------

class CudaOom(torch.cuda.OutOfMemoryError):
    """A CUDA out-of-memory error re-raised with forensics attached —
    ``bundle_path`` points at the incident bundle written at the moment
    of failure (None when no reporter was active). A subclass of
    ``torch.cuda.OutOfMemoryError``, so every handler of the original
    class (the engine's OOM degrade) still catches it, as the JAX
    package's ``XlaOom`` is caught where its OOM is."""

    def __init__(self, message: str, bundle_path: Optional[str] = None):
        super().__init__(message)
        self.bundle_path = bundle_path


def classify_exception(exc: BaseException) -> Optional[str]:
    """``"cuda_oom"`` for ``torch.cuda.OutOfMemoryError`` or another
    error whose message says the device ran out of memory (a CUDA
    library's allocation failure arrives as a plain RuntimeError), None
    for everything else."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "cuda_oom"
    if "out of memory" in f"{type(exc).__name__}: {exc}".lower():
        return "cuda_oom"
    return None


def _enrich_oom(exc: BaseException, bundle_path: Optional[str],
                context: str) -> CudaOom:
    mem = ""
    # the allocator's host-side counters only, and only once CUDA is up:
    # a crash dump must never be the thing that initialises the device
    if torch.cuda.is_initialized():
        mem = (f"; device mem {torch.cuda.memory_allocated()} B live / "
               f"{torch.cuda.max_memory_allocated()} B peak")
    where = f"; incident bundle: {bundle_path}" if bundle_path else ""
    return CudaOom(
        f"CUDA out of memory during {context}: {exc}{mem}{where}",
        bundle_path)


# ---- incident bundles -------------------------------------------------------

BUNDLE_SCHEMA_VERSION = "paddle_tpu.incident/1"

# the pinned schema: key -> allowed types (None marks nullable). The
# forced-crash acceptance test and scripts/read_incident.py both
# validate against THIS dict, so producers and consumers can't drift.
BUNDLE_SCHEMA = {
    "schema": (str,),
    "reason": (str,),
    "context": (str, type(None)),
    "ts": (int, float),
    "pid": (int,),
    "rank": (int, type(None)),
    "host": (str,),
    "exception": (dict, type(None)),
    "recorder": (dict,),
    "events": (list,),
    "spans": (list,),
    "metrics": (dict,),
    "engines": (dict,),
    "config": (dict,),
    "threads": (list,),
    # the JAX package's runtime lock-order witness report; the port has
    # no witness, so its bundles carry None here
    "lock_witness": (dict, type(None)),
    # the recent TSDB window (paddle_tpu.timeseries/1 dump; None when
    # the time-series store never sampled) — an incident reader sees
    # the minutes BEFORE the crash, not just the terminal snapshot
    "timeseries": (dict, type(None)),
    # every live AlertManager's state + bounded transition history
    # (None when no manager exists)
    "alerts": (dict, type(None)),
    # the step-anatomy profile (perf.profile_payload(); None when no
    # engine ever registered a profiler) — per-phase p50/p99, roofline
    # ratios, and the top-K slowest recent steps at crash time
    "profile": (dict, type(None)),
    # the KV & memory atlas (kvatlas.kvstate_payload(); None when no
    # engine ever registered an atlas) — pool occupancy, per-slot page
    # ledger, host-parked preemption bytes and the prefix-reuse index
    # at crash time: the memory story behind an OOM incident
    "kvstate": (dict, type(None)),
    # the correctness sentinel (sentinel.audit_payload(); None when no
    # engine ever registered a sentinel) — audit verdict counters,
    # canary fingerprint/results and recent divergence bundle paths at
    # crash time: was the model already producing wrong tokens?
    "audit": (dict, type(None)),
}

_EVENT_KEYS = ("seq", "ts", "mono_ns", "kind", "tid")

# keys added after paddle_tpu.incident/1 shipped: producers always emit
# them, but a reader must keep accepting bundles written before they
# existed (the version string is unchanged — the addition is additive)
_OPTIONAL_KEYS = frozenset({"lock_witness", "timeseries", "alerts",
                            "profile", "kvstate", "audit"})


def validate_bundle(bundle: dict) -> dict:
    """Assert ``bundle`` matches :data:`BUNDLE_SCHEMA` (and each event
    carries the reserved keys); raises ValueError naming every problem,
    returns the bundle unchanged when clean."""
    problems = []
    for key, types in BUNDLE_SCHEMA.items():
        if key not in bundle:
            if key not in _OPTIONAL_KEYS:
                problems.append(f"missing key: {key}")
        elif not isinstance(bundle[key], types):
            problems.append(
                f"key {key}: expected {'/'.join(t.__name__ for t in types)},"
                f" got {type(bundle[key]).__name__}")
    if bundle.get("schema") not in (None, BUNDLE_SCHEMA_VERSION):
        problems.append(f"unknown schema {bundle.get('schema')!r} "
                        f"(this reader speaks {BUNDLE_SCHEMA_VERSION})")
    for i, ev in enumerate(bundle.get("events") or []):
        missing = [k for k in _EVENT_KEYS if k not in ev]
        if missing:
            problems.append(f"event[{i}] missing {missing}")
            break  # one malformed event is enough to report
    if problems:
        raise ValueError("invalid incident bundle: " + "; ".join(problems))
    return bundle


def _rank() -> Optional[int]:
    r = os.environ.get("PADDLE_TRAINER_ID") or os.environ.get("RANK")
    return int(r) if r is not None else None


def _thread_stacks() -> List[dict]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append({
            "thread_id": tid,
            "name": names.get(tid, "?"),
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return out


def _timeseries_window() -> Optional[dict]:
    """The recent TSDB window for the bundle (None when the store never
    sampled — alert-free processes and old readers see the same absent
    shape)."""
    try:
        from . import timeseries as _ts

        store = _ts.get_store()
        if not store.stats()["samples"]:
            return None
        return store.dump()
    except Exception:  # pdlint: disable=silent-exception -- a crash dump must not die on an optional history surface; the bundle just omits it
        return None


def _alerts_state() -> Optional[dict]:
    """Every live AlertManager's state for the bundle (None when no
    manager exists)."""
    try:
        from . import alerts as _alerts

        return _alerts.snapshot_all()
    except Exception:  # pdlint: disable=silent-exception -- a crash dump must not die on the alerting layer; the bundle just omits it
        return None


def _profile_section() -> Optional[dict]:
    """The step-anatomy profile for the bundle (None when no engine
    ever registered a profiler — processes without serving engines and
    old readers see the same absent shape)."""
    try:
        from . import perf as _perf

        if not _perf._PROFILERS:
            return None
        return _perf.profile_payload()
    except Exception:  # pdlint: disable=silent-exception -- a crash dump must not die on an optional perf surface; the bundle just omits it
        return None


def _kvstate_section() -> Optional[dict]:
    """The KV & memory atlas for the bundle (None when no engine ever
    registered an atlas — processes without serving engines and old
    readers see the same absent shape)."""
    try:
        from . import kvatlas as _kvatlas

        if not _kvatlas._ATLASES:
            return None
        return _kvatlas.kvstate_payload()
    except Exception:  # pdlint: disable=silent-exception -- a crash dump must not die on an optional memory surface; the bundle just omits it
        return None


def _audit_section() -> Optional[dict]:
    """The correctness-sentinel view for the bundle (None when no engine
    ever registered a sentinel — processes without serving engines and
    old readers see the same absent shape)."""
    try:
        from . import sentinel as _sentinel

        if not _sentinel._SENTINELS:
            return None
        return _sentinel.audit_payload()
    except Exception:  # pdlint: disable=silent-exception -- a crash dump must not die on an optional audit surface; the bundle just omits it
        return None


_CONFIG_ENV = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "RANK",
               "WORLD_SIZE", "MASTER_ADDR", "CUDA_VISIBLE_DEVICES")


def _config_info() -> dict:
    import numpy as _np

    info = {
        "python": sys.version.split()[0],
        "numpy": _np.__version__,
        "argv": list(sys.argv),
        "env": {k: os.environ[k] for k in _CONFIG_ENV if k in os.environ},
    }
    from .. import __version__

    info["paddle_tpu_torch"] = __version__
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    return info


class IncidentReporter:
    """Writes self-contained incident bundles at the moment of failure.

    ``activate(directory)`` arms it; ``install()`` additionally hooks
    ``sys.excepthook`` / ``threading.excepthook``, a SIGTERM handler,
    and ``faulthandler`` for SIGABRT (C-level stacks into a rank-tagged
    sidecar log — a Python handler can't run for an abort). Bundles are
    written atomically (tmp + rename) and rank-suffixed so concurrent
    multihost ranks never collide; a ``.events.jsonl`` sidecar carries
    the drained ring one event per line for grep/tail without jq.
    """

    def __init__(self, directory: str = "incidents"):
        self.directory = directory
        self.active = False
        self._lock = threading.RLock()
        self._engines: Dict[str, "weakref.ref"] = {}
        self._count = 0
        self._dumping = False
        self._installed = False
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._prev_signals: Dict[int, object] = {}
        self._fh_file = None
        self.last_bundle_path: Optional[str] = None

    # ---- wiring --------------------------------------------------------
    def activate(self, directory: Optional[str] = None) -> "IncidentReporter":
        if directory is not None:
            self.directory = directory
        os.makedirs(self.directory, exist_ok=True)
        self.active = True
        return self

    def register_engine(self, name: str, engine) -> "IncidentReporter":
        """Weakly remember an engine so bundles include its slot/queue
        state (weak: forensics must never pin a replaced engine)."""
        self._engines[name] = weakref.ref(engine)
        return self

    def install(self, excepthook: bool = True, signals: bool = True
                ) -> "IncidentReporter":
        self.activate()
        if self._installed:
            return self
        self._installed = True
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
            self._prev_thread_hook = threading.excepthook
            threading.excepthook = self._thread_excepthook
        if signals:
            try:
                self._prev_signals[_signal.SIGTERM] = _signal.signal(
                    _signal.SIGTERM, self._signal_handler)
            except ValueError:
                # not the main thread: signal wiring is impossible here,
                # but excepthooks and explicit dumps still work
                _logger().warning("incident reporter: SIGTERM handler not "
                                  "installed (not on the main thread)")
            try:
                import faulthandler

                suffix = (f".rank{_rank()}" if _rank() is not None else "")
                self._fh_file = open(
                    os.path.join(self.directory,
                                 f"faulthandler{suffix}.log"), "w")
                # enable() (not register()) — SIGABRT/SIGSEGV are the
                # signals faulthandler reserves for its own C-level
                # handler, which is exactly what an abort needs: Python
                # code can't run then, but the C stack dumper can
                faulthandler.enable(file=self._fh_file)
            except (ValueError, OSError, RuntimeError,
                    AttributeError) as e:
                _logger().warning("incident reporter: faulthandler fatal-"
                                  "signal hook not installed (%s: %s)",
                                  type(e).__name__, e)
        return self

    def uninstall(self):
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_thread_hook is not None:
            threading.excepthook = self._prev_thread_hook
            self._prev_thread_hook = None
        for signum, prev in self._prev_signals.items():
            try:
                _signal.signal(signum, prev)
            except (ValueError, TypeError) as e:
                _logger().warning("incident reporter: could not restore "
                                  "handler for signal %s (%s)", signum, e)
        self._prev_signals.clear()
        if self._fh_file is not None:
            import faulthandler

            try:
                faulthandler.disable()
            except (ValueError, AttributeError) as e:
                _logger().warning("incident reporter: faulthandler "
                                  "disable failed (%s)", e)
            self._fh_file.close()
            self._fh_file = None

    # ---- hook bodies ---------------------------------------------------
    def _excepthook(self, tp, val, tb):
        try:
            if not getattr(val, "_pd_incident_reported", False):
                self.dump(classify_exception(val) or "exception", exc=val,
                          context="sys.excepthook")
        except Exception:  # pdlint: disable=silent-exception -- the hook must never mask the original traceback below
            pass
        (self._prev_excepthook or sys.__excepthook__)(tp, val, tb)

    def _thread_excepthook(self, args):
        try:
            if not getattr(args.exc_value, "_pd_incident_reported", False):
                self.dump(classify_exception(args.exc_value) or "exception",
                          exc=args.exc_value,
                          context="thread "
                                  f"{getattr(args.thread, 'name', '?')}")
        except Exception:  # pdlint: disable=silent-exception -- the hook must never mask the original traceback below
            pass
        (self._prev_thread_hook or threading.__excepthook__)(args)

    def _signal_handler(self, signum, frame):
        try:
            name = _signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        try:
            self.dump("signal", context=name)
        finally:
            prev = self._prev_signals.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev != _signal.SIG_IGN:
                # default disposition: restore it and re-raise so the
                # launcher still sees a SIGTERM death, not a swallow
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)

    # ---- bundles -------------------------------------------------------
    def engine_states(self) -> dict:
        out = {}
        for name, ref in list(self._engines.items()):
            eng = ref()
            if eng is None:
                continue
            try:
                out[name] = eng.debug_state()
            except Exception as e:
                # a half-poisoned engine must not abort the whole dump —
                # record what failed where the state would have been
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def bundle(self, reason: str, exc: Optional[BaseException] = None,
               context: Optional[str] = None) -> dict:
        """Build the bundle in memory (``GET /debug/dump`` serves this
        without touching disk)."""
        from .metrics import get_registry
        from .tracing import get_tracer

        exc_info = None
        if exc is not None:
            exc_info = {
                "type": type(exc).__name__,
                "message": str(exc),
                "classified": classify_exception(exc),
                "traceback": [ln.rstrip("\n") for ln in
                              traceback.format_exception(
                                  type(exc), exc, exc.__traceback__)],
            }
        try:
            host = __import__("socket").gethostname()
        except Exception:  # pdlint: disable=silent-exception -- resolver failures must not block a crash dump
            host = "unknown"
        return {
            "schema": BUNDLE_SCHEMA_VERSION,
            "reason": reason,
            "context": context,
            "ts": time.time(),
            "pid": os.getpid(),
            "rank": _rank(),
            "host": host,
            "exception": exc_info,
            "recorder": RECORDER.stats(),
            "events": RECORDER.events(),
            "spans": get_tracer().spans(include_live=True),
            "metrics": get_registry().snapshot(),
            "engines": self.engine_states(),
            "config": _config_info(),
            "threads": _thread_stacks(),
            "lock_witness": None,
            "timeseries": _timeseries_window(),
            "alerts": _alerts_state(),
            "profile": _profile_section(),
            "kvstate": _kvstate_section(),
            "audit": _audit_section(),
        }

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             context: Optional[str] = None) -> Optional[str]:
        """Write one bundle atomically; returns its path (None when a
        dump is already in flight — a failure inside the dump path must
        not recurse into a second dump)."""
        with self._lock:
            if self._dumping:
                return None
            self._dumping = True
            self._count += 1
            count = self._count
        try:
            if not self.active:
                self.activate()
            # buffered telemetry first: the bundle's metrics snapshot and
            # any train JSONL must agree about the moment of failure
            from . import snapshot as _snap

            _snap.flush_all_writers()
            b = self.bundle(reason, exc=exc, context=context)
            suffix = f".rank{b['rank']}" if b["rank"] is not None else ""
            stem = (f"incident-{time.strftime('%Y%m%d-%H%M%S')}"
                    f"-{count:03d}-{reason}{suffix}")
            path = os.path.join(self.directory, stem + ".json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(b, f, indent=1, default=str)
            os.replace(tmp, path)
            ev_path = os.path.join(self.directory, stem + ".events.jsonl")
            tmp = ev_path + ".tmp"
            with open(tmp, "w") as f:
                for ev in b["events"]:
                    f.write(json.dumps(ev, default=str) + "\n")
            os.replace(tmp, ev_path)
            with self._lock:
                self.last_bundle_path = path
            RECORDER.record(EV_INCIDENT, reason=reason, path=path)
            _logger().error("incident bundle written: %s (reason=%s)",
                            path, reason)
            return path
        finally:
            with self._lock:
                self._dumping = False


# ---- process singletons -----------------------------------------------------

RECORDER = FlightRecorder()
_REPORTER = IncidentReporter()


def get_recorder() -> FlightRecorder:
    """The process-wide flight recorder (what the engines feed and
    ``/debug/events`` serves)."""
    return RECORDER


def get_reporter() -> IncidentReporter:
    """The process-wide incident reporter (inactive until
    ``activate()``/``install()`` arms it)."""
    return _REPORTER


def install_reporter(directory: str = "incidents",
                     enable_recorder: bool = True,
                     **install_kw) -> IncidentReporter:
    """One-call wiring: arm the reporter at ``directory``, hook
    excepthooks + fatal signals, and (by default) turn the flight
    recorder on so the bundle's ring is non-empty."""
    if enable_recorder:
        RECORDER.enable()
    return _REPORTER.activate(directory).install(**install_kw)


@contextlib.contextmanager
def incident_scope(context: str):
    """Wrap a crash boundary (train fit, bench run, engine loop): an
    escaping exception dumps a bundle when a reporter is active, and a
    CUDA OOM re-raises enriched (:class:`CudaOom` carrying the bundle
    path) — otherwise the original exception propagates untouched."""
    try:
        yield
    except BaseException as exc:
        kind = classify_exception(exc)
        path = None
        rep = _REPORTER
        if rep.active and not getattr(exc, "_pd_incident_reported", False):
            try:
                path = rep.dump(kind or "exception", exc=exc,
                                context=context)
            except Exception as e:
                # the dump failing must never mask the real crash
                _logger().warning("incident dump failed (%s: %s)",
                                  type(e).__name__, e)
            try:
                # one crash, one bundle: the excepthook this exception
                # reaches next checks the marker and stands down
                exc._pd_incident_reported = True
            except Exception:  # pdlint: disable=silent-exception -- exceptions with __slots__ can't carry the marker; worst case is a duplicate bundle
                pass
        if kind == "cuda_oom":
            enriched = _enrich_oom(exc, path, context)
            enriched._pd_incident_reported = True
            raise enriched from exc
        raise


def _logger():
    """The package's logger."""
    from logging import getLogger as get_logger

    return get_logger("paddle_tpu_torch.observability")
