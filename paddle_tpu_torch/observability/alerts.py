"""SLO objectives and multi-window burn-rate alerting over the TSDB.

timeseries.py gives the stack history; this module turns history into
JUDGMENTS — the SRE alerting loop: a declarative :class:`SloObjective`
names what good service means (goodput-under-SLO ratio, deadline-miss
ratio, a TTFT p99 bound, a worker-restart budget) and an
:class:`AlertManager` evaluates every objective on the ts-sampler's
cadence through a ``pending -> firing -> resolved`` state machine.
The port's copy of ``paddle_tpu/observability/alerts.py``.

Two objective kinds:

- ``burn_rate`` — the multi-window error-budget rule. With an SLO
  target of ``slo_target`` (say 0.99), the error budget is
  ``1 - slo_target``; the burn rate is ``(bad/total over a window) /
  budget`` (1.0 = burning exactly at budget). The alert requires BOTH a
  fast window (catches a cliff in minutes) and a slow window (suppresses
  blips a single bad second would cause) above their thresholds —
  the classic 14.4x/6x pairing at the default windows.
- ``threshold`` — a bound on one aggregation of one series:
  ``increase``/``rate`` (worker restarts), ``quantile`` (TTFT p99),
  ``avg``/``last`` (lost-worker gauge).

Flap suppression is structural: a breach shorter than ``for_s`` never
leaves ``pending`` (no event, no page), and a firing alert resolves
only after ``resolve_s`` of clean evaluations. Every *firing*/*resolved*
transition records an ``alert.fire``/``alert.resolve`` flight-recorder
event, increments ``alerts_transitions_total`` and — when the tracer is
live — drops an instant ``alert.transition`` span onto the trace
timeline, so an operator replaying an incident sees the alerting layer's
judgments interleaved with the raw signals that caused them.

``DEFAULT_OBJECTIVES`` covers one serving process;
``CLUSTER_OBJECTIVES`` covers the router's federated view (worker
restarts, lost workers, cluster deadline burn, poison quarantines). The
``alert-catalog`` pdlint rule keeps docs/SERVING.md's alert table and
these registries agreeing in both directions, and every referenced
metric real.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import flightrecorder as _frec
from . import tracing as _tracing

__all__ = [
    "SloObjective", "Alert", "AlertManager",
    "DEFAULT_OBJECTIVES", "CLUSTER_OBJECTIVES", "FEDERATED_SERIES",
    "default_objectives", "cluster_objectives", "default_manager",
    "snapshot_all",
]

_KINDS = ("burn_rate", "threshold")
_AGGS = ("increase", "rate", "avg", "quantile", "last")


class SloObjective:
    """One declarative service-level objective (see module doc).

    ``burn_rate`` kind: ``bad``/``total`` are ``(metric_name,
    label_filter)`` selectors; ``bad_in_total=False`` adds the bad
    count into the denominator (deadline misses were never admitted).
    ``threshold`` kind: ``metric`` + ``agg`` + ``op`` + ``threshold``
    over ``window_s`` (``quantile=`` for agg="quantile").
    """

    __slots__ = ("name", "kind", "severity", "summary",
                 "bad", "total", "bad_in_total", "slo_target",
                 "fast_window_s", "slow_window_s", "fast_burn",
                 "slow_burn",
                 "metric", "labels", "agg", "quantile", "op", "threshold",
                 "window_s", "for_s", "resolve_s")

    def __init__(self, name: str, kind: str, *, severity: str = "page",
                 summary: str = "",
                 # burn_rate
                 bad: Optional[Tuple[str, Optional[dict]]] = None,
                 total: Optional[Tuple[str, Optional[dict]]] = None,
                 bad_in_total: bool = True, slo_target: float = 0.99,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 # threshold
                 metric: Optional[str] = None,
                 labels: Optional[dict] = None, agg: str = "increase",
                 quantile: float = 0.99, op: str = ">",
                 threshold: float = 0.0, window_s: float = 300.0,
                 # state machine
                 for_s: float = 0.0, resolve_s: float = 60.0):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        if kind == "burn_rate" and (bad is None or total is None):
            raise ValueError("burn_rate objectives need bad= and total= "
                             "(metric, label_filter) selectors")
        if kind == "threshold":
            if metric is None:
                raise ValueError("threshold objectives need metric=")
            if agg not in _AGGS:
                raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
            if op not in (">", ">=", "<", "<="):
                raise ValueError(f"op must be a comparison, got {op!r}")
        if not 0.0 < slo_target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        self.name = name
        self.kind = kind
        self.severity = severity
        self.summary = summary
        self.bad = bad
        self.total = total
        self.bad_in_total = bool(bad_in_total)
        self.slo_target = float(slo_target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.metric = metric
        self.labels = dict(labels) if labels else None
        self.agg = agg
        self.quantile = float(quantile)
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.for_s = float(for_s)
        self.resolve_s = float(resolve_s)

    def metric_names(self) -> List[str]:
        """Every series this objective reads — what the alert-catalog
        lint checks against the registry + federated series."""
        if self.kind == "burn_rate":
            return [self.bad[0], self.total[0]]
        return [self.metric]

    def scaled(self, time_scale: float) -> "SloObjective":
        """A copy with every window/hold scaled — how the chaos dryrun
        gets second-scale alerting out of minute-scale defaults without
        changing the burn-rate math."""
        o = SloObjective.__new__(SloObjective)
        for slot in self.__slots__:
            setattr(o, slot, getattr(self, slot))
        o.labels = dict(self.labels) if self.labels else None
        for slot in ("fast_window_s", "slow_window_s", "window_s",
                     "for_s", "resolve_s"):
            setattr(o, slot, getattr(self, slot) * float(time_scale))
        return o

    def as_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind,
             "severity": self.severity, "summary": self.summary,
             "for_s": self.for_s, "resolve_s": self.resolve_s}
        if self.kind == "burn_rate":
            d.update(bad=list(self.bad), total=list(self.total),
                     bad_in_total=self.bad_in_total,
                     slo_target=self.slo_target,
                     fast_window_s=self.fast_window_s,
                     slow_window_s=self.slow_window_s,
                     fast_burn=self.fast_burn, slow_burn=self.slow_burn)
        else:
            d.update(metric=self.metric, labels=self.labels, agg=self.agg,
                     op=self.op, threshold=self.threshold,
                     window_s=self.window_s)
            if self.agg == "quantile":
                d["quantile"] = self.quantile
        return d

    # ---- evaluation -----------------------------------------------------
    def evaluate(self, store, now: float
                 ) -> Tuple[Optional[bool], dict]:
        """``(breached, detail)`` against the store at ``now``; breached
        is None when the store has no usable data yet (no traffic is
        neither healthy nor unhealthy — the state machine treats it as
        not breached but the detail says why)."""
        if self.kind == "burn_rate":
            budget = max(1e-9, 1.0 - self.slo_target)
            fast = store.ratio(self.bad, self.total, self.fast_window_s,
                               now=now, bad_in_total=self.bad_in_total)
            slow = store.ratio(self.bad, self.total, self.slow_window_s,
                               now=now, bad_in_total=self.bad_in_total)
            detail = {
                "fast_burn": None if fast is None else fast / budget,
                "slow_burn": None if slow is None else slow / budget,
                "fast_threshold": self.fast_burn,
                "slow_threshold": self.slow_burn,
            }
            if fast is None or slow is None:
                return None, detail
            return (detail["fast_burn"] >= self.fast_burn
                    and detail["slow_burn"] >= self.slow_burn), detail
        if self.agg == "increase":
            v = store.increase(self.metric, self.window_s,
                               labels=self.labels, now=now)
        elif self.agg == "rate":
            v = store.rate(self.metric, self.window_s,
                           labels=self.labels, now=now)
        elif self.agg == "avg":
            v = store.avg_over_time(self.metric, self.window_s,
                                    labels=self.labels, now=now)
        elif self.agg == "quantile":
            v = store.quantile_over_time(self.metric, self.quantile,
                                         self.window_s,
                                         labels=self.labels, now=now)
        else:                                   # "last"
            v = store.last(self.metric, labels=self.labels)
        detail = {"value": v, "op": self.op, "threshold": self.threshold,
                  "agg": self.agg}
        if v is None:
            return None, detail
        breached = {
            ">": v > self.threshold, ">=": v >= self.threshold,
            "<": v < self.threshold, "<=": v <= self.threshold,
        }[self.op]
        return breached, detail


# ---- default objective catalogs ---------------------------------------------
# Document every name here in docs/SERVING.md's "Alert catalog" table —
# the alert-catalog pdlint rule asserts both directions and that each
# referenced metric actually exists.

def default_objectives(time_scale: float = 1.0
                       ) -> Dict[str, SloObjective]:
    """Per-process serving objectives (each worker / single server)."""
    objs = [
        SloObjective(
            "slo_goodput_burn", "burn_rate", severity="page",
            summary="requests with an slo_ms are finishing past their "
                    "deadline faster than the error budget allows",
            bad=("serving_slo_outcomes_total", {"outcome": "late"}),
            total=("serving_slo_outcomes_total", None),
            slo_target=0.99, fast_window_s=120.0, slow_window_s=1800.0,
            fast_burn=14.4, slow_burn=6.0, for_s=0.0, resolve_s=120.0),
        SloObjective(
            "deadline_miss_burn", "burn_rate", severity="page",
            summary="queued requests are being shed on spent/unmeetable "
                    "deadlines faster than the error budget allows",
            bad=("serving_deadline_misses_total", None),
            total=("serving_requests_total", {"event": "admitted"}),
            bad_in_total=False, slo_target=0.99,
            fast_window_s=120.0, slow_window_s=1800.0,
            fast_burn=14.4, slow_burn=6.0, for_s=0.0, resolve_s=120.0),
        SloObjective(
            "ttft_p99_high", "threshold", severity="ticket",
            summary="time-to-first-token p99 over the window exceeds "
                    "the latency bound",
            metric="serving_time_to_first_token_seconds",
            agg="quantile", quantile=0.99, window_s=300.0,
            op=">", threshold=2.0, for_s=60.0, resolve_s=120.0),
        SloObjective(
            "decode_step_p99_high", "threshold", severity="ticket",
            summary="p99 device-dispatch time per decode step over the "
                    "window exceeds the latency bound — the model is "
                    "slower than the step budget allows",
            metric="serving_step_phase_seconds",
            labels={"phase": "dispatch"},
            agg="quantile", quantile=0.99, window_s=300.0,
            op=">", threshold=1.0, for_s=60.0, resolve_s=120.0),
        SloObjective(
            "kv_pressure_high", "threshold", severity="page",
            summary="free-slot headroom in the decoder's KV pool has "
                    "been below 10% of the admission budget for a "
                    "sustained window — page pressure is about to "
                    "become preemption churn or OOM degrade",
            metric="serving_kv_headroom_frac",
            labels={"engine": "decoder"},
            agg="avg", window_s=60.0, op="<", threshold=0.10,
            for_s=60.0, resolve_s=120.0),
        SloObjective(
            "audit_divergence", "threshold", severity="page",
            summary="the correctness sentinel recorded a diverged "
                    "verdict inside the window — a live token stream "
                    "disagreed with the reference replay; inspect the "
                    "sealed divergence bundle and run "
                    "scripts/replay_divergence.py",
            metric="serving_audit_total", labels={"verdict": "diverged"},
            agg="increase", window_s=600.0, op=">=", threshold=1.0,
            for_s=0.0, resolve_s=60.0),
    ]
    return {o.name: o.scaled(time_scale) if time_scale != 1.0 else o
            for o in objs}


def cluster_objectives(time_scale: float = 1.0
                       ) -> Dict[str, SloObjective]:
    """Router-level objectives over the federated store (pool /
    supervisor series + per-replica worker counters)."""
    objs = [
        SloObjective(
            "worker_restart_rate", "threshold", severity="page",
            summary="the supervisor restarted at least one worker "
                    "inside the window — the tier is crash-looping or "
                    "absorbing faults",
            metric="worker_restarts_total", agg="increase",
            window_s=120.0, op=">=", threshold=1.0,
            for_s=0.0, resolve_s=10.0),
        SloObjective(
            "cluster_workers_lost", "threshold", severity="page",
            summary="at least one pool member is lost (lease lapsed or "
                    "observed dead) and has not rejoined",
            metric="router_workers", labels={"state": "lost"},
            agg="avg", window_s=30.0, op=">", threshold=0.0,
            for_s=0.0, resolve_s=10.0),
        SloObjective(
            "cluster_deadline_burn", "burn_rate", severity="page",
            summary="the tier-wide deadline-miss ratio is burning the "
                    "error budget too fast",
            bad=("cluster_deadline_misses", None),
            total=("cluster_requests_admitted", None),
            bad_in_total=False, slo_target=0.99,
            fast_window_s=120.0, slow_window_s=1800.0,
            fast_burn=14.4, slow_burn=6.0, for_s=0.0, resolve_s=120.0),
        SloObjective(
            "poison_quarantine", "threshold", severity="ticket",
            summary="a request id was quarantined for killing workers "
                    "inside the window — inspect the supervisor ledger",
            metric="requests_quarantined_total", agg="increase",
            window_s=600.0, op=">=", threshold=1.0,
            for_s=0.0, resolve_s=60.0),
        SloObjective(
            "cluster_audit_divergence", "threshold", severity="page",
            summary="some replica's correctness sentinel recorded a "
                    "diverged verdict inside the window — find the "
                    "replica on GET /audit/cluster and replay its "
                    "sealed divergence bundle",
            metric="cluster_audit_diverged", agg="increase",
            window_s=600.0, op=">=", threshold=1.0,
            for_s=0.0, resolve_s=60.0),
    ]
    return {o.name: o.scaled(time_scale) if time_scale != 1.0 else o
            for o in objs}


DEFAULT_OBJECTIVES: Dict[str, SloObjective] = default_objectives()
CLUSTER_OBJECTIVES: Dict[str, SloObjective] = cluster_objectives()

#: series the cluster federation collector derives from the pool and
#: supervisor (TSDB-only — not registry families; the alert-catalog
#: lint accepts objective metrics from the registry OR this set, and a
#: tier-1 test pins the router collector to emit exactly these)
FEDERATED_SERIES = frozenset({
    "cluster_workers_alive",
    "cluster_breakers_open",
    "cluster_requests_admitted",
    "cluster_requests_finished",
    "cluster_requests_shed",
    "cluster_deadline_misses",
    "cluster_tokens_generated",
    "cluster_profile_step_ms",
    "cluster_profile_roofline_ratio",
    "cluster_kv_pages_in_use",
    "cluster_kv_bytes",
    "cluster_kv_headroom_slots",
    "cluster_prefix_hit_ratio",
    "cluster_audit_pass",
    "cluster_audit_diverged",
    "cluster_audit_skipped",
    "cluster_audit_drift",
})


# ---- runtime state ----------------------------------------------------------

class Alert:
    """Runtime state of one objective inside a manager."""

    __slots__ = ("objective", "state", "pending_since", "fired_at",
                 "clear_since", "resolved_at", "fired_count",
                 "last_detail")

    def __init__(self, objective: SloObjective):
        self.objective = objective
        self.state = "ok"
        self.pending_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.fired_count = 0
        self.last_detail: dict = {}

    def as_dict(self) -> dict:
        return {
            "name": self.objective.name,
            "severity": self.objective.severity,
            "state": self.state,
            "pending_since": self.pending_since,
            "fired_at": self.fired_at,
            "resolved_at": self.resolved_at,
            "fired_count": self.fired_count,
            "detail": dict(self.last_detail),
            "summary": self.objective.summary,
        }


# live managers (weak — a torn-down server must not pin one): what
# incident bundles snapshot
_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()


class AlertManager:
    """Evaluates objectives against a TimeSeriesStore through the
    pending -> firing -> resolved state machine (see module doc).

    ``attach()`` subscribes :meth:`evaluate` to the store's sampler so
    alerting runs on the ts-sampler thread at the sampling cadence —
    no second thread, no extra clock."""

    def __init__(self, store, objectives: Optional[Dict[str, SloObjective]]
                 = None, name: str = "serving", clock=None,
                 max_transitions: int = 256):
        self._lock = threading.Lock()
        self.name = name
        self._store = store
        self._clock = clock or store.now
        objectives = (default_objectives() if objectives is None
                      else objectives)
        self._alerts: Dict[str, Alert] = {
            n: Alert(o) for n, o in objectives.items()}
        self._transitions: deque = deque(maxlen=int(max_transitions))
        self._n_transitions = 0
        self._m_trans: Dict[Tuple[str, str], object] = {}
        _MANAGERS.add(self)

    def attach(self) -> "AlertManager":
        self._store.add_listener(self.evaluate)
        return self

    def detach(self):
        self._store.remove_listener(self.evaluate)

    # ---- evaluation ------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation round over every objective; returns the
        transitions it made (handy for tests and the dryrun report)."""
        now = self._clock() if now is None else float(now)
        made: List[dict] = []
        with self._lock:
            alerts = list(self._alerts.values())
        for al in alerts:
            try:
                breached, detail = al.objective.evaluate(self._store, now)
            except Exception as e:
                _logger().warning("alert %s: evaluation failed (%s: %s)",
                                  al.objective.name, type(e).__name__, e)
                continue
            with self._lock:
                al.last_detail = detail
                made.extend(self._advance(al, bool(breached), now))
        return made

    def _advance(self, al: Alert, breached: bool, now: float
                 ) -> List[dict]:
        """State-machine step for one alert (under the lock); emits
        events/metrics for the transitions it performs."""
        obj = al.objective
        made: List[dict] = []
        if al.state == "ok":
            if breached:
                al.pending_since = now
                if obj.for_s <= 0:
                    al.state = "firing"
                    al.fired_at = now
                    al.clear_since = None
                    al.fired_count += 1
                    made.append(self._transition(al, "ok", "firing", now))
                else:
                    al.state = "pending"
                    made.append(self._transition(al, "ok", "pending", now))
        elif al.state == "pending":
            if not breached:
                # flap suppressed: the breach never outlived for_s —
                # back to ok with no fire event, no page
                al.state = "ok"
                al.pending_since = None
                made.append(self._transition(al, "pending", "ok", now))
            elif now - al.pending_since >= obj.for_s:
                al.state = "firing"
                al.fired_at = now
                al.clear_since = None
                al.fired_count += 1
                made.append(self._transition(al, "pending", "firing", now))
        elif al.state == "firing":
            if breached:
                al.clear_since = None
            else:
                if al.clear_since is None:
                    al.clear_since = now
                if now - al.clear_since >= obj.resolve_s:
                    al.state = "ok"
                    al.resolved_at = now
                    al.pending_since = None
                    al.clear_since = None
                    made.append(self._transition(al, "firing", "resolved",
                                                 now))
        return made

    def _transition(self, al: Alert, frm: str, to: str, now: float
                    ) -> dict:
        obj = al.objective
        rec = {"alert": obj.name, "manager": self.name, "from": frm,
               "to": to, "t": now, "severity": obj.severity,
               "detail": dict(al.last_detail)}
        self._transitions.append(rec)
        self._n_transitions += 1
        m = self._m_trans.get((obj.name, to))
        if m is None:
            from . import catalog as _cat

            m = _cat.ALERTS_TRANSITIONS.labels(alert=obj.name, to=to)
            self._m_trans[(obj.name, to)] = m
        m.inc()
        if to in ("firing", "resolved"):
            recd = _frec.RECORDER
            if recd.enabled:
                recd.record(
                    _frec.EV_ALERT_FIRE if to == "firing"
                    else _frec.EV_ALERT_RESOLVE,
                    alert=obj.name, manager=self.name,
                    severity=obj.severity, state_from=frm,
                    detail=dict(al.last_detail))
            tr = _tracing.get_tracer()
            if tr.enabled:
                # annotate the live trace timeline: an instant span so a
                # chrome export shows the judgment next to the signals
                t_ns = time.perf_counter_ns()
                tr.add_span(_tracing.SPAN_ALERT, start_ns=t_ns,
                            end_ns=t_ns,
                            attrs={"alert": obj.name, "from": frm,
                                   "to": to, "severity": obj.severity})
        return rec

    # ---- views -----------------------------------------------------------
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, a in self._alerts.items()
                          if a.state == "firing")

    def get(self, name: str) -> Optional[Alert]:
        with self._lock:
            return self._alerts.get(name)

    def state(self) -> dict:
        """The ``GET /alerts`` payload: every alert's runtime state,
        firing names on top, plus the bounded transition history."""
        with self._lock:
            alerts = [a.as_dict() for a in self._alerts.values()]
            transitions = list(self._transitions)
            n = self._n_transitions
        alerts.sort(key=lambda a: (a["state"] != "firing", a["name"]))
        return {"manager": self.name,
                "firing": [a["name"] for a in alerts
                           if a["state"] == "firing"],
                "alerts": alerts,
                "transitions": transitions,
                "transitions_total": n}


# ---- process wiring ---------------------------------------------------------

_DEFAULT_MANAGER: Optional[AlertManager] = None


def default_manager(store=None) -> AlertManager:
    """The process-wide manager over :data:`DEFAULT_OBJECTIVES`,
    created (and attached to the store) once — every CompletionServer
    in a process shares it, exactly like the tracer/recorder
    singletons."""
    global _DEFAULT_MANAGER
    if _DEFAULT_MANAGER is None:
        from . import timeseries as _ts

        _DEFAULT_MANAGER = AlertManager(
            store or _ts.get_store(), default_objectives(),
            name="serving").attach()
    return _DEFAULT_MANAGER


def snapshot_all() -> Optional[dict]:
    """Every live manager's state — what incident bundles carry under
    ``bundle["alerts"]`` (None when no manager exists, so old readers
    and alert-free processes see the same absent key)."""
    managers = list(_MANAGERS)
    if not managers:
        return None
    return {"managers": [m.state() for m in managers]}


def _logger():
    from logging import getLogger as get_logger

    return get_logger("paddle_tpu_torch.observability")
