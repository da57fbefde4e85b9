"""The metric catalog: every family this codebase publishes, declared in
ONE place and registered into the default registry at import time.
The port's copy of ``paddle_tpu/observability/catalog.py``.

This is the contract surface: docs/SERVING.md documents exactly these
names (scripts/check_metrics_catalog.py asserts both directions), the
engines/HTTP/train hooks bind children off these family objects, and
``GET /metrics`` renders them. Add a metric HERE (plus its docs row) —
ad-hoc ``get_registry().counter(...)`` calls elsewhere would dodge the
lint and drift out of the docs.
"""
from __future__ import annotations

from .metrics import get_registry

_R = get_registry()

# ---- serving (ContinuousBatchEngine / Seq2SeqBatchEngine; label
# engine="decoder" | "seq2seq") ----------------------------------------------

SERVING_QUEUE_WAIT = _R.histogram(
    "serving_queue_wait_seconds",
    "Time a request spent queued before slot admission",
    labels=("engine",))

SERVING_TTFT = _R.histogram(
    "serving_time_to_first_token_seconds",
    "Submission to first generated token (queue wait + prefill + first "
    "decode step)",
    labels=("engine",))

SERVING_INTER_TOKEN = _R.histogram(
    "serving_inter_token_latency_seconds",
    "Gap between consecutive generated tokens of one request",
    labels=("engine",))

SERVING_PREFILL = _R.histogram(
    "serving_prefill_seconds",
    "Admission prefill wall time per request (includes compiles on cold "
    "prompt-length buckets)",
    labels=("engine",))

SERVING_DECODE_STEP = _R.histogram(
    "serving_decode_step_seconds",
    "One fused decode dispatch for all active slots (device step + host "
    "sync)",
    labels=("engine",))

SERVING_REQUESTS = _R.counter(
    "serving_requests_total",
    "Lifetime request events "
    "(event=admitted|finished|cancelled|rejected|shed)",
    labels=("engine", "event"))

SERVING_DEADLINE_MISSES = _R.counter(
    "serving_deadline_misses_total",
    "Queued requests shed because their end-to-end deadline had already "
    "passed or was provably unmeetable (each is a sched.shed event and "
    "an HTTP 504 with code=deadline_exceeded)",
    labels=("engine",))

SERVING_TOKENS = _R.counter(
    "serving_tokens_generated_total",
    "Lifetime generated tokens",
    labels=("engine",))

SERVING_PREFIX_LOOKUPS = _R.counter(
    "serving_prefix_cache_lookups_total",
    "Prefix-cache admissions by outcome (result=hit|miss; only counted "
    "when enable_prefix_cache is on)",
    labels=("engine", "result"))

SERVING_PREFIX_PAGES = _R.counter(
    "serving_prefix_cache_pages_reused_total",
    "KV pages copied from an active slot instead of recomputed",
    labels=("engine",))

SERVING_SPEC_ACCEPTED = _R.histogram(
    "serving_spec_accepted_tokens",
    "Draft tokens the target accepted per speculative verify, observed "
    "once per slot per verify dispatch (engine=decoder: the continuous-"
    "batching engine's n-gram drafter; engine=solo: speculative_generate; "
    "engine=mtp: the MTP self-draft — there each observation is the 0/1 "
    "hit of its single-draft round)",
    labels=("engine",))

SERVING_SLO_OUTCOMES = _R.counter(
    "serving_slo_outcomes_total",
    "Finished requests that carried an slo_ms budget, by whether they "
    "retired inside it (outcome=good|late) — the goodput-under-SLO "
    "numerator/denominator the slo_goodput_burn alert burns against "
    "(requests without an SLO are not counted; deadline SHEDS count "
    "serving_deadline_misses_total instead)",
    labels=("engine", "outcome"))

SERVING_SCHED = _R.counter(
    "serving_sched_decisions_total",
    "Scheduler decisions on the serving hot loop "
    "(decision=chunk|preempt|restore|migrate_out|migrate_in|shed) — "
    "each one is also a sched.* flight-recorder event carrying the "
    "full context",
    labels=("engine", "decision"))

SERVING_ACTIVE_SLOTS = _R.gauge(
    "serving_active_slots",
    "Slots currently decoding (refreshed on every stats() snapshot)",
    labels=("engine",))

SERVING_QUEUE_DEPTH = _R.gauge(
    "serving_queue_depth",
    "Requests queued for a free slot (refreshed on every stats() "
    "snapshot)",
    labels=("engine",))

SERVING_STEP_PHASE = _R.histogram(
    "serving_step_phase_seconds",
    "Per-step wall time attributed to one named engine phase "
    "(phase=admit|prefill|draft|dispatch|sync|retire; the step-anatomy "
    "profiler, docs/SERVING.md 'Step anatomy & roofline accounting' — "
    "sum over phases of one step ~= serving_decode_step_seconds)",
    labels=("engine", "phase"))

SERVING_ROOFLINE_RATIO = _R.gauge(
    "serving_roofline_ratio",
    "Roofline-predicted dispatch ms / measured dispatch ms for the most "
    "recent profiled window (1.0 = running at the hardware roofline; "
    "0 until the engine has a registered cost model and traffic)",
    labels=("engine",))

SERVING_ACHIEVED_HBM_GBPS = _R.gauge(
    "serving_achieved_hbm_gbps",
    "Achieved HBM bandwidth over the most recent profiled window "
    "(analytical bytes moved / measured dispatch time)",
    labels=("engine",))

SERVING_ACHIEVED_GFLOPS = _R.gauge(
    "serving_achieved_gflops",
    "Achieved compute throughput over the most recent profiled window "
    "(analytical FLOPs / measured dispatch time)",
    labels=("engine",))

SERVING_MFU = _R.gauge(
    "serving_mfu",
    "Serving model-FLOPs utilization: achieved FLOP/s over the device's "
    "peak bf16 FLOP/s (autotune.roofline_caps) for the most recent "
    "profiled window",
    labels=("engine",))

SERVING_KV_PAGES_IN_USE = _R.gauge(
    "serving_kv_pages_in_use",
    "Live KV-cache pages held by active + chunk-reserved slots "
    "(KvAtlas ledger; 0 while the atlas is disabled or the engine is "
    "unpaged)",
    labels=("engine",))

SERVING_KV_BYTES = _R.gauge(
    "serving_kv_bytes",
    "Live KV-cache bytes held by active + chunk-reserved slots "
    "(pages_in_use x page_size x per-token KV bytes from the model "
    "config)",
    labels=("engine",))

SERVING_KV_HEADROOM_SLOTS = _R.gauge(
    "serving_kv_headroom_slots",
    "Free slots under the LIVE admission budget (max_active_slots, "
    "which OOM degrade shrinks) — the capacity-forecast numerator",
    labels=("engine",))

SERVING_KV_HEADROOM_FRAC = _R.gauge(
    "serving_kv_headroom_frac",
    "Free-slot headroom as a fraction of the live admission budget "
    "(1.0 = empty pool; the kv_pressure_high alert watches this)",
    labels=("engine",))

SERVING_PREFIX_HIT_RATIO = _R.gauge(
    "serving_prefix_hit_ratio",
    "Prefix-cache admission hit ratio since process start "
    "(hits / (hits + misses); 0 before any lookup)",
    labels=("engine",))

SERVING_BUNDLE_BYTES = _R.histogram(
    "serving_bundle_bytes",
    "Size of sealed KV bundles crossing the host boundary, by kind "
    "(preempt = eviction to host, migrate = export to a peer, handoff "
    "= prefill->decode transfer)",
    labels=("engine", "kind"),
    buckets=(4096.0, 16384.0, 65536.0, 262144.0, 1048576.0, 4194304.0,
             16777216.0, 67108864.0, 268435456.0, 1073741824.0))

SERVING_AUDIT = _R.counter(
    "serving_audit_total",
    "Correctness-sentinel audit verdicts (pass = reference replay "
    "token-identical, diverged = any token mismatch — a sealed "
    "paddle_tpu.divergence/1 bundle exists for each, skipped = audit "
    "shed by budget/eligibility, never silent)",
    labels=("engine", "verdict"))

SERVING_AUDIT_DRIFT = _R.histogram(
    "serving_audit_logprob_drift",
    "Max per-position |logprob(live) - logprob(reference)| over one "
    "audited request (observed on pass AND diverged verdicts; drift "
    "without token divergence is numeric noise to trend, not an alert)",
    labels=("engine",),
    buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))

SERVING_AUDIT_FIRST_DIVERGENCE = _R.histogram(
    "serving_audit_first_divergence_position",
    "Token position of the first live/reference mismatch (observed on "
    "diverged verdicts only — early positions implicate prefill, late "
    "positions the decode tail or speculation)",
    labels=("engine",),
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0))

# ---- HTTP front-end ---------------------------------------------------------

HTTP_REQUESTS = _R.counter(
    "serving_http_requests_total",
    "HTTP responses by route and status code (unknown routes bucket "
    "under path=other)",
    labels=("path", "code"))

# ---- disaggregated serving tier (serving_cluster router) -------------------

ROUTER_PLACEMENTS = _R.counter(
    "router_placements_total",
    "Cluster-router placement outcomes "
    "(outcome=placed|retried|busy|deadline|quarantined|failed); retried "
    "counts every failed attempt that was requeued, busy counts 429 "
    "placement feedback, deadline counts requests shed at the router "
    "because their SLO budget ran out, quarantined counts poison "
    "requests refused typed (422), failed counts requests that "
    "exhausted the retry budget",
    labels=("outcome",))

ROUTER_WORKERS = _R.gauge(
    "router_workers",
    "Workers in the router's pool by liveness (state=alive|lost; "
    "refreshed on every pool poll and /metrics scrape)",
    labels=("state",))

WORKER_RESTARTS = _R.counter(
    "worker_restarts_total",
    "Supervised worker restarts by replica (each is a sup.restart "
    "event: the supervisor observed the worker process die and "
    "respawned it under the backoff ladder; breaker-held deaths are "
    "NOT counted — they produce sup.breaker_open instead)",
    labels=("replica",))

REQUESTS_QUARANTINED = _R.counter(
    "requests_quarantined_total",
    "Request ids quarantined by the poison-request ledger (implicated "
    "in >= 2 distinct worker deaths via deathnote/journal blame; the "
    "router answers them 422 code=request_quarantined and never "
    "retries them)",
    labels=())

# ---- observability self-telemetry ------------------------------------------

ALERTS_TRANSITIONS = _R.counter(
    "alerts_transitions_total",
    "Alert state-machine transitions by objective and destination "
    "state (to=pending|firing|resolved|ok; ok counts a pending breach "
    "that cleared before its for_s hold — a suppressed flap). Every "
    "firing/resolved transition is also an alert.fire/alert.resolve "
    "flight-recorder event",
    labels=("alert", "to"))

METRICS_SERIES_DROPPED = _R.counter(
    "metrics_series_dropped_total",
    "Updates routed to a family's {overflow=\"true\"} bucket because "
    "the family hit its label-cardinality cap (max_series, default "
    "256) — a per-request id leaking into a label shows up HERE "
    "instead of as unbounded registry growth",
    labels=("metric",))
# counting a drop ON the drop counter would recurse into another drop;
# its own overflow bucket still bounds it (cardinality = family count)
METRICS_SERIES_DROPPED._count_drops = False

TRACING_SPANS_DROPPED = _R.counter(
    "tracing_spans_dropped_total",
    "Finished spans evicted from the tracer's ring buffer (overflow — "
    "raise Tracer(capacity=) if this grows during an investigation)",
    labels=())

FLIGHTRECORDER_EVENTS = _R.counter(
    "flightrecorder_events_total",
    "Flight-recorder events recorded, by event kind (see the event "
    "catalog in docs/SERVING.md)",
    labels=("kind",))

# ---- training / step telemetry (StepTimer) ---------------------------------

TRAIN_STEP_SECONDS = _R.histogram(
    "train_step_seconds",
    "Train-loop step wall time (StepTimer)",
    labels=())

TRAIN_TOKENS_PER_SEC = _R.gauge(
    "train_tokens_per_second",
    "Most recent step's token throughput (StepTimer)",
    labels=())

TRAIN_SAMPLES_PER_SEC = _R.gauge(
    "train_samples_per_second",
    "Most recent step's sample throughput (StepTimer / profiler ips)",
    labels=())

DEVICE_MEM_IN_USE = _R.gauge(
    "device_memory_bytes_in_use",
    "Live device bytes (framework.device.memory_stats bytes_in_use; 0 "
    "when the backend doesn't track)",
    labels=())

DEVICE_MEM_PEAK = _R.gauge(
    "device_memory_peak_bytes",
    "Peak device bytes (framework.device.memory_stats "
    "peak_bytes_in_use)",
    labels=())
