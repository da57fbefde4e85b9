"""Step-anatomy profiler: continuous per-phase attribution of engine
steps, roofline/MFU accounting, and the serving→autotune feedback loop.
The port's copy of ``paddle_tpu/observability/perf.py``.

The watchtower (alerts.py) judges *whether* the tier meets its SLOs and
the flight recorder explains *what broke*; this module explains *where
each decode step's milliseconds go* and whether the engine runs as fast
as the hardware allows:

- ``PhaseClock`` — a lock-free, engine-thread-only stopwatch the engines
  drive through their step loop: ``begin()`` at the top, ``lap(phase)``
  at each boundary. Phases accumulate in a plain dict, so a phase that
  recurs inside one step (the trailing admission re-laps "admit") sums
  instead of overwriting, and the per-step phase total equals the step
  wall time by construction.
- ``StepProfiler`` — one per engine, registered by label. Disabled by
  default and guarded Tracer-style at every hot site (one attribute
  check — the enabled overhead bar is < 1% of a decode step, the
  flight-recorder bar). ``commit()`` publishes per-phase histograms
  (``serving_step_phase_seconds``), keeps a bounded window of recent
  steps for exact p50/p99 and top-K-slowest reporting, and joins the
  measured dispatch+sync time against the autotune roofline model.
- Roofline join — a ``serving_decode_step`` analytical cost model is
  registered with ``ops/hopper/autotune.py`` (same contract as the
  kernels' models: deterministic on (params, choice)), and priced at the
  card's rates there (the H100's 3.35 TB/s and 989 TFLOP/s bf16). From
  it the profiler publishes achieved-vs-roofline ratio,
  achieved HBM GB/s and GFLOP/s, and a serving-MFU gauge, and it
  persists (signature, measured_ms, predicted_ms) observations into the
  autotune cost table so ``search()`` can later fit learned cost models
  from real serving traffic instead of offline sweeps.
- ``profile_payload()`` — the JSON surface behind ``GET /profile``,
  router-side ``GET /profile/cluster`` federation, the PROFILE section
  of incident bundles, and ``scripts/step_anatomy.py``.

See docs/SERVING.md "Step anatomy & roofline accounting".
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import catalog as _cat
from . import flightrecorder as _frec

__all__ = ["PHASES", "PhaseClock", "StepProfiler", "get_profiler",
           "profile_payload", "decode_step_params"]

#: the phase vocabulary, in step order. ``draft`` only appears on the
#: speculative path; the seq2seq engine folds its encoder+seed prefill
#: into ``admit`` (that IS its admission prefill) and never drafts.
PHASES = ("admit", "prefill", "draft", "dispatch", "sync", "retire")

#: recent-step window: exact quantiles + top-K come from here, while the
#: histograms carry the unbounded series for the TSDB/alerting path
_WINDOW = 512

#: cadence (in committed steps) of roofline gauge refresh and of
#: persisting an observation into the autotune cost table — batched so
#: the per-step commit stays far under the 1% overhead bar
_GAUGE_EVERY = 32
_PERSIST_EVERY = 256


def _dtype_bytes(dtype: Any) -> int:
    """Itemsize from a dtype spelled as a string — deterministic on the
    persisted params (the graph-cost-table lint replays this model from
    JSON, so no live dtype objects are involved)."""
    s = str(dtype)
    if "bfloat16" in s or "float16" in s:
        return 2
    if "float64" in s or "int64" in s:
        return 8
    if "int8" in s or "uint8" in s:
        return 1
    return 4


def _decode_step_cost(params: dict, choice: tuple) -> dict:
    """Whole-dispatch analytical cost of ONE fused decode step at
    ``choice = (active_batch, kv_bucket)``: the weight stream is read
    once per dispatch regardless of batch (why continuous batching pays
    on the HBM-bound decode tail), the KV read scales with batch × kv
    length, and FLOPs scale with batch. Same contract as the kernels'
    models — deterministic on (params, choice)."""
    b, kv = int(choice[0]), int(choice[1])
    hidden = int(params["hidden"])
    layers = int(params["layers"])
    inter = int(params["intermediate"])
    wtot = int(params["wtot"])          # (H + 2*hk) * head_dim per layer
    kvdim = int(params["kvdim"])        # 2 * hk * head_dim per token
    vocab = int(params["vocab"])
    it = _dtype_bytes(params["dtype"])
    # weights: qkv + o_proj + 3 MLP mats per layer + the lm head
    w_elems = layers * (hidden * wtot + hidden * hidden
                        + 3 * hidden * inter) + hidden * vocab
    act_elems = b * (layers * (4 * hidden + 2 * inter) + vocab)
    kv_elems = b * kv * layers * kvdim
    return {
        "bytes": (w_elems + act_elems + kv_elems) * it,
        "flops": 2 * b * w_elems + 4 * b * kv * layers * hidden,
        "vmem_bytes": 0,                 # a whole step; never infeasible
        "grid": 0,
    }


def _register_cost_model() -> None:
    try:
        from ..ops.hopper import autotune
    except Exception:  # pdlint: disable=silent-exception -- builds without the kernel package skip the roofline join; phase attribution still works
        return
    autotune.register_cost_model("serving_decode_step", _decode_step_cost)


_register_cost_model()


def decode_step_params(cfg: Any, max_batch: int) -> Optional[dict]:
    """Cost-model params from a llama-shaped config (the
    ``_resolve_spec_k`` idiom); None for configs the model can't
    describe — the profiler then attributes phases without a roofline."""
    try:
        from ..models.llama import head_dim_of

        hd = head_dim_of(cfg)
        h, hk = cfg.num_attention_heads, cfg.num_key_value_heads
        return {
            "batch": int(max_batch), "hidden": int(cfg.hidden_size),
            "layers": int(cfg.num_hidden_layers),
            "intermediate": int(cfg.intermediate_size),
            "wtot": int((h + 2 * hk) * hd),
            "kvdim": int(2 * hk * hd),
            "vocab": int(cfg.vocab_size),
            "dtype": str(cfg.dtype),
        }
    except (AttributeError, TypeError, ImportError):
        return None


def _kv_bucket(kv: int) -> int:
    """Power-of-two kv-length bucket (floor 16): keeps the autotune
    signature/choice cardinality bounded under growing contexts."""
    return 1 << max(4, int(kv - 1).bit_length()) if kv > 16 else 16


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = int(math.ceil(q * len(sorted_vals))) - 1
    return sorted_vals[min(max(rank, 0), len(sorted_vals) - 1)]


class PhaseClock:
    """Engine-thread-only phase stopwatch. No locks: exactly one thread
    (the engine's step loop) ever touches an instance, and the profiler
    reads it only inside that same thread's ``commit()``."""

    __slots__ = ("t0", "_last", "phases")

    def __init__(self):
        self.t0 = 0.0
        self._last = 0.0
        self.phases: Dict[str, float] = {}

    def begin(self) -> None:
        self.t0 = self._last = time.perf_counter()
        self.phases.clear()

    def lap(self, phase: str) -> None:
        """Attribute the time since the previous lap (or ``begin``) to
        ``phase``; repeated laps of one phase accumulate."""
        now = time.perf_counter()
        self.phases[phase] = (self.phases.get(phase, 0.0)
                              + (now - self._last))
        self._last = now

    def total(self) -> float:
        """Wall seconds from ``begin()`` to the last lap — equals the
        sum of the phase buckets by construction."""
        return self._last - self.t0


class StepProfiler:
    """Per-engine step-anatomy profiler. Construct disabled; the HTTP
    server (or a bench/test harness) calls ``enable()``. Hot sites guard
    on the single ``enabled`` attribute before touching the clock."""

    def __init__(self, engine: str):
        self.engine = engine
        self.enabled = False
        self.clock = PhaseClock()
        self.steps = 0
        self.recent: deque = deque(maxlen=_WINDOW)
        self.last_roofline: Optional[dict] = None
        self._params: Optional[dict] = None
        self._sig: Optional[str] = None
        self._lock = threading.Lock()   # recent-window snapshot vs append
        self._m_phase: Dict[str, Any] = {}
        self._g_ratio = _cat.SERVING_ROOFLINE_RATIO.labels(engine=engine)
        self._g_hbm = _cat.SERVING_ACHIEVED_HBM_GBPS.labels(engine=engine)
        self._g_flops = _cat.SERVING_ACHIEVED_GFLOPS.labels(engine=engine)
        self._g_mfu = _cat.SERVING_MFU.labels(engine=engine)
        # roofline accumulation window (reset every _GAUGE_EVERY commits)
        self._win_meas_s = 0.0
        self._win_bytes = 0.0
        self._win_flops = 0.0
        self._win_pred_s = 0.0
        self._win_n = 0
        self._n_publish = 0
        self._cost_cache: Dict[tuple, Optional[dict]] = {}
        _PROFILERS[engine] = self       # latest engine under a label wins

    # ---- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def set_cost_params(self, params: Optional[dict]) -> None:
        """Attach the engine's cost-model params (``decode_step_params``
        output). None keeps phase attribution without a roofline."""
        self._params = params
        self._sig = (" ".join(f"{k}{v}" for k, v in sorted(params.items()))
                     if params else None)
        _register_cost_model()  # idempotent; covers import-order races

    # ---- the per-step commit (engine thread) ---------------------------
    def commit(self, active: int = 0, kv_len: int = 0,
               fr_seq: int = 0) -> None:
        """Fold one completed step's clock into the published state.
        Called ONLY from the engine thread, after the final lap."""
        clk = self.clock
        total = clk.total()
        if total <= 0.0 or not clk.phases:
            return
        for name, secs in clk.phases.items():
            m = self._m_phase.get(name)
            if m is None:
                m = self._m_phase[name] = _cat.SERVING_STEP_PHASE.labels(
                    engine=self.engine, phase=name)
            m.observe(secs)
        self.steps += 1
        rec = {"ms": total * 1e3,
               "phases": {k: v * 1e3 for k, v in clk.phases.items()},
               "active": int(active), "kv": int(kv_len),
               "fr_seq": int(fr_seq)}
        with self._lock:
            self.recent.append(rec)
        self._roofline_accum(clk.phases, int(active), int(kv_len))

    def _roofline_accum(self, phases: Dict[str, float], active: int,
                        kv_len: int) -> None:
        if self._params is None or active <= 0:
            return
        meas = phases.get("dispatch", 0.0) + phases.get("sync", 0.0)
        if meas <= 0.0:
            return
        choice = (active, _kv_bucket(kv_len))
        cost = self._cost_cache.get(choice)
        if cost is None and choice not in self._cost_cache:
            try:
                from ..ops.hopper import autotune

                cost = autotune.analytical_cost(
                    "serving_decode_step", self._params, choice)
                if cost is not None:
                    cost = dict(cost)
                    cost["roofline_ms"] = autotune.roofline_ms(
                        cost["bytes"], cost["flops"])
            except Exception:  # pdlint: disable=silent-exception -- no kernel package / no backend means no roofline join; phase attribution must keep working
                cost = None
            self._cost_cache[choice] = cost
        if cost is None:
            return
        self._win_meas_s += meas
        self._win_bytes += cost["bytes"]
        self._win_flops += cost["flops"]
        self._win_pred_s += cost["roofline_ms"] * 1e-3
        self._win_n += 1
        if self._win_n >= _GAUGE_EVERY:
            self._publish_roofline(choice)

    def _publish_roofline(self, choice: tuple) -> None:
        meas_s = self._win_meas_s
        if meas_s <= 0.0:
            self._win_n = 0
            return
        try:
            from ..ops.hopper import autotune

            _, peak = autotune.roofline_caps()
            device = autotune.device_kind()
        except Exception:  # pdlint: disable=silent-exception -- accumulation already proved the kernel package imports; a late backend fault just skips this window's publish
            self._win_n = 0
            return
        achieved_flops = self._win_flops / meas_s
        roofline = {
            "ratio": min(1.0, self._win_pred_s / meas_s),
            "measured_ms": self._win_meas_s * 1e3 / self._win_n,
            "predicted_ms": self._win_pred_s * 1e3 / self._win_n,
            "achieved_hbm_gbps": self._win_bytes / meas_s / 1e9,
            "achieved_gflops": achieved_flops / 1e9,
            "mfu": achieved_flops / peak,
            "window_steps": self._win_n,
            "device": device,
            "choice": list(choice),
        }
        self.last_roofline = roofline
        self._g_ratio.set(roofline["ratio"])
        self._g_hbm.set(roofline["achieved_hbm_gbps"])
        self._g_flops.set(roofline["achieved_gflops"])
        self._g_mfu.set(roofline["mfu"])
        self._win_meas_s = self._win_bytes = 0.0
        self._win_flops = self._win_pred_s = 0.0
        self._win_n = 0
        self._n_publish += 1
        if self._n_publish % (_PERSIST_EVERY // _GAUGE_EVERY) == 0:
            self._persist(roofline, choice)

    def _persist(self, roofline: dict, choice: tuple) -> None:
        """One (signature, measured_ms, predicted_ms) observation into
        the autotune cost table — the training rows a later learned
        cost-model fit consumes. Batched in memory; the cache flushes at
        exit and on incident dumps like every sweep does."""
        if self._sig is None:
            return
        try:
            from ..ops.hopper import autotune

            if not autotune.enabled():
                return
            cost = self._cost_cache.get(choice)
            if cost is None:
                return
            cache = autotune.get_cache()
            key = autotune.full_key(self._sig)
            cache.record_result("serving_decode_step", key, choice,
                                ms=roofline["measured_ms"])
            cache.put("serving_decode_step", key, choice,
                      roofline["measured_ms"], params=self._params,
                      est={"bytes": cost["bytes"], "flops": cost["flops"],
                           "roofline_ms": cost["roofline_ms"]})
        except Exception:  # pdlint: disable=silent-exception -- the cost table is an optimization input; a persistence fault must never surface into the serving step loop
            return
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_PERF_ROOFLINE, engine=self.engine,
                       measured_ms=roofline["measured_ms"],
                       predicted_ms=roofline["predicted_ms"],
                       ratio=roofline["ratio"], mfu=roofline["mfu"])

    # ---- read side (any thread) ----------------------------------------
    def federated(self) -> Dict[str, float]:
        """The two scalars worth carrying over /health into the router's
        cluster_* federation (stats()-shaped; see router._FEDERATED_STATS)."""
        with self._lock:
            last = self.recent[-1] if self.recent else None
        lr = self.last_roofline or {}
        return {"profile_step_ms": float(last["ms"]) if last else 0.0,
                "profile_roofline_ratio": float(lr.get("ratio", 0.0))}

    def payload(self, top_k: int = 5) -> dict:
        with self._lock:
            recent = list(self.recent)
        phases: Dict[str, dict] = {}
        total_ms = sum(r["ms"] for r in recent) or 1.0
        for name in PHASES:
            vals = sorted(r["phases"][name] for r in recent
                          if name in r["phases"])
            if not vals:
                continue
            s = sum(vals)
            phases[name] = {"p50_ms": _quantile(vals, 0.5),
                            "p99_ms": _quantile(vals, 0.99),
                            "mean_ms": s / len(vals),
                            "share": s / total_ms,
                            "count": len(vals)}
        step_vals = sorted(r["ms"] for r in recent)
        top = sorted(recent, key=lambda r: -r["ms"])[:max(int(top_k), 0)]
        return {
            "engine": self.engine,
            "enabled": self.enabled,
            "steps": self.steps,
            "window": len(recent),
            "step_ms": {"p50": _quantile(step_vals, 0.5),
                        "p99": _quantile(step_vals, 0.99),
                        "mean": (sum(step_vals) / len(step_vals)
                                 if step_vals else 0.0)},
            "phases": phases,
            "roofline": self.last_roofline,
            "top_slowest": top,
        }


#: engine label → live profiler (latest registration wins, matching the
#: flight-recorder reporter's engine registry semantics)
_PROFILERS: Dict[str, StepProfiler] = {}


def get_profiler(engine: str) -> Optional[StepProfiler]:
    return _PROFILERS.get(engine)


def profile_payload(top_k: int = 5) -> dict:
    """The ``GET /profile`` document: every registered engine's anatomy.
    Engines that never committed a step are listed (enabled flag and
    zero counters) so the surface is discoverable before traffic."""
    return {
        "schema_version": 1,
        "engines": {name: prof.payload(top_k)
                    for name, prof in sorted(_PROFILERS.items())},
    }
