"""StepTimer: train-loop step telemetry into the metrics registry.

One object serves three call styles — the hapi callback wraps
begin()/end() around each batch, bench.py records an externally timed
loop through observe(), and ad-hoc loops can use the ``step()`` context
manager. Every record publishes the step-time histogram, tokens/s and
samples/s gauges, and the device-memory gauges from the CUDA caching
allocator's counters; when ``FLAGS_log_memory_stats`` is set
(utils/flags.py — the reference's memory/stats.cc step logging) each
step also logs live/peak bytes. The port's copy of
``paddle_tpu/observability/timer.py``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

from . import catalog as _cat
from . import flightrecorder as _frec
from . import tracing as _tracing

__all__ = ["StepTimer"]


def _memory_stats() -> dict:
    """Live and peak bytes of the CUDA caching allocator (host-side
    counters, no device call); empty before CUDA is initialised."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated()}


class StepTimer:
    """Publish step time, throughput, and device memory each step.

    >>> timer = StepTimer()
    >>> with timer.step(n_tokens=4096):
    ...     run_one_step()
    """

    def __init__(self, logger=None):
        self._t0: Optional[float] = None
        self._logger = logger  # injectable for tests; rank-aware default
        self._span = None      # the open train.step span (tracing on)
        self.last_step_seconds: Optional[float] = None
        self.n_steps = 0

    # ---- recording styles ----------------------------------------------
    def begin(self):
        self._t0 = time.perf_counter()
        tracer = _tracing.get_tracer()
        if tracer.enabled:
            self._span = tracer.start_span(_tracing.SPAN_TRAIN_STEP)

    def end(self, n_samples: Optional[int] = None,
            n_tokens: Optional[int] = None) -> Optional[float]:
        """Close the begin() span and publish; None without a begin()
        (a callback attached mid-epoch must not record garbage)."""
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        span, self._span = self._span, None
        # observe with the step's span current so the train_step_seconds
        # histogram picks the trace_id up as an exemplar
        with _tracing.get_tracer().use(span):
            self.observe(dt, n_samples=n_samples, n_tokens=n_tokens)
        if span is not None:
            span.set_attr("step", self.n_steps)
            span.end()
        return dt

    @contextlib.contextmanager
    def step(self, n_samples: Optional[int] = None,
             n_tokens: Optional[int] = None):
        self.begin()
        try:
            yield self
        finally:
            self.end(n_samples=n_samples, n_tokens=n_tokens)

    def observe(self, step_seconds: float, n_samples: Optional[int] = None,
                n_tokens: Optional[int] = None):
        """Record one step of known duration (bench.py times its loop
        around a block_until_ready sync, then records here)."""
        dt = float(step_seconds)
        self.last_step_seconds = dt
        self.n_steps += 1
        _rec = _frec.get_recorder()
        if _rec.enabled:
            _rec.record(_frec.EV_TRAIN_STEP, step=self.n_steps, seconds=dt)
        _cat.TRAIN_STEP_SECONDS.observe(dt)
        if n_tokens and dt > 0:
            _cat.TRAIN_TOKENS_PER_SEC.set(n_tokens / dt)
        if n_samples and dt > 0:
            _cat.TRAIN_SAMPLES_PER_SEC.set(n_samples / dt)
        self._publish_memory(dt)

    # ---- device memory --------------------------------------------------
    def _publish_memory(self, dt: float):
        try:
            stats = _memory_stats()
        except Exception:  # pdlint: disable=silent-exception -- no device backend (bare-CPU unit tests); gauges fall back to 0
            stats = {}
        in_use = int(stats.get("bytes_in_use", 0))
        peak = int(stats.get("peak_bytes_in_use", in_use))
        _cat.DEVICE_MEM_IN_USE.set(in_use)
        _cat.DEVICE_MEM_PEAK.set(peak)
        if self._flag_log_memory():
            (self._logger or self._default_logger()).info(
                "step %d: %.1f ms, device mem %d B live / %d B peak",
                self.n_steps, dt * 1000.0, in_use, peak)

    @staticmethod
    def _flag_log_memory() -> bool:
        try:
            from ..utils.flags import flag

            return bool(flag("FLAGS_log_memory_stats"))
        except Exception:  # pdlint: disable=silent-exception -- flags module unavailable means the flag is unset
            return False

    @staticmethod
    def _default_logger():
        from logging import getLogger as get_logger

        return get_logger("paddle_tpu_torch.observability")
