"""The port's observability package (``paddle_tpu_torch/observability``)
against the JAX package's: the metric catalog (names, label sets and
buckets), the Prometheus text of the same observations, the W3C
``traceparent`` round trip, the event and span catalogs, the CUDA
out-of-memory classification, and one scripted engine run (chunked
prefill, preemption and restore, a cancel and a deadline shed) through
both packages' ``ContinuousBatchEngine``, whose flight-recorder event
kinds, span-name tree, request counters, KV-atlas totals at every step and
profiler phases must be equal."""
import time
from collections import Counter

import numpy as np
import pytest
import torch
from test_torch_engine_sched import llama_pair

import paddle_tpu.observability as jax_obs
import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.observability as port_obs
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.observability import flightrecorder as port_frec


def _catalog(obs):
    out = {}
    for name, fam in obs.get_registry()._families.items():
        out[name] = (fam.kind, tuple(fam.label_names),
                     getattr(fam, "buckets", None))
    return out


def test_catalog_equals_jax():
    got, want = _catalog(port_obs), _catalog(jax_obs)
    assert got == want
    assert set(port_obs.tracing.SPAN_CATALOG) == set(
        jax_obs.tracing.SPAN_CATALOG)
    assert set(port_obs.flightrecorder.EVENT_CATALOG) == set(
        jax_obs.flightrecorder.EVENT_CATALOG)
    assert set(port_obs.flightrecorder.BUNDLE_SCHEMA) == set(
        jax_obs.flightrecorder.BUNDLE_SCHEMA)


def _observe(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("t_requests_total", "requests", labels=("engine",
                                                            "event"))
    g = reg.gauge("t_active", "active slots", labels=("engine",))
    h = reg.histogram("t_latency_seconds", "latency", labels=("engine",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    d = reg.histogram("t_default_seconds", "default buckets")
    for i, v in enumerate((0.0005, 0.003, 0.05, 0.5, 2.0, 0.01)):
        c.labels(engine="decoder", event="admitted").inc()
        c.labels(engine="decoder", event="finished").inc(i)
        g.labels(engine="decoder").set(v * 3)
        h.labels(engine="decoder").observe(v)
        d.observe(v)
    return reg.render_prometheus()


def test_prometheus_text_renders_identically():
    assert _observe(port_obs) == _observe(jax_obs)


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "zz-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "garbage", "", None])
def test_traceparent_round_trip(header):
    got = port_obs.parse_traceparent(header)
    assert got == jax_obs.parse_traceparent(header)
    if got is not None:
        out = port_obs.format_traceparent(*got)
        assert out == jax_obs.format_traceparent(*got)
        assert port_obs.parse_traceparent(out) == got


def test_cuda_oom_is_classified_and_reraised_with_bundle(tmp_path):
    """``incident_scope`` re-raises a CUDA OOM as ``CudaOom`` (still a
    ``torch.cuda.OutOfMemoryError``) with the bundle path it wrote."""
    rep = port_frec.get_reporter()
    was_active, was_dir = rep.active, rep.directory
    rep.activate(str(tmp_path))
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            with port_frec.incident_scope("engine.step"):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        err = ei.value
        assert isinstance(err, port_frec.CudaOom)
        assert err.bundle_path and "cuda_oom" in err.bundle_path
        import json

        with open(err.bundle_path) as f:
            port_frec.validate_bundle(json.load(f))
        with pytest.raises(ValueError):
            with port_frec.incident_scope("engine.step"):
                raise ValueError("not an oom")
    finally:
        rep.active, rep.directory = was_active, was_dir


# ---- one scripted run through both engines ----------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def _counts(obs):
    snap = obs.get_registry().snapshot()
    return {fam: dict(snap[fam]["series"]) for fam in (
        "serving_requests_total", "serving_sched_decisions_total",
        "serving_tokens_generated_total")}


def _delta(after, before):
    return {fam: {k: v - before[fam].get(k, 0) for k, v in vals.items()
                  if v - before[fam].get(k, 0)}
            for fam, vals in after.items()}


def _span_tree(spans):
    by_id = {s["span_id"]: s for s in spans}
    return sorted(Counter(
        (s["name"], by_id[s["parent_id"]]["name"]
         if s["parent_id"] in by_id else None, s["status"])
        for s in spans).items())


def _atlas(eng):
    p = eng.kvatlas.payload()
    return (p["pages_in_use"], p["pages_peak"], p["chunk_parked_pages"],
            p["host_parked_requests"], p["host_parked_bytes"],
            p["capacity_bytes"], p["headroom_slots"],
            p["prefix"]["hits"], p["prefix"]["misses"])


def _scripted_run(mod, obs, model, clock):
    rec = obs.flightrecorder.get_recorder()
    tracer = obs.tracing.get_tracer()
    before = _counts(obs)
    was = rec.enabled, tracer.enabled
    rec.enable()
    rec.clear()
    tracer.enable()
    tracer.clear()
    try:
        eng = mod.ContinuousBatchEngine(
            model, max_batch=2, max_len=64, page_size=8,
            prefill_chunk_tokens=16, enable_preemption=True,
            enable_prefix_cache=True)
        eng.profiler.enable()
        eng.kvatlas.enable()
        rng = np.random.RandomState(7)
        p = [rng.randint(0, 512, (n,)) for n in (40, 5, 6, 7, 6)]
        atlas, done = [], {}
        a = eng.add_request(p[0], max_new_tokens=6, priority=2)
        b = eng.add_request(p[1], max_new_tokens=12, priority=1)
        for _ in range(4):            # A's three chunks land
            done.update(eng.step())
            atlas.append(_atlas(eng))
        c = eng.add_request(p[2], max_new_tokens=4, priority=0)  # preempts A
        atlas.append(_atlas(eng))
        d = eng.add_request(p[3], max_new_tokens=4, priority=3)
        eng.cancel(d)
        e = eng.add_request(p[4], max_new_tokens=4, priority=3, slo_ms=50)
        clock.t += 1.0                # E's deadline passes in the queue
        while eng._queue or eng.num_active or eng._chunking:
            done.update(eng.step())
            atlas.append(_atlas(eng))
        kinds = [ev["kind"] for ev in rec.events()
                 if ev["kind"] != "jit.compile"]
        return dict(
            tokens=[done.get(r, np.zeros(0)).tolist() for r in (a, b, c)],
            reasons=[eng.finish_reason(r) for r in (a, b, c, d, e)],
            kinds=kinds, spans=_span_tree(tracer.spans()),
            counts=_delta(_counts(obs), before), atlas=atlas,
            phases=sorted(eng.profiler.payload()["phases"]),
            usage=eng.request_usage(b)["dispatches"])
    finally:
        rec.clear()
        tracer.clear()
        if not was[0]:
            rec.disable()
        if not was[1]:
            tracer.disable()


def test_scripted_engine_run_matches_jax(clock):
    jax_model, port_model = llama_pair()
    want = _scripted_run(jax_serving, jax_obs, jax_model, clock)
    got = _scripted_run(port_serving, port_obs, port_model, clock)
    assert got["reasons"] == want["reasons"] == [
        "length", "length", "length", "cancelled", "shed"]
    assert got["tokens"] == want["tokens"]
    assert got["kinds"] == want["kinds"]
    for kind in ("sched.chunk", "sched.preempt", "sched.restore",
                 "sched.shed", "engine.cancel", "engine.step"):
        assert kind in got["kinds"], kind
    assert got["spans"] == want["spans"]
    assert got["counts"] == want["counts"]
    assert got["atlas"] == want["atlas"]
    assert any(row[4] > 0 for row in got["atlas"])    # parked bytes seen
    assert got["phases"] == want["phases"]
    assert got["usage"] == want["usage"]
