"""The port's HTTP front-end (``paddle_tpu_torch/serving_http.py``) on the
cases of ``tests/test_serving_http.py``: completions (batch and SSE),
concurrent clients riding one engine, per-request sampling, the error
paths, priority / SLO, keep-alive, /health and /v1/models, stop ids,
logprobs, ``n`` and a tokenizer; then what the port adds to those cases:
``traceparent`` in and out, ``X-Audit: 1``, /metrics, /profile, /kvstate,
/audit, the engine-thread command path and a client that disconnects mid
stream. (``test_multimodal_over_http`` waits for multimodal serving; a
``pixel_values`` request to this text model answers 400 here, as in JAX.)

The model is the two-layer f32 Llama of ``test_torch_pair.build_pair``,
shared with the engine tests (``test_torch_engine_sched.llama_pair``). The
tokens of a greedy completion are held equal to the port's solo
``generate``, to the JAX ``ContinuousBatchEngine`` over the same numpy
weights and, for the first case, to the JAX ``model.generate``."""
import functools
import gc
import http.client
import json
import socket
import struct
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from test_torch_engine_sched import llama_pair
from test_torch_pair import jax_generate

import paddle_tpu.serving as jax_serving
from paddle_tpu_torch.generation import generate
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.serving_http import CompletionServer, EngineCommand

V = 512


@pytest.fixture(scope="module")
def served():
    _, model = llama_pair()
    eng = ContinuousBatchEngine(model, max_batch=4, max_len=64, page_size=8)
    srv = CompletionServer(eng, model_name="tiny-llama").start()
    yield model, srv
    srv.close()


@functools.lru_cache(maxsize=None)
def _jax_engine():
    jax_model, _ = llama_pair()
    return jax_serving.ContinuousBatchEngine(jax_model, max_batch=2,
                                             max_len=64, page_size=8)


def jax_engine_tokens(prompts, max_new, **kw):
    """The JAX engine's greedy tokens for ``prompts`` (one engine per
    process, so its programs trace once)."""
    eng = _jax_engine()
    rids = [eng.add_request(np.asarray(p), max_new_tokens=max_new, **kw)
            for p in prompts]
    done = eng.run_until_done()
    return [done[r].tolist() for r in rids]


def solo(model, prompt, n):
    """The port's solo greedy ``generate``."""
    return generate(model, torch.tensor([prompt]),
                    max_new_tokens=n)[0].tolist()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, V, (n,)).tolist()


def _post(srv, path, body, headers=None):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(srv, path, raw=False):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, (data if raw else json.loads(data))


def _sse(srv, body):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp, [line[len("data: "):] for line in raw.splitlines()
                  if line.startswith("data: ")]


def test_completion_matches_solo_generate(served):
    model, srv = served
    jax_model, _ = llama_pair()
    prompt = _prompt(0, 9)
    want = solo(model, prompt, 6)
    assert jax_generate(jax_model, np.asarray([prompt]),
                        max_new_tokens=6)[0].tolist() == want
    assert jax_engine_tokens([prompt], 6) == [want]
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 6})
    assert status == 200
    out = json.loads(data)
    assert out["object"] == "text_completion"
    assert out["choices"][0]["token_ids"] == want
    assert out["usage"]["completion_tokens"] == 6
    assert out["usage"]["dispatches"] == 6


def test_streaming_sse(served):
    model, srv = served
    prompt = _prompt(1, 7)
    want = solo(model, prompt, 5)
    resp, events = _sse(srv, {"prompt_token_ids": prompt, "max_tokens": 5,
                              "stream": True})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert [c["choices"][0]["token_ids"][0] for c in chunks] == want
    # the usage block rides the last token chunk
    assert chunks[-1]["usage"]["completion_tokens"] == 5
    assert "usage" not in chunks[0]


def test_concurrent_clients_in_flight(served):
    model, srv = served
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, V, (n,)).tolist() for n in (8, 5, 11)]
    want = [solo(model, p, 6) for p in prompts]
    assert jax_engine_tokens(prompts, 6) == want
    results = [None] * len(prompts)

    def worker(i):
        status, data = _post(srv, "/v1/completions",
                             {"prompt_token_ids": prompts[i],
                              "max_tokens": 6})
        results[i] = (status, json.loads(data))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (status, out) in enumerate(results):
        assert status == 200
        assert out["choices"][0]["token_ids"] == want[i], i


def test_sampling_override_and_reproducibility(served):
    _, srv = served
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": _prompt(3, 6), "max_tokens": 8,
                          "temperature": 0.7, "top_k": 40})
    assert status == 200
    out = json.loads(data)
    assert len(out["choices"][0]["token_ids"]) == 8


def test_error_paths(served):
    _, srv = served
    status, data = _post(srv, "/v1/completions", {"max_tokens": 4})
    assert status == 400 and b"prompt" in data
    status, data = _post(srv, "/v1/completions",
                         {"prompt": "hello", "max_tokens": 4})
    assert status == 400 and b"tokenizer" in data
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": [1] * 100, "max_tokens": 10})
    assert status == 400 and b"max_len" in data
    status, _ = _post(srv, "/v1/nope", {})
    assert status == 404
    # wrong-typed fields answer 400, not a dropped connection
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": [1, 2], "max_tokens": "ten"})
    assert status == 400
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": [1, 2], "do_sample": True,
                          "temperature": None})
    assert status == 400
    # pixel_values to a text-only model: a client error, not a 500
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": [1, 2], "max_tokens": 3,
                          "pixel_values": [[[[0.0]]]]})
    assert status == 400 and b"multimodal" in data
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": [1, 2], "max_tokens": 3,
                          "pixel_values": [[1.0, 2.0]]})
    assert status == 400 and b"n_images" in data


def test_priority_and_slo_params(served):
    model, srv = served
    prompt = _prompt(3, 7)
    # a deadline of ten minutes: the request carries one, and no loaded
    # run spends it before the engine answers
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 5,
                          "priority": 0, "slo_ms": 600000.0})
    assert status == 200
    assert json.loads(data)["choices"][0]["token_ids"] == solo(model,
                                                               prompt, 5)
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 2,
                          "slo_ms": -5})
    assert status == 400 and b"slo_ms" in data
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 2,
                          "priority": "urgent"})
    assert status == 400
    # a spent deadline header answers 504 before the engine is touched
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 2},
                         {"X-Request-Deadline": "-3"})
    assert status == 504 and json.loads(data)["code"] == "deadline_exceeded"


def test_keepalive_connection_reuse(served):
    """One HTTP/1.1 connection, three requests back to back, including a
    404 POST whose body must be drained."""
    model, srv = served
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    prompt = _prompt(9, 5)
    want = solo(model, prompt, 4)
    for path, body, code in (
            ("/v1/completions", {"prompt_token_ids": prompt,
                                 "max_tokens": 4}, 200),
            ("/v1/other", {"prompt_token_ids": prompt}, 404),
            ("/v1/completions", {"prompt_token_ids": prompt,
                                 "max_tokens": 4}, 200)):
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == code, (path, resp.status)
        if code == 200:
            assert json.loads(data)["choices"][0]["token_ids"] == want
    conn.close()


def test_streaming_error_has_no_done(served):
    _, srv = served
    resp, events = _sse(srv, {"prompt_token_ids": [1] * 100,
                              "max_tokens": 10, "stream": True})
    assert resp.status == 400
    assert "[DONE]" not in events


def test_health_and_models(served):
    _, srv = served
    status, _ = _post(srv, "/v1/completions",
                      {"prompt_token_ids": _prompt(10, 5), "max_tokens": 3})
    assert status == 200
    status, health = _get(srv, "/health")
    assert status == 200 and health["status"] == "ok"
    assert health["max_batch"] == 4
    stats = health["stats"]
    assert stats["requests_finished"] >= 1
    assert stats["tokens_generated"] >= stats["requests_finished"]
    assert 0.0 <= stats["slot_utilization"] <= 1.0
    assert health["active"] == stats["requests_active"]
    status, models = _get(srv, "/v1/models")
    assert status == 200
    assert models["data"][0]["id"] == "tiny-llama"


def test_stop_token_ids(served):
    model, srv = served
    prompt = _prompt(11, 6)
    want = solo(model, prompt, 8)
    stop_at = want[2]
    assert jax_engine_tokens([prompt], 8, stop_token_ids=[stop_at]) == [
        want[:want.index(stop_at) + 1]]
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 8,
                          "stop_token_ids": [stop_at]})
    assert status == 200
    out = json.loads(data)
    assert out["choices"][0]["token_ids"] == want[:want.index(stop_at) + 1]
    assert out["choices"][0]["finish_reason"] == "stop"
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 8,
                          "stop_token_ids": [10 ** 6]})
    out = json.loads(data)
    assert out["choices"][0]["token_ids"] == want
    assert out["choices"][0]["finish_reason"] == "length"
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 8,
                          "stop_token_ids": []})
    assert status == 200
    assert json.loads(data)["choices"][0]["token_ids"] == want


def test_logprobs(served):
    model, srv = served
    prompt = _prompt(13, 6)
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 4,
                          "logprobs": True})
    assert status == 200
    out = json.loads(data)["choices"][0]
    toks = out["token_ids"]
    lps = out["logprobs"]["token_logprobs"]
    assert len(lps) == len(toks) == 4
    with torch.no_grad():
        logits = model(torch.tensor([prompt]))
    ref = torch.log_softmax(logits[0, -1].float(), -1)
    assert abs(float(ref[toks[0]]) - lps[0]) < 1e-3
    assert all(lp <= 0.0 for lp in lps)
    # and the JAX engine's logprobs on the same weights
    eng = _jax_engine()
    rid = eng.add_request(np.asarray(prompt), max_new_tokens=4,
                          logprobs=True)
    eng.run_until_done()
    np.testing.assert_allclose(lps, eng.logprobs(rid), rtol=0, atol=1e-4)
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 3,
                          "logprobs": 0})
    assert status == 200
    assert len(json.loads(data)["choices"][0]["logprobs"]
               ["token_logprobs"]) == 3
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 3,
                          "logprobs": False})
    assert status == 200
    assert "logprobs" not in json.loads(data)["choices"][0]
    _, events = _sse(srv, {"prompt_token_ids": prompt, "max_tokens": 3,
                           "stream": True, "logprobs": True})
    chunks = [json.loads(e) for e in events if e != "[DONE]"]
    stream_lps = [c["choices"][0]["logprobs"]["token_logprobs"][0]
                  for c in chunks]
    assert len(stream_lps) == 3
    assert abs(stream_lps[0] - lps[0]) < 1e-6


def test_n_completions(served):
    _, srv = served
    prompt = _prompt(14, 6)
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 5,
                          "n": 3, "temperature": 0.9, "logprobs": True})
    assert status == 200
    out = json.loads(data)
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    for c in out["choices"]:
        assert len(c["token_ids"]) == 5
        assert len(c["logprobs"]["token_logprobs"]) == 5
    assert out["usage"]["completion_tokens"] == 15
    assert out["usage"]["dispatches"] == 15
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 5,
                          "n": 3})
    assert status == 400 and b"sampling" in data
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": prompt, "max_tokens": 5,
                          "n": 2, "temperature": 0.9, "stream": True})
    assert status == 400 and b"stream" in data


# ---- what the port's server adds to the JAX cases ---------------------------

def test_traceparent_in_and_out_and_trace_route(served):
    _, srv = served
    tid, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt_token_ids": _prompt(20, 5),
                             "max_tokens": 3}),
                 {"Content-Type": "application/json",
                  "traceparent": f"00-{tid}-{parent}-01"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    assert resp.status == 200
    got = tracing.parse_traceparent(resp.getheader("traceparent"))
    assert got is not None and got[0] == tid
    status, body = _get(srv, f"/trace?trace_id={tid}")
    names = {s["name"] for s in body["spans"]}
    assert {"http.request", "serving.request", "serving.queue_wait",
            "serving.prefill", "serving.decode_step",
            "serving.slot_free"} <= names
    status, chrome = _get(srv, f"/trace/chrome?trace_id={tid}")
    assert status == 200 and chrome["traceEvents"]


def test_audit_header_metrics_profile_kvstate(served):
    model, srv = served
    status, data = _post(srv, "/v1/completions",
                         {"prompt_token_ids": _prompt(21, 7),
                          "max_tokens": 4}, {"X-Audit": "1"})
    assert status == 200
    audit = json.loads(data)["audit"]
    assert audit["verdict"] == "pass" and audit["first_divergence"] is None
    status, body = _get(srv, "/audit")
    assert body["engines"]["decoder"]["verdicts"]["pass"] >= 1
    status, text = _get(srv, "/metrics", raw=True)
    lines = text.decode().splitlines()
    finished = [ln for ln in lines if ln.startswith(
        'serving_requests_total{engine="decoder",event="finished"}')]
    assert finished and float(finished[0].split()[-1]) >= 1
    assert any(ln.startswith("serving_http_requests_total") for ln in lines)
    status, prof = _get(srv, "/profile")
    phases = prof["engines"]["decoder"]["phases"]
    assert {"admit", "prefill", "dispatch", "sync", "retire"} <= set(phases)
    status, kv = _get(srv, "/kvstate")
    ent = kv["engines"]["decoder"]
    eng = srv.engine
    pool = sum(c[k].numel() * c[k].element_size()
               for c in eng._caches for k in ("k_pages", "v_pages"))
    assert ent["capacity_bytes"] == pool
    assert ent["pages_in_use"] == 0      # every request retired
    status, events = _get(srv, "/debug/events?kind=engine")
    assert status == 200 and events["events"]


def test_engine_command_and_client_disconnect(served):
    """An EngineCommand runs on the engine thread; a streaming client
    that goes away mid stream ends in the engine's ``cancelled``."""
    _, srv = served

    class Probe(EngineCommand):
        def execute(self, engine):
            return threading.current_thread().name

    assert srv.submit_command(Probe()) == "engine-loop"
    eng = srv.engine
    n0 = eng.stats()["requests_cancelled"]
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt_token_ids": _prompt(22, 6),
                             "max_tokens": 40, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.fp.readline()          # the first chunk's size line

    class Pause(EngineCommand):
        def __init__(self):
            super().__init__()
            self.started, self.go = threading.Event(), threading.Event()

        def execute(self, engine):
            self.started.set()
            self.go.wait(60)

    # hold the engine thread between steps while the client goes away, so
    # the stream is still early in its 40 tokens when the server notices
    pause = Pause()
    waiter = threading.Thread(target=srv.submit_command, args=(pause,))
    waiter.start()
    assert pause.started.wait(60)
    # the client goes away: a reset, so the server's next write fails
    conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
    conn.sock.close()
    conn.close()
    pause.go.set()
    waiter.join(60)
    assert not waiter.is_alive()

    class Reasons(EngineCommand):
        def execute(self, engine):
            return engine.stats()["requests_cancelled"]

    for _ in range(200):
        if srv.submit_command(Reasons()) > n0:
            break
        time.sleep(0.05)
    assert srv.submit_command(Reasons()) == n0 + 1
    rid = max(eng._finished_reason)
    assert eng.finish_reason(rid) == "cancelled"


def test_string_prompt_with_tokenizer():
    # last in the file: its engine takes over the process-wide "decoder"
    # registrations that /profile, /kvstate and /audit read
    class ToyTok:
        def encode(self, s):
            return [ord(c) % 256 + 1 for c in s]

        def decode(self, ids):
            return "".join(chr((i - 1) % 256) for i in ids)

    _, model = llama_pair()
    eng = ContinuousBatchEngine(model, max_batch=2, max_len=64, page_size=8)
    tok = ToyTok()
    with CompletionServer(eng, tokenizer=tok) as srv:
        prompt = "hello tpu"
        want = solo(model, tok.encode(prompt), 5)
        status, data = _post(srv, "/v1/completions",
                             {"prompt": prompt, "max_tokens": 5})
        assert status == 200
        out = json.loads(data)
        assert out["choices"][0]["token_ids"] == want
        assert out["choices"][0]["text"] == tok.decode(want)
    # a closed server leaves nothing holding its engine (the process-wide
    # registries keep the sentinel, profiler and atlas of the label)
    ref = weakref.ref(eng)
    del eng, srv
    gc.collect()
    assert ref() is None
