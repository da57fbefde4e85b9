"""Port parity of the serving slice: paddle_tpu_torch's ContinuousBatchEngine
against paddle_tpu's on the same weights and request mix (more requests
than slots; exact and padded prefill buckets). f32: greedy tokens
identical, logprobs within atol 1e-4."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_pair import build_pair, mix_prompts

from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine

LENGTHS = (5, 16, 32, 40, 64)
NEW_TOKENS = (6, 10, 4, 8, 5)
ENGINE = dict(max_batch=3, max_len=128, page_size=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jax_model, port_model, _ = build_pair(max_len=ENGINE["max_len"])
    return jax_model, port_model


def _run(engine, prompts, **req):
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True,
                               **req)
            for p, n in zip(prompts, NEW_TOKENS)]
    out = engine.run_until_done()
    return [(out[r], engine.finish_reason(r), engine.logprobs(r))
            for r in rids]


def test_engine_greedy_tokens_and_logprobs_match(pair):
    jax_model, port_model = pair
    prompts = mix_prompts(0, LENGTHS)
    jax_eng = JaxEngine(jax_model, **ENGINE)
    port_eng = PortEngine(port_model, **ENGINE)
    want = _run(jax_eng, prompts)
    got = _run(port_eng, prompts)
    for (wt, wr, wl), (gt, gr, gl), n in zip(want, got, NEW_TOKENS):
        assert len(gt) == n
        np.testing.assert_array_equal(gt, wt)
        assert gr == wr == "length"
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    j, p = jax_eng.stats(), port_eng.stats()
    for key in ("requests_admitted", "requests_finished", "decode_steps",
                "tokens_generated", "requests_active", "requests_queued"):
        assert p[key] == j[key], key


def test_stop_token_ids_match(pair):
    jax_model, port_model = pair
    prompts = mix_prompts(0, LENGTHS)
    # a stop token the greedy stream of request 1 emits at its third step
    ref = _run(PortEngine(port_model, **ENGINE), prompts)
    stop = int(ref[1][0][2])
    want = _run(JaxEngine(jax_model, **ENGINE), prompts,
                stop_token_ids=[stop])
    got = _run(PortEngine(port_model, **ENGINE), prompts,
               stop_token_ids=[stop])
    for (wt, wr, _), (gt, gr, _) in zip(want, got):
        np.testing.assert_array_equal(gt, wt)
        assert gr == wr
    assert got[1][1] == "stop" and got[1][0][-1] == stop
    assert len(got[1][0]) <= 3


def test_eos_and_streaming(pair):
    _, port_model = pair
    prompts = mix_prompts(0, LENGTHS)
    ref = _run(PortEngine(port_model, **ENGINE), prompts)
    eos = int(ref[0][0][1])
    eng = PortEngine(port_model, eos_token_id=eos, **ENGINE)
    seen = []
    rid = eng.add_request(prompts[0], max_new_tokens=6,
                          on_token=lambda r, t, done: seen.append((r, t, done)))
    out = eng.run_until_done()
    assert out[rid].tolist() == ref[0][0][:2].tolist()
    assert eng.finish_reason(rid) == "stop"
    assert seen == [(rid, int(ref[0][0][0]), False), (rid, eos, True)]


def _stream(engine, prompts, on_token):
    """The same ``add_request`` call on either engine: every prompt with
    ``logprobs=True`` and one streaming callback. Returns [(rid, tokens,
    logprobs)]."""
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True,
                               on_token=on_token)
            for p, n in zip(prompts, NEW_TOKENS)]
    out = engine.run_until_done()
    return [(r, out[r].tolist(), engine.logprobs(r)) for r in rids]


@pytest.mark.parametrize("arity", ["four", "varargs", "three", "defaulted"])
def test_add_request_streams_as_the_jax_engine(pair, arity):
    """One ``add_request(ids, max_new_tokens=..., logprobs=True,
    on_token=cb)`` call, the JAX engine's keywords, on both engines. A
    callback with four required positional parameters or ``*args`` gets
    the chosen token's logprob as its 4th argument; a 3-parameter one, or
    one whose 4th parameter has a default, gets (rid, token, done). f32,
    greedy: tokens and done flags identical, logprobs (streamed and
    ``engine.logprobs``) within 1e-4."""
    jax_model, port_model = pair
    prompts = mix_prompts(0, LENGTHS)
    seen = {"jax": [], "port": []}

    def callback(log):
        if arity == "four":
            return lambda rid, tok, done, lp: log.append((rid, tok, done, lp))
        if arity == "varargs":
            return lambda *a: log.append(a)
        if arity == "three":
            return lambda rid, tok, done: log.append((rid, tok, done))
        return lambda rid, tok, done, lp=None: log.append(
            (rid, tok, done) if lp is None else (rid, tok, done, lp))

    want = _stream(JaxEngine(jax_model, **ENGINE), prompts,
                   callback(seen["jax"]))
    got = _stream(PortEngine(port_model, **ENGINE), prompts,
                  callback(seen["port"]))
    n_args = 4 if arity in ("four", "varargs") else 3
    for (wr, wt, wl), (gr, gt, gl) in zip(want, got):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
        w_ev = [e for e in seen["jax"] if e[0] == wr]
        g_ev = [e for e in seen["port"] if e[0] == gr]
        assert [len(e) for e in g_ev] == [len(e) for e in w_ev] == (
            [n_args] * len(gt))
        assert [e[1:3] for e in g_ev] == [e[1:3] for e in w_ev] == [
            (t, i == len(gt) - 1) for i, t in enumerate(gt)]
        if n_args == 4:
            np.testing.assert_allclose([e[3] for e in g_ev], gl, rtol=0,
                                       atol=0)
            np.testing.assert_allclose([e[3] for e in g_ev],
                                       [e[3] for e in w_ev], rtol=0,
                                       atol=1e-4)


def test_cancel_queued_and_active(pair):
    _, port_model = pair
    eng = PortEngine(port_model, max_batch=1, max_len=128, page_size=16)
    prompts = mix_prompts(3, (8, 9))
    a = eng.add_request(prompts[0], max_new_tokens=5)
    b = eng.add_request(prompts[1], max_new_tokens=5)   # waits for the slot
    assert eng.stats()["requests_queued"] == 1
    assert eng.cancel(b) and eng.finish_reason(b) == "cancelled"
    eng.step()
    assert eng.cancel(a) and eng.finish_reason(a) == "cancelled"
    assert not eng.cancel(a)
    assert eng.run_until_done() == {}
    s = eng.stats()
    assert s["requests_cancelled"] == 2 and s["requests_active"] == 0


def test_sampled_requests_are_seeded_and_in_range(pair):
    import paddle_tpu_torch

    _, port_model = pair
    prompts = mix_prompts(4, (7, 20, 33))
    runs = []
    for _ in range(2):
        paddle_tpu_torch.seed(11)
        eng = PortEngine(port_model, **ENGINE)
        rids = [eng.add_request(p, max_new_tokens=6, do_sample=True,
                                temperature=0.8, top_k=k, top_p=tp)
                for p, k, tp in zip(prompts, (0, 5, 50), (1.0, 0.9, 0.5))]
        greedy = eng.add_request(prompts[0], max_new_tokens=6)
        out = eng.run_until_done()
        runs.append([out[r].tolist() for r in rids + [greedy]])
    assert runs[0] == runs[1]
    assert all(0 <= t < 512 for row in runs[0] for t in row)
    # temperature 0 decodes greedily even when sampling is asked for
    eng = PortEngine(port_model, **ENGINE)
    r0 = eng.add_request(prompts[0], max_new_tokens=6, do_sample=True,
                         temperature=0.0)
    assert eng.run_until_done()[r0].tolist() == runs[0][3]


def test_requests_that_do_not_fit_are_refused(pair):
    _, port_model = pair
    eng = PortEngine(port_model, **ENGINE)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(np.zeros(120, np.int32), max_new_tokens=9)
    with pytest.raises(ValueError, match="temperature"):
        eng.add_request(np.zeros(4, np.int32), temperature=-1.0)


def test_no_device_and_no_cuda_raises(monkeypatch):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    from paddle_tpu_torch.framework.random import default_device

    with pytest.raises(RuntimeError):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.weights, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.ops.fused_loss, "
            "paddle_tpu_torch.speculative, paddle_tpu_torch.utils.flags, "
            "paddle_tpu_torch.ops.hopper.decode_tail, "
            "paddle_tpu_torch.models.deepseek, "
            "paddle_tpu_torch.distributed.moe, "
            "paddle_tpu_torch.ops.hopper.mla_decode, "
            "paddle_tpu_torch.serving_http\n"
            "import importlib, pkgutil, paddle_tpu_torch.observability as o\n"
            "mods = [m.name for m in pkgutil.iter_modules(o.__path__)]\n"
            "assert {'metrics', 'catalog', 'tracing', 'flightrecorder', "
            "'timer', 'snapshot', 'perf', 'kvatlas', 'timeseries', "
            "'alerts', 'sentinel'} <= set(mods), mods\n"
            "for m in mods:\n"
            "    importlib.import_module('paddle_tpu_torch.observability.' "
            "+ m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.') or m == 'ml_dtypes')\n"
            "assert not bad, bad\n"
            "print('clean')")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
