"""Port parity of speculative decoding: the n-gram drafter, the paged
verify chunk, and the speculative engine (k in {1, 4}, fused decode tail off
and on) against the JAX speculative engine and the port's one-token engine
on the same weights (f32: greedy tokens identical, logprobs within atol
1e-4, equal ``spec_*`` stats)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_decode_tail import fused_flag  # noqa: F401  (fixture)
from test_torch_pair import build_pair, mix_prompts

from paddle_tpu.generation import \
    paged_cached_attention as jax_paged_attention
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu.speculative import ngram_propose as jax_propose
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.generation import paged_cached_attention
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.speculative import ngram_propose
from paddle_tpu_torch.utils.flags import flag_overrides

ENGINE = dict(max_batch=2, max_len=128, page_size=16)
SPEC_KEYS = ("spec_dispatches", "spec_emitted_tokens", "spec_accepted_tokens",
             "accepted_tokens_per_dispatch", "decode_steps",
             "tokens_generated", "requests_finished")


@pytest.fixture(scope="module")
def pair():
    jax_model, port_model, _ = build_pair(max_len=ENGINE["max_len"])
    return jax_model, port_model


def _repetitive(seed=0, period=1, reps=30):
    rng = np.random.RandomState(seed)
    return np.tile(rng.randint(0, 512, size=period), reps).astype(np.int32)


# ---- the drafter ------------------------------------------------------------

@pytest.mark.parametrize("hist, k, n", [
    ([], 3, 3), ([5], 3, 3), ([1, 2, 3, 1, 2], 3, 3),
    ([1, 2, 9, 4, 1, 2, 8, 4, 1, 2], 2, 3), ([9, 9, 9], 3, 3),
    ([4, 6, 4, 6], 4, 3), ([1, 2, 3], 0, 3), ([1, 2, 3, 4], 3, 3),
    ("random", 5, 2), ("random", 4, 3), ("periodic", 6, 3)])
def test_ngram_propose_matches_jax(hist, k, n):
    if hist == "random":
        hist = np.random.RandomState(k).randint(0, 6, size=40)
    elif hist == "periodic":
        hist = _repetitive(0, 5, 6)
    got = ngram_propose(hist, k, n)
    want = jax_propose(hist, k, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---- the verify chunk -------------------------------------------------------

def test_paged_verify_chunk_matches_jax():
    """S = 3 tokens per row over the paged pool: rope at lengths[b] + j, the
    scattered KV and the chunk-causal attention."""
    rng = np.random.RandomState(3)
    B, S, H, hk, D, ps, pps = 2, 3, 4, 1, 128, 16, 4
    n_pages = B * pps
    q, k, v = (rng.randn(B, S, n, D).astype(np.float32)
               for n in (H, hk, hk))
    kp, vp = (rng.randn(hk, n_pages, ps, D).astype(np.float32)
              for _ in range(2))
    pidx = rng.permutation(n_pages).reshape(B, pps).astype(np.int32)
    lengths = np.array([14, 33], np.int32)        # the chunk crosses a page
    cos, sin = _rope_tables(pps * ps, D, 10000.0)
    out, kp2, vp2 = paged_cached_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), cos, sin,
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
        torch.from_numpy(pidx), torch.from_numpy(lengths), ps)
    want, wk, wv = jax_paged_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(cos.numpy()),
        jnp.asarray(sin.numpy()), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pidx), jnp.asarray(lengths), ps)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(kp2.numpy(), np.asarray(wk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(wv))


# ---- the engine -------------------------------------------------------------

def _run(engine, prompts, news):
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True)
            for p, n in zip(prompts, news)]
    out = engine.run_until_done()
    return [(out[r].tolist(), engine.logprobs(r)) for r in rids]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_spec_engine_matches_jax_and_one_token(pair, fused_flag, k, fused):
    jax_model, port_model = pair
    prompts = mix_prompts(8, (7, 19)) + [_repetitive(1),
                                         _repetitive(2, 2, 15)]
    news = (8, 5, 12, 10)
    one_token = _run(PortEngine(port_model, **ENGINE), prompts, news)
    with flag_overrides({"use_fused_decode_tail": fused}):
        port_eng = PortEngine(port_model, speculative_k=k, **ENGINE)
        got = _run(port_eng, prompts, news)
    jax_set_flags({"FLAGS_use_fused_decode_tail": fused})
    jax_eng = JaxEngine(jax_model, speculative_k=k, **ENGINE)
    want = _run(jax_eng, prompts, news)
    for (gt, gl), (wt, wl), (ot, ol) in zip(got, want, one_token):
        assert gt == wt == ot
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
        np.testing.assert_allclose(gl, ol, rtol=0, atol=1e-4)
    p, j = port_eng.stats(), jax_eng.stats()
    for key in SPEC_KEYS:
        assert p[key] == j[key], key
    assert p["spec_dispatches"] == p["decode_steps"]
    if k == 4:   # the repetitive prompts earn accepted drafts
        assert p["spec_accepted_tokens"] > 0
        assert p["accepted_tokens_per_dispatch"] > 1.0


def test_spec_streaming_stops_and_request_counters(pair):
    """on_token streams every token of an accepted run in order (the last
    flagged done), a stop token inside a run retires the request there, and
    each request counts its rounds and accepted drafts."""
    _, port_model = pair
    p = _repetitive(3)
    ref = _run(PortEngine(port_model, **ENGINE), [p], [12])
    seen = []
    eng = PortEngine(port_model, speculative_k=4, **ENGINE)
    rid = eng.add_request(p, max_new_tokens=12,
                          on_token=lambda r, t, d: seen.append((t, d)))
    req = eng._queue[0] if eng._queue else next(
        r for r in eng._slots if r is not None)
    out = eng.run_until_done()
    assert out[rid].tolist() == ref[0][0]
    assert [t for t, _ in seen] == ref[0][0]
    assert [d for _, d in seen] == [False] * 11 + [True]
    assert req.spec_rounds == eng.stats()["spec_dispatches"]
    assert req.spec_accepted == eng.stats()["spec_accepted_tokens"]
    stop = ref[0][0][3]
    eng = PortEngine(port_model, speculative_k=4, **ENGINE)
    rid = eng.add_request(p, max_new_tokens=12, stop_token_ids=[stop])
    got = eng.run_until_done()[rid].tolist()
    j = ref[0][0].index(stop)
    assert j == 3 and eng.finish_reason(rid) == "stop"
    assert got == ref[0][0][:j + 1]


def test_spec_slack_enforced_at_admission(pair):
    """prompt + max_new + (k-1) must fit max_len."""
    _, port_model = pair
    eng = PortEngine(port_model, max_batch=1, max_len=16, page_size=4,
                     speculative_k=4)
    eng.add_request(np.arange(1, 6), max_new_tokens=8)   # 5 + 8 + 3 == 16
    with pytest.raises(ValueError, match="speculation slack"):
        eng.add_request(np.arange(1, 7), max_new_tokens=8)


def test_sampling_slot_falls_back_to_one_token_step(pair):
    import paddle_tpu_torch

    _, port_model = pair
    pg = _repetitive(1)
    ps = mix_prompts(11, (9,))[0]
    ref = _run(PortEngine(port_model, **ENGINE), [pg], [12])
    paddle_tpu_torch.seed(123)
    eng = PortEngine(port_model, speculative_k=4, **ENGINE)
    r_greedy = eng.add_request(pg, max_new_tokens=12)
    r_sample = eng.add_request(ps, max_new_tokens=4, do_sample=True,
                               temperature=0.8, top_k=7)
    done = eng.run_until_done()
    assert done[r_greedy].tolist() == ref[0][0]
    assert done[r_sample].shape == (4,)
    st = eng.stats()
    # the sampler's 4 dispatches ran one-token; speculation resumed after
    assert 0 < st["spec_dispatches"] < st["decode_steps"]


@pytest.mark.parametrize("k, err", [("auto", NotImplementedError),
                                    (0, ValueError), (200, ValueError)])
def test_spec_k_refused(pair, k, err):
    _, port_model = pair
    with pytest.raises(err, match="speculative_k"):
        PortEngine(port_model, speculative_k=k, **ENGINE)
    assert PortEngine(port_model, **ENGINE).stats()["spec_dispatches"] == 0
