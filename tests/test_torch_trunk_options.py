"""The Llama trunk's q/k/v projection biases (``attention_bias``, Qwen2)
and q/k RMSNorm (``qk_norm``: ``True`` per head, Qwen3; ``"full"`` over
the projected width, OLMo2) against the JAX package, on the CPU, on a
small Llama of head_dim 128 built in both packages from the same numpy
weights (biases and norm scales 1 + 0.1 N(0, 1), so every term counts):
the non-cached logits, the bucketed prefill into a dense cache, the paged
engine's prefill and decode step, and greedy ``generate`` tokens on the
dense and paged caches. f32: logits and caches within atol 1e-4, rtol
1e-4 (sums in another order); tokens identical. The fused decode tail's
gate declines such layers, as the JAX gate does."""
import numpy as np
import pytest
import torch
from test_torch_pair import build_pair, jax_generate, mix_prompts

import jax.numpy as jnp
import paddle_tpu
from paddle_tpu.generation import _get_prefill_step
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu_torch.generation import _PrefillStep
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           fused_decode_structural)
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 128
OPTIONS = {"bias": dict(attention_bias=True),
           "qk-per-head": dict(qk_norm=True),
           "qk-full": dict(qk_norm="full")}


@pytest.fixture(scope="module", params=list(OPTIONS))
def pair(request):
    kw = OPTIONS[request.param]
    jax_model, port_model, state = build_pair(max_len=MAX_LEN, seed=5, **kw)
    return kw, jax_model, port_model, state


def test_parameters_are_the_jax_ones(pair):
    """The same parameter names as the JAX layer (q/k/v biases, never
    o_proj's; q_norm / k_norm of head_dim or of the projected width); a
    new model's biases start at 0 and its norm scales at 1."""
    kw, jax_model, port_model, state = pair
    names = set(dict(port_model.named_parameters()))
    assert names == set(jax_model.functional_state()) == set(state)
    attn = port_model.llama.layers[0].self_attn
    assert attn.o_proj.bias is None
    if kw.get("attention_bias"):
        assert "llama.layers.0.self_attn.k_proj.bias" in names
    if kw.get("qk_norm"):
        width = 128 if kw["qk_norm"] in (True, "per_head") else 4 * 128
        assert attn.q_norm.weight.shape == (width,)
    fresh = type(port_model)(port_model.config, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    for name, p in fresh.named_parameters():
        if name.endswith("_proj.bias"):
            assert not bool(p.detach().any())
        if name.endswith("norm.weight"):
            assert bool((p == 1).all())


def test_uncached_logits_match_jax(pair):
    _, jax_model, port_model, _ = pair
    ids = np.random.RandomState(1).randint(0, 512, (2, 24))
    want = np.asarray(jax_model(paddle_tpu.to_tensor(ids))._array)
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_prompt", [32, 21])   # unpadded, padded bucket
def test_dense_prefill_logits_and_cache_match_jax(pair, n_prompt):
    _, jax_model, port_model, _ = pair
    bucket = 32
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n_prompt] = mix_prompts(2, (n_prompt,))[0]
    ragged = n_prompt != bucket
    pad = np.zeros((1, bucket), bool)
    pad[0, :n_prompt] = True
    j_last, j_caches = _get_prefill_step(jax_model, bucket, ragged,
                                         rope_len=MAX_LEN)(
        jnp.asarray(ids), jnp.asarray([n_prompt], jnp.int32),
        jnp.asarray(pad) if ragged else None)
    p_last, p_caches = _PrefillStep(port_model, bucket, ragged,
                                    rope_len=MAX_LEN)(
        torch.from_numpy(ids), torch.tensor([n_prompt], dtype=torch.int32),
        torch.from_numpy(pad) if ragged else None)
    np.testing.assert_allclose(p_last.numpy(), np.asarray(j_last), **TOL)
    for jc, pc in zip(j_caches, p_caches):
        for key in ("k", "v"):
            np.testing.assert_allclose(pc[key].numpy()[:, :n_prompt],
                                       np.asarray(jc[key])[:, :n_prompt],
                                       **TOL)


def test_paged_engine_logits_match_jax(pair):
    """Two requests into the paged pool, then two decode steps: the last
    logits after the prefills and after each step, and the pages."""
    _, jax_model, port_model, _ = pair
    jax_eng = JaxEngine(jax_model, max_batch=2, max_len=MAX_LEN, page_size=16)
    port_eng = PortEngine(port_model, max_batch=2, max_len=MAX_LEN,
                          page_size=16)
    for p in mix_prompts(3, (19, 32)):
        jax_eng.add_request(p, max_new_tokens=4)
        port_eng.add_request(p, max_new_tokens=4)
    np.testing.assert_allclose(port_eng._last.numpy(),
                               np.asarray(jax_eng._last), **TOL)
    for _ in range(2):
        jax_eng.step()
        port_eng.step()
        np.testing.assert_allclose(port_eng._last.numpy(),
                                   np.asarray(jax_eng._last), **TOL)
    for jc, pc in zip(jax_eng._caches, port_eng._caches):
        np.testing.assert_allclose(pc["k_pages"].numpy(),
                                   np.asarray(jc["k_pages"]), **TOL)


@pytest.mark.parametrize("route", ["dense", "paged"])
def test_greedy_generate_tokens_match_jax(pair, route):
    _, jax_model, port_model, _ = pair
    ids = np.random.RandomState(4).randint(0, 512, (2, 12))
    kw = dict(max_new_tokens=6)
    if route == "paged":
        kw.update(paged=True, page_size=8)
    want = jax_generate(jax_model, ids, **kw)
    got = port_model.generate(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_decode_tail_declines_the_layer(pair):
    """The structural half of the gate refuses a layer with a q/k norm or
    a biased projection, as ``llama.py:786-790`` does; the same layer
    without the options is taken."""
    kw, _, port_model, _ = pair
    layer = port_model.llama.layers[0]
    assert not fused_decode_structural(layer, torch.float32)
    plain = type(port_model)(LlamaConfig.tiny(**{
        k: getattr(port_model.config, k) for k in (
            "hidden_size", "intermediate_size", "num_attention_heads",
            "num_key_value_heads", "num_hidden_layers")}), device="cpu")
    assert fused_decode_structural(plain.llama.layers[0], torch.float32)
