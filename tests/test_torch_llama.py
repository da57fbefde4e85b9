"""Port parity of the Llama serving trunk: the weight bridge, the bucketed
prefill and one paged decode step, each against the JAX package on the
same numpy weights (f32; logits within atol 1e-4, rtol 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import SMALL, build_pair, mix_prompts

from paddle_tpu.generation import _get_prefill_step
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu_torch.generation import _PrefillStep
from paddle_tpu_torch.models.llama import _rope_tables as port_rope_tables
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.weights import from_jax_state, to_numpy_state

TOL = dict(rtol=1e-4, atol=1e-4)


def test_state_round_trip_f32_bit_exact():
    jax_model, port_model, state = build_pair()
    assert set(state) == set(jax_model.functional_state())
    assert set(dict(port_model.named_parameters())) == set(state)
    back = to_numpy_state(port_model)
    for name, arr in state.items():
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # Paddle's [in, out] Linear layout crosses unchanged
    assert back["llama.layers.0.self_attn.k_proj.weight"].shape == (512, 128)


def test_state_round_trip_bf16_bit_exact():
    import paddle_tpu
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig

    paddle_tpu.seed(1)
    kw = dict(SMALL, num_hidden_layers=1, dtype="bfloat16")
    jax_model = LlamaForCausalLM(LlamaConfig.tiny(**kw))
    state = {k: np.asarray(v) for k, v in jax_model.functional_state().items()}
    model = from_jax_state(state, PortConfig.tiny(**kw), device="cpu")
    assert model.lm_head.weight.dtype == torch.bfloat16
    back = to_numpy_state(model)
    for name, arr in state.items():
        assert back[name].dtype == np.uint16
        np.testing.assert_array_equal(back[name], arr.view(np.uint16),
                                      err_msg=name)
    # uint16 bit patterns go in as well and come back the same
    again = to_numpy_state(from_jax_state(back, PortConfig.tiny(**kw),
                                          device="cpu"))
    for name in state:
        np.testing.assert_array_equal(again[name], back[name])


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
])
def test_rope_tables_match(scaling):
    cos_j, sin_j = jax_rope_tables(96, 128, 500000.0, scaling=scaling)
    cos_p, sin_p = port_rope_tables(96, 128, 500000.0, scaling=scaling)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n_prompt", [32, 21])   # unpadded, padded bucket
@pytest.mark.parametrize("tied", [False, True])
def test_prefill_logits_and_cache_match(n_prompt, tied):
    max_len, bucket = 128, 32
    jax_model, port_model, _ = build_pair(max_len=max_len,
                                          tie_word_embeddings=tied)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n_prompt] = mix_prompts(1, (n_prompt,))[0]
    ragged = n_prompt != bucket
    pad = np.zeros((1, bucket), bool)
    pad[0, :n_prompt] = True
    j_last, j_caches = _get_prefill_step(jax_model, bucket, ragged,
                                         rope_len=max_len)(
        jnp.asarray(ids), jnp.asarray([n_prompt], jnp.int32),
        jnp.asarray(pad) if ragged else None)
    p_last, p_caches = _PrefillStep(port_model, bucket, ragged,
                                    rope_len=max_len)(
        torch.from_numpy(ids), torch.tensor([n_prompt], dtype=torch.int32),
        torch.from_numpy(pad) if ragged else None)
    np.testing.assert_allclose(p_last.numpy(), np.asarray(j_last), **TOL)
    for jc, pc in zip(j_caches, p_caches):
        for key in ("k", "v"):
            np.testing.assert_allclose(pc[key].numpy()[:, :n_prompt],
                                       np.asarray(jc[key])[:, :n_prompt],
                                       **TOL)


def test_paged_decode_step_logits_match():
    """Two requests admitted into the paged pool, then one fused decode
    step: the last-logit rows agree after the prefill and after the step."""
    max_len = 128
    jax_model, port_model, _ = build_pair(max_len=max_len)
    jax_eng = JaxEngine(jax_model, max_batch=2, max_len=max_len, page_size=16)
    port_eng = PortEngine(port_model, max_batch=2, max_len=max_len,
                          page_size=16)
    for p in mix_prompts(2, (19, 32)):
        jax_eng.add_request(p, max_new_tokens=4)
        port_eng.add_request(p, max_new_tokens=4)
    np.testing.assert_allclose(port_eng._last.numpy(),
                               np.asarray(jax_eng._last), **TOL)
    jax_eng.step()
    port_eng.step()
    np.testing.assert_array_equal(port_eng._lengths,
                                  np.asarray(jax_eng._lengths))
    np.testing.assert_allclose(port_eng._last.numpy(),
                               np.asarray(jax_eng._last), **TOL)
    # the written KV pages agree too
    for jc, pc in zip(jax_eng._caches, port_eng._caches):
        np.testing.assert_allclose(pc["k_pages"].numpy(),
                                   np.asarray(jc["k_pages"]), **TOL)
