"""Shared set-up of the port parity tests (``test_torch_llama``,
``test_torch_serving``, ...): one small Llama built in both packages from
the same numpy weights, and a check that the pair really shares them; CPU
tensors posing as CUDA and stand-in kernel launches for the route tests.

The config has head_dim 128 (the real one) at a small width. Weights are
drawn with numpy from a seed with a wider spread than the initializer's
(projections 0.05, norms 1 + 0.1 N(0, 1)), so greedy choices are decided by
clear margins rather than by f32 rounding."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SMALL = dict(hidden_size=512, intermediate_size=1024, num_attention_heads=4,
             num_key_value_heads=1, num_hidden_layers=2)


def numpy_state(jax_model, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, arr in jax_model.functional_state().items():
        if arr.ndim == 1:
            w = 1.0 + 0.1 * rng.randn(*arr.shape)
        else:
            w = 0.05 * rng.randn(*arr.shape)
        out[name] = w.astype(np.float32)
    return out


def build_pair(max_len=128, seed=0, **overrides):
    """(jax_model, port_model, numpy state) with identical f32 weights. The
    JAX model's rope table for ``max_len`` is built eagerly here: under
    jax 0.9 ``paddle_tpu.jit.is_tracing()`` is always False, so a table first
    built inside a jitted prefill would be memoised as a tracer."""
    import paddle_tpu
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
    from paddle_tpu_torch.weights import from_jax_state

    kw = dict(SMALL, **overrides)
    paddle_tpu.seed(seed)
    jax_model = LlamaForCausalLM(LlamaConfig.tiny(**kw))
    state = numpy_state(jax_model, seed)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(max_len)
    port_model = from_jax_state(state, PortConfig.tiny(**kw), device="cpu")
    return jax_model, port_model, state


def mix_prompts(seed=0, lengths=(5, 16, 32, 40, 64), vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


class _Dev(str):
    type = "cuda"


class _OnCuda(torch.Tensor):
    @property
    def device(self):
        return _Dev("cpu")


def posing_as_cuda(t, grad=False):
    """``t`` (a CPU tensor) whose ``device`` reads as CUDA to the kernel
    wrappers' checks, while what they allocate "on its device" still lands
    on the CPU: a CUDA route runs up to its C calls without a card. One
    class for every such tensor, so that torch ops may mix them."""
    return t.as_subclass(_OnCuda).requires_grad_(grad)


@pytest.fixture
def fake_kernels(monkeypatch):
    """Stand-ins for the kernels' C entry points: each records its name and
    arguments and returns 0 (success), on no stream; no device check;
    fresh launch counters. Yields the list of (name, args) calls."""
    from paddle_tpu_torch.ops.hopper import _build

    calls = []

    def function(stem, name, argtypes):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda device: None)
    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_build, "launches", Counter())
    return calls


def test_build_pair_shares_every_weight():
    jax_model, port_model, state = build_pair(max_len=32)
    jax_state = jax_model.functional_state()
    port_state = dict(port_model.named_parameters())
    assert set(jax_state) == set(port_state) == set(state)
    for name, arr in state.items():
        np.testing.assert_array_equal(np.asarray(jax_state[name]), arr,
                                      err_msg=name)
        np.testing.assert_array_equal(port_state[name].detach().numpy(), arr,
                                      err_msg=name)
