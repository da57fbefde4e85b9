"""Port parity of the Mistral family (sliding-window attention) against the
JAX package, on the CPU with the plain versions: the config presets, the
weight bridge, the logits of a sequence longer than the window, a 3-step
``train_step`` trajectory and the serving engine with prompts beyond the
window (exact and padded buckets, the paged band gather in decode), the
fused decode tail off and on. f32; each test states its tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_decode_tail import fused_flag  # noqa: F401  (fixture)
from test_torch_decode_tail import trace_jax_afresh
from test_torch_pair import SMALL, mix_prompts, numpy_state

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.models.mistral import MistralConfig as JaxConfig
from paddle_tpu.models.mistral import MistralForCausalLM as JaxLM
from paddle_tpu.ops.pallas import decode_tail as jax_tail
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models import MistralConfig, MistralForCausalLM
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.weights import from_jax_state, to_numpy_state


def _pair(max_len, seed=0, **kw):
    """(jax_model, port_model, numpy state) of ``MistralConfig.tiny(**kw)``
    holding the same f32 weights; the JAX rope table is built eagerly (see
    test_torch_pair.build_pair)."""
    paddle_tpu.seed(seed)
    jax_model = JaxLM(JaxConfig.tiny(**kw))
    state = numpy_state(jax_model, seed)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(max_len)
    port_model = from_jax_state(state, MistralConfig.tiny(**kw),
                                device="cpu")
    return jax_model, port_model, state


def test_presets_match_jax():
    for name in ("mistral_7b", "tiny"):
        want = dataclasses.asdict(getattr(JaxConfig, name)())
        got = dataclasses.asdict(getattr(MistralConfig, name)())
        for key, value in got.items():
            if key in want:
                assert value == want[key], (name, key)
    cfg = MistralConfig.mistral_7b()
    assert (cfg.sliding_window, cfg.vocab_size, cfg.rope_theta,
            cfg.tie_word_embeddings) == (4096, 32000, 10000.0, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_round_trip_bit_exact(dtype):
    """Every parameter of a JAX ``MistralForCausalLM``, the untied lm_head
    included, crosses into the port's ``MistralForCausalLM`` and back bit
    for bit (bf16 as its uint16 pattern)."""
    paddle_tpu.seed(2)
    cfg = dict(sliding_window=8, dtype=dtype)
    jax_model = JaxLM(JaxConfig.tiny(**cfg))
    state = {k: np.asarray(v)
             for k, v in jax_model.functional_state().items()}
    assert "lm_head.weight" in state
    model = from_jax_state(state, MistralConfig.tiny(**cfg), device="cpu")
    assert type(model) is MistralForCausalLM
    assert all(layer.self_attn.window == 8 for layer in model.llama.layers)
    back = to_numpy_state(model)
    assert set(back) == set(state)
    for name, arr in state.items():
        want = arr.view(np.uint16) if dtype == "bfloat16" else arr
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_logits_beyond_the_window_match_jax():
    """Logits of the non-cached forward at sequence 24 over window 8; f32,
    within rtol 1e-4, atol 1e-4 (as the Llama parity tests). The window
    bites: a windowless model gives other logits."""
    jax_model, port_model, _ = _pair(24, sliding_window=8)
    ids = np.random.RandomState(3).randint(0, 512, size=(2, 24))
    want = np.asarray(jax_model(paddle_tpu.to_tensor(ids)).numpy())
    got = port_model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for layer in port_model.llama.layers:
        layer.self_attn.window = None
    wide = port_model(torch.from_numpy(ids)).detach().numpy()
    assert np.abs(wide - want).max() > 1e-2


def test_train_step_matches_jax():
    """Three ``train_step``s of AdamW(3e-4, weight_decay=0.1) on one batch
    of sequence 16 over window 8, f32: losses within 1e-5 relative at every
    step, parameters as in test_torch_train (within 1e-6 but for at most
    0.1% of each tensor, and those within 2 * 3 * lr)."""
    jax_model, port_model, _ = _pair(16, seed=1, sliding_window=8)
    step_j = paddle_tpu.jit.train_step(
        jax_model, lambda m, a, b: m(a, labels=b)[0],
        jax_opt.AdamW(3e-4, parameters=jax_model.parameters(),
                      weight_decay=0.1))
    step_p = port_train_step(
        port_model, lambda m, a, b: m(a, labels=b)[0],
        port_opt.AdamW(3e-4, parameters=port_model.parameters(),
                       weight_decay=0.1))
    ids = np.random.RandomState(0).randint(0, 512, size=(2, 17))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    losses = []
    for _ in range(3):
        lj = float(step_j(paddle_tpu.to_tensor(x),
                          paddle_tpu.to_tensor(y)).numpy())
        lp = step_p(torch.from_numpy(x), torch.from_numpy(y)).item()
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
        losses.append(lp)
    assert losses[2] < losses[0]
    jstate = jax_model.functional_state()
    for name, p in port_model.named_parameters():
        diff = np.abs(p.detach().numpy()
                      - np.asarray(jstate[name]).astype(np.float32))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 2 * 3 * 3e-4, name


ENGINE = dict(max_batch=3, max_len=64, page_size=8)
LENGTHS = (16, 21, 32, 5)       # exact, padded, exact, padded buckets
NEW_TOKENS = (8, 6, 10, 7)


def _engine_run(engine, prompts):
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True)
            for p, n in zip(prompts, NEW_TOKENS)]
    out = engine.run_until_done()
    return [(out[r].tolist(), engine.logprobs(r)) for r in rids]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_beyond_the_window_matches_jax(fused, fused_flag,
                                             monkeypatch):
    """Window 8 at head_dim 128, four requests on three slots: exact
    buckets take the flash route, padded ones the einsum whose window counts
    true positions, every decode step the band gather (window 8 < max_len
    64). Greedy tokens identical to the JAX engine's, logprobs within
    1e-4, with the fused decode tail off and on in both packages."""
    from paddle_tpu_torch import generation as port_gen

    kw = dict(SMALL, sliding_window=8)
    jax_model, port_model, _ = _pair(ENGINE["max_len"], **kw)
    prompts = mix_prompts(5, LENGTHS)
    routes = []
    for name in ("flash_attention_bshd", "append_attention_plain",
                 "_paged_window_attention"):
        real = getattr(port_gen, name)
        monkeypatch.setattr(
            port_gen, name,
            lambda *a, _real=real, _name=name, **k: (
                routes.append((_name, k.get("window", a[-1]))),
                _real(*a, **k))[1])
    with flags.flag_overrides({"use_fused_decode_tail": fused}):
        eng = PortEngine(port_model, **ENGINE)
        got = _engine_run(eng, prompts)
    # per layer: two exact prefills through flash, two padded ones through
    # the einsum, and every decode step through the band gather alone
    layers = port_model.config.num_hidden_layers
    steps = eng.stats()["decode_steps"]
    assert routes.count(("flash_attention_bshd", 8)) == 2 * layers
    assert routes.count(("append_attention_plain", 8)) == 2 * layers
    assert routes.count(("_paged_window_attention", 8)) == steps * layers
    assert len(routes) == (4 + steps) * layers
    jax_set_flags({"FLAGS_use_fused_decode_tail": fused})
    trace_jax_afresh()
    want = _engine_run(JaxEngine(jax_model, **ENGINE), prompts)
    assert bool(jax_tail._announced) == fused
    for (gt, gl), (wt, wl), n in zip(got, want, NEW_TOKENS):
        assert len(gt) == n
        assert gt == wt
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
