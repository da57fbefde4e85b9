"""The dense Llama-trunk families — Qwen2 / Qwen2.5, Qwen3, Phi-3, OLMo2, GLM
and GLM-4 — against the JAX package on the CPU, each at its ``tiny()`` size
(and Qwen2 at heads of 64, Phi-3 at heads of 96: the widths of
Qwen2.5-0.5B and Phi-3-mini) built in both packages from the same numpy
weights (``test_torch_pair.numpy_state``: 1-D parameters 1 + 0.1 N(0, 1),
so the q/k/v biases and the q/k norms are non-zero):

- the presets' fields and the constructors' checks (same messages);
- the bridge (``weights.from_jax_state``) builds the family's class with
  every JAX parameter, bit for bit;
- the non-cached logits, f32, within atol 1e-4, rtol 1e-4 (sums in another
  order); bf16 within 0.03 + 2^-7 |p| (one bf16 rounding of an f32 sum
  taken in another order per layer), as the other families;
- greedy tokens: JAX ``generate`` on its dense cache = the port's dense
  cache = its paged pool = ``ContinuousBatchEngine`` (two slots, three
  requests) = solo ``generate``;
- the CUDA routes with stand-in launches: the width rule
  (``append_attention.plain_width``), paged decode at D 96 and D 64 on
  their own entry points and counters, no attention launch at 96 for a
  prefill, dense decode or the forward without a cache, the (64, 64)
  instances at 64, a width no kernel takes raising before any launch.

The JAX side's rope tables are built eagerly at the lengths ``generate``
computes (``test_torch_pair.jax_generate``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import (fake_kernels, jax_generate,  # noqa: F401
                             numpy_state, posing_as_cuda)

import paddle_tpu
from paddle_tpu.models import glm as j_glm
from paddle_tpu.models import olmo2 as j_olmo2
from paddle_tpu.models import phi3 as j_phi3
from paddle_tpu.models import qwen2 as j_qwen2
from paddle_tpu.models import qwen3 as j_qwen3
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import generation as port_gen
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.models import llama as p_llama
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.ops.hopper import paged_attention as port_paged
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.weights import from_jax_state, model_class

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_RTOL = 0.03, 2.0 ** -7
# family: (JAX config, JAX model, port config, port model)
CLASSES = {
    "qwen2": (j_qwen2.Qwen2Config, j_qwen2.Qwen2ForCausalLM,
              port_models.Qwen2Config, port_models.Qwen2ForCausalLM),
    "qwen3": (j_qwen3.Qwen3Config, j_qwen3.Qwen3ForCausalLM,
              port_models.Qwen3Config, port_models.Qwen3ForCausalLM),
    "phi3": (j_phi3.Phi3Config, j_phi3.Phi3ForCausalLM,
             port_models.Phi3Config, port_models.Phi3ForCausalLM),
    "olmo2": (j_olmo2.Olmo2Config, j_olmo2.Olmo2ForCausalLM,
              port_models.Olmo2Config, port_models.Olmo2ForCausalLM),
    "glm": (j_glm.GlmConfig, j_glm.GlmForCausalLM,
            port_models.GlmConfig, port_models.GlmForCausalLM),
    "glm4": (j_glm.Glm4Config, j_glm.Glm4ForCausalLM,
             port_models.Glm4Config, port_models.Glm4ForCausalLM),
}
# the pairs: (family, tiny() keywords); Qwen2 at heads of 64 (Qwen2.5-0.5B's
# width, a group of 2) and Phi-3 at heads of 96 (Phi-3-mini's) beside the
# tiny ones
PAIRS = {
    "qwen2": ("qwen2", {}),
    "qwen2_d64": ("qwen2", dict(hidden_size=128, num_attention_heads=2,
                                num_key_value_heads=1)),
    "qwen3": ("qwen3", {}),
    "phi3": ("phi3", {}),
    "phi3_d96": ("phi3", dict(hidden_size=192, num_attention_heads=2,
                              num_key_value_heads=1)),
    "olmo2": ("olmo2", {}),
    "glm": ("glm", {}),
    "glm4": ("glm4", {}),
}
# (family, preset): the published shapes and the tiny ones
PRESETS = [("qwen2", None), ("qwen2", "qwen25_7b"), ("qwen2", "qwen25_0_5b"),
           ("qwen2", "tiny"), ("qwen3", None), ("qwen3", "qwen3_8b"),
           ("qwen3", "qwen3_4b"), ("qwen3", "tiny"), ("phi3", None),
           ("phi3", "tiny"), ("olmo2", None), ("olmo2", "tiny"),
           ("glm", None), ("glm", "tiny"), ("glm4", None), ("glm4", "tiny")]
PROMPT, NEW = 20, 6


def _build_pair(name, dtype="float32", seed=0):
    """(jax_model, port_model, numpy state) of pair ``name``: the same
    weights in both packages, bf16 ones rounded once by JAX and carried as
    their bits."""
    family, kw = PAIRS[name]
    jcfg, jlm, pcfg, _ = CLASSES[family]
    paddle_tpu.seed(seed)
    jax_model = jlm(jcfg.tiny(dtype=dtype, **kw))
    state = numpy_state(jax_model, seed)
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in state.items()}
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    jax_model.llama._rope(128)
    port = from_jax_state(state, pcfg.tiny(dtype=dtype, **kw), device="cpu")
    return jax_model, port, state


def jax_logits(model, ids):
    """The JAX model's non-cached logits, its forward jitted over its
    state."""
    def fwd(state, x):
        model.load_functional_state(state)
        return unwrap(model(wrap(x)))

    state = model.functional_state()
    out = jax.jit(fwd)(state, jnp.asarray(ids))
    model.load_functional_state(state)
    return np.asarray(out.astype(jnp.float32))


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 512, shape)


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    return (request.param,) + _build_pair(request.param, seed=13)


# ------------------------------------------------------------- families --

@pytest.mark.parametrize("family,preset", PRESETS)
def test_presets_match_jax(family, preset):
    jcfg, _, pcfg, _ = CLASSES[family]
    want = dataclasses.asdict(getattr(jcfg, preset)() if preset else jcfg())
    got = dataclasses.asdict(getattr(pcfg, preset)() if preset else pcfg())
    shared = set(want) & set(got)
    assert {"vocab_size", "hidden_size", "head_dim", "attention_bias",
            "qk_norm", "partial_rotary_factor", "rope_theta",
            "rms_norm_eps", "tie_word_embeddings", "rope_scaling",
            "max_position_embeddings"} <= shared
    for key in shared:
        assert got[key] == want[key], (family, preset, key)


@pytest.mark.parametrize("family,bad", [
    ("qwen2", dict(attention_bias=False)),
    ("qwen3", dict(qk_norm="full")),
    ("qwen3", dict(qk_norm=False)),
    ("olmo2", dict(qk_norm=True)),
    ("olmo2", dict(qk_norm=False)),
    ("glm", dict(attention_bias=False)),
    ("glm", dict(partial_rotary_factor=1.0)),
    ("glm4", dict(attention_bias=False)),
    ("glm4", dict(partial_rotary_factor=1.0)),
])
def test_constructor_checks_match_jax(family, bad):
    jcfg, jlm, pcfg, plm = CLASSES[family]
    with pytest.raises(ValueError) as jerr:
        jlm(jcfg.tiny(**bad))
    with pytest.raises(ValueError) as perr:
        plm(pcfg.tiny(**bad), device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_bridge_builds_each_family(pair):
    """``from_jax_state`` builds the family's class (``model_class``) with
    every JAX parameter, bit for bit: OLMo2's post-norm pair and no input
    norm, GLM-4's sandwich norms, the q/k/v biases, the q/k norms."""
    name, jax_model, port, state = pair
    family = PAIRS[name][0]
    assert type(port) is CLASSES[family][3]
    assert model_class(port.config) is CLASSES[family][3]
    names = set(dict(port.named_parameters()))
    assert names == set(jax_model.functional_state()) == set(state)
    layer0 = {n.split("layers.0.", 1)[1] for n in names if "layers.0." in n}
    if family == "olmo2":
        assert "input_layernorm.weight" not in layer0
        assert {"post_attention_layernorm.weight",
                "post_feedforward_layernorm.weight",
                "self_attn.q_norm.weight"} <= layer0
    if family == "glm4":
        assert {"pre_feedforward_layernorm.weight",
                "post_feedforward_layernorm.weight"} <= layer0
    if family in ("qwen2", "glm", "glm4"):
        assert "self_attn.q_proj.bias" in layer0
    for n, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), state[n])


def test_logits_match_jax_f32(pair):
    _, jax_model, port, _ = pair
    ids = _ids(1, (2, PROMPT))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jax_logits(jax_model, ids), **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_logits_close_to_jax_bf16(name):
    jax_model, port, state = _build_pair(name, dtype="bfloat16", seed=14)
    for n, p in port.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p.detach().view(torch.int16).numpy().view(np.uint16),
            np.asarray(state[n]).view(np.uint16), err_msg=n)
    ids = _ids(2, (1, 16))
    want = jax_logits(jax_model, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


def test_greedy_tokens_match_jax_dense_paged_and_engine(pair):
    """JAX ``generate``'s greedy tokens on its dense cache; the port's on
    its dense cache, its paged pool (page 8) and through the engine (two
    slots, three requests: one waits) are the same, and the engine's
    tokens are solo ``generate``'s."""
    _, jax_model, port, _ = pair
    ids = _ids(3, (2, PROMPT))
    want = jax_generate(jax_model, ids, max_new_tokens=NEW)
    for kw in ({}, dict(paged=True, page_size=8)):
        got = port.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                            **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    prompts = [ids[0], ids[1], _ids(4, (9,))]
    eng = ContinuousBatchEngine(port, max_batch=2, max_len=64)
    rids = [eng.add_request(p, max_new_tokens=NEW) for p in prompts]
    out = eng.run_until_done()
    for rid, p, row in zip(rids, prompts, (want[0], want[1], None)):
        solo = port.generate(torch.from_numpy(p[None]),
                             max_new_tokens=NEW).numpy()[0]
        np.testing.assert_array_equal(out[rid], solo)
        if row is not None:
            np.testing.assert_array_equal(out[rid], row)


def test_fused_tail_gate_declines_every_family(pair):
    """No layer of these families reaches the fused decode tail, as in
    JAX: biases, q/k norms, the partial rotary slice or a width that is no
    multiple of 128 each decline it, with the flag on."""
    from paddle_tpu_torch.utils.flags import flag_overrides

    _, _, port, _ = pair
    cos, _ = port.llama._rope(64)
    hidden = torch.zeros(1, 1, port.config.hidden_size)
    with flag_overrides({"use_fused_decode_tail": True}):
        for layer in port.llama.layers:
            assert not p_llama.fused_decode_supported(layer, hidden,
                                                      {"pos": 0}, cos)


# ------------------------------------------------------------ CUDA routes --

@pytest.mark.parametrize("widths,plain", [
    ((64, 64), False), ((96, 96), True), ((128, 128), False),
    ((192, 128), False), ((256, 256), False), ((80, 80), True),
    ((384, 384), False)])
def test_width_rule(widths, plain):
    """The plain route exactly where no instance exists and JAX's gates
    refuse the width (D % 128 != 0); 384 has no instance but passes JAX's
    gate, so the kernel route takes it and raises."""
    assert port_append.plain_width(*widths) is plain


def _pool(D, B=2, H=4, hk=2, ps=16, pps=8, seed=40):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    vp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    idx = rng.permutation(B * pps).astype(np.int32).reshape(B, pps)
    return q, kp, vp, np.array([77, 128][:B], np.int32), idx


@pytest.mark.parametrize("D,group", [(96, 1), (96, 4), (64, 1), (64, 7)])
def test_paged_decode_launches_its_width(D, group, fake_kernels,
                                         monkeypatch):
    """Paged decode on "CUDA" tensors at D 96 and D 64 (groups 1, 4 and 7)
    launches its own entry point once, counted as ``paged_attention_96``
    or ``paged_attention_64``, with the group in its arguments."""
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    arrays = _pool(D, H=2 * group)
    q, kp, vp = (posing_as_cuda(torch.from_numpy(a).to(torch.bfloat16))
                 for a in arrays[:3])
    lengths, idx = (posing_as_cuda(torch.from_numpy(a)) for a in arrays[3:])
    port_gen.paged_decode_attention(q, kp, vp, lengths, idx)
    assert dict(_build.launches) == {f"paged_attention_{D}": 1}
    (name, args), = fake_kernels
    assert name == f"pt_paged_attention_{D}"
    assert args[10:12] == (2 * group, 2)        # H, hk


def _dense_inputs(D, S, T=32, H=4, hk=2, seed=41):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(1, S, H, D), rng.randn(1, S, hk, D),
              rng.randn(1, S, hk, D), rng.randn(T, D), rng.randn(T, D),
              np.zeros((1, T, hk, D)), np.zeros((1, T, hk, D)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("S,pos", [(16, 0), (1, 16)])
def test_width_96_cached_attention_launches_nothing(S, pos, fake_kernels):
    """At D 96 an exact prefill (S 16 at pos 0, the flash route's case) and
    a dense decode step (S 1) take the plain einsum on "CUDA" tensors, as
    JAX's gates send them there: no launch, and the plain result."""
    arrays = _dense_inputs(96, S)
    posed = [posing_as_cuda(a.clone()) for a in arrays]
    got = port_gen.cached_attention(*posed, pos, prefill=pos == 0)[0]
    want = port_gen.cached_attention(*arrays, pos, prefill=pos == 0)[0]
    assert not fake_kernels and not _build.launches
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())


@pytest.mark.parametrize("S,pos,counter", [
    (16, 0, "flash_attention_bshd"), (1, 16, "append_attention"),
    (4, 16, "append_attention")])
def test_width_64_cached_attention_launches_its_instance(S, pos, counter,
                                                          fake_kernels):
    """At (64, 64) the port keeps its kernels where JAX runs the einsum: an
    exact prefill launches the flash forward, a decode step or a chunk at
    pos > 0 append attention, each at the (64, 64) instance."""
    posed = [posing_as_cuda(a) for a in _dense_inputs(64, S)]
    port_gen.cached_attention(*posed, pos, prefill=pos == 0)
    assert dict(_build.launches) == {counter: 1}
    (name, args), = fake_kernels
    assert name == "pt_append_attention" and args[11:13] == (64, 64)


def test_width_96_forward_without_cache_launches_no_attention(fake_kernels):
    """The forward without a cache at heads of 96 ropes q and k on the
    kernel (``fused_rope`` twice) and takes ``_sdpa_ref``, as JAX's gate
    sends it there: no flash launch, and the plain forward's result."""
    cfg = port_models.Phi3Config.tiny(hidden_size=192, num_attention_heads=2,
                                      num_key_value_heads=1)
    attn = p_llama.LlamaAttention(cfg, device="cpu")
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(5)) * 0.05)
    cos, sin = p_llama._rope_tables(12, 96, 10000.0)
    x = torch.randn(1, 12, 192, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        attn(posing_as_cuda(x.clone()), cos, sin)
        assert dict(_build.launches) == {"fused_rope": 2}
        assert [name for name, _ in fake_kernels] == ["pt_fused_rope"] * 2


@pytest.mark.parametrize("case", ["paged_80", "paged_192", "prefill_384",
                                  "decode_384"])
def test_other_widths_raise_before_any_launch(case, fake_kernels):
    """Paged decode takes D 64, 96, 128 and 256 only; at 384 (a multiple of
    128, which JAX's gates pass) the dense routes take the kernel and
    raise. Nothing launches."""
    if case.startswith("paged"):
        D = int(case.split("_")[1])
        q, kp, vp, lengths, idx = (posing_as_cuda(torch.from_numpy(a))
                                   for a in _pool(D))
        with pytest.raises(ValueError, match="head_dim"):
            port_gen.paged_decode_attention(q, kp, vp, lengths, idx)
    else:
        S, pos = (16, 0) if case == "prefill_384" else (1, 16)
        posed = [posing_as_cuda(a) for a in _dense_inputs(384, S)]
        with pytest.raises((ValueError, NotImplementedError),
                           match="head widths"):
            port_gen.cached_attention(*posed, pos, prefill=pos == 0)
    assert not fake_kernels and not _build.launches


def test_paged_entries_cover_the_families_widths():
    """D 64 and D 96 have their own entry points and counters, from the
    narrow source."""
    assert {d: e for d, e in port_paged.ENTRIES.items() if d < 128} == {
        64: ("paged_attention_narrow", "pt_paged_attention_64",
             "paged_attention_64"),
        96: ("paged_attention_narrow", "pt_paged_attention_96",
             "paged_attention_96")}
