"""Gemma and Gemma2 on the Llama trunk, and the trunk's Gemma options,
against the JAX package on the CPU, from the same numpy weights
(``test_torch_pair.numpy_state``: 1-D parameters 1 + 0.1 N(0, 1); the
(1 + w) norms' w is drawn 0.1 N(0, 1), so that their scales are 1 + 0.1
N(0, 1) as every other family's).

- Each family at ``tiny()`` in f32 (one pair a family, built once in this
  module): the presets, the constructors' checks, the bridge, the
  non-cached logits (atol 1e-4, rtol 1e-4: sums in another order), greedy
  ``generate`` tokens on the dense and paged caches equal to JAX's, and
  the engine's tokens equal to solo ``generate``'s. bf16 logits within
  0.03 + 2^-7 |p|, as the other families.
- One small Llama per option (``rms_norm_offset``, ``scale_embeddings``,
  ``query_pre_attn_scalar``, ``attn_logit_softcapping``,
  ``final_logit_softcapping``): logits against JAX; the bf16 scalar of
  ``scale_embeddings`` (55.5 at hidden 3072) and the bf16 add of the
  offset norm bit for bit.
- The kernel-bearing functions at head width 256 (the plain versions the
  wrappers run on CPU tensors) against the JAX functions at one small
  shape each: append attention and the splash forward in Pallas interpret
  mode, paged decode through the JAX ``paged_decode_attention`` (its
  gather reference off the TPU); the capped routes (dense einsum, paged
  gather reference, verify chunk, band) against JAX's.
- The CUDA routes with stand-in launches: width 256 takes its own
  counters (``append_attention_256``, ``flash_attention_256``,
  ``paged_attention_256``), capped attention launches no attention
  kernel, a width no kernel takes raises (Gemma training at 256 is
  ``tests/test_torch_gemma_train.py``).

The JAX side's rope tables are built eagerly at the lengths ``generate``
computes (``test_torch_pair.jax_generate``)."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import (fake_kernels, jax_generate,  # noqa: F401
                             numpy_state, posing_as_cuda)

import paddle_tpu
from paddle_tpu import generation as jax_gen
from paddle_tpu.models import gemma as j_gemma
from paddle_tpu.models import gemma2 as j_gemma2
from paddle_tpu.models import llama as j_llama
from paddle_tpu.ops.pallas import append_attention as jax_append
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import generation as port_gen
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.models import llama as p_llama
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from paddle_tpu_torch.ops.hopper import paged_attention as port_paged
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.weights import from_jax_state, model_class

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_RTOL = 0.03, 2.0 ** -7
ATOL = 2e-5          # the attention functions: f32 sums in another order
FAMILIES = {
    "gemma": (j_gemma.GemmaConfig, j_gemma.GemmaForCausalLM,
              port_models.GemmaConfig, port_models.GemmaForCausalLM),
    "gemma2": (j_gemma2.Gemma2Config, j_gemma2.Gemma2ForCausalLM,
               port_models.Gemma2Config, port_models.Gemma2ForCausalLM),
}
# (family, preset): the published shapes and the tiny ones
PRESETS = [("gemma", None), ("gemma", "gemma_2b"), ("gemma", "tiny"),
           ("gemma2", None), ("gemma2", "tiny")]
# one option of the trunk a case, at values that bite on the tiny Llama
OPTIONS = {
    "rms_norm_offset": dict(rms_norm_offset=True),
    "scale_embeddings": dict(scale_embeddings=True),
    "query_pre_attn_scalar": dict(query_pre_attn_scalar=8.0),
    "attn_logit_softcapping": dict(attn_logit_softcapping=0.3),
    "final_logit_softcapping": dict(final_logit_softcapping=0.5),
}
PROMPT, NEW = 20, 6


def _pair(jcfg, jlm, pcfg, seed, dtype="float32"):
    """(jax_model, port_model, numpy state): the same weights in both
    packages, bf16 ones rounded once by JAX and carried as their bits."""
    paddle_tpu.seed(seed)
    jax_model = jlm(jcfg)
    state = numpy_state(jax_model, seed)
    if jcfg.rms_norm_offset:
        # the (1 + w) norms' scales 1 + 0.1 N(0, 1), as every other norm's
        state = {k: v - 1.0 if k.endswith("norm.weight") else v
                 for k, v in state.items()}
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in state.items()}
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    jax_model.llama._rope(128)
    return jax_model, from_jax_state(state, pcfg, device="cpu"), state


def _family(family, seed, dtype="float32"):
    jcfg, jlm, pcfg, _ = FAMILIES[family]
    return _pair(jcfg.tiny(dtype=dtype), jlm, pcfg.tiny(dtype=dtype), seed,
                 dtype)


def jax_logits(model, ids):
    """The JAX model's non-cached logits, its forward jitted over its
    state (one compile, where the eager forward compiles op by op)."""
    def fwd(state, x):
        model.load_functional_state(state)
        return unwrap(model(wrap(x)))

    state = model.functional_state()
    out = jax.jit(fwd)(state, jnp.asarray(ids))
    model.load_functional_state(state)
    return np.asarray(out.astype(jnp.float32))


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 512, shape)


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request):
    return (request.param,) + _family(request.param, seed=11)


# ------------------------------------------------------------- families --

@pytest.mark.parametrize("family,preset", PRESETS)
def test_presets_match_jax(family, preset):
    jcfg, _, pcfg, _ = FAMILIES[family]
    want = dataclasses.asdict(getattr(jcfg, preset)() if preset else jcfg())
    got = dataclasses.asdict(getattr(pcfg, preset)() if preset else pcfg())
    shared = set(want) & set(got)
    assert {"head_dim", "rms_norm_offset", "scale_embeddings", "hidden_act",
            "query_pre_attn_scalar", "attn_logit_softcapping",
            "final_logit_softcapping", "layer_types",
            "tie_word_embeddings"} <= shared
    for key in shared:
        assert got[key] == want[key], (family, preset, key)
    if family == "gemma2":
        assert got["layer_types"][:2] == ("sliding_attention",
                                          "full_attention")


@pytest.mark.parametrize("family,bad", [
    ("gemma", dict(hidden_act="silu")),
    ("gemma", dict(rms_norm_offset=False)),
    ("gemma", dict(scale_embeddings=False)),
    ("gemma", dict(tie_word_embeddings=False)),
    ("gemma2", dict(hidden_act="silu")),
    ("gemma2", dict(scale_embeddings=False)),
    ("gemma2", dict(tie_word_embeddings=False)),
])
def test_constructor_checks_match_jax(family, bad):
    jcfg, jlm, pcfg, plm = FAMILIES[family]
    with pytest.raises(ValueError) as jerr:
        jlm(jcfg.tiny(**bad))
    with pytest.raises(ValueError) as perr:
        plm(pcfg.tiny(**bad), device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_bridge_builds_each_family(pair):
    """``from_jax_state`` builds the family's class with every JAX
    parameter (Gemma2's pre / post feed-forward norms, no lm head: tied),
    bit for bit; a fresh model's (1 + w) norms start at w = 0."""
    family, jax_model, port, state = pair
    assert type(port) is FAMILIES[family][3]
    assert model_class(port.config) is FAMILIES[family][3]
    names = set(dict(port.named_parameters()))
    assert names == set(jax_model.functional_state()) == set(state)
    assert "lm_head.weight" not in names
    extra = {"llama.layers.1.pre_feedforward_layernorm.weight",
             "llama.layers.1.post_feedforward_layernorm.weight"}
    assert (extra <= names) == (family == "gemma2")
    for name, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), state[name])
    fresh = type(port)(port.config, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    for name, p in fresh.named_parameters():
        if name.endswith("norm.weight"):
            assert not bool(p.detach().any()), name


def test_logits_match_jax_f32(pair):
    _, jax_model, port, _ = pair
    ids = _ids(1, (2, PROMPT))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jax_logits(jax_model, ids), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_close_to_jax_bf16(family):
    """The bf16 state crosses the bridge bit for bit; the logits within
    0.03 + 2^-7 |p|."""
    jax_model, port, state = _family(family, seed=12, dtype="bfloat16")
    for name, p in port.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p.detach().view(torch.int16).numpy().view(np.uint16),
            np.asarray(state[name]).view(np.uint16), err_msg=name)
    ids = _ids(2, (1, 16))
    want = jax_logits(jax_model, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


def test_greedy_tokens_match_jax_dense_paged_and_engine(pair):
    """JAX ``generate``'s greedy tokens on its dense cache; the port's on
    its dense cache, its paged pool (page 8) and through
    ``ContinuousBatchEngine`` (two slots, three requests: one waits) are
    the same. The prompt is longer than Gemma2's window of 16, so its
    sliding layers mask on every route."""
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


# -------------------------------------------------------------- options --

@pytest.mark.parametrize("option", list(OPTIONS))
def test_trunk_option_logits_match_jax(option):
    """Each option alone on a tiny Llama (head_dim 32): the non-cached
    logits and greedy dense tokens as JAX's."""
    kw = OPTIONS[option]
    jax_model, port, _ = _pair(j_llama.LlamaConfig.tiny(**kw),
                               j_llama.LlamaForCausalLM,
                               p_llama.LlamaConfig.tiny(**kw), seed=21)
    ids = _ids(5, (2, 12))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jax_logits(jax_model, ids), **TOL)
    if option == "final_logit_softcapping":
        assert np.abs(got).max() < kw[option]


def test_scale_embeddings_rounds_the_scalar_in_bf16():
    """sqrt(3072) = 55.43 rounds to 55.5 in bf16 before it multiplies the
    bf16 embedding, as JAX rounds it: the same bits on both sides."""
    x = np.random.RandomState(6).randn(4, 3072).astype(np.float32)
    jcfg = j_llama.LlamaConfig(hidden_size=3072, scale_embeddings=True,
                               dtype="bfloat16")
    pcfg = p_llama.LlamaConfig(hidden_size=3072, scale_embeddings=True,
                               dtype="bfloat16")
    want = np.asarray(unwrap(j_llama._scale_embed(
        wrap(jnp.asarray(x, jnp.bfloat16)), jcfg)).astype(jnp.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = p_llama._scale_embed(xb, pcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert p_llama._in_dtype(math.sqrt(3072), torch.bfloat16) == 55.5
    np.testing.assert_array_equal(got.float().numpy(),
                                  (xb * 55.5).float().numpy())


def test_offset_norm_adds_one_in_the_weight_dtype():
    """The (1 + w) norm's effective weight is w + 1 rounded to bf16, as
    JAX adds it; the norm's output as JAX's within one bf16 rounding."""
    rng = np.random.RandomState(7)
    w = (0.1 * rng.randn(256)).astype(np.float32)
    x = rng.randn(3, 256).astype(np.float32)
    jnorm = j_llama.LlamaRMSNorm(j_llama.LlamaConfig(
        hidden_size=256, rms_norm_offset=True, dtype="bfloat16"))
    jnorm.weight._array = jnp.asarray(w, jnp.bfloat16)
    pnorm = p_llama.LlamaRMSNorm(p_llama.LlamaConfig(
        hidden_size=256, rms_norm_offset=True, dtype="bfloat16"))
    with torch.no_grad():
        pnorm.weight.copy_(torch.from_numpy(w).to(torch.bfloat16))
    want = np.asarray(unwrap(jnorm.effective_weight()).astype(jnp.float32))
    got = pnorm.effective_weight().detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    jout = np.asarray(unwrap(jnorm(wrap(jnp.asarray(x, jnp.bfloat16))))
                      .astype(jnp.float32))
    with torch.no_grad():
        pout = pnorm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.all(np.abs(pout - jout) <= 2.0 ** -7 * np.abs(jout) + 1e-6)


def test_final_softcap_refuses_the_fused_loss_as_jax():
    kw = dict(final_logit_softcapping=30.0, fuse_linear_cross_entropy=True)
    with pytest.raises(NotImplementedError) as jerr:
        j_llama.LlamaConfig.tiny(**kw)
    with pytest.raises(NotImplementedError) as perr:
        p_llama.LlamaConfig.tiny(**kw)
    assert str(perr.value) == str(jerr.value)


def test_fused_tail_gate_declines_the_q_premultiplier():
    """The fused decode tail's structural gate takes a Gemma layer and
    declines a layer with ``query_pre_attn_scalar`` (Gemma2), as JAX's
    ``fused_decode_structural`` (``llama.py:786``)."""
    for kw, want in ((dict(rms_norm_offset=True), True),
                     (dict(query_pre_attn_scalar=8.0), False)):
        m = p_llama.LlamaForCausalLM(p_llama.LlamaConfig.tiny(**kw),
                                     device="cpu")
        assert p_llama.fused_decode_structural(
            m.llama.layers[0], torch.float32) is want


# ----------------------------------------------- attention at width 256 --

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(B, S, T, H, hk, D=256, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32))


def test_append_and_flash_at_width_256_match_pallas_interpret():
    """The plain append attention (a chunk at pos 0 of S = T = 128) and the
    plain causal flash forward at [1, 128, 4 | 2, 256] against the Pallas
    kernels in interpret mode."""
    q, k, v = _qkv(1, 128, 128, 4, 2, seed=30)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_append.append_attention(jq, jk, jv, 0,
                                                  interpret=True))
    got = port_append.append_attention(_t(q), _t(k), _t(v), 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want = np.asarray(jax_flash.flash_attention_bshd(jq, jk, jv, causal=True,
                                                     interpret=True))
    got = port_flash.flash_attention_bshd(_t(q), _t(k), _t(v),
                                          causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _pool(B=2, H=4, hk=2, D=256, ps=16, pps=8, seed=31):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    vp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    idx = rng.permutation(B * pps).astype(np.int32).reshape(B, pps)
    lengths = np.array([77, 128][:B], np.int32)
    return q, kp, vp, lengths, idx


def _jit(fn, **static):
    """``fn`` with ``static`` keywords, jitted: one compile in place of an
    eager compile per operation."""
    return jax.jit(functools.partial(fn, **static))


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("softcap", [None, 2.0])
def test_paged_decode_at_width_256_matches_jax(softcap):
    """Paged decode at head width 256 (uncapped: the wrapper's plain
    version; capped: the gather reference) against the JAX
    ``paged_decode_attention``, which runs its gather reference off the
    TPU."""
    arrays = _pool()
    want = _jit(jax_gen.paged_decode_attention, softcap=softcap)(
        *_jnp(*arrays))
    got = port_gen.paged_decode_attention(*(_t(a) for a in arrays),
                                          softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_capped_routes_match_jax():
    """The capped scores on the JAX package's windowed routes (the
    uncapped window and the unwindowed cap are held above and in
    ``test_torch_attention``): the dense einsum of ``cached_attention`` (a
    chunk of 4 at pos 60, and with a column mask: the ragged window), the
    paged verify chunk and the band gather of paged decode, window 40, cap
    2.0 (scores of unit vectors at width 128 reach a few units)."""
    cap, window = 2.0, 40
    B, S, T, H, hk, D = 2, 4, 64, 4, 2, 128
    q, k, v = _qkv(B, S, T, H, hk, D, seed=32)
    rng = np.random.RandomState(33)
    cos = rng.randn(T, D).astype(np.float32)
    sin = rng.randn(T, D).astype(np.float32)
    allowed = np.ones((B, T), bool)
    allowed[1, 20:50] = False
    dense = _jit(jax_gen.cached_attention, window=window, softcap=cap)
    for am in (None, allowed):
        want = dense(*_jnp(q, k[:, :S], v[:, :S], cos, sin, k, v), 60,
                     *_jnp(am))[0]
        got = port_gen.cached_attention(
            *(_t(a) for a in (q, k[:, :S], v[:, :S], cos, sin, k.copy(),
                              v.copy())), 60,
            allowed=None if am is None else _t(am), use_flash=False,
            window=window, softcap=cap)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    qd, kp, vp, lengths, idx = _pool(D=D, seed=34)
    qc = np.random.RandomState(35).randn(2, 3, 4, D).astype(np.float32)
    for jfn, pfn, qq, ll in (
            (jax_gen._paged_chunk_attention, port_gen._paged_chunk_attention,
             qc, lengths - 3),
            (jax_gen.paged_decode_attention, port_gen.paged_decode_attention,
             qd, lengths)):
        want = _jit(jfn, window=window, softcap=cap)(
            *_jnp(qq, kp, vp, ll, idx))
        got = pfn(*(_t(a) for a in (qq, kp, vp, ll, idx)), window=window,
                  softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


# ------------------------------------------------------------ CUDA routes --

def test_width_256_cuda_routes_take_their_own_counters(fake_kernels,
                                                        monkeypatch):
    """On "CUDA" tensors at head width 256: append attention, the causal
    flash forward and paged decode each launch their kernel once,
    counted as ``append_attention_256``, ``flash_attention_256`` and
    ``paged_attention_256`` (its own C entry point), no plain version."""
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    bf = torch.bfloat16
    q = posing_as_cuda(torch.zeros(1, 64, 4, 256, dtype=bf))
    k = posing_as_cuda(torch.zeros(1, 64, 2, 256, dtype=bf))
    port_append.append_attention(q, k, k, 0)
    port_flash.flash_attention_bshd(q, k, k, causal=True)
    qd = posing_as_cuda(torch.zeros(2, 4, 256, dtype=bf))
    pages = posing_as_cuda(torch.zeros(2, 8, 16, 256, dtype=bf))
    lengths = posing_as_cuda(torch.tensor([5, 70], dtype=torch.int32))
    idx = posing_as_cuda(torch.zeros(2, 4, dtype=torch.int32))
    port_paged.paged_attention(qd, pages, pages, lengths, idx)
    assert dict(_build.launches) == {"append_attention_256": 1,
                                     "flash_attention_256": 1,
                                     "paged_attention_256": 1}
    assert [name for name, _ in fake_kernels] == [
        "pt_append_attention", "pt_append_attention",
        "pt_paged_attention_256"]
    assert [args[11:13] for _, args in fake_kernels[:2]] == [(256, 256)] * 2


def test_capped_paged_decode_launches_no_kernel(fake_kernels):
    """Capped rows on a "CUDA" pool take the gather reference: no paged
    kernel runs, as the JAX package routes them."""
    q, kp, vp, lengths, idx = (posing_as_cuda(_t(a)) for a in _pool())
    port_gen.paged_decode_attention(q, kp, vp, lengths, idx, softcap=2.0)
    assert not fake_kernels and not _build.launches


@pytest.mark.parametrize("case", ["width_384", "paged_192", "grad_384",
                                  "window_192"])
def test_refusals_on_cuda(case, fake_kernels):
    """A width no kernel takes raises before any launch: append attention
    at 384, paged decode at 192, the flash forward at 384 with a gradient
    (which JAX's gate passes) and a window at (192, 128) (a window is
    taken at (128, 128) and (256, 256) only)."""
    if case == "paged_192":
        q = posing_as_cuda(torch.zeros(2, 4, 192))
        pages = posing_as_cuda(torch.zeros(2, 8, 16, 192))
        with pytest.raises(ValueError, match="head_dim"):
            port_paged.paged_attention(
                q, pages, pages,
                posing_as_cuda(torch.ones(2, dtype=torch.int32)),
                posing_as_cuda(torch.zeros(2, 4, dtype=torch.int32)))
    elif case == "width_384":
        q = posing_as_cuda(torch.zeros(1, 64, 4, 384))
        with pytest.raises(ValueError, match="head widths"):
            port_append.append_attention(q, q[:, :, :2], q[:, :, :2], 0)
    elif case == "grad_384":
        q = posing_as_cuda(torch.zeros(1, 128, 4, 384), True)
        k = posing_as_cuda(torch.zeros(1, 128, 2, 384), True)
        assert port_flash.supported(q, k, k)
        with pytest.raises(NotImplementedError, match="head widths"):
            port_flash.flash_attention_bshd(q, k, k, causal=True)
    else:
        q = posing_as_cuda(torch.zeros(1, 64, 4, 192))
        k = posing_as_cuda(torch.zeros(1, 64, 2, 192))
        v = posing_as_cuda(torch.zeros(1, 64, 2, 128))
        with pytest.raises(NotImplementedError, match="window"):
            port_flash.flash_attention_bshd(q, k, v, causal=True, window=32)
    assert not fake_kernels and not _build.launches
