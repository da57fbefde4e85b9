"""GPT-2 in the port against the JAX package on the CPU, at ``tiny()`` (heads
of 32) and at heads of 64 (GPT-2's width), built in both packages from the
same numpy weights (``test_torch_pair.numpy_state``: 1-D parameters 1 +
0.1 N(0, 1), so the biases and the LayerNorms' scales are non-zero):

- the presets (``num_key_value_heads`` = heads) and the bridge (the JAX
  parameter names, bit for bit);
- the non-cached logits, f32 within atol 1e-4, rtol 1e-4; bf16 within
  0.03 + 2^-7 |p|; greedy tokens: JAX ``generate`` = the port's dense
  cache = its paged pool = the engine = solo ``generate``;
- ``nn.LayerNorm`` and the tanh gelu against JAX's (f32 within 1e-6; bf16
  within one rounding, 2^-7 |p|), the position-limit error (same message),
  the init recipe's spreads;
- ``paged_attention_plain`` at D 64 and D 96, groups 1 and 7, against
  JAX's ``_paged_attention_ref`` (f32 sums in another order: atol 2e-5);
- the CUDA route with stand-in launches: a paged decode step of GPT-2's
  attention at heads of 64 launches ``paged_attention_64`` once."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import (fake_kernels, numpy_state,  # noqa: F401
                             posing_as_cuda)

import paddle_tpu
from paddle_tpu import generation as jax_gen
from paddle_tpu import nn as j_nn
from paddle_tpu.models import gpt2 as j_gpt2
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch import nn as p_nn
from paddle_tpu_torch.models import gpt2 as p_gpt2
from paddle_tpu_torch.models import llama as p_llama
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import paged_attention as port_paged
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.weights import from_jax_state, model_class

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_RTOL = 0.03, 2.0 ** -7
ATOL = 2e-5
# tiny (4 heads of 32) and GPT-2's heads of 64
PAIRS = {"tiny": {}, "d64": dict(num_attention_heads=2)}
PROMPT, NEW = 20, 6


def _build_pair(name, dtype="float32", seed=0):
    kw = PAIRS[name]
    paddle_tpu.seed(seed)
    jax_model = j_gpt2.GPT2LMHeadModel(j_gpt2.GPT2Config.tiny(dtype=dtype,
                                                              **kw))
    state = numpy_state(jax_model, seed)
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in state.items()}
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    port = from_jax_state(state, port_models.GPT2Config.tiny(dtype=dtype,
                                                             **kw),
                          device="cpu")
    return jax_model, port, state


def jax_logits(model, ids):
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
    return _build_pair(request.param, seed=17)


@pytest.mark.parametrize("preset", [None, "tiny"])
def test_presets_match_jax(preset):
    jc = j_gpt2.GPT2Config.tiny() if preset else j_gpt2.GPT2Config()
    pc = port_models.GPT2Config.tiny() if preset else port_models.GPT2Config()
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.num_key_value_heads == jc.num_key_value_heads \
        == pc.num_attention_heads
    assert pc.intermediate_size == 4 * pc.hidden_size


def test_bridge_keeps_the_jax_names(pair):
    jax_model, port, state = pair
    assert type(port) is p_gpt2.GPT2LMHeadModel
    assert model_class(port.config) is p_gpt2.GPT2LMHeadModel
    names = set(dict(port.named_parameters()))
    assert names == set(jax_model.functional_state()) == set(state)
    assert {"llama.wte.weight", "llama.wpe.weight", "llama.ln_f.bias",
            "llama.h.0.attn.c_attn.bias", "llama.h.1.mlp.c_proj.weight",
            "llama.h.0.ln_2.weight"} <= names
    assert port.lm_head is None and port.transformer is port.llama
    for n, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), state[n])


def test_logits_match_jax_f32(pair):
    jax_model, port, _ = pair
    ids = _ids(1, (2, PROMPT))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jax_logits(jax_model, ids), **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_logits_close_to_jax_bf16(name):
    jax_model, port, _ = _build_pair(name, dtype="bfloat16", seed=18)
    ids = _ids(2, (1, 16))
    want = jax_logits(jax_model, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


def test_greedy_tokens_match_jax_dense_paged_and_engine(pair):
    """JAX ``generate``'s greedy tokens; the port's on its dense cache, its
    paged pool (page 8) and through the engine (two slots, three requests:
    one waits) are the same, and the engine's are solo ``generate``'s."""
    jax_model, port, _ = pair
    ids = _ids(3, (2, PROMPT))
    want = np.asarray(jax_model.generate(jnp.asarray(ids),
                                         max_new_tokens=NEW).numpy())
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


def test_identity_tables_and_no_fused_tail(pair):
    """The units' ``model.llama._rope`` hands out cos 1 / sin 0 at the head
    width; the block is no Llama decoder layer, so the fused tail's gate
    declines it."""
    _, port, _ = pair
    cos, sin = port.llama._rope(10)
    d = port.config.hidden_size // port.config.num_attention_heads
    assert cos.shape == sin.shape == (10, d)
    assert bool((cos == 1).all()) and not bool(sin.any())
    assert not p_llama.fused_decode_structural(port.llama.h[0],
                                               torch.float32)


def test_position_limit_error_matches_jax(pair):
    jax_model, port, _ = pair
    ids = _ids(5, (1, port.config.max_position_embeddings + 1))
    with pytest.raises(ValueError) as jerr:
        jax_model(wrap(jnp.asarray(ids)))
    with pytest.raises(ValueError) as perr:
        port(torch.from_numpy(ids))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.RandomState(8)
    x = (3 * rng.randn(3, 5, 64) + 1).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jln = j_nn.LayerNorm(64, epsilon=1e-5)
    jln.weight._array = jnp.asarray(w, jdt)
    jln.bias._array = jnp.asarray(b, jdt)
    want = np.asarray(unwrap(jln(wrap(jnp.asarray(x, jdt)))).astype(
        jnp.float32))
    pln = p_nn.LayerNorm(64, 1e-5, dtype=tdt)
    with torch.no_grad():
        pln.weight.copy_(torch.from_numpy(w))
        pln.bias.copy_(torch.from_numpy(b))
        got = pln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_tanh_gelu_matches_jax():
    x = np.random.RandomState(9).randn(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_init_recipe():
    """A fresh model draws ``wte``, ``wpe``, ``c_attn`` and ``c_fc`` from
    N(0, 0.02) and the residual ``c_proj`` from N(0, 0.02 / sqrt(2 L));
    biases zeros, LayerNorm scales ones (``gpt2.py:180-197``)."""
    cfg = port_models.GPT2Config.tiny(hidden_size=256, num_hidden_layers=8)
    m = p_gpt2.GPT2LMHeadModel(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    resid = 0.02 / np.sqrt(2 * 8)
    for name, p in m.named_parameters():
        t = p.detach()
        if name.endswith("c_proj.weight"):
            assert abs(float(t.std()) - resid) < 0.05 * resid, name
        elif name.endswith(("wte.weight", "wpe.weight", "c_attn.weight",
                            "c_fc.weight")):
            assert abs(float(t.std()) - 0.02) < 0.05 * 0.02, name
        elif name.endswith("bias"):
            assert not bool(t.any()), name
        else:
            assert bool((t == 1).all()), name


@pytest.mark.parametrize("D,H,hk", [(64, 2, 2), (64, 14, 2), (96, 2, 2),
                                    (96, 14, 2)])
def test_paged_attention_plain_matches_jax_ref(D, H, hk):
    rng = np.random.RandomState(D + H)
    B, ps, pps = 3, 8, 6
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    vp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    idx = rng.permutation(B * pps).astype(np.int32).reshape(B, pps)
    lengths = np.array([1, 29, 48], np.int32)
    arrays = (q, kp, vp, lengths, idx)
    want = jax.jit(jax_gen._paged_attention_ref)(
        *(jnp.asarray(a) for a in arrays))
    got = port_paged.paged_attention_plain(
        *(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_paged_decode_step_launches_paged_attention_64(fake_kernels,
                                                       monkeypatch):
    """A decode step of GPT-2's attention (heads of 64) over a "CUDA" paged
    pool launches the paged kernel's D 64 entry once and nothing else."""
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    cfg = port_models.GPT2Config.tiny(num_attention_heads=2)
    attn = p_gpt2.GPT2Attention(cfg, device="cpu")
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    B, ps, pps = 2, 8, 4
    pool = functools.partial(torch.zeros, 2, B * pps, ps, 64)
    cache = {"k_pages": posing_as_cuda(pool()),
             "v_pages": posing_as_cuda(pool()),
             "page_indices": posing_as_cuda(torch.arange(
                 B * pps, dtype=torch.int32).reshape(B, pps)),
             "lengths": posing_as_cuda(torch.tensor([3, 9],
                                                    dtype=torch.int32)),
             "page_size": ps}
    cos, sin = p_gpt2.GPT2Model(cfg, device="cpu")._rope(B * pps * ps)
    hidden = posing_as_cuda(torch.randn(B, 1, 128))
    with torch.no_grad():
        _, new = attn(hidden, (cos, sin), cache)
    assert dict(_build.launches) == {"paged_attention_64": 1}
    assert [name for name, _ in fake_kernels] == ["pt_paged_attention_64"]
    assert new["lengths"].tolist() == [4, 10]
