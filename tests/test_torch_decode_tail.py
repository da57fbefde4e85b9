"""Port parity of the fused decode tail: the plain versions of
``fused_qkv_rope`` / ``fused_epilogue`` against the Pallas kernels in
interpret mode, the port's flag registry, the gate's decisions, and the
flag-on decode forward and engine against the JAX package (f32; bf16 at the
kernel level).

Tolerances: f32, 1e-5 of the largest entry (the same f32 products summed in
another order). bf16, one bf16 ulp of the largest entry: both sides sum the
exact f32 products of bf16 values in f32 and differ only in the order, so a
result rounds to the other neighbour at most, and RoPE of such a pair
(cos^2 + sin^2 = 1, each product and the sum rounded) stays within one ulp
of the largest entry as well."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_decode_tail import fused_flag  # noqa: F401  (fixture)
from test_torch_pair import build_pair, mix_prompts

import paddle_tpu
from paddle_tpu.models.llama import fused_decode_supported as jax_supported
from paddle_tpu.ops.pallas import decode_tail as jax_tail
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.models.llama import \
    fused_decode_supported as port_supported
from paddle_tpu_torch.ops.hopper import decode_tail
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.utils import flags

HIDDEN, H, HK, D = 256, 2, 1, 128
EPS = 1e-6
ENGINE = dict(max_batch=3, max_len=128, page_size=16)


def trace_jax_afresh():
    """Make the JAX package's next call trace its programs anew, so the
    fused tail's ``announce`` (which fills ``_announced`` when a program is
    traced) fires whatever this process traced before: JAX's compile
    caches and the announce set are cleared. The models come fresh from
    ``build_pair``, so no step is memoised on them yet."""
    jax.clear_caches()
    jax_tail._announced.clear()


def _as(arr, dtype):
    t = torch.from_numpy(np.asarray(arr, np.float32))
    j = jnp.asarray(arr, jnp.float32)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _close(port, ref, dtype):
    got = port.float().numpy()
    want = np.asarray(jnp.asarray(ref, jnp.float32))
    top = float(np.abs(want).max())
    if dtype == "float32":
        tol = 1e-5 * top
    else:                               # one bf16 ulp of the largest entry
        tol = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _rope_rows(rng, rows):
    cos, sin = _rope_tables(64, D, 10000.0)
    pos = rng.randint(0, 64, size=rows)
    return cos[pos].numpy(), sin[pos].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 6])
def test_fused_qkv_rope_matches_pallas(rows, dtype):
    rng = np.random.RandomState(rows)
    arrs = [rng.randn(rows, HIDDEN), 1 + 0.1 * rng.randn(HIDDEN),
            0.05 * rng.randn(HIDDEN, H * D), 0.05 * rng.randn(HIDDEN, HK * D),
            0.05 * rng.randn(HIDDEN, HK * D)]
    pairs = [_as(a, dtype) for a in arrs]
    cos, sin = _rope_rows(rng, rows)
    got = decode_tail.fused_qkv_rope(*(p for p, _ in pairs),
                                     torch.from_numpy(cos),
                                     torch.from_numpy(sin), EPS, H, HK, D)
    want = jax_tail.fused_qkv_rope(*(j for _, j in pairs), jnp.asarray(cos),
                                   jnp.asarray(sin), EPS, H, HK, D,
                                   interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == pairs[0][0].dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 6])
def test_fused_epilogue_matches_pallas(rows, dtype):
    rng = np.random.RandomState(10 + rows)
    arrs = [rng.randn(rows, H * D), 0.05 * rng.randn(H * D, HIDDEN),
            rng.randn(rows, HIDDEN), 1 + 0.1 * rng.randn(HIDDEN)]
    pairs = [_as(a, dtype) for a in arrs]
    got = decode_tail.fused_epilogue(*(p for p, _ in pairs), EPS)
    want = jax_tail.fused_epilogue(*(j for _, j in pairs), EPS,
                                   interpret=True)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_cost_models_match_jax():
    qkv = {"batch": 8, "hidden": 4096, "wtot": 6144, "dtype": "bfloat16"}
    epi = {"batch": 32, "width": 4096, "hidden": 4096, "dtype": "bfloat16"}
    for port, jax_fn, params in ((decode_tail._qkv_cost, jax_tail._qkv_cost,
                                  qkv),
                                 (decode_tail._epilogue_cost,
                                  jax_tail._epilogue_cost, epi)):
        want = jax_fn(params, (128,))
        got = port(params)
        assert got == {"bytes": want["bytes"], "flops": want["flops"]}
    # the bound the chip check derives: Llama-3-8B decode at 8 slots
    assert decode_tail._qkv_cost(qkv)["bytes"] == 50_495_488


# ---------------------------------------------------------------- flags --

def test_flag_env_parsing(monkeypatch):
    for raw, want in (("1", True), ("true", True), ("ON", True),
                      ("0", False), ("no", False)):
        monkeypatch.setenv("FLAGS_use_fused_decode_tail", raw)
        f = flags._Flag("FLAGS_use_fused_decode_tail", False, "")
        assert f.value is want
    monkeypatch.delenv("FLAGS_use_fused_decode_tail")
    assert flags._Flag("FLAGS_use_fused_decode_tail", False, "").value is False


def test_set_flags_and_thread_local_overrides():
    prev = flags.flag("use_fused_decode_tail")
    try:
        flags.set_flags({"FLAGS_use_fused_decode_tail": "1"})
        assert flags.get_flags("use_fused_decode_tail") == {
            "use_fused_decode_tail": True}
        assert decode_tail.enabled()
        seen = []
        with flags.flag_overrides({"use_fused_decode_tail": False}):
            assert not decode_tail.enabled()
            with flags.flag_overrides({"FLAGS_use_fused_decode_tail": "on"}):
                assert decode_tail.enabled()
            assert not decode_tail.enabled()
            # another thread sees the global value, not this overlay
            t = threading.Thread(target=lambda: seen.append(
                decode_tail.enabled()))
            t.start()
            t.join()
        assert seen == [True] and decode_tail.enabled()
        assert flags.get_flags() == {"FLAGS_use_fused_decode_tail": True}
        for bad in (lambda: flags.set_flags({"nope": 1}),
                    lambda: flags.get_flags("nope"),
                    lambda: flags.flag_overrides({"nope": 1}).__enter__()):
            with pytest.raises(ValueError, match="unknown flag"):
                bad()
    finally:
        flags.set_flags({"use_fused_decode_tail": prev})


# ----------------------------------------------------------------- gate --

FUSABLE = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, max_position_embeddings=256,
               use_flash_attention=False, dtype="float32")


def _gate_inputs(kw, s=1):
    """(jax decision args, port decision args) for layer 0 of a model of
    ``FUSABLE`` updated by ``kw``, a dense cache at pos 4 and S tokens."""
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
    from paddle_tpu_torch.models.llama import \
        LlamaForCausalLM as PortForCausalLM

    cfg = dict(FUSABLE, **kw)
    paddle_tpu.seed(0)
    jm = LlamaForCausalLM(LlamaConfig(**cfg))
    pm = PortForCausalLM(PortConfig(**cfg), device="cpu")
    out = []
    for m, zeros, wrap in ((jm, jnp.zeros, paddle_tpu.to_tensor),
                           (pm, torch.zeros, torch.from_numpy)):
        layer = m.llama.layers[0]
        d, hk = layer.self_attn.head_dim, cfg["num_key_value_heads"]
        cache = {"k": zeros((2, 16, hk, d)), "v": zeros((2, 16, hk, d)),
                 "pos": 4}
        hidden = wrap(np.zeros((2, s, cfg["hidden_size"]), np.float32))
        out.append((layer, hidden, cache, m.llama._rope(16)[0]))
    return out


@pytest.mark.parametrize("kw, s, flag_on, want", [
    ({}, 1, True, True),                                        # fusable
    ({}, 1, False, False),                                      # flag off
    (dict(num_attention_heads=4, num_key_value_heads=2), 1, True, False),
    (dict(partial_rotary_factor=0.5), 1, True, False),          # partial rope
    ({}, 4, True, False),                                       # prefill chunk
])
def test_gate_decisions_match_jax(fused_flag, kw, s, flag_on, want):
    jax_args, port_args = _gate_inputs(kw, s)
    jax_set_flags({"FLAGS_use_fused_decode_tail": flag_on})
    with flags.flag_overrides({"use_fused_decode_tail": flag_on}):
        got = port_supported(*port_args)
    assert jax_supported(*jax_args) is want
    assert got is want


@pytest.mark.parametrize("kw", [dict(qk_norm=True),
                                dict(attention_bias=True)])
def test_gate_declines_what_the_port_cannot_build(fused_flag, kw):
    """qk-norm and projection bias: the JAX gate declines them, and the port
    cannot build such a layer at all (its config refuses qk-norm and has no
    bias field); a foreign projection module is declined structurally."""
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig

    jax_set_flags({"FLAGS_use_fused_decode_tail": True})
    jm = LlamaForCausalLM(LlamaConfig(**FUSABLE, **kw))
    cache = {"k": jnp.zeros((2, 16, 1, 128)), "v": jnp.zeros((2, 16, 1, 128)),
             "pos": 4}
    hidden = paddle_tpu.to_tensor(np.zeros((2, 1, 256), np.float32))
    assert not jax_supported(jm.llama.layers[0], hidden, cache,
                             jm.llama._rope(16)[0])
    with pytest.raises((NotImplementedError, TypeError)):
        PortConfig(**FUSABLE, **kw)
    _, (layer, p_hidden, p_cache, cos) = _gate_inputs({})
    layer.self_attn.q_proj = torch.nn.Linear(256, 256)   # carries a bias
    with flags.flag_overrides({"use_fused_decode_tail": True}):
        assert not port_supported(layer, p_hidden, p_cache, cos)


# ------------------------------------------------------ decode forward --

def _caches(kind, rng, n_layers, B=2, hk=1, d=128, T=64, ps=16):
    """One layer's cache dicts as numpy, for both packages."""
    out = []
    for _ in range(n_layers):
        if kind == "paged":
            n_pages = B * T // ps
            pidx = rng.permutation(n_pages).reshape(B, -1)
            out.append({
                "k_pages": 0.5 * rng.randn(hk, n_pages, ps, d),
                "v_pages": 0.5 * rng.randn(hk, n_pages, ps, d),
                "page_indices": pidx.astype(np.int32),
                "lengths": np.array([7, 30], np.int32), "page_size": ps})
        else:
            c = {"k": 0.5 * rng.randn(B, T, hk, d),
                 "v": 0.5 * rng.randn(B, T, hk, d), "pos": 9}
            if kind == "row_pos":
                c["row_pos"] = np.array([3, 9], np.int32)
            out.append(c)
    return out


def _convert(caches, to):
    conv = []
    for c in caches:
        d = {}
        for key, v in c.items():
            if isinstance(v, np.ndarray):
                v = (torch.from_numpy(v.astype(np.float32)
                                      if v.dtype == np.float64 else v)
                     if to == "torch" else
                     jnp.asarray(v.astype(np.float32)
                                 if v.dtype == np.float64 else v))
            d[key] = v
        conv.append(d)
    return conv


@pytest.mark.parametrize("kind", ["dense", "row_pos", "paged"])
def test_fused_forward_cached_matches_jax(fused_flag, monkeypatch, kind):
    jax_model, port_model, _ = build_pair(max_len=64)
    calls = []
    real = decode_tail.fused_qkv_rope
    monkeypatch.setattr(decode_tail, "fused_qkv_rope",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.RandomState(5)
    caches = _caches(kind, rng, 2)
    ids = rng.randint(0, 512, size=(2, 1)).astype(np.int32)
    jax_set_flags({"FLAGS_use_fused_decode_tail": True})
    trace_jax_afresh()
    jh, jc = jax_model.llama.forward_cached(paddle_tpu.to_tensor(ids),
                                            _convert(caches, "jax"), 64)
    with flags.flag_overrides({"use_fused_decode_tail": True}):
        with torch.inference_mode():
            ph, pc = port_model.llama.forward_cached(
                torch.from_numpy(ids), _convert(caches, "torch"), 64)
            logits = port_model.lm_head_logits(ph)
    assert jax_tail._announced and len(calls) == 2     # both took the tail
    want = np.asarray(jax_model.lm_head_logits(jh).numpy())
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)
    key = "k_pages" if kind == "paged" else "k"
    for j, p in zip(jc, pc):
        np.testing.assert_allclose(p[key].numpy(), np.asarray(j[key]),
                                   rtol=1e-5, atol=1e-5)


def _engine_run(engine, prompts, news):
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True)
            for p, n in zip(prompts, news)]
    out = engine.run_until_done()
    return [(out[r].tolist(), engine.logprobs(r)) for r in rids]


def test_port_fused_engine_matches_discrete_and_jax(fused_flag):
    """Flag on: the port's fused engine equals its discrete engine token for
    token (f32), and the JAX engine with the flag on in tokens and
    logprobs."""
    jax_model, port_model, _ = build_pair(max_len=ENGINE["max_len"])
    prompts = mix_prompts(6, (5, 16, 40, 21))
    news = (6, 9, 4, 7)
    discrete = _engine_run(PortEngine(port_model, **ENGINE), prompts, news)
    with flags.flag_overrides({"use_fused_decode_tail": True}):
        fused = _engine_run(PortEngine(port_model, **ENGINE), prompts, news)
    jax_set_flags({"FLAGS_use_fused_decode_tail": True})
    trace_jax_afresh()
    want = _engine_run(JaxEngine(jax_model, **ENGINE), prompts, news)
    assert jax_tail._announced
    for (dt, dl), (ft, fl), (wt, wl) in zip(discrete, fused, want):
        assert ft == dt == wt
        np.testing.assert_allclose(fl, dl, rtol=0, atol=1e-5)
        np.testing.assert_allclose(fl, wl, rtol=0, atol=1e-4)
