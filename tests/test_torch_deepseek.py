"""Port parity of DeepSeek-V2 serving (MLA + DeepSeekMoE) against the JAX
package, on the CPU with the plain versions: the yarn rope tables and the
MLA softmax scale at DeepSeek-V2-Lite's rope scaling, the plain MLA decode
against the Pallas kernel in interpret mode (dead row exactly 0), the
non-cached logits and the cached attention (expanded prefill, absorbed
chunks, single tokens at a scalar or per-row position), the prefill step,
the engine in latent mode against the JAX engine and against solo runs,
the weight bridge, and the refusals. f32; each test states its
tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import mix_prompts, numpy_state

import paddle_tpu
from paddle_tpu.generation import _get_prefill_step
from paddle_tpu.models import deepseek as jax_ds
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.ops.pallas import mla_decode as jax_mla
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu_torch.generation import _PrefillStep
from paddle_tpu_torch.models import deepseek as port_ds
from paddle_tpu_torch.models.llama import _rope_tables as port_rope_tables
from paddle_tpu_torch.models.llama import validate_rope_scaling
from paddle_tpu_torch.ops.hopper import mla_decode as port_mla
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.weights import from_jax_state, to_numpy_state

TOL = dict(rtol=1e-4, atol=1e-4)
# DeepSeek-V2-Lite's published rope_scaling (config.json)
V2_LITE_YARN = {"type": "yarn", "factor": 40, "beta_fast": 32,
                "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096}


def _pair(max_len=128, seed=0, preset="tiny_mla", **kw):
    """(jax_model, port_model, numpy state) of ``DeepseekV2Config.<preset>
    (num_hidden_layers=2, **kw)`` holding the same f32 weights; the JAX
    rope table is built eagerly (see test_torch_pair.build_pair)."""
    kw = dict(num_hidden_layers=2, **kw)
    paddle_tpu.seed(seed)
    jax_model = jax_ds.DeepseekV2ForCausalLM(
        getattr(jax_ds.DeepseekV2Config, preset)(**kw))
    state = numpy_state(jax_model, seed)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(max_len)
    port_model = from_jax_state(
        state, getattr(port_ds.DeepseekV2Config, preset)(**kw), device="cpu")
    return jax_model, port_model, state


@pytest.mark.parametrize("seq", [64, 4096])
def test_yarn_tables_and_softmax_scale_match_jax(seq):
    """cos / sin at V2-Lite's yarn scaling (rope width 64), and the
    softmax scale with its mscale_all_dim^2 factor, within 1e-6."""
    cos_j, sin_j = jax_rope_tables(seq, 64, 10000.0, scaling=V2_LITE_YARN,
                                   max_position=163840)
    cos_p, sin_p = port_rope_tables(seq, 64, 10000.0, scaling=V2_LITE_YARN,
                                    max_position=163840)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_j), rtol=0,
                               atol=1e-6)
    kw = dict(rope_scaling=V2_LITE_YARN, max_position_embeddings=163840)
    want = jax_ds.mla_softmax_scale(jax_ds.DeepseekV2Config.tiny_mla(**kw))
    got = port_ds.mla_softmax_scale(port_ds.DeepseekV2Config.tiny_mla(**kw))
    assert abs(got - want) <= 1e-6 * want
    lite = port_ds.DeepseekV2Config(rope_scaling=V2_LITE_YARN)
    assert abs(port_ds.mla_softmax_scale(lite) - 0.1147) < 5e-5


def _mla_inputs(rng, B=2, H=8, r=128, dr=16, T=256):
    return (rng.randn(B, H, r).astype(np.float32) * 0.05,
            rng.randn(B, H, dr).astype(np.float32) * 0.05,
            rng.randn(B, T, r).astype(np.float32) * 0.3,
            rng.randn(B, T, dr).astype(np.float32) * 0.3)


@pytest.mark.parametrize("pos", [37, "rows"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "allowed"])
def test_mla_decode_plain_matches_pallas_interpret(pos, ragged):
    """``mla_decode_plain`` against the Pallas kernel in interpret mode at
    the shapes of tests/test_deepseek.py (B 2, H 8, r 128, dr 16, T 256),
    a scalar or per-row pos, with and without an allowed mask holding an
    interior hole; atol 2e-5."""
    ql, qp, ckv, kpe = _mla_inputs(np.random.RandomState(31))
    p = np.array([0, 255], np.int32) if pos == "rows" else pos
    allowed = None
    if ragged:
        allowed = np.ones((2, 256), bool)
        allowed[1, 5:20] = False
    want = jax_mla.mla_decode_attention(
        jnp.asarray(ql), jnp.asarray(qp), jnp.asarray(ckv), jnp.asarray(kpe),
        jnp.asarray(p), None if allowed is None else jnp.asarray(allowed),
        interpret=True)
    got = port_mla.mla_decode(
        torch.from_numpy(ql), torch.from_numpy(qp), torch.from_numpy(ckv),
        torch.from_numpy(kpe), torch.from_numpy(np.asarray(p)),
        None if allowed is None else torch.from_numpy(allowed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_mla_decode_dead_row_is_exactly_zero():
    """A row with no visible column comes out exactly 0 (the Pallas
    kernel's rule), the live row agrees with the kernel."""
    ql, qp, ckv, kpe = _mla_inputs(np.random.RandomState(5))
    dead = np.ones((2, 256), bool)
    dead[1, :] = False
    want = np.asarray(jax_mla.mla_decode_attention(
        jnp.asarray(ql), jnp.asarray(qp), jnp.asarray(ckv), jnp.asarray(kpe),
        100, jnp.asarray(dead), interpret=True))
    got = port_mla.mla_decode(
        torch.from_numpy(ql), torch.from_numpy(qp), torch.from_numpy(ckv),
        torch.from_numpy(kpe), 100, torch.from_numpy(dead)).numpy()
    assert np.all(want[1] == 0) and np.all(got[1] == 0)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_lora_rank", [None, 16])
def test_logits_match_jax(q_lora_rank):
    """Non-cached logits of a 2-layer tiny_mla (one dense, one MoE layer)
    under V2-Lite's yarn scaling; f32 within 1e-4."""
    jax_model, port_model, _ = _pair(q_lora_rank=q_lora_rank,
                                     rope_scaling=V2_LITE_YARN)
    ids = mix_prompts(7, (24,))[0][None]
    want = np.asarray(jax_model(paddle_tpu.to_tensor(ids))._array)
    with torch.no_grad():
        got = port_model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["prefill", "chunk", "single", "single-allowed",
                                  "rows"])
def test_mla_cached_attention_matches_jax(case):
    """``mla_cached_attention`` (the pos-dict cache): the expanded prefill,
    an absorbed chunk at pos > 0, a single token at a scalar pos with and
    without an allowed mask, a single token at per-row ``row_pos``; the
    outputs and the written buffers within 1e-5."""
    rng = np.random.RandomState(3)
    B, H, dn, dr, dv, r, T = 2, 4, 32, 16, 32, 64, 64
    S = {"prefill": 12, "chunk": 5}.get(case, 1)
    pos = 0 if case == "prefill" else 20
    arrs = dict(q_nope=rng.randn(B, S, H, dn), q_pe=rng.randn(B, S, H, dr),
                c_kv=rng.randn(B, S, r), k_pe=rng.randn(B, S, dr),
                ckv_buf=rng.randn(B, T, r), kpe_buf=rng.randn(B, T, dr),
                w=rng.randn(r, H * (dn + dv)) * 0.1)
    arrs = {k: (0.3 * v).astype(np.float32) for k, v in arrs.items()}
    cos, sin = port_rope_tables(T, dr, 10000.0)
    kw = dict(nope_dim=dn, v_dim=dv, prefill=case == "prefill",
              sm_scale=0.11)
    allowed = row_pos = None
    if case == "single-allowed":
        allowed = np.ones((B, T), bool)
        allowed[0, 3:9] = False
    if case == "rows":
        row_pos = np.array([20, 7], np.int32)
    names = ("q_nope", "q_pe", "c_kv", "k_pe")
    want = jax_ds.mla_cached_attention(
        *(jnp.asarray(arrs[n]) for n in names), jnp.asarray(cos.numpy()),
        jnp.asarray(sin.numpy()), jnp.asarray(arrs["ckv_buf"]),
        jnp.asarray(arrs["kpe_buf"]), pos, jnp.asarray(arrs["w"]),
        allowed=None if allowed is None else jnp.asarray(allowed),
        row_pos=None if row_pos is None else jnp.asarray(row_pos),
        use_flash=True, interpret=True, **kw)
    got = port_ds.mla_cached_attention(
        *(torch.from_numpy(arrs[n]) for n in names), cos, sin,
        torch.from_numpy(arrs["ckv_buf"].copy()),
        torch.from_numpy(arrs["kpe_buf"].copy()), pos,
        torch.from_numpy(arrs["w"]),
        allowed=None if allowed is None else torch.from_numpy(allowed),
        row_pos=None if row_pos is None else torch.from_numpy(row_pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_prompt", [32, 21])   # exact, padded bucket
def test_prefill_step_logits_and_latent_cache_match(n_prompt):
    """The prefill step of the engine: last logits within 1e-4 and the
    latent caches within 1e-5 on the prompt's rows; the exact bucket takes
    the expanded flash route, the padded one the absorbed einsum."""
    max_len, bucket = 128, 32
    jax_model, port_model, _ = _pair(max_len=max_len)
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
        assert "prefill" not in pc
        for key in ("c_kv", "k_pe"):
            np.testing.assert_allclose(pc[key].numpy()[:, :n_prompt],
                                       np.asarray(jc[key])[:, :n_prompt],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("path", ["forward", "prefill"])
def test_expanded_attention_takes_the_flash_wrapper_whatever_the_flag(
        path, use_flash, monkeypatch):
    """The non-cached forward and the exact-bucket prefill reach
    ``flash_attention_bshd`` (the kernel on CUDA, its plain version only
    for CPU tensors) at q/k width dn + dr and v width dv in every layer,
    with ``use_flash_attention`` off as on."""
    cfg = port_ds.DeepseekV2Config.tiny_mla(num_hidden_layers=2,
                                            use_flash_attention=use_flash)
    model = port_ds.DeepseekV2ForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    widths = []
    real = port_ds.flash_attention_bshd

    def flash(q, k, v, **kw):
        widths.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_ds, "flash_attention_bshd", flash)
    ids = torch.from_numpy(mix_prompts(7, (16,))[0][None].astype(np.int64))
    with torch.no_grad():
        if path == "forward":
            model(ids)
        else:
            _PrefillStep(model, 16, False, rope_len=64)(
                ids, torch.tensor([16], dtype=torch.int32), None)
    d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert widths == [(d_qk, d_qk, cfg.v_head_dim)] * 2


def test_mla_width_flash_launches_flash_attention_mla_on_cuda(monkeypatch):
    """On a CUDA tensor, causal attention at q/k width 192 and v width 128
    launches the append kernel under the ``flash_attention_mla`` counter
    with its ``sm_scale`` (a stand-in for the launch, as in
    tests/test_torch_attention.py)."""
    from test_torch_attention import _as_cuda

    from paddle_tpu_torch.ops.hopper import flash_attention as port_flash

    q, k = (_as_cuda(torch.zeros(1, 16, 4, 192)) for _ in range(2))
    v = _as_cuda(torch.zeros(1, 16, 4, 128))
    seen = {}

    def fake_launch(q_, k_, v_, pos, allowed, scale, counter, with_lse=False,
                    window=None):
        seen.update(pos=pos, scale=scale, counter=counter, window=window)
        return torch.zeros(1, 16, 4, 128)

    monkeypatch.setattr(port_flash._append, "launch", fake_launch)
    port_flash.flash_attention_bshd(q, k, v, causal=True, sm_scale=0.1147)
    assert seen == dict(pos=0, scale=0.1147, counter="flash_attention_mla",
                        window=None)


LENGTHS = (5, 16, 32, 20, 40)      # exact buckets 16 and 32, three padded
NEW_TOKENS = (6, 9, 4, 7, 5)
ENGINE = dict(max_batch=2, max_len=128, page_size=16)


@pytest.fixture(scope="module")
def engine_pair():
    jax_model, port_model, _ = _pair(max_len=ENGINE["max_len"])
    return jax_model, port_model


def _run(engine, prompts, news):
    rids = [engine.add_request(p, max_new_tokens=n, logprobs=True)
            for p, n in zip(prompts, news)]
    out = engine.run_until_done()
    return [(out[r], engine.logprobs(r)) for r in rids]


def test_latent_engine_matches_jax_and_solo(engine_pair, monkeypatch):
    """The engine in latent mode over tiny_mla (2 layers), five requests
    for two slots, exact and padded prompts: greedy tokens identical to
    the JAX engine's and to the port's solo runs, logprobs within 1e-4,
    the same step counts. Routes: the exact buckets' prefills take the
    expanded path (flash_attention_bshd at q/k width 48, v width 32), every
    decode step's attention the MLA decode wrapper."""
    jax_model, port_model = engine_pair
    prompts = mix_prompts(11, LENGTHS)
    calls = {"flash": [], "mla": 0}
    real_flash, real_mla = port_ds.flash_attention_bshd, port_ds.mla_decode

    def flash(q, k, v, **kw):
        calls["flash"].append((q.shape[-1], v.shape[-1]))
        return real_flash(q, k, v, **kw)

    def mla(*a, **kw):
        calls["mla"] += 1
        return real_mla(*a, **kw)

    monkeypatch.setattr(port_ds, "flash_attention_bshd", flash)
    monkeypatch.setattr(port_ds, "mla_decode", mla)
    jax_eng = JaxEngine(jax_model, **ENGINE)
    port_eng = PortEngine(port_model, **ENGINE)
    assert port_eng._latent_mode and jax_eng._latent_mode
    # the latent rows and the engine's one device lengths tensor, no pages
    assert set(port_eng._caches[0]) == {"c_kv", "k_pe", "lengths"}
    assert port_eng._caches[0]["lengths"] is port_eng._caches[1]["lengths"]
    want = _run(jax_eng, prompts, NEW_TOKENS)
    got = _run(port_eng, prompts, NEW_TOKENS)
    for (wt, wl), (gt, gl), n in zip(want, got, NEW_TOKENS):
        assert len(gt) == n
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    j, p = jax_eng.stats(), port_eng.stats()
    for key in ("decode_steps", "tokens_generated", "requests_finished"):
        assert p[key] == j[key], key
    n_exact = sum(1 for n in LENGTHS if n in (16, 32))
    assert calls["flash"] == [(48, 32)] * (2 * n_exact)
    assert calls["mla"] == 2 * p["decode_steps"]
    for prompt, n, (gt, _) in zip(prompts, NEW_TOKENS, got):
        solo = PortEngine(port_model, max_batch=1, max_len=128)
        rid = solo.add_request(prompt, max_new_tokens=n)
        np.testing.assert_array_equal(solo.run_until_done()[rid], gt)


def test_latent_decode_logits_match_jax(engine_pair):
    """Two requests admitted into the latent rows, then two decode steps:
    the last-logit rows and the written latent rows agree within 1e-4."""
    jax_model, port_model = engine_pair
    jax_eng = JaxEngine(jax_model, **ENGINE)
    port_eng = PortEngine(port_model, **ENGINE)
    for p in mix_prompts(2, (19, 32)):
        jax_eng.add_request(p, max_new_tokens=4)
        port_eng.add_request(p, max_new_tokens=4)
    for _ in range(2):
        np.testing.assert_allclose(port_eng._last.numpy(),
                                   np.asarray(jax_eng._last), **TOL)
        jax_eng.step()
        port_eng.step()
    np.testing.assert_array_equal(port_eng._lengths,
                                  np.asarray(jax_eng._lengths))
    np.testing.assert_allclose(port_eng._last.numpy(),
                               np.asarray(jax_eng._last), **TOL)
    for jc, pc in zip(jax_eng._caches, port_eng._caches):
        for key in ("c_kv", "k_pe"):
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset,kw", [
    ("tiny_mla", {}),
    ("tiny_v3", dict(q_lora_rank=16, n_shared_experts=2)),
])
def test_state_round_trip_bit_exact(dtype, preset, kw):
    """Every DeepSeek parameter (router, experts w1/b1/w2/b2, shared
    experts, correction bias, kv_a_proj_with_mqa, kv_a_layernorm,
    kv_b_proj, the q variants) crosses into the port and back bit for
    bit."""
    paddle_tpu.seed(4)
    cfg = dict(num_hidden_layers=2, dtype=dtype, **kw)
    jax_model = jax_ds.DeepseekV2ForCausalLM(
        getattr(jax_ds.DeepseekV2Config, preset)(**cfg))
    state = {k: np.asarray(v)
             for k, v in jax_model.functional_state().items()}
    for part in ("mlp.gate_weight", "mlp.experts.w1", "mlp.experts.b2",
                 "mlp.shared_expert.down_proj.weight",
                 "self_attn.kv_a_proj_with_mqa.weight",
                 "self_attn.kv_a_layernorm.weight",
                 "self_attn.kv_b_proj.weight"):
        assert any(part in name for name in state), part
    model = from_jax_state(
        state, getattr(port_ds.DeepseekV2Config, preset)(**cfg),
        device="cpu")
    assert type(model) is port_ds.DeepseekV2ForCausalLM
    back = to_numpy_state(model)
    assert set(back) == set(state)
    for name, arr in state.items():
        want = arr.view(np.uint16) if dtype == "bfloat16" else arr
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_latent_mode_refuses_speculation(engine_pair):
    jax_model, port_model = engine_pair
    for engine, model in ((JaxEngine, jax_model), (PortEngine, port_model)):
        with pytest.raises(NotImplementedError, match="latent"):
            engine(model, speculative_k=2, **ENGINE)


def test_unported_options_raise():
    """Multi-token prediction is ported: an MTP config builds, as in JAX,
    with its depths (``tests/test_torch_deepseek_mtp.py`` holds them to
    JAX). LongRoPE is ported on the
    trunk's tables: a longrope scaling builds the config, as in JAX, and
    the loader's gate (``validate_rope_scaling``) refuses this one, which
    has no factor lists, with JAX's message. Training is ported: labels
    give a finite (loss, logits) pair."""
    mtp = port_ds.DeepseekV2Config.tiny_mla(num_nextn_predict_layers=1)
    assert (mtp.num_nextn_predict_layers, mtp.mtp_loss_lambda) == (1, 0.3)
    cfg = port_ds.DeepseekV2Config.tiny_mla(rope_scaling={
        "rope_type": "longrope", "factor": 2.0})
    with pytest.raises(ValueError, match="short_factor and long_factor"):
        validate_rope_scaling(cfg.rope_scaling,
                              max_position=cfg.max_position_embeddings)
    _, port_model, _ = _pair(max_len=32)
    ids = torch.zeros(1, 4, dtype=torch.long)
    loss, logits = port_model(ids, labels=ids)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    assert tuple(logits.shape) == (1, 4, port_model.config.vocab_size)
