"""The sparse-MoE families on the MoE trunk — ERNIE-4.5, Qwen2-MoE
(Qwen1.5-MoE), Qwen3-MoE and Mixtral — against the JAX package, on the
CPU, each at its ``tiny()`` size built in both packages from the same numpy
weights (``weights.from_jax_state``; 1-D parameters 1 + 0.1 N(0, 1), so
ERNIE's correction bias, Qwen2's q/k/v biases and the q/k norms are all
non-zero): the presets, the constructors' checks, the non-cached logits
(f32 within atol 1e-4, rtol 1e-4; bf16 within 0.03 + 2^-7 |p|, one bf16
rounding of an f32 sum taken in another order per layer), greedy
``generate`` tokens on the dense and paged caches (f32, identical), and
the engine against solo ``generate``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import jax_generate, numpy_state

import paddle_tpu
from paddle_tpu.models import ernie45 as j_ernie
from paddle_tpu.models import mixtral as j_mixtral
from paddle_tpu.models import qwen2_moe as j_qwen2
from paddle_tpu.models import qwen3_moe as j_qwen3
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.weights import from_jax_state, model_class

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_RTOL = 0.03, 2.0 ** -7
FAMILIES = {
    "ernie45": (j_ernie.Ernie45Config, j_ernie.Ernie45ForCausalLM,
                port_models.Ernie45Config, port_models.Ernie45ForCausalLM),
    "qwen2_moe": (j_qwen2.Qwen2MoeConfig, j_qwen2.Qwen2MoeForCausalLM,
                  port_models.Qwen2MoeConfig,
                  port_models.Qwen2MoeForCausalLM),
    "qwen3_moe": (j_qwen3.Qwen3MoeConfig, j_qwen3.Qwen3MoeForCausalLM,
                  port_models.Qwen3MoeConfig,
                  port_models.Qwen3MoeForCausalLM),
    "mixtral": (j_mixtral.MixtralConfig, j_mixtral.MixtralForCausalLM,
                port_models.MixtralConfig, port_models.MixtralForCausalLM),
}
# (family, preset): the published shapes and the tiny ones
PRESETS = [("ernie45", "a3b"), ("ernie45", "tiny"), ("qwen2_moe", None),
           ("qwen2_moe", "tiny"), ("qwen3_moe", None), ("qwen3_moe", "tiny"),
           ("mixtral", None), ("mixtral", "tiny")]


def _build(family, dtype="float32", seed=0, **kw):
    jcfg_cls, jlm, pcfg_cls, _ = FAMILIES[family]
    paddle_tpu.seed(seed)
    jax_model = jlm(jcfg_cls.tiny(dtype=dtype, **kw))
    state = numpy_state(jax_model, seed)
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in state.items()}
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    jax_model.llama._rope(128)
    port = from_jax_state(state, pcfg_cls.tiny(dtype=dtype, **kw),
                          device="cpu")
    return jax_model, port, state


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


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request):
    return (request.param,) + _build(request.param, seed=7)


@pytest.mark.parametrize("family,preset", PRESETS)
def test_presets_match_jax(family, preset):
    jcfg, _, pcfg, _ = FAMILIES[family]
    want = dataclasses.asdict(getattr(jcfg, preset)() if preset else jcfg())
    got = dataclasses.asdict(getattr(pcfg, preset)() if preset else pcfg())
    shared = set(want) & set(got)
    assert {"n_routed_experts", "num_experts_per_tok", "attention_bias",
            "qk_norm", "head_dim", "moe_correction_bias"} <= shared
    for key in shared:
        assert got[key] == want[key], (family, preset, key)


@pytest.mark.parametrize("family,bad", [
    ("qwen2_moe", dict(attention_bias=False)),
    ("qwen2_moe", dict(shared_expert_gate=False)),
    ("qwen3_moe", dict(qk_norm="full")),
    ("qwen3_moe", dict(n_shared_experts=1)),
    ("mixtral", dict(n_shared_experts=1)),
    ("mixtral", dict(norm_topk_prob=False)),
    ("mixtral", dict(first_k_dense_replace=1)),
])
def test_constructor_checks_match_jax(family, bad):
    jcfg, jlm, pcfg, plm = FAMILIES[family]
    with pytest.raises(ValueError) as jerr:
        jlm(jcfg.tiny(**bad))
    with pytest.raises(ValueError) as perr:
        plm(pcfg.tiny(**bad), device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_bridge_builds_each_family_and_its_options(pair):
    """``from_jax_state`` builds the family's own class (``model_class``
    maps each config before the MoE base), with the q/k/v biases, the q/k
    norms and the correction bias where the family has them."""
    family, _, port, state = pair
    assert type(port) is FAMILIES[family][3]
    assert model_class(port.config) is FAMILIES[family][3]
    names = set(state)
    has = {"ernie45": "mlp.e_score_correction_bias",
           "qwen2_moe": "self_attn.q_proj.bias",
           "qwen3_moe": "self_attn.q_norm.weight",
           "mixtral": "mlp.experts.w1"}[family]
    assert f"llama.layers.1.{has}" in names
    assert bool(port.llama.layers[1].mlp.gate_weight.detach().any())


def test_logits_match_jax_f32(pair):
    _, jax_model, port, _ = pair
    ids = np.random.RandomState(1).randint(0, 512, (2, 20))
    want = jax_logits(jax_model, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_close_to_jax_bf16(family):
    jax_model, port, _ = _build(family, dtype="bfloat16", seed=8)
    ids = np.random.RandomState(2).randint(0, 512, (1, 16))
    want = jax_logits(jax_model, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


def test_greedy_tokens_match_jax_dense_and_paged(pair):
    """The JAX ``generate``'s tokens on its dense cache; the port's on its
    dense cache and on its paged pool (page 8) are the same."""
    _, jax_model, port, _ = pair
    ids = np.random.RandomState(3).randint(0, 512, (2, 12))
    want = jax_generate(jax_model, ids, max_new_tokens=6)
    for kw in ({}, dict(paged=True, page_size=8)):
        got = port.generate(torch.from_numpy(ids), max_new_tokens=6,
                            **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_engine_equals_solo_generate(pair):
    """Three requests through ``ContinuousBatchEngine`` (paged, two slots,
    so one waits for a free slot): each gets the tokens of ``generate`` on
    its prompt alone."""
    _, _, port, _ = pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, size=n) for n in (16, 9, 21)]
    eng = ContinuousBatchEngine(port, max_batch=2, max_len=64)
    rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    out = eng.run_until_done()
    for rid, p in zip(rids, prompts):
        solo = port.generate(torch.from_numpy(p[None]),
                             max_new_tokens=5).numpy()[0]
        np.testing.assert_array_equal(out[rid], solo)


def test_ernie_correction_bias_steers_selection_only():
    """ERNIE's non-zero correction bias: the port's routes and logits equal
    JAX's with it, and zeroing it on both sides changes the routes (so the
    selection path ran), while the combine weights stay the raw softmax."""
    jax_model, port, state = _build("ernie45", seed=9)
    mlp = port.llama.layers[1].mlp
    x = torch.from_numpy(np.random.RandomState(5).randn(24, 128).astype(
        np.float32))
    with torch.no_grad():
        probs, _, idx_bias, wts = mlp.route(x)
        # the weights are the raw probabilities of the chosen experts,
        # renormalised: the bias picks, it does not weigh
        chosen = probs.gather(1, idx_bias)
        assert torch.equal(wts, chosen / chosen.sum(-1, keepdim=True))
        ids = np.random.RandomState(6).randint(0, 512, (1, 16))
        got = port(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, jax_logits(jax_model, ids), **TOL)
        mlp.e_score_correction_bias.zero_()
        _, _, idx_plain, _ = mlp.route(x)
    assert not torch.equal(idx_bias, idx_plain)
