"""The port's HuggingFace bridge for the sparse-MoE families and DeepSeek
(``load_hf_grouped_moe`` / ``pack_hf_experts``, ``qwen2_moe_from_hf``,
``qwen3_moe_from_hf``, ``mixtral_from_hf``, ``ernie45_from_hf``,
``deepseek_from_hf``) against the JAX package's converters and against
transformers.

Qwen2-MoE, Qwen3-MoE, Mixtral and ERNIE-4.5 are tiny random-init
transformers models (1-D weights and ERNIE's correction bias moved off
their initial values): every parameter equal to the JAX converter's bit
for bit in f32 and bf16, and f32 logits within the JAX tests' tolerances
of transformers' (``moe_capacity_factor`` 8, so the capacity dispatch
drops no route, as transformers' dropless routing). DeepSeek goes through
the ``_FakeHF`` state of ``tests/test_deepseek.py`` with MoE layers (full
and LoRA q, yarn, V3's correction bias): parameters equal to the JAX
``deepseek_from_hf``'s, logits within 1e-5 of the port model
``from_jax_state`` builds from the JAX parameters, and a V3 checkpoint's
MTP tensors left unused, as JAX leaves them."""
import os
import types

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")   # transformers' TensorFlow import
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from test_deepseek import _FakeHF  # noqa: E402
from test_torch_hf_bridge import (assert_same_parameters,  # noqa: E402
                                  perturb_1d_)

# family: (transformers classes, config fields, (module, converter),
# logits tolerance) — the shapes and tolerances of the JAX family tests
FAMILIES = {
    "qwen2_moe": (("Qwen2MoeConfig", "Qwen2MoeForCausalLM"),
                  dict(rms_norm_eps=1e-6, rope_theta=1e6, num_experts=4,
                       num_experts_per_tok=2, moe_intermediate_size=32,
                       shared_expert_intermediate_size=64,
                       norm_topk_prob=False, decoder_sparse_step=1,
                       mlp_only_layers=[]),
                  ("qwen2_moe", "qwen2_moe_from_hf"), 5e-4),
    "qwen3_moe": (("Qwen3MoeConfig", "Qwen3MoeForCausalLM"),
                  dict(head_dim=32, rms_norm_eps=1e-6, rope_theta=1e6,
                       num_experts=4, num_experts_per_tok=2,
                       moe_intermediate_size=32, norm_topk_prob=True),
                  ("qwen3_moe", "qwen3_moe_from_hf"), 3e-4),
    "mixtral": (("MixtralConfig", "MixtralForCausalLM"),
                dict(intermediate_size=96, rms_norm_eps=1e-5,
                     rope_theta=1e6, num_local_experts=4,
                     num_experts_per_tok=2),
                ("mixtral", "mixtral_from_hf"), 5e-4),
    "ernie45": (("Ernie4_5_MoeConfig", "Ernie4_5_MoeForCausalLM"),
                dict(vocab_size=96, num_hidden_layers=3, rms_norm_eps=1e-5,
                     rope_theta=5e5, moe_num_experts=4, moe_k=2,
                     moe_intermediate_size=32, moe_num_shared_experts=1,
                     moe_layer_start_index=1, use_bias=False,
                     tie_word_embeddings=True),
                ("ernie45", "ernie45_from_hf"), 5e-4),
}


def converter(package, family):
    import importlib

    mod, fn = FAMILIES[family][2]
    return getattr(importlib.import_module(f"{package}.models.{mod}"), fn)


def hf_model(family, seed=0):
    (cfg_name, cls_name), fields = FAMILIES[family][:2]
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              tie_word_embeddings=False)
    kw.update(fields)
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_name)(attn_implementation="eager",
                                          output_router_logits=False, **kw)
    hf = perturb_1d_(getattr(transformers, cls_name)(cfg).eval(), seed)
    if family == "ernie45":
        # a non-zero selection bias, so that selection and combine differ
        with torch.no_grad():
            for layer in hf.model.layers[1:]:
                layer.mlp.moe_statics.e_score_correction_bias.add_(
                    torch.tensor([[0.3, -0.2, 0.1, -0.3]]))
    return hf


_CACHE = {}


def converted(family, dtype):
    key = (family, dtype)
    if key not in _CACHE:
        if family not in _CACHE:
            _CACHE[family] = hf_model(family)
        hf = _CACHE[family]
        kw = dict(dtype=dtype, use_flash_attention=False,
                  moe_capacity_factor=8.0)
        _CACHE[key] = (hf, converter("paddle_tpu_torch", family)(
            hf, device="cpu", **kw), converter("paddle_tpu", family)(hf, **kw))
    return _CACHE[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parameters_equal_the_jax_converter(family, dtype):
    _, port, jax_model = converted(family, dtype)
    assert_same_parameters(port, jax_model)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_transformers(family):
    hf, port, _ = converted(family, "float32")
    tol = FAMILIES[family][3]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, hf.config.vocab_size, (2, 9)))
    with torch.no_grad():
        np.testing.assert_allclose(port(ids).numpy(), hf(ids).logits.numpy(),
                                   atol=tol, rtol=tol)


def test_experts_are_written_into_the_grouped_weights():
    """Each expert's gate / up / down land in its slices of w1 / w2 (the
    fused gate‖up), transposed, in the module's own storage; b1 / b2 are
    zeros; the stacking form of ``pack_hf_experts`` gives the same."""
    from paddle_tpu_torch.models.llama_moe import pack_hf_experts

    hf, port, _ = converted("mixtral", "float32")
    sd = hf.state_dict()
    experts = port.llama.layers[1].mlp.experts
    M = experts.d_hidden
    pre = "model.layers.1.block_sparse_moe.experts"
    for e in range(4):
        assert torch.equal(experts.w1[e, :, :M], sd[f"{pre}.{e}.w1.weight"].t())
        assert torch.equal(experts.w1[e, :, M:], sd[f"{pre}.{e}.w3.weight"].t())
        assert torch.equal(experts.w2[e], sd[f"{pre}.{e}.w2.weight"].t())
    assert not experts.b1.any() and not experts.b2.any()

    def take(key, transpose):
        return sd[key].t() if transpose else sd[key]

    stacked = pack_hf_experts(take, "model.layers.1.block_sparse_moe", 4, 64,
                              expert_keys=("w1", "w3", "w2"))
    for got, want in zip(stacked, (experts.w1, experts.b1, experts.w2,
                                   experts.b2)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("family", ["qwen2_moe", "mixtral"])
def test_moe_refusals(family):
    """A leftover tensor (ValueError) and a missing expert (KeyError), as
    the JAX loaders raise them, before anything is written."""
    hf = converted(family, "float32")[0]
    kw = dict(dtype="float32", use_flash_attention=False)
    extra = dict(hf.state_dict(), **{"model.layers.0.extra.weight":
                                     torch.zeros(2)})
    short = {k: v for k, v in hf.state_dict().items()
             if ".experts.3." not in k}
    for state, exc in ((extra, ValueError), (short, KeyError)):
        with pytest.raises(exc):
            converter("paddle_tpu", family)(state, hf.config, **kw)
        with pytest.raises(exc):
            converter("paddle_tpu_torch", family)(state, hf.config,
                                                  device="cpu", **kw)


def test_mixed_sparse_stacks_refuse():
    from paddle_tpu.models.qwen2_moe import _hf_config_to_qwen2_moe as jax_map

    from paddle_tpu_torch.models.qwen2_moe import _hf_config_to_qwen2_moe

    cfg = dict(hf_model("qwen2_moe").config.to_dict(), mlp_only_layers=[1])
    for fn in (jax_map, _hf_config_to_qwen2_moe):
        with pytest.raises(NotImplementedError, match="mixed"):
            fn(cfg)


# ------------------------------------------------------------- DeepSeek --

H, DN, DR, DV, R, HID, V, E, M = 4, 16, 8, 16, 24, 48, 64, 4, 24

DEEPSEEK_CASES = {
    "fullq": dict(q_lora_rank=None, rope_scaling=None),
    "qlora": dict(q_lora_rank=24, rope_scaling=None),
    # DeepSeek-V2's yarn (distinct mscale / mscale_all_dim)
    "yarn": dict(q_lora_rank=None, rope_scaling={
        "type": "yarn", "factor": 2.0, "original_max_position_embeddings": 32,
        "beta_fast": 32, "beta_slow": 1, "mscale": 1.0,
        "mscale_all_dim": 0.4}),
    # V3's routing: sigmoid scores, the aux-free correction bias, groups
    "v3": dict(q_lora_rank=24, rope_scaling=None, topk_method="noaux_tc",
               scoring_func="sigmoid", n_group=2, topk_group=1,
               routed_scaling_factor=2.5),
}


def deepseek_checkpoint(case, mtp=False, seed=11):
    """(state {key: f32 array}, config namespace): three layers, the first
    dense, two MoE (4 experts, 1 shared)."""
    opts = dict(DEEPSEEK_CASES[case])
    q_lora = opts.pop("q_lora_rank")
    rng = np.random.RandomState(seed)
    L = 3

    def w(*shape, norm=False):
        a = 0.05 * rng.randn(*shape)
        return (1 + 2 * a if norm else a).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, HID),
          "model.norm.weight": w(HID, norm=True),
          "lm_head.weight": w(V, HID)}
    for i in range(L + (1 if mtp else 0)):
        p = f"model.layers.{i}"
        if q_lora:
            sd[f"{p}.self_attn.q_a_proj.weight"] = w(q_lora, HID)
            sd[f"{p}.self_attn.q_a_layernorm.weight"] = w(q_lora, norm=True)
            sd[f"{p}.self_attn.q_b_proj.weight"] = w(H * (DN + DR), q_lora)
        else:
            sd[f"{p}.self_attn.q_proj.weight"] = w(H * (DN + DR), HID)
        sd[f"{p}.self_attn.kv_a_proj_with_mqa.weight"] = w(R + DR, HID)
        sd[f"{p}.self_attn.kv_a_layernorm.weight"] = w(R, norm=True)
        sd[f"{p}.self_attn.kv_b_proj.weight"] = w(H * (DN + DV), R)
        sd[f"{p}.self_attn.o_proj.weight"] = w(HID, H * DV)
        sd[f"{p}.input_layernorm.weight"] = w(HID, norm=True)
        sd[f"{p}.post_attention_layernorm.weight"] = w(HID, norm=True)
        if i == 0:
            for proj, shape in (("gate_proj", (2 * HID, HID)),
                                ("up_proj", (2 * HID, HID)),
                                ("down_proj", (HID, 2 * HID))):
                sd[f"{p}.mlp.{proj}.weight"] = w(*shape)
            continue
        sd[f"{p}.mlp.gate.weight"] = w(E, HID)
        if opts.get("topk_method") == "noaux_tc":
            sd[f"{p}.mlp.gate.e_score_correction_bias"] = w(E)
        for e in range(E):
            for proj, shape in (("gate_proj", (M, HID)), ("up_proj", (M, HID)),
                                ("down_proj", (HID, M))):
                sd[f"{p}.mlp.experts.{e}.{proj}.weight"] = w(*shape)
        for proj, shape in (("gate_proj", (M, HID)), ("up_proj", (M, HID)),
                            ("down_proj", (HID, M))):
            sd[f"{p}.mlp.shared_experts.{proj}.weight"] = w(*shape)
        if mtp and i == L:   # V3's MTP depth beside its block
            sd[f"{p}.eh_proj.weight"] = w(HID, 2 * HID)
            for norm in ("enorm", "hnorm", "shared_head.norm"):
                sd[f"{p}.{norm}.weight"] = w(HID, norm=True)
    cfg = types.SimpleNamespace(
        vocab_size=V, hidden_size=HID, intermediate_size=2 * HID,
        num_hidden_layers=L, num_attention_heads=H,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        q_lora_rank=q_lora, kv_lora_rank=R, qk_nope_head_dim=DN,
        qk_rope_head_dim=DR, v_head_dim=DV, n_routed_experts=E,
        n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=M,
        first_k_dense_replace=1, norm_topk_prob=True,
        tie_word_embeddings=False, **opts)
    return sd, cfg


@pytest.mark.parametrize("case", sorted(DEEPSEEK_CASES))
def test_deepseek_equals_the_jax_converter(case):
    """Both q variants, yarn and V3's routing: the f32 parameters (config
    mapped from the checkpoint's, as JAX maps it) equal JAX's bit for bit,
    and the logits equal, within 1e-5, those of the port model
    ``from_jax_state`` builds from the JAX parameters."""
    from paddle_tpu.models.deepseek import deepseek_from_hf as jax_from_hf

    from paddle_tpu_torch.models.deepseek import deepseek_from_hf
    from paddle_tpu_torch.weights import from_jax_state

    sd, cfg = deepseek_checkpoint(case)
    port = deepseek_from_hf(_FakeHF(sd, cfg), device="cpu")
    jax_model = jax_from_hf(_FakeHF(sd, cfg))
    assert port.config.dtype == "float32"
    assert_same_parameters(port, jax_model)
    state = {k: np.asarray(v) for k, v in jax_model.functional_state().items()}
    ref = from_jax_state(state, port.config, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, V, (2, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(port(ids).numpy(), ref(ids).numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["fullq", "v3"])
def test_deepseek_bf16_config(case):
    """With a bf16 config given (as the card phase loads it), the
    parameters equal JAX's converter's given the same config."""
    import dataclasses

    from paddle_tpu.models.deepseek import DeepseekV2Config as JaxConfig
    from paddle_tpu.models.deepseek import deepseek_from_hf as jax_from_hf

    from paddle_tpu_torch.models.deepseek import deepseek_from_hf

    sd, cfg = deepseek_checkpoint(case)
    f32 = deepseek_from_hf(_FakeHF(sd, cfg), device="cpu").config
    bf16 = dataclasses.replace(f32, dtype="bfloat16")
    port = deepseek_from_hf(_FakeHF(sd, cfg), config=bf16, device="cpu")
    jax_model = jax_from_hf(_FakeHF(sd, cfg), config=JaxConfig(
        **dataclasses.asdict(bf16)))
    assert_same_parameters(port, jax_model)


def test_deepseek_rope_rows_are_deinterleaved():
    """The q_pe rows of each head and the k_pe tail reordered even then
    odd: the inverse reorder gives the checkpoint's rows back."""
    from paddle_tpu_torch.models.deepseek import (deinterleave_q,
                                                  deinterleave_rows)

    sd, _ = deepseek_checkpoint("fullq")
    q = torch.from_numpy(sd["model.layers.0.self_attn.q_proj.weight"])
    got = deinterleave_q(q, H, DN, DR).reshape(H, DN + DR, -1)
    want = q.reshape(H, DN + DR, -1)
    assert torch.equal(got[:, :DN], want[:, :DN])
    assert torch.equal(got[:, DN:DN + DR // 2], want[:, DN::2])
    assert torch.equal(got[:, DN + DR // 2:], want[:, DN + 1::2])
    kv = torch.from_numpy(sd["model.layers.0.self_attn.kv_a_proj_with_mqa."
                             "weight"])
    got = deinterleave_rows(kv, DR)
    assert torch.equal(got[:R], kv[:R])
    assert torch.equal(got[R:R + DR // 2], kv[R::2])
    assert torch.equal(got[R + DR // 2:], kv[R + 1::2])


def test_deepseek_mtp_tensors_are_left_unused():
    """A V3 checkpoint with its MTP depth (``model.layers.{L}.*``) loads
    as JAX loads it: the extra tensors are not read and the trunk is the
    one converted without them."""
    from paddle_tpu.models.deepseek import deepseek_from_hf as jax_from_hf

    from paddle_tpu_torch.models.deepseek import deepseek_from_hf

    sd, cfg = deepseek_checkpoint("v3", mtp=True)
    assert any(k.startswith("model.layers.3.") for k in sd)
    port = deepseek_from_hf(_FakeHF(sd, cfg), device="cpu")
    assert port.mtp_layers is None
    assert_same_parameters(port, jax_from_hf(_FakeHF(sd, cfg)))
    trunk = {k: v for k, v in sd.items()
             if not k.startswith("model.layers.3.")}
    plain = deepseek_from_hf(_FakeHF(trunk, cfg), device="cpu")
    for (name, a), (_, b) in zip(port.named_parameters(),
                                 plain.named_parameters()):
        assert torch.equal(a, b), name


def test_deepseek_missing_key_raises():
    from paddle_tpu_torch.models.deepseek import deepseek_from_hf

    sd, cfg = deepseek_checkpoint("fullq")
    del sd["model.layers.2.mlp.experts.1.up_proj.weight"]
    with pytest.raises(KeyError, match="experts.1.up_proj"):
        deepseek_from_hf(_FakeHF(sd, cfg), device="cpu")
