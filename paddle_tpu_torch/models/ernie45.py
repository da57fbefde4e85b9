"""ERNIE-4.5 text decoder — counterpart of ``paddle_tpu/models/ernie45.py``.

The MoE decoder of ``llama_moe`` with ERNIE-4.5's knobs: one leading dense
layer, then 64 routed experts (top-6, softmax renormalised over the
selected k) beside two always-on shared experts, and the aux-free
correction bias that steers the top-k selection only. GQA attention over
the shared Llama trunk: the 21B-A3B shape has 20 query heads over 4 KV
heads, a group of 5, which every attention kernel of the port takes. A
HuggingFace checkpoint converts through ``ernie45_from_hf``
(``ernie45.py:72-215``): the interleaved rotary q / k rows reordered even
then odd on the device, the leading dense layers as plain MLPs, the
router's correction bias from ``moe_statics``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..framework.random import default_device
from .llama import _hf_get, _state_and_config
from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM, _load_grouped


@dataclasses.dataclass
class Ernie45Config(LlamaMoEConfig):
    """ERNIE-4.5 text-model knobs on the MoE decoder base
    (``ernie45.py:25``)."""

    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    moe_correction_bias: bool = True
    router_aux_loss_coef: float = 0.001

    @staticmethod
    def a3b(**kw):
        """The 21B-A3B open-release shape (text experts)."""
        base = dict(vocab_size=103424, hidden_size=2560,
                    intermediate_size=12288, num_hidden_layers=28,
                    num_attention_heads=20, num_key_value_heads=4,
                    max_position_embeddings=131072,
                    moe_intermediate_size=1536)
        base.update(kw)
        return Ernie45Config(**base)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=3, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32", n_routed_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=64,
                    n_shared_experts=1, first_k_dense_replace=1)
        base.update(kw)
        return Ernie45Config(**base)


class Ernie45ForCausalLM(LlamaMoEForCausalLM):
    """ERNIE-4.5-style causal LM: the MoE decoder with shared experts and
    the selection bias; serving, ``generate`` and training are the MoE
    base's."""


def _hf_config_to_ernie45(hf_config, **overrides) -> Ernie45Config:
    """A transformers Ernie4_5_Moe config as an ``Ernie45Config``
    (``ernie45.py:72-110``); biases, trailing dense layers and dense
    layers between MoE ones refuse."""
    get = _hf_get(hf_config)
    if get("use_bias", False):
        raise NotImplementedError(
            "ernie45_from_hf: use_bias=True checkpoints are not "
            "represented (the 4.5 text releases ship bias-free)")
    end = get("moe_layer_end_index", -1)
    layers = get("num_hidden_layers")
    if end not in (-1, None) and end < layers - 1:
        raise NotImplementedError(
            "ernie45_from_hf: trailing dense layers "
            f"(moe_layer_end_index={end} < {layers - 1}) are not "
            "representable; only leading dense layers map")
    if get("moe_layer_interval", 1) != 1:
        raise NotImplementedError(
            "ernie45_from_hf: moe_layer_interval != 1 (dense layers "
            "interleaved mid-stack) is not representable; only leading "
            "dense layers (moe_layer_start_index) map")
    kw = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 500000.0),
        tie_word_embeddings=bool(get("tie_word_embeddings", True)),
        n_routed_experts=get("moe_num_experts"),
        num_experts_per_tok=get("moe_k"),
        moe_intermediate_size=get("moe_intermediate_size"),
        n_shared_experts=get("moe_num_shared_experts"),
        first_k_dense_replace=get("moe_layer_start_index", 1),
    )
    kw.update(overrides)
    return Ernie45Config(**kw)


def _interleaved_rows(n_heads, head_dim):
    """ERNIE-4.5's interleaved (rotate-every-two) rotary as the half-rotate
    rotation here: each head's rows of a torch [out, in] weight reordered
    even then odd (the Meta -> HF Llama permutation), on the device."""
    def fn(w):
        out_dim, in_dim = w.shape
        wh = w.reshape(n_heads, head_dim, in_dim)
        wh = torch.cat([wh[:, 0::2], wh[:, 1::2]], dim=1)
        return wh.reshape(out_dim, in_dim)
    return fn


def load_hf_ernie45(model: "Ernie45ForCausalLM",
                    hf_state_dict) -> "Ernie45ForCausalLM":
    """A transformers Ernie4_5_MoeForCausalLM state dict written into
    ``model`` in place (``ernie45.py:113-203``): q / k rows de-interleaved,
    the leading dense layers as plain MLPs, per MoE layer the router, its
    correction bias ([1, E] -> [E]), the experts packed and the shared
    experts."""
    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    plan = {"llama.embed_tokens.weight": ("model.embed_tokens.weight", False),
            "llama.norm.weight": ("model.norm.weight", False)}
    if model.lm_head is not None:
        plan["lm_head.weight"] = (
            "lm_head.weight" if "lm_head.weight" in hf_state_dict
            else "model.embed_tokens.weight", True)
    transforms, experts = {}, {}
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"model.layers.{i}", f"llama.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            plan[f"{ours}.self_attn.{proj}.weight"] = (
                f"{hf}.self_attn.{proj}.weight", True)
        transforms[f"{ours}.self_attn.q_proj.weight"] = _interleaved_rows(
            cfg.num_attention_heads, head_dim)
        transforms[f"{ours}.self_attn.k_proj.weight"] = _interleaved_rows(
            cfg.num_key_value_heads, head_dim)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            plan[f"{ours}.{norm}.weight"] = (f"{hf}.{norm}.weight", False)
        if i < cfg.first_k_dense_replace:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                plan[f"{ours}.mlp.{proj}.weight"] = (
                    f"{hf}.mlp.{proj}.weight", True)
            continue
        plan[f"{ours}.mlp.gate_weight"] = (f"{hf}.mlp.gate.weight", True)
        bias = f"{ours}.mlp.e_score_correction_bias"
        plan[bias] = (f"{hf}.mlp.moe_statics.e_score_correction_bias", False)
        transforms[bias] = lambda t: t.reshape(-1)
        experts[f"{ours}.mlp.experts"] = f"{hf}.mlp"
        for proj in ("gate_proj", "up_proj", "down_proj"):
            plan[f"{ours}.mlp.shared_expert.{proj}.weight"] = (
                f"{hf}.mlp.shared_experts.{proj}.weight", True)
    return _load_grouped("load_hf_ernie45", model, hf_state_dict, plan,
                         experts, transforms=transforms,
                         aliases=("lm_head.weight",))


def ernie45_from_hf(hf_model_or_state, hf_config=None, device=None,
                    **config_overrides):
    """An ``Ernie45ForCausalLM`` from a transformers
    Ernie4_5_MoeForCausalLM, or from a state dict and its config, on
    ``device`` (``ernie45.py:206-215``)."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    cfg = _hf_config_to_ernie45(hf_config, **config_overrides)
    return load_hf_ernie45(Ernie45ForCausalLM(cfg, device=device), state)
