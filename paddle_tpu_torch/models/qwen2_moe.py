"""Qwen2-MoE / Qwen1.5-MoE decoder — counterpart of
``paddle_tpu/models/qwen2_moe.py``.

The MoE decoder of ``llama_moe`` specialised three ways: q/k/v projection
biases (``attention_bias``), a sigmoid gate on the shared expert's output
(``shared_expert_gate``) and raw top-k softmax weights
(``norm_topk_prob=False``); every layer sparse. A HuggingFace checkpoint
converts through ``qwen2_moe_from_hf`` (``qwen2_moe.py:73-130``: the
config map with its refusals, then ``load_hf_grouped_moe``).
"""
from __future__ import annotations

import dataclasses

from ..framework.random import default_device
from .llama import _hf_get, _state_and_config, mapped_rope_scaling
from .llama_moe import (LlamaMoEConfig, LlamaMoEForCausalLM,
                        load_hf_grouped_moe)


@dataclasses.dataclass
class Qwen2MoeConfig(LlamaMoEConfig):
    # Qwen1.5-MoE-A2.7B shape
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 8192
    rope_theta: float = 1e6
    attention_bias: bool = True            # Qwen2 q/k/v biases
    n_routed_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 4              # shared width 5632 = 4 x 1408
    shared_expert_gate: bool = True        # sigmoid-gated shared expert
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 0         # every layer sparse

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32", n_routed_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=64,
                    n_shared_experts=2, first_k_dense_replace=0)
        base.update(kw)
        return Qwen2MoeConfig(**base)


class Qwen2MoeForCausalLM(LlamaMoEForCausalLM):
    """Qwen2-MoE causal LM: the MoE decoder with q/k/v biases and the
    sigmoid shared-expert gate (the checks of ``qwen2_moe.py:64-69``)."""

    def __init__(self, config: Qwen2MoeConfig, device=None, generator=None):
        if not config.attention_bias:
            raise ValueError("Qwen2-MoE uses attention_bias=True")
        if not config.shared_expert_gate and config.n_shared_experts > 0:
            raise ValueError("Qwen2-MoE gates its shared expert "
                             "(shared_expert_gate=True)")
        super().__init__(config, device=device, generator=generator)


def _hf_config_to_qwen2_moe(hf_config, **overrides) -> Qwen2MoeConfig:
    """A transformers Qwen2-MoE config as a ``Qwen2MoeConfig``
    (``qwen2_moe.py:73-110``); mixed sparse / dense stacks and a shared
    width that is no multiple of the expert width refuse."""
    get = _hf_get(hf_config)
    if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers", []):
        raise NotImplementedError(
            "qwen2_moe_from_hf: mixed sparse/dense layer patterns "
            "(decoder_sparse_step != 1 or mlp_only_layers) are not "
            "representable; this build supports uniformly-sparse stacks")
    shared_inter = get("shared_expert_intermediate_size")
    moe_inter = get("moe_intermediate_size")
    if not shared_inter or not moe_inter:
        raise KeyError(
            "qwen2_moe_from_hf: config must carry positive "
            "moe_intermediate_size and shared_expert_intermediate_size "
            f"(got {moe_inter!r} / {shared_inter!r})")
    if shared_inter % moe_inter:
        raise NotImplementedError(
            f"shared_expert_intermediate_size ({shared_inter}) must be a "
            f"multiple of moe_intermediate_size ({moe_inter})")
    kw = dict(
        rope_scaling=mapped_rope_scaling(get),
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1e6),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        n_routed_experts=get("num_experts"),
        num_experts_per_tok=get("num_experts_per_tok"),
        moe_intermediate_size=moe_inter,
        n_shared_experts=shared_inter // moe_inter,
        norm_topk_prob=bool(get("norm_topk_prob", False)),
        router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
    )
    kw.update(overrides)
    return Qwen2MoeConfig(**kw)


def load_hf_qwen2_moe(model: Qwen2MoeForCausalLM,
                      hf_state_dict) -> Qwen2MoeForCausalLM:
    """A transformers Qwen2MoeForCausalLM state dict written into ``model``
    in place (``qwen2_moe.py:113-118``: q/k/v biases, the sigmoid-gated
    shared expert)."""
    return load_hf_grouped_moe(model, hf_state_dict, attn_biases=True,
                               shared_expert=True, shared_gate=True,
                               who="load_hf_qwen2_moe")


def qwen2_moe_from_hf(hf_model_or_state, hf_config=None, device=None,
                      **config_overrides):
    """A ``Qwen2MoeForCausalLM`` from a transformers model, or from a state
    dict and its config, on ``device`` (``qwen2_moe.py:121-130``)."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    cfg = _hf_config_to_qwen2_moe(hf_config, **config_overrides)
    return load_hf_qwen2_moe(Qwen2MoeForCausalLM(cfg, device=device), state)
