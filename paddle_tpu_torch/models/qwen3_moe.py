"""Qwen3-MoE decoder (the Qwen3-30B-A3B class) — counterpart of
``paddle_tpu/models/qwen3_moe.py``.

The MoE decoder of ``llama_moe`` with the Qwen3 attention signature:
per-head q/k RMSNorm (``qk_norm``, the ``rms_norm`` kernel at width
``head_dim``), bias-free projections, ``head_dim`` decoupled from the
hidden width; a routed FFN with no shared expert and renormalised top-k
weights, every layer sparse. A HuggingFace checkpoint converts through
``qwen3_moe_from_hf`` (``qwen3_moe.py:71-120``: the config map, then
``load_hf_grouped_moe`` with the q/k norms).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..framework.random import default_device
from .llama import _hf_get, _state_and_config, mapped_rope_scaling
from .llama_moe import (LlamaMoEConfig, LlamaMoEForCausalLM,
                        load_hf_grouped_moe)


@dataclasses.dataclass
class Qwen3MoeConfig(LlamaMoEConfig):
    # Qwen3-30B-A3B shape
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 48
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = 128          # decoupled (the quotient is 64)
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    attention_bias: bool = False
    qk_norm: bool = True                   # the Qwen3 attention signature
    n_routed_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    n_shared_experts: int = 0              # no shared expert
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 0         # every layer sparse

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=32,
                    max_position_embeddings=256, dtype="float32",
                    n_routed_experts=4, num_experts_per_tok=2,
                    moe_intermediate_size=32, n_shared_experts=0,
                    first_k_dense_replace=0)
        base.update(kw)
        return Qwen3MoeConfig(**base)


class Qwen3MoeForCausalLM(LlamaMoEForCausalLM):
    """Qwen3-MoE causal LM: the MoE decoder with per-head q/k norms and no
    shared expert (the checks of ``qwen3_moe.py:60-67``)."""

    def __init__(self, config: Qwen3MoeConfig, device=None, generator=None):
        if config.qk_norm not in (True, "per_head"):
            raise ValueError(
                "Qwen3-MoE uses PER-HEAD q/k norms (qk_norm=True); "
                f"got qk_norm={config.qk_norm!r}")
        if config.n_shared_experts:
            raise ValueError("Qwen3-MoE has no shared expert "
                             "(n_shared_experts=0)")
        super().__init__(config, device=device, generator=generator)


def _hf_config_to_qwen3_moe(hf_config, **overrides) -> Qwen3MoeConfig:
    """A transformers Qwen3-MoE config as a ``Qwen3MoeConfig``
    (``qwen3_moe.py:71-101``); mixed sparse / dense stacks refuse, a yarn
    scaling is validated and mapped."""
    get = _hf_get(hf_config)
    if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers", []):
        raise NotImplementedError(
            "qwen3_moe_from_hf: mixed sparse/dense layer patterns "
            "(decoder_sparse_step != 1 or mlp_only_layers) are not "
            "representable; this build supports uniformly-sparse stacks")
    kw = dict(
        rope_scaling=mapped_rope_scaling(get),
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1e6),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        n_routed_experts=get("num_experts"),
        num_experts_per_tok=get("num_experts_per_tok"),
        moe_intermediate_size=get("moe_intermediate_size"),
        # the HF class default for configs that omit the key
        norm_topk_prob=bool(get("norm_topk_prob", False)),
        router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
    )
    kw.update(overrides)
    return Qwen3MoeConfig(**kw)


def load_hf_qwen3_moe(model: Qwen3MoeForCausalLM,
                      hf_state_dict) -> Qwen3MoeForCausalLM:
    """A transformers Qwen3MoeForCausalLM state dict written into ``model``
    in place (``qwen3_moe.py:104-110``: per-head q/k norms, no biases, no
    shared expert)."""
    return load_hf_grouped_moe(model, hf_state_dict, qk_norms=True,
                               who="load_hf_qwen3_moe")


def qwen3_moe_from_hf(hf_model_or_state, hf_config=None, device=None,
                      **config_overrides):
    """A ``Qwen3MoeForCausalLM`` from a transformers model, or from a state
    dict and its config, on ``device`` (``qwen3_moe.py:113-120``)."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    cfg = _hf_config_to_qwen3_moe(hf_config, **config_overrides)
    return load_hf_qwen3_moe(Qwen3MoeForCausalLM(cfg, device=device), state)
