"""Mixtral (8x7B / 8x22B) sparse-MoE decoder — counterpart of
``paddle_tpu/models/mixtral.py``.

The MoE decoder of ``llama_moe`` the Mixtral way: every layer sparse, no
shared expert, top-2 of 8 with the softmax over the selected logits (the
trunk's ``norm_topk_prob=True``), SwiGLU experts in the fused gate‖up
layout, bias-free GQA attention. A HuggingFace checkpoint converts
through ``mixtral_from_hf`` (``mixtral.py:80-125``: ``block_sparse_moe``
with per-expert w1 / w3 / w2 as gate / up / down).
"""
from __future__ import annotations

import dataclasses

from ..framework.random import default_device
from .llama import _hf_get, _state_and_config, mapped_rope_scaling
from .llama_moe import (LlamaMoEConfig, LlamaMoEForCausalLM,
                        load_hf_grouped_moe)


@dataclasses.dataclass
class MixtralConfig(LlamaMoEConfig):
    # Mixtral-8x7B shape
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 14336
    n_shared_experts: int = 0              # no shared expert
    first_k_dense_replace: int = 0         # every layer sparse
    norm_topk_prob: bool = True            # softmax over the top-2 logits
    # the released Mixtral-8x7B config.json ships 0.02
    router_aux_loss_coef: float = 0.02

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32", n_routed_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=64,
                    n_shared_experts=0, first_k_dense_replace=0)
        base.update(kw)
        return MixtralConfig(**base)


class MixtralForCausalLM(LlamaMoEForCausalLM):
    """Mixtral causal LM: the all-sparse MoE decoder, no shared expert,
    renormalised top-k combine (the checks of ``mixtral.py:66-78``)."""

    def __init__(self, config: MixtralConfig, device=None, generator=None):
        if config.n_shared_experts:
            raise ValueError("Mixtral has no shared expert "
                             "(n_shared_experts=0)")
        if not config.norm_topk_prob:
            raise ValueError(
                "Mixtral softmaxes over the selected top-k logits "
                "(norm_topk_prob=True)")
        if config.first_k_dense_replace:
            raise ValueError("Mixtral is sparse from layer 0 "
                             "(first_k_dense_replace=0)")
        super().__init__(config, device=device, generator=generator)


def _hf_config_to_mixtral(hf_config, **overrides) -> MixtralConfig:
    """A transformers Mixtral config as a ``MixtralConfig``
    (``mixtral.py:80-104``): the expert width is ``intermediate_size``."""
    get = _hf_get(hf_config)
    kw = dict(
        rope_scaling=mapped_rope_scaling(get),
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        moe_intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 1e6),
        sliding_window=get("sliding_window"),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        n_routed_experts=get("num_local_experts"),
        num_experts_per_tok=get("num_experts_per_tok"),
        router_aux_loss_coef=get("router_aux_loss_coef", 0.001),
    )
    kw.update(overrides)
    return MixtralConfig(**kw)


def load_hf_mixtral(model: MixtralForCausalLM,
                    hf_state_dict) -> MixtralForCausalLM:
    """A transformers MixtralForCausalLM state dict written into ``model``
    in place (``mixtral.py:107-114``)."""
    return load_hf_grouped_moe(model, hf_state_dict,
                               who="load_hf_mixtral",
                               mlp_key="block_sparse_moe",
                               expert_keys=("w1", "w3", "w2"))


def mixtral_from_hf(hf_model_or_state, hf_config=None, device=None,
                    **config_overrides):
    """A ``MixtralForCausalLM`` from a transformers model, or from a state
    dict and its config, on ``device`` (``mixtral.py:117-125``)."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    cfg = _hf_config_to_mixtral(hf_config, **config_overrides)
    return load_hf_mixtral(MixtralForCausalLM(cfg, device=device), state)
