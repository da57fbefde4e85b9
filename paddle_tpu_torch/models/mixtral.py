"""Mixtral (8x7B / 8x22B) sparse-MoE decoder — counterpart of
``paddle_tpu/models/mixtral.py``.

The MoE decoder of ``llama_moe`` the Mixtral way: every layer sparse, no
shared expert, top-2 of 8 with the softmax over the selected logits (the
trunk's ``norm_topk_prob=True``), SwiGLU experts in the fused gate‖up
layout, bias-free GQA attention. Not ported: the HF loader
(``mixtral_from_hf``).
"""
from __future__ import annotations

import dataclasses

from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM


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
