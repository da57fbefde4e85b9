"""Qwen2-MoE / Qwen1.5-MoE decoder — counterpart of
``paddle_tpu/models/qwen2_moe.py``.

The MoE decoder of ``llama_moe`` specialised three ways: q/k/v projection
biases (``attention_bias``), a sigmoid gate on the shared expert's output
(``shared_expert_gate``) and raw top-k softmax weights
(``norm_topk_prob=False``); every layer sparse. Not ported: the HF loader
(``qwen2_moe_from_hf``).
"""
from __future__ import annotations

import dataclasses

from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM


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
