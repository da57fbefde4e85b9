"""Qwen3-MoE decoder (the Qwen3-30B-A3B class) — counterpart of
``paddle_tpu/models/qwen3_moe.py``.

The MoE decoder of ``llama_moe`` with the Qwen3 attention signature:
per-head q/k RMSNorm (``qk_norm``, the ``rms_norm`` kernel at width
``head_dim``), bias-free projections, ``head_dim`` decoupled from the
hidden width; a routed FFN with no shared expert and renormalised top-k
weights, every layer sparse. Not ported: the HF loader
(``qwen3_moe_from_hf``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM


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
