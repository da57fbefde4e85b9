"""ERNIE-4.5 text decoder — counterpart of ``paddle_tpu/models/ernie45.py``.

The MoE decoder of ``llama_moe`` with ERNIE-4.5's knobs: one leading dense
layer, then 64 routed experts (top-6, softmax renormalised over the
selected k) beside two always-on shared experts, and the aux-free
correction bias that steers the top-k selection only. GQA attention over
the shared Llama trunk: the 21B-A3B shape has 20 query heads over 4 KV
heads, a group of 5, which every attention kernel of the port takes. Not
ported: the HF loader (``ernie45_from_hf``).
"""
from __future__ import annotations

import dataclasses

from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM


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
