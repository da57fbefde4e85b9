"""Phi-3 decoder family (mini / medium, 4k and 128k) — counterpart of
``paddle_tpu/models/phi3.py``.

The Llama trunk (RoPE GQA, SwiGLU, RMSNorm, untied head); the 128k
variants scale RoPE by LongRoPE (``rope_scaling`` type ``"longrope"``,
``llama._longrope_params``: the short or the long factor list by the
length a table is built for, and the sqrt(1 + ln f / ln orig) magnitude).
Phi-3-mini's heads are 96 wide, which no attention kernel is instantiated
at and JAX's gates refuse (96 % 128 != 0): the forward without a cache and
every prefill take the plain attention (``append_attention.plain_width``),
decode over the paged pool the paged kernel at D 96
(``paged_attention_96``), dense decode the einsum, as in JAX. Not ported:
the HF conversion (``split_phi3_fused``, ``split_gate_up``,
``phi3_from_hf``).
"""
from __future__ import annotations

import dataclasses

from .llama import LlamaConfig, LlamaForCausalLM


@dataclasses.dataclass
class Phi3Config(LlamaConfig):
    # Phi-3-mini shape
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32")
        base.update(kw)
        return Phi3Config(**base)


class Phi3ForCausalLM(LlamaForCausalLM):
    """Phi-3 causal LM: the Llama trunk; the family's identity is its
    checkpoint packaging and its LongRoPE tables."""
