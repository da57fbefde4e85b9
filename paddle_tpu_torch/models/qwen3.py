"""Qwen3 decoder family — counterpart of ``paddle_tpu/models/qwen3.py``.

The Llama trunk with per-head q/k RMSNorm after the head split
(``qk_norm=True``: two more ``rms_norm`` launches a layer, at width
``head_dim``), no projection bias, and ``head_dim`` decoupled from hidden
/ heads (Qwen3-4B: hidden 2560, 32 heads of 128). The q/k norms keep every
layer off the fused decode tail, as in JAX. A HuggingFace checkpoint
converts through ``qwen3_from_hf`` (``qwen3.py:73``: the Llama bridge with
the q/k norms).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .llama import LlamaConfig, LlamaForCausalLM, _from_hf


@dataclasses.dataclass
class Qwen3Config(LlamaConfig):
    # Qwen3-8B shape
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = 128
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    attention_bias: bool = False
    qk_norm: bool | str = True

    @staticmethod
    def qwen3_8b(**kw):
        return Qwen3Config(**kw)

    @staticmethod
    def qwen3_4b(**kw):
        # head_dim 128 with hidden / heads = 80: the decoupled case
        base = dict(hidden_size=2560, intermediate_size=9728,
                    num_hidden_layers=36, num_attention_heads=32,
                    num_key_value_heads=8, tie_word_embeddings=True)
        base.update(kw)
        return Qwen3Config(**base)

    @staticmethod
    def tiny(**kw):
        # head_dim 32 != hidden / heads (16): the decoupling stays exercised
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=32,
                    max_position_embeddings=256, dtype="float32")
        base.update(kw)
        return Qwen3Config(**base)


class Qwen3ForCausalLM(LlamaForCausalLM):
    """Qwen3 causal LM: the Llama decoder with per-head q/k norms and a
    decoupled head width (the check of ``qwen3.py:67-72``)."""

    def __init__(self, config: Qwen3Config, device=None, generator=None):
        if config.qk_norm not in (True, "per_head"):
            raise ValueError(
                "Qwen3 uses PER-HEAD q/k norms (qk_norm=True); "
                f"got qk_norm={config.qk_norm!r}")
        super().__init__(config, device=device, generator=generator)


def qwen3_from_hf(hf_model_or_state, hf_config=None, device=None,
                  **config_overrides):
    """A ``Qwen3ForCausalLM`` from a transformers Qwen3 model, or from a
    state dict and its config, on ``device`` (``qwen3.py:73-79``)."""
    config_overrides.setdefault("qk_norm", True)
    return _from_hf(Qwen3Config, Qwen3ForCausalLM, hf_model_or_state,
                    hf_config, device=device, **config_overrides)
