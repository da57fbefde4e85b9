"""Gemma decoder family (Gemma-2B / 7B) — counterpart of
``paddle_tpu/models/gemma.py``.

The Llama trunk with Gemma's three options, each a ``LlamaConfig`` field:
a GeGLU MLP (``hidden_act="gelu_pytorch_tanh"``), (1 + w) norms with w
initialised to zeros (``rms_norm_offset``) and embeddings scaled by
sqrt(hidden_size) (``scale_embeddings``); head width 256 decoupled from
hidden / heads, and the head tied to the embedding. On CUDA its attention
runs the kernels at head width 256: the flash forward for an exact
prefill, append attention for dense decode and padded prefills, the paged
kernel in the engine and ``generate_paged``. A HuggingFace checkpoint
converts through ``gemma_from_hf`` (``gemma.py:84``: the Llama bridge with
the three options set, the activation from ``hidden_activation``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .llama import LlamaConfig, LlamaForCausalLM, _from_hf, _hf_get


@dataclasses.dataclass
class GemmaConfig(LlamaConfig):
    # Gemma-7B shape
    vocab_size: int = 256000
    hidden_size: int = 3072
    intermediate_size: int = 24576
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: Optional[int] = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = True
    hidden_act: str = "gelu_pytorch_tanh"
    rms_norm_offset: bool = True
    scale_embeddings: bool = True

    @staticmethod
    def gemma_2b(**kw):
        # 2B is the MQA member: 8 heads over 1 KV head, head_dim 256
        base = dict(hidden_size=2048, intermediate_size=16384,
                    num_hidden_layers=18, num_attention_heads=8,
                    num_key_value_heads=1)
        base.update(kw)
        return GemmaConfig(**base)

    @staticmethod
    def tiny(**kw):
        # head_dim 32 != hidden / heads (16): the decoupling stays exercised
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=32,
                    max_position_embeddings=256, dtype="float32")
        base.update(kw)
        return GemmaConfig(**base)


class GemmaForCausalLM(LlamaForCausalLM):
    """Gemma causal LM: the Llama decoder with GeGLU, (1 + w) norms, scaled
    embeddings and a tied head (the checks of ``gemma.py:65-82``)."""

    def __init__(self, config: GemmaConfig, device=None, generator=None):
        if config.hidden_act != "gelu_pytorch_tanh":
            raise ValueError("Gemma uses hidden_act='gelu_pytorch_tanh'")
        if not config.rms_norm_offset:
            raise ValueError("Gemma norms are (1 + w)-parameterized "
                             "(rms_norm_offset=True)")
        if not config.scale_embeddings:
            raise ValueError("Gemma scales embeddings by sqrt(hidden_size) "
                             "(scale_embeddings=True)")
        if not config.tie_word_embeddings:
            raise ValueError("Gemma ties the lm head to the embedding")
        super().__init__(config, device=device, generator=generator)


def gemma_from_hf(hf_model_or_state, hf_config=None, device=None,
                  **config_overrides):
    """A ``GemmaForCausalLM`` from a transformers Gemma model, or from a
    state dict and its config, on ``device`` (``gemma.py:84-98``). HF
    Gemma carries its activation in ``hidden_activation`` (``hidden_act``
    there is vestigial)."""
    get = _hf_get(hf_config if hf_config is not None
                  else hf_model_or_state.config)
    config_overrides.setdefault(
        "hidden_act", get("hidden_activation") or "gelu_pytorch_tanh")
    config_overrides.setdefault("rms_norm_offset", True)
    config_overrides.setdefault("scale_embeddings", True)
    return _from_hf(GemmaConfig, GemmaForCausalLM, hf_model_or_state,
                    hf_config, device=device, **config_overrides)
