"""Mistral decoder family — counterpart of ``paddle_tpu/models/mistral.py``.

The Llama decoder with causal sliding-window attention (window 4096 in
v0.1 / v0.2), expressed as a ``LlamaConfig`` specialisation: every path is
the Llama trunk's, with ``sliding_window`` set. On CUDA the training
forward and the unpadded prefill run the LocalMask flash kernels
(``ops/hopper/flash_attention.py``), windowed decode gathers only the
pages of the band (``generation._paged_window_attention``). A
HuggingFace checkpoint converts through ``mistral_from_hf``
(``mistral.py:48``: the Llama bridge; ``sliding_window`` maps for
``model_type`` "mistral").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .llama import LlamaConfig, LlamaForCausalLM, _from_hf


@dataclasses.dataclass
class MistralConfig(LlamaConfig):
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = 4096

    @staticmethod
    def mistral_7b(**kw):
        return MistralConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    sliding_window=32, dtype="float32")
        base.update(kw)
        return MistralConfig(**base)


class MistralForCausalLM(LlamaForCausalLM):
    """Mistral causal LM — the Llama decoder with sliding-window attention."""


def mistral_from_hf(hf_model_or_state, hf_config=None, device=None,
                    **config_overrides):
    """A ``MistralForCausalLM`` from a transformers Mistral model, or from a
    state dict and its config, on ``device`` (``mistral.py:48-52``)."""
    return _from_hf(MistralConfig, MistralForCausalLM, hf_model_or_state,
                    hf_config, device=device, **config_overrides)
