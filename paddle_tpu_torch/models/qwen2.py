"""Qwen2 / Qwen2.5 decoder family — counterpart of
``paddle_tpu/models/qwen2.py``.

The Llama trunk with q/k/v projection biases (``attention_bias``), its own
RoPE base and presets. On CUDA its attention runs the kernels at its head
width: 128 for Qwen2.5-7B (28 | 4 heads), 64 for Qwen2.5-0.5B (14 | 2, a
group of 7; the (64, 64) flash forward and append attention, and
``paged_attention_64``). The biases keep every layer off the fused decode
tail, as in JAX. A HuggingFace checkpoint converts through
``qwen2_from_hf`` (``qwen2.py:62``: the Llama bridge).
"""
from __future__ import annotations

import dataclasses

from .llama import LlamaConfig, LlamaForCausalLM, _from_hf


@dataclasses.dataclass
class Qwen2Config(LlamaConfig):
    # Qwen2.5-7B shape
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    attention_bias: bool = True

    @staticmethod
    def qwen25_7b(**kw):
        return Qwen2Config(**kw)

    @staticmethod
    def qwen25_0_5b(**kw):
        base = dict(hidden_size=896, intermediate_size=4864,
                    num_hidden_layers=24, num_attention_heads=14,
                    num_key_value_heads=2, tie_word_embeddings=True)
        base.update(kw)
        return Qwen2Config(**base)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32")
        base.update(kw)
        return Qwen2Config(**base)


class Qwen2ForCausalLM(LlamaForCausalLM):
    """Qwen2 causal LM: the Llama decoder with q/k/v biases (the check of
    ``qwen2.py:55-58``)."""

    def __init__(self, config: Qwen2Config, device=None, generator=None):
        if not config.attention_bias:
            raise ValueError("Qwen2 uses attention_bias=True")
        super().__init__(config, device=device, generator=generator)


def qwen2_from_hf(hf_model_or_state, hf_config=None, device=None,
                  **config_overrides):
    """A ``Qwen2ForCausalLM`` from a transformers Qwen2 model, or from a
    state dict and its config, on ``device`` (``qwen2.py:62-66``)."""
    return _from_hf(Qwen2Config, Qwen2ForCausalLM, hf_model_or_state,
                    hf_config, device=device, **config_overrides)
