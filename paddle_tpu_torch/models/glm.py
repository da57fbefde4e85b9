"""GLM / GLM-4 decoder families (glm-4-9b, the GLM-4-0414 line) —
counterpart of ``paddle_tpu/models/glm.py``.

Both are the Llama trunk with q/k/v biases and a partial rotary slice
(``partial_rotary_factor`` 0.5: the leading half of each head of 128
rotates, in the half-rotate layout the HF conversion gives it by an
even-then-odd reorder of the rotary rows). GLM-4 wraps each sublayer in
Gemma2's sandwich norms, so its trunk is ``Gemma2Model`` with plain
RMSNorm weights, no embedding scale, no q pre-multiplier and no caps (all
four left at the trunk's defaults by ``GlmConfig``): four ``rms_norm``
launches a layer and no ``add_rms_norm``. The biases and the partial
rotary keep every layer off the fused decode tail, as in JAX. Not ported:
the HF conversion (``deinterleave_rotary``, ``_translate_glm_state``,
``glm_from_hf``, ``glm4_from_hf``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .gemma2 import Gemma2Model
from .llama import LlamaConfig, LlamaForCausalLM


@dataclasses.dataclass
class GlmConfig(LlamaConfig):
    # glm-4-9b shape
    vocab_size: int = 151552
    hidden_size: int = 4096
    intermediate_size: int = 13696
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    head_dim: Optional[int] = 128
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1.5625e-07
    rope_theta: float = 10000.0
    attention_bias: bool = True
    partial_rotary_factor: float = 0.5

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16,
                    max_position_embeddings=256, dtype="float32")
        base.update(kw)
        return GlmConfig(**base)


@dataclasses.dataclass
class Glm4Config(GlmConfig):
    # GLM-4-0414: GLM's attention on the sandwich-norm block

    @staticmethod
    def tiny(**kw):
        # GlmConfig.tiny's fields as a Glm4Config (JAX's inherited preset
        # returns a GlmConfig; the bridge here picks the class by config)
        return Glm4Config(**dataclasses.asdict(GlmConfig.tiny(**kw)))


class GlmForCausalLM(LlamaForCausalLM):
    """GLM causal LM: the Llama trunk with q/k/v biases and a partial
    rotary slice (the checks of ``glm.py:66-74``)."""

    def __init__(self, config: GlmConfig, device=None, generator=None):
        if not config.attention_bias:
            raise ValueError("GLM uses attention_bias=True")
        if config.partial_rotary_factor >= 1.0:
            raise ValueError("GLM rotates a partial slice "
                             "(partial_rotary_factor < 1)")
        super().__init__(config, device=device, generator=generator)


class Glm4ForCausalLM(GlmForCausalLM):
    """GLM-4 causal LM: GLM's attention on the sandwich-norm trunk."""

    model_cls = Gemma2Model
