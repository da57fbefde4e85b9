"""Gemma2 decoder family (2B / 9B / 27B) — counterpart of
``paddle_tpu/models/gemma2.py``.

Gemma's options (``gemma.py``) plus Gemma2's four, each at the trunk level:

- sandwich norms: a norm on the attention output before the residual add
  and a pre / post pair around the MLP (``Gemma2DecoderLayer``, four
  (1 + w) ``rms_norm`` launches a layer and no ``add_rms_norm``);
- ``query_pre_attn_scalar``: the softmax scale folded into q after the
  projection (``LlamaAttention.q_premul``), which also keeps the layer
  off the fused decode tail;
- tanh caps on the attention scores (``attn_logit_softcapping``) and on
  the logits (``final_logit_softcapping``): capped attention takes the
  plain capped routes the JAX package takes, never an attention kernel
  (the dense einsum, the paged gather reference ``paged_attention_plain``,
  the band gather);
- sliding and full attention in turn through the trunk's ``layer_types``.

A HuggingFace checkpoint converts through ``gemma2_from_hf``
(``gemma2.py:131``: the Llama bridge with the sandwich norms, the caps,
the q scalar and the layer schedule from the config).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn as tnn

from .gemma import GemmaConfig
from .llama import (LlamaAttention, LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaRMSNorm, _from_hf, _hf_get, layer_window)


@dataclasses.dataclass
class Gemma2Config(GemmaConfig):
    # Gemma2-9B shape
    vocab_size: int = 256000
    hidden_size: int = 3584
    intermediate_size: int = 14336
    num_hidden_layers: int = 42
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: Optional[int] = 256
    query_pre_attn_scalar: Optional[float] = 256.0
    attn_logit_softcapping: Optional[float] = 50.0
    final_logit_softcapping: Optional[float] = 30.0
    sliding_window: Optional[int] = 4096

    def __post_init__(self):
        if self.layer_types is None and self.sliding_window is not None:
            # the Gemma2 alternation: even layers sliding, odd layers full
            self.layer_types = tuple(
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(self.num_hidden_layers))
        super().__post_init__()

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=32,
                    query_pre_attn_scalar=64.0, sliding_window=16,
                    max_position_embeddings=256, dtype="float32")
        base.update(kw)
        return Gemma2Config(**base)


class Gemma2DecoderLayer(tnn.Module):
    """Sandwich-norm decoder block: norm(attn) before the residual add and
    a pre / post norm pair around the MLP (four (1 + w) RMSNorms a layer;
    ``gemma2.py:71-103``)."""

    def __init__(self, config: Gemma2Config, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device=device)
        self.mlp = LlamaMLP(config, device=device)
        self.input_layernorm = LlamaRMSNorm(config, device=device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device)
        self.pre_feedforward_layernorm = LlamaRMSNorm(config, device=device)
        self.post_feedforward_layernorm = LlamaRMSNorm(config, device=device)

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """Returns hidden, or (hidden, new cache) when given a cache."""
        residual = hidden_states
        hidden_states = self.input_layernorm(hidden_states)
        if kv_cache is not None:
            hidden_states, kv_cache = self.self_attn(hidden_states, cos, sin,
                                                     kv_cache)
        else:
            hidden_states = self.self_attn(hidden_states, cos, sin)
        hidden_states = residual + self.post_attention_layernorm(
            hidden_states)
        residual = hidden_states
        hidden_states = self.mlp(self.pre_feedforward_layernorm(hidden_states))
        hidden_states = residual + self.post_feedforward_layernorm(
            hidden_states)
        if kv_cache is not None:
            return hidden_states, kv_cache
        return hidden_states


class Gemma2Model(LlamaModel):
    def _make_layer(self, config, layer_idx, device):
        layer = Gemma2DecoderLayer(config, device=device)
        layer.self_attn.window = layer_window(config, layer_idx)
        return layer


class Gemma2ForCausalLM(LlamaForCausalLM):
    """Gemma2 causal LM: the sandwich-norm trunk; the final soft cap is the
    base head's (``LlamaForCausalLM.lm_head_logits``; the checks of
    ``gemma2.py:114-129``)."""

    model_cls = Gemma2Model

    def __init__(self, config: Gemma2Config, device=None, generator=None):
        if config.hidden_act != "gelu_pytorch_tanh":
            raise ValueError("Gemma2 uses hidden_act='gelu_pytorch_tanh'")
        if not (config.rms_norm_offset and config.scale_embeddings):
            raise ValueError("Gemma2 needs rms_norm_offset=True and "
                             "scale_embeddings=True (the Gemma base knobs)")
        if not config.tie_word_embeddings:
            raise ValueError("Gemma2 ties the lm head to the embedding")
        super().__init__(config, device=device, generator=generator)


def gemma2_from_hf(hf_model_or_state, hf_config=None, device=None,
                   **config_overrides):
    """A ``Gemma2ForCausalLM`` from a transformers Gemma2 model, or from a
    state dict and its config, on ``device`` (``gemma2.py:131-160``): the
    window schedule arrives as ``layer_types`` and a uniform window."""
    get = _hf_get(hf_config if hf_config is not None
                  else hf_model_or_state.config)
    config_overrides.setdefault(
        "hidden_act", get("hidden_activation") or "gelu_pytorch_tanh")
    config_overrides.setdefault("rms_norm_offset", True)
    config_overrides.setdefault("scale_embeddings", True)
    for key in ("query_pre_attn_scalar", "attn_logit_softcapping",
                "final_logit_softcapping", "sliding_window"):
        config_overrides.setdefault(key, get(key))
    lt = get("layer_types")
    config_overrides.setdefault("layer_types",
                                tuple(lt) if lt is not None else None)
    return _from_hf(Gemma2Config, Gemma2ForCausalLM, hf_model_or_state,
                    hf_config,
                    extra_layer_norms=("pre_feedforward_layernorm",
                                       "post_feedforward_layernorm"),
                    device=device, **config_overrides)
