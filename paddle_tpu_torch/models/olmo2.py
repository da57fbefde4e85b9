"""OLMo2 decoder family — counterpart of ``paddle_tpu/models/olmo2.py``.

The Llama trunk with two deviations:

- post-norm-only blocks, ``h = h + norm(attn(h)); h = h + norm(mlp(h))``,
  no pre-norm (``Olmo2DecoderLayer``: two ``rms_norm`` launches a layer
  on the sublayers' outputs and no ``add_rms_norm``); the final norm
  stays;
- ``qk_norm="full"``: one RMSNorm over the whole projected q (and k)
  width before the head split (two more ``rms_norm`` launches a layer,
  at widths H D and hk D).

Every other path (caches, engine, beams) is the trunk's; the block is no
``LlamaDecoderLayer``, so it never reaches the fused decode tail. A
HuggingFace checkpoint converts through ``olmo2_from_hf`` (``olmo2.py:98``:
the Llama bridge with the post-only norm pair, ``_OLMO2_NORMS``).
"""
from __future__ import annotations

import dataclasses

from torch import nn as tnn

from .llama import (LlamaAttention, LlamaConfig, LlamaForCausalLM, LlamaMLP,
                    LlamaModel, LlamaRMSNorm, _from_hf, layer_window)

#: OLMo2's per-layer norms in the checkpoint (``olmo2.py:25``)
_OLMO2_NORMS = ("post_attention_layernorm", "post_feedforward_layernorm")


@dataclasses.dataclass
class Olmo2Config(LlamaConfig):
    # OLMo-2-7B shape
    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 500000.0
    qk_norm: bool | str = "full"

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32")
        base.update(kw)
        return Olmo2Config(**base)


class Olmo2DecoderLayer(tnn.Module):
    """Post-norm block: each sublayer's output normed, then added to the
    residual (``olmo2.py:55-78``)."""

    def __init__(self, config: Olmo2Config, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device=device)
        self.mlp = LlamaMLP(config, device=device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device)
        self.post_feedforward_layernorm = LlamaRMSNorm(config, device=device)

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """Returns hidden, or (hidden, new cache) when given a cache."""
        if kv_cache is not None:
            a, kv_cache = self.self_attn(hidden_states, cos, sin, kv_cache)
        else:
            a = self.self_attn(hidden_states, cos, sin)
        hidden_states = hidden_states + self.post_attention_layernorm(a)
        hidden_states = hidden_states + self.post_feedforward_layernorm(
            self.mlp(hidden_states))
        if kv_cache is not None:
            return hidden_states, kv_cache
        return hidden_states


class Olmo2Model(LlamaModel):
    def _make_layer(self, config, layer_idx, device):
        layer = Olmo2DecoderLayer(config, device=device)
        layer.self_attn.window = layer_window(config, layer_idx)
        return layer


class Olmo2ForCausalLM(LlamaForCausalLM):
    """OLMo2 causal LM: the post-norm trunk with full-width q/k norms (the
    check of ``olmo2.py:92-96``)."""

    model_cls = Olmo2Model

    def __init__(self, config: Olmo2Config, device=None, generator=None):
        if config.qk_norm != "full":
            raise ValueError("OLMo2 norms the WHOLE projected q/k "
                             "(qk_norm='full')")
        super().__init__(config, device=device, generator=generator)


def olmo2_from_hf(hf_model_or_state, hf_config=None, device=None,
                  **config_overrides):
    """An ``Olmo2ForCausalLM`` from a transformers Olmo2 model, or from a
    state dict and its config, on ``device`` (``olmo2.py:98-105``)."""
    config_overrides.setdefault("qk_norm", "full")
    return _from_hf(Olmo2Config, Olmo2ForCausalLM, hf_model_or_state,
                    hf_config, layer_norms=_OLMO2_NORMS, device=device,
                    **config_overrides)
