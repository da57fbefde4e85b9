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
rotary keep every layer off the fused decode tail, as in JAX. A
HuggingFace checkpoint converts through ``glm_from_hf`` / ``glm4_from_hf``
(``glm.py:85-175``): each head's rotary q / k rows reordered even then odd
(``deinterleave_rotary``, on the device, one tensor at a time as the
loader reads it), the fused ``gate_up_proj`` split, GLM-4's sandwich-norm
names mapped onto Gemma2's (``_translate_glm_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from collections.abc import Mapping

import torch

from ..framework.random import default_device
from .gemma2 import Gemma2Model
from .llama import (LlamaConfig, LlamaForCausalLM, _from_hf, _hf_get,
                    _state_and_config, hf_tensor, rope_dim_of)


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


def deinterleave_rotary(w, n_heads, head_dim, rope_dim):
    """Even-then-odd reorder of each head's rotary rows of a torch [out,
    ...] weight or bias (``glm.py:85-93``): interleaved-pair rotation is
    the half-rotate rotation after it; the pass-through rows stay."""
    v = w.reshape((n_heads, head_dim) + tuple(w.shape[1:]))
    rot = v[:, :rope_dim]
    rot = torch.cat([rot[:, 0::2], rot[:, 1::2]], dim=1)
    return torch.cat([rot, v[:, rope_dim:]], dim=1).reshape(w.shape)


class _DeferredState(Mapping):
    """A translated checkpoint whose values are made when a key is read,
    ``{key: (fn, source value)}``: a loader that reads one key at a time
    holds one translated tensor at a time."""

    def __init__(self):
        self._items = {}

    def put(self, key, value, fn=None):
        self._items[key] = (fn, value)

    def __getitem__(self, key):
        fn, value = self._items[key]
        return value if fn is None else fn(value)

    def __contains__(self, key):
        return key in self._items

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


def _translate_glm_state(state, hf_config, sandwich, device=None):
    """A GLM checkpoint in the key layout here (``glm.py:96-142``): q / k
    rotary rows de-interleaved on ``device`` when read, the fused gate_up
    split (row views), GLM-4's norms renamed onto the Gemma2 sandwich:
    ``post_self_attn`` -> ``post_attention``, ``post_attention`` ->
    ``pre_feedforward``, ``post_mlp`` -> ``post_feedforward``."""
    import types

    from .phi3 import split_gate_up

    device = default_device(device)
    get = _hf_get(hf_config)
    heads = get("num_attention_heads")
    hd = get("head_dim") or get("hidden_size") // heads
    # the permuted rows are exactly the rotated ones: the runtime's width
    rd = rope_dim_of(types.SimpleNamespace(
        head_dim=hd,
        partial_rotary_factor=(get("partial_rotary_factor") or 0.5)))
    kv = get("num_key_value_heads")
    renames = {}
    if sandwich:
        renames = {
            ".post_self_attn_layernorm.": ".post_attention_layernorm.",
            ".post_attention_layernorm.": ".pre_feedforward_layernorm.",
            ".post_mlp_layernorm.": ".post_feedforward_layernorm.",
        }

    def rotary(n):
        return lambda v: deinterleave_rotary(hf_tensor(v).to(device), n, hd,
                                             rd)

    out = _DeferredState()
    for key, val in state.items():
        new_key = key
        for old, new in renames.items():
            if old in key:
                new_key = key.replace(old, new)
                break
        if key.endswith((".self_attn.q_proj.weight",
                         ".self_attn.q_proj.bias")):
            out.put(new_key, val, rotary(heads))
        elif key.endswith((".self_attn.k_proj.weight",
                           ".self_attn.k_proj.bias")):
            out.put(new_key, val, rotary(kv))
        elif key.endswith(".mlp.gate_up_proj.weight"):
            halves = {}
            split_gate_up(new_key, hf_tensor(val), halves)
            for k, v in halves.items():
                out.put(k, v)
        else:
            out.put(new_key, val)
    return out


def _glm_from_hf(config_cls, model_cls, sandwich, hf_model_or_state,
                 hf_config=None, device=None, **config_overrides):
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    get = _hf_get(hf_config)
    config_overrides.setdefault(
        "partial_rotary_factor", float(get("partial_rotary_factor") or 0.5))
    extra = (("pre_feedforward_layernorm", "post_feedforward_layernorm")
             if sandwich else ())
    return _from_hf(config_cls, model_cls,
                    _translate_glm_state(state, hf_config, sandwich,
                                         device=device),
                    hf_config, extra_layer_norms=extra, device=device,
                    **config_overrides)


def glm_from_hf(hf_model_or_state, hf_config=None, device=None,
                **config_overrides):
    """A ``GlmForCausalLM`` from a transformers Glm model, or from a state
    dict and its config, on ``device`` (``glm.py:162-166``)."""
    return _glm_from_hf(GlmConfig, GlmForCausalLM, False, hf_model_or_state,
                        hf_config, device=device, **config_overrides)


def glm4_from_hf(hf_model_or_state, hf_config=None, device=None,
                 **config_overrides):
    """A ``Glm4ForCausalLM`` from a transformers Glm4 model, or from a state
    dict and its config, on ``device`` (``glm.py:169-175``)."""
    return _glm_from_hf(Glm4Config, Glm4ForCausalLM, True, hf_model_or_state,
                        hf_config, device=device, **config_overrides)
