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
(``paged_attention_96``), dense decode the einsum, as in JAX. A
HuggingFace checkpoint converts through ``phi3_from_hf`` (``phi3.py:95``):
the fused ``qkv_proj`` and ``gate_up_proj`` rows split into the trunk's
projections (``split_phi3_fused``, ``split_gate_up``: row slices, no copy),
``original_max_position_embeddings`` folded into the longrope scaling, the
window mapped as is.
"""
from __future__ import annotations

import dataclasses

from .llama import (LlamaConfig, LlamaForCausalLM, _from_hf, _hf_get,
                    _state_and_config, hf_tensor)


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


def split_phi3_fused(hf_state_dict, hf_config):
    """A transformers Phi3 state dict in the Llama key layout
    (``phi3.py:56-82``): each ``qkv_proj`` split into q / k / v rows (torch
    [out, in]), each ``gate_up_proj`` into equal gate / up halves; every
    other key passes through. The parts are row slices of the fused
    tensors, views: nothing is copied."""
    get = _hf_get(hf_config)
    h = get("hidden_size")
    heads = get("num_attention_heads")
    kv = get("num_key_value_heads")
    hd = get("head_dim") or h // heads
    out = {}
    for key, val in hf_state_dict.items():
        if key.endswith(".self_attn.qkv_proj.weight"):
            base = key[: -len("qkv_proj.weight")]
            v = hf_tensor(val)
            if v.shape[0] != (heads + 2 * kv) * hd:
                raise ValueError(
                    f"{key}: fused qkv rows {v.shape[0]} != "
                    f"(H + 2*kv) * head_dim = {(heads + 2 * kv) * hd}")
            out[base + "q_proj.weight"] = v[: heads * hd]
            out[base + "k_proj.weight"] = v[heads * hd: (heads + kv) * hd]
            out[base + "v_proj.weight"] = v[(heads + kv) * hd:]
        elif key.endswith(".mlp.gate_up_proj.weight"):
            split_gate_up(key, hf_tensor(val), out)
        else:
            out[key] = val
    return out


def split_gate_up(key, v, out):
    """Fused [gate; up] checkpoint rows into ``gate_proj`` / ``up_proj``
    entries of ``out`` (torch [out, in] halves; ``phi3.py:85-92``, shared
    with GLM)."""
    base = key[: -len("gate_up_proj.weight")]
    half = v.shape[0] // 2
    out[base + "gate_proj.weight"] = v[:half]
    out[base + "up_proj.weight"] = v[half:]


def phi3_from_hf(hf_model_or_state, hf_config=None, device=None,
                 **config_overrides):
    """A ``Phi3ForCausalLM`` from a transformers Phi3 model, or from a
    state dict and its config, on ``device`` (``phi3.py:95-123``)."""
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    get = _hf_get(hf_config)
    scaling = get("rope_scaling")
    if scaling:
        # the factor list is chosen against original_max_position_embeddings,
        # a config attribute in Phi-3: fold it into the scaling dict
        scaling = dict(scaling)
        orig = get("original_max_position_embeddings")
        if orig:
            scaling.setdefault("original_max_position_embeddings", orig)
        config_overrides.setdefault("rope_scaling", scaling)
    config_overrides.setdefault("sliding_window", get("sliding_window"))
    return _from_hf(Phi3Config, Phi3ForCausalLM,
                    split_phi3_fused(state, hf_config), hf_config,
                    device=device, **config_overrides)
