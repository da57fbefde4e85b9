"""Weight bridge between the JAX package's state and the port's model.

``from_jax_state`` takes ``paddle_tpu``'s ``Layer.functional_state()``
converted to numpy by the caller ({name: np.ndarray}, same names as the
port's parameters, ``mlp.experts.w1`` and ``self_attn.kv_b_proj.weight``
included) and returns the port's causal LM of the config's family
(``model_class``); ``load_jax_state`` fills any module (a standalone
``MoELayer`` or gate) by parameter name; ``to_numpy_state`` goes the other
way. Linear weights are [in, out] in both packages, so nothing is
transposed. numpy has no bfloat16: bf16 travels as its uint16 bit pattern
(a ``bfloat16`` array from ml_dtypes is taken as well), so the round trip
is bit-exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.deepseek import DeepseekV2Config, DeepseekV2ForCausalLM
from .models.ernie45 import Ernie45Config, Ernie45ForCausalLM
from .models.gemma import GemmaConfig, GemmaForCausalLM
from .models.gemma2 import Gemma2Config, Gemma2ForCausalLM
from .models.glm import (Glm4Config, Glm4ForCausalLM, GlmConfig,
                         GlmForCausalLM)
from .models.gpt2 import GPT2Config, GPT2LMHeadModel
from .models.llama import LlamaConfig, LlamaForCausalLM, torch_dtype
from .models.llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM
from .models.mistral import MistralConfig, MistralForCausalLM
from .models.mixtral import MixtralConfig, MixtralForCausalLM
from .models.olmo2 import Olmo2Config, Olmo2ForCausalLM
from .models.phi3 import Phi3Config, Phi3ForCausalLM
from .models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from .models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from .models.qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
from .models.qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM


def _to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")   # writable, contiguous
    if arr.dtype.name == "bfloat16" or (arr.dtype == np.uint16
                                        and dtype == torch.bfloat16):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dtype)


def model_class(config: LlamaConfig):
    """The causal-LM class of a config's family (each MoE family before
    ``LlamaMoEConfig``, which they all extend; Gemma2 before Gemma, GLM-4
    before GLM; GPT-2's config is no ``LlamaConfig``)."""
    for cfg_cls, model_cls in ((GPT2Config, GPT2LMHeadModel),
                               (DeepseekV2Config, DeepseekV2ForCausalLM),
                               (Gemma2Config, Gemma2ForCausalLM),
                               (GemmaConfig, GemmaForCausalLM),
                               (Ernie45Config, Ernie45ForCausalLM),
                               (Qwen2MoeConfig, Qwen2MoeForCausalLM),
                               (Qwen3MoeConfig, Qwen3MoeForCausalLM),
                               (MixtralConfig, MixtralForCausalLM),
                               (LlamaMoEConfig, LlamaMoEForCausalLM),
                               (MistralConfig, MistralForCausalLM),
                               (Qwen2Config, Qwen2ForCausalLM),
                               (Qwen3Config, Qwen3ForCausalLM),
                               (Phi3Config, Phi3ForCausalLM),
                               (Olmo2Config, Olmo2ForCausalLM),
                               (Glm4Config, Glm4ForCausalLM),
                               (GlmConfig, GlmForCausalLM)):
        if isinstance(config, cfg_cls):
            return model_cls
    return LlamaForCausalLM


def from_jax_state(state: dict, config: LlamaConfig, device=None,
                   dtype=None) -> LlamaForCausalLM:
    """The port's model of ``config``'s family holding ``state``; ``dtype``
    defaults to the config's. Every parameter of the model must be in
    ``state``."""
    if dtype is not None:
        config = dataclasses.replace(
            config, dtype=str(torch_dtype(dtype)).replace("torch.", ""))
    model = model_class(config)(config, device=device)
    return _load(model, state, torch_dtype(config.dtype))


def load_jax_state(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """``module`` (any ``nn.Module``: a ``MoELayer``, a gate, a model)
    holding ``state`` ({name: np.ndarray} by its parameter names), each
    parameter keeping its own dtype and device. Every parameter must be in
    ``state``, and nothing else."""
    return _load(module, state, None)


def _load(module, state, dtype):
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = _to_tensor(np.asarray(state[name]), dtype or p.dtype)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.data = src.to(p.device)
    return module


def to_numpy_state(model: LlamaForCausalLM) -> dict:
    """{name: np.ndarray}; bfloat16 parameters as uint16 bit patterns."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[name] = t.view(torch.int16).numpy().view(np.uint16).copy()
        else:
            out[name] = t.numpy().copy()
    return out
