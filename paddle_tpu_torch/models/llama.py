"""Llama-3 decoder — counterpart of ``paddle_tpu/models/llama.py``.

Ported: the config and its presets, rope tables (default, ``llama3``,
``linear``, ``yarn`` and ``longrope`` scaling; ``validate_rope_scaling``),
RMSNorm (also over another width, ``_width_norm``), attention over the
static KV caches (dense prefill cache and paged pool) and without a cache
(the training forward: fused RoPE, then causal or sliding-window flash
attention), the gated MLP,
the decoder layer on the discrete path, ``LlamaModel.forward`` /
``forward_cached``, the causal-LM head, ``LlamaForCausalLM.forward`` with
labels (the chunked fused lm-head + cross-entropy, or the logits and
``causal_lm_loss``), ``LlamaForCausalLM.generate``, and the fused decode
tail behind
``FLAGS_use_fused_decode_tail`` (two kernels per layer for a decode step
or a paged speculative-verify chunk), layer recompute
(``recompute=True`` wraps every decoder layer in
``distributed.recompute_layer.RecomputeLayer``, as ``llama.py:903-906``;
the cached forward calls the bare layers), q/k/v projection biases
(``attention_bias``, Qwen2) and q/k RMSNorm (``qk_norm``: per head, Qwen3,
or over the projected width, OLMo2), and Gemma's options: (1 + w) norms
(``rms_norm_offset``), embeddings scaled by sqrt(hidden)
(``scale_embeddings``), the softmax scale folded into q
(``query_pre_attn_scalar``), tanh caps on the attention scores
(``attn_logit_softcapping``: the plain capped attention, which the JAX
package routes them to) and on the logits (``final_logit_softcapping``).
Not ported: context parallelism in the trunk (the port has no process
group; JAX refuses capped attention there too).

The HuggingFace checkpoint bridge (``hf_config_to_llama``,
``load_hf_llama``, ``export_hf_llama``, ``llama_from_hf``,
``llama_to_hf``; ``llama.py:205-230, 1260-1501``) is the one every
Llama-layout family converts through: a state dict of torch tensors or
numpy arrays and a config object or ``config.json`` dict in, each tensor
written into its parameter in place on the model's device.

Parameter names equal the JAX package's (``llama.layers.0.self_attn.
q_proj.weight``, ``lm_head.weight``, ...), and Linear weights keep Paddle's
[in, out] layout, so ``weights.from_jax_state`` moves a state across as is.

Every norm runs the fused-norm kernels; cached attention routes through
``generation.cached_attention`` / ``paged_cached_attention``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn

from .. import nn
from ..distributed.recompute_layer import RecomputeLayer
from ..framework.random import default_device, default_generator
from ..ops.fused_loss import fused_linear_cross_entropy
from ..ops.hopper import decode_tail, fused_norm
from ..ops.hopper.append_attention import plain_width
from ..ops.hopper.flash_attention import flash_attention_bshd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # HF-style rope_scaling dict: {"rope_type": "llama3", "factor": 8.0,
    # "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    # "original_max_position_embeddings": 8192}, {"rope_type": "linear",
    # "factor": N}, {"rope_type": "yarn", ...} or {"rope_type": "longrope",
    # "short_factor": [...], "long_factor": [...],
    # "original_max_position_embeddings": N} (Phi-3)
    rope_scaling: Optional[dict] = None
    # attention head width decoupled from hidden_size / num_heads
    head_dim: Optional[int] = None
    # fraction of head_dim that rotates
    partial_rotary_factor: float = 1.0
    # causal sliding window, uniform or per layer through layer_types
    sliding_window: Optional[int] = None
    layer_types: Optional[tuple] = None
    use_flash_attention: bool = True
    # "silu" (SwiGLU) or "gelu_pytorch_tanh" (GeGLU)
    hidden_act: str = "silu"
    dtype: str = "bfloat16"
    # training loss through the chunked fused lm-head + CE
    # (ops/fused_loss.py) instead of the full logits
    fuse_linear_cross_entropy: bool = False
    # recompute each decoder layer's activations in the backward (the
    # Llama and Mistral trunks; the MoE and MLA trunks train unwrapped, as
    # in the JAX package)
    recompute: bool = False
    # q/k/v projection biases (Qwen2; o_proj never has one)
    attention_bias: bool = False
    # RMSNorm on q and k before RoPE: True / "per_head" (Qwen3, one norm of
    # head_dim per head after the split) or "full" (OLMo2, one norm over
    # the projected width before the split)
    qk_norm: bool | str = False
    # RMSNorm weight as (1 + w), w initialised to zeros (Gemma): every
    # kernel call takes the effective weight
    rms_norm_offset: bool = False
    # embeddings times sqrt(hidden_size), the scalar rounded to the compute
    # dtype first (Gemma)
    scale_embeddings: bool = False
    # softmax scale query_pre_attn_scalar ** -0.5 instead of head_dim **
    # -0.5, folded into q after the projection (Gemma2)
    query_pre_attn_scalar: Optional[float] = None
    # tanh cap on the attention scores, cap * tanh(s / cap) (Gemma2): the
    # plain capped attention on every route, as in the JAX package
    attn_logit_softcapping: Optional[float] = None
    # tanh cap on the lm-head logits (Gemma2)
    final_logit_softcapping: Optional[float] = None

    def __post_init__(self):
        if self.final_logit_softcapping and self.fuse_linear_cross_entropy:
            raise NotImplementedError(
                "final_logit_softcapping cannot combine with "
                "fuse_linear_cross_entropy (the chunked-CE scan computes "
                "uncapped logits)")
        if self.qk_norm not in (False, True, "per_head", "full"):
            raise ValueError(
                f"qk_norm must be False, True, 'per_head' or 'full', "
                f"got {self.qk_norm!r}")
        if self.hidden_act not in ("silu", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"hidden_act must be 'silu' or 'gelu_pytorch_tanh', "
                f"got {self.hidden_act!r}")
        if not (0.0 < self.partial_rotary_factor <= 1.0):
            raise ValueError(
                f"partial_rotary_factor must be in (0, 1], got "
                f"{self.partial_rotary_factor}")
        if _rope_type(self.rope_scaling) not in SUPPORTED_ROPE_SCALING:
            raise NotImplementedError(
                f"rope_scaling type {_rope_type(self.rope_scaling)!r} is not "
                f"ported (supported: {', '.join(SUPPORTED_ROPE_SCALING)})")
        if self.layer_types is not None:
            self.layer_types = tuple(self.layer_types)
            if len(self.layer_types) != self.num_hidden_layers:
                raise ValueError(
                    f"layer_types has {len(self.layer_types)} entries for "
                    f"{self.num_hidden_layers} layers")
            bad = set(self.layer_types) - {"sliding_attention",
                                           "full_attention"}
            if bad:
                raise ValueError(f"unknown layer_types entries: {bad}")

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_70b(**kw):
        base = dict(hidden_size=8192, intermediate_size=28672,
                    num_hidden_layers=80, num_attention_heads=64,
                    num_key_value_heads=8)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32")
        base.update(kw)
        return LlamaConfig(**base)


def layer_window(config, layer_idx: int):
    """Layer ``layer_idx``'s sliding window (uniform, or per layer through
    ``layer_types``)."""
    lt = getattr(config, "layer_types", None)
    if not lt:
        return config.sliding_window
    return (config.sliding_window if lt[layer_idx] == "sliding_attention"
            else None)


def head_dim_of(config) -> int:
    hd = getattr(config, "head_dim", None)
    return int(hd) if hd else config.hidden_size // config.num_attention_heads


def rope_dim_of(config) -> int:
    """Rotary table width: head_dim scaled by partial_rotary_factor, floored
    to even."""
    r = int(head_dim_of(config) * getattr(config, "partial_rotary_factor",
                                          1.0))
    return r - (r % 2)


SUPPORTED_ROPE_SCALING = ("default", "none", "llama3", "linear", "yarn",
                          "longrope")


def _rope_type(scaling: Optional[dict]):
    if not scaling:
        return "default"
    return scaling.get("rope_type", scaling.get("type", None))


def _scale_inv_freq(inv_freq, scaling: Optional[dict]):
    """HF-style rope_scaling on the base frequencies ("llama3": long
    wavelengths divided by ``factor``, short kept, the band between
    interpolated; "linear": all divided by ``factor``)."""
    rope_type = _rope_type(scaling)
    if rope_type in ("default", "none"):
        return inv_freq
    factor = float(scaling["factor"])
    if rope_type == "linear":
        return inv_freq / factor
    if rope_type == "yarn":
        raise ValueError("yarn frequencies depend on head_dim and theta: "
                         "build tables through _rope_tables(scaling=...)")
    if rope_type == "llama3":
        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig / low
        high_wavelen = orig / high
        smooth = (orig / wavelen - low) / (high - low)
        interp = (1.0 - smooth) / factor + smooth
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor,
                             inv_freq)
        in_band = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(in_band, interp * inv_freq, scaled)
    raise NotImplementedError(f"rope_scaling type {rope_type!r} is not ported")


def validate_rope_scaling(scaling: Optional[dict],
                          max_position: Optional[int] = None) -> None:
    """The checkpoint loader's gate (``paddle_tpu/models/llama.py:
    233-262``), with its messages: a type no table builder takes raises
    NotImplementedError; a malformed yarn or longrope scaling ValueError
    (longrope: two factor lists of one non-zero length, and
    original_max_position_embeddings or ``max_position`` to choose
    between them)."""
    rope_type = _rope_type(scaling)
    if rope_type in ("default", "none"):
        return
    if rope_type not in SUPPORTED_ROPE_SCALING:
        scaled = sorted(t for t in SUPPORTED_ROPE_SCALING
                        if t not in ("default", "none"))
        raise NotImplementedError(
            f"rope_scaling type {rope_type!r} is not implemented "
            f"(supported: {', '.join(scaled)})")
    if rope_type == "yarn":
        # dummy dims: only the parameter handling can raise
        _yarn_params(scaling, 64, 10000.0, fallback_orig=max_position)
    if rope_type == "longrope":
        n_short = len(scaling.get("short_factor") or ())
        n_long = len(scaling.get("long_factor") or ())
        if not n_short or not n_long or n_short != n_long:
            raise ValueError(
                "longrope rope_scaling needs short_factor and long_factor "
                f"lists of equal length (got {n_short}/{n_long})")
        if not (scaling.get("original_max_position_embeddings")
                or max_position):
            raise ValueError(
                "longrope rope_scaling needs "
                "original_max_position_embeddings (or a max_position "
                "fallback) to pick between the factor lists")


def _longrope_params(scaling: dict, dim: int, base: float, seq_len: int,
                     max_position: Optional[int] = None, device=None):
    """(inv_freq [dim // 2] f32, attention factor) of Phi-3's LongRoPE
    (``paddle_tpu/models/llama.py:264-300``): each frequency divided by
    its entry of ``short_factor``, or of ``long_factor`` where the table is
    built for more than original_max_position_embeddings positions, and the
    magnitude factor sqrt(1 + ln f / ln orig), f = max_position / orig.
    The list is chosen by the length the table is built for, so every
    unit of a request builds its table at the request's ``max_len``
    (``rope_len``): one request never mixes the two lists."""
    orig = int(scaling.get("original_max_position_embeddings")
               or max_position)
    factor = scaling.get("factor")
    if max_position and orig:
        factor = max_position / orig
    att = scaling.get("attention_factor")
    if att is None:
        att = (1.0 if not factor or factor <= 1.0
               else math.sqrt(1 + math.log(factor) / math.log(orig)))
    ext = (scaling["long_factor"] if seq_len > orig
           else scaling["short_factor"])
    ext = torch.tensor(ext, dtype=torch.float32, device=device)
    if ext.shape[0] != dim // 2:
        raise ValueError(
            f"longrope factor lists must have head_dim/2 = {dim // 2} "
            f"entries, got {ext.shape[0]}")
    inv_freq = 1.0 / (ext * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    return inv_freq, float(att)


def _yarn_get_mscale(scale: float, m: float = 1.0) -> float:
    """yarn magnitude term 0.1 m ln(s) + 1: the tables' factor and the
    DeepSeek softmax scale's (``paddle_tpu/models/llama.py:299``)."""
    if scale <= 1:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def _yarn_params(scaling: dict, dim: int, base: float,
                 fallback_orig: Optional[int] = None, device=None):
    """(inv_freq [dim // 2] f32, attention factor) of yarn: NTK-by-parts
    blend of interpolated and extrapolated frequencies, and the magnitude
    the cos / sin tables are multiplied by, DeepSeek's mscale /
    mscale_all_dim variant included (``paddle_tpu/models/llama.py:
    307-353``). ``fallback_orig`` anchors the correction range when the
    scaling omits original_max_position_embeddings."""
    factor = float(scaling["factor"])
    orig = scaling.get("original_max_position_embeddings") or fallback_orig
    if not orig:
        raise ValueError(
            "yarn rope_scaling needs original_max_position_embeddings "
            "(or a max_position fallback) to anchor the correction range")
    orig = float(orig)
    att = scaling.get("attention_factor")
    if att is None:
        mscale = scaling.get("mscale")
        mscale_all_dim = scaling.get("mscale_all_dim")
        if mscale and mscale_all_dim:
            att = float(_yarn_get_mscale(factor, float(mscale))
                        / _yarn_get_mscale(factor, float(mscale_all_dim)))
        else:
            att = _yarn_get_mscale(factor)
    beta_fast = float(scaling.get("beta_fast") or 32)
    beta_slow = float(scaling.get("beta_slow") or 1)

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001  # prevent singularity
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
        / (high - low), 0, 1)
    extrap = 1.0 - ramp                     # 1 = keep base freq (short wl)
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device) / dim)
    inv_freq = ((1.0 / (factor * pos_freqs)) * (1.0 - extrap)
                + (1.0 / pos_freqs) * extrap)
    return inv_freq, float(att)


def _rope_tables(seq_len, head_dim, theta, scaling=None, device=None,
                 max_position=None):
    """(cos, sin) [seq_len, head_dim] f32, rotate-half layout; under yarn
    and longrope both are multiplied by the attention factor."""
    att = 1.0
    if _rope_type(scaling) == "yarn":
        inv_freq, att = _yarn_params(scaling, head_dim, theta,
                                     fallback_orig=max_position,
                                     device=device)
    elif _rope_type(scaling) == "longrope":
        inv_freq, att = _longrope_params(scaling, head_dim, theta, seq_len,
                                         max_position=max_position,
                                         device=device)
    else:
        inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                                 dtype=torch.float32,
                                                 device=device) / head_dim))
        inv_freq = _scale_inv_freq(inv_freq, scaling)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    if att != 1.0:
        return torch.cos(emb) * att, torch.sin(emb) * att
    return torch.cos(emb), torch.sin(emb)


class LlamaRMSNorm(tnn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.variance_epsilon = config.rms_norm_eps
        # Gemma: the weight is the delta from identity, (1 + w), w zeros
        self.offset = 1.0 if getattr(config, "rms_norm_offset", False) else 0.0
        self.weight = tnn.Parameter(
            torch.full((config.hidden_size,), 1.0 - self.offset,
                       device=device, dtype=torch_dtype(config.dtype)))

    def effective_weight(self):
        """The scale every kernel call takes: the weight, or w + 1 added
        in the weight's dtype (``llama.py:427-442``)."""
        return self.weight + self.offset if self.offset else self.weight

    def forward(self, x):
        return fused_norm.rms_norm(x, self.effective_weight(),
                                   self.variance_epsilon)


def _width_norm(config, width, device=None):
    """RMSNorm over another trailing width (the MLA latents) built from the
    family config (``paddle_tpu/models/llama.py:195``)."""
    return LlamaRMSNorm(dataclasses.replace(config, hidden_size=width),
                        device=device)


def _scale_embed(hidden, config):
    """Gemma's input scaling: hidden * sqrt(hidden_size), the scalar first
    rounded to the hidden's dtype (``llama.py:487-493``: 55.5 in bf16 for
    hidden 3072, not 55.43)."""
    if not getattr(config, "scale_embeddings", False):
        return hidden
    return hidden * _in_dtype(math.sqrt(config.hidden_size), hidden.dtype)


def _in_dtype(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX rounds a Python scalar that
    multiplies an array of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


class LlamaAttention(tnn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = head_dim_of(config)
        self.window = config.sliding_window
        # Gemma2's softmax scale folded into q once after the projection:
        # every path divides by sqrt(head_dim), and RoPE is linear
        qpas = getattr(config, "query_pre_attn_scalar", None)
        self.q_premul = math.sqrt(self.head_dim / qpas) if qpas else None
        self.softcap = getattr(config, "attn_logit_softcapping", None)
        dt = torch_dtype(config.dtype)
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        self.qk_norm_mode = ("per_head" if config.qk_norm is True
                             else (config.qk_norm or None))
        if self.qk_norm_mode == "per_head":
            # Qwen3: one norm of head_dim per head, after the head split
            self.q_norm = _width_norm(config, d, device=device)
            self.k_norm = _width_norm(config, d, device=device)
        elif self.qk_norm_mode == "full":
            # OLMo2: one norm over the projected width, before the split
            self.q_norm = _width_norm(config, h * d, device=device)
            self.k_norm = _width_norm(config, hk * d, device=device)
        else:
            self.q_norm = self.k_norm = None
        bias = config.attention_bias
        self.q_proj = nn.Linear(self.hidden_size, h * d, device=device,
                                dtype=dt, bias=bias)
        self.k_proj = nn.Linear(self.hidden_size, hk * d, device=device,
                                dtype=dt, bias=bias)
        self.v_proj = nn.Linear(self.hidden_size, hk * d, device=device,
                                dtype=dt, bias=bias)
        self.o_proj = nn.Linear(h * d, self.hidden_size, device=device, dtype=dt)

    def cached_attn_core(self, q, k, v, cos, sin, kv_cache,
                         rope_applied=False):
        """Attention against the serving caches: the paged pool (decode or
        verify chunk) or a dense [B, T, hk, D] buffer (prefill).
        ``rope_applied``: q and k arrive rotated (the fused decode tail).
        Returns (out [b, s, H*D] before o_proj, new cache dict)."""
        from ..generation import cached_attention, paged_cached_attention

        b, s = q.shape[0], q.shape[1]
        hd = self.num_heads * self.head_dim
        if "k_pages" in kv_cache:
            out, kp, vp = paged_cached_attention(
                q, k, v, cos, sin, kv_cache["k_pages"], kv_cache["v_pages"],
                kv_cache["page_indices"], kv_cache["lengths"],
                kv_cache["page_size"], window=self.window,
                softcap=self.softcap, rope_applied=rope_applied)
            new = dict(kv_cache)
            new.update(k_pages=kp, v_pages=vp,
                       lengths=kv_cache["lengths"] + s)
            return out.reshape(b, s, hd), new
        out, k_buf, v_buf = cached_attention(
            q, k, v, cos, sin, kv_cache["k"], kv_cache["v"], kv_cache["pos"],
            kv_cache.get("allowed"), kv_cache.get("row_pos"),
            use_flash=(self.config.use_flash_attention
                       and self.softcap is None),
            prefill=bool(kv_cache.get("prefill", False)), window=self.window,
            softcap=self.softcap, rope_applied=rope_applied)
        new = {"k": k_buf, "v": v_buf, "pos": kv_cache["pos"] + s}
        if "allowed" in kv_cache:
            new["allowed"] = kv_cache["allowed"]
        if "row_pos" in kv_cache:
            new["row_pos"] = kv_cache["row_pos"] + s
        return out.reshape(b, s, hd), new

    def decode_fused_qkv(self, hidden_states, norm_weight, eps, cos, sin,
                         kv_cache):
        """``rms_norm`` → q/k/v → RoPE through the fused kernel (the caller
        has checked ``fused_decode_supported``). A chunk of S > 1 flattens
        to B*S rows, each roped at its own cache position. Returns (q, k, v)
        shaped like the discrete projections, q and k rotated."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        cos_r, sin_r = _rope_rows_for_cache(cos, sin, kv_cache, b, s)
        q, k, v = decode_tail.fused_qkv_rope(
            hidden_states.reshape(b * s, self.hidden_size), norm_weight,
            self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
            cos_r, sin_r, eps, h, hk, d)
        return (q.reshape(b, s, h, d), k.reshape(b, s, hk, d),
                v.reshape(b, s, hk, d))

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """With a cache dict: the serving path, returns (out, new cache).
        Without: RoPE on q and k (fused kernel), then causal flash attention
        over the sequence, within the layer's sliding window if it has one
        (``llama.py:644-710``), returns out. On a CPU tensor the plain flash
        version runs, the same math as the JAX ``_sdpa_ref`` fallback.
        Capped scores (``attn_logit_softcapping``) never reach the flash
        kernel: the plain capped attention runs, as in JAX
        (``llama.py:692-709``); nor does a head width with no kernel
        instance that JAX's gate refuses too
        (``append_attention.plain_width``: not in ``WIDTHS`` and D % 128
        != 0, Phi-3's 96): the plain attention, JAX's ``_sdpa_ref``,
        decided from the shape before any launch. At (64, 64) the port
        keeps its kernel where JAX runs ``_sdpa_ref``. The q/k norms, then
        the q pre-multiplier, run first on both paths
        (``llama.py:614-634``)."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(hidden_states)
        k = self.k_proj(hidden_states)
        if self.qk_norm_mode == "full":
            q, k = self.q_norm(q), self.k_norm(k)
        q = q.reshape(b, s, h, d)
        k = k.reshape(b, s, hk, d)
        v = self.v_proj(hidden_states).reshape(b, s, hk, d)
        if self.qk_norm_mode == "per_head":
            q, k = self.q_norm(q), self.k_norm(k)
        if self.q_premul is not None:
            q = q * _in_dtype(self.q_premul, q.dtype)
        if isinstance(kv_cache, dict):
            out, new = self.cached_attn_core(q, k, v, cos, sin, kv_cache)
            return self.o_proj(out), new
        if kv_cache is not None:
            raise NotImplementedError(
                "the (k, v) tuple cache of the non-cached forward "
                "(paddle_tpu/models/llama.py:712-716) is not ported")
        q = fused_norm.apply_rope(q, cos, sin)
        k = fused_norm.apply_rope(k, cos, sin)
        if self.softcap is None and not plain_width(d, d):
            out = flash_attention_bshd(q, k, v, causal=True,
                                       window=self.window)
        else:
            out = _plain_attention(q, k, v, self.window, self.softcap)
        return self.o_proj(out.reshape(b, s, h * d))


def _plain_attention(q, k, v, window, softcap):
    """Causal attention (optionally within a sliding window, with
    tanh-capped scores): the JAX package's ``_sdpa_ref(..., softcap=)``
    over k / v expanded to every query head (``llama.py:697-709``)."""
    from ..nn.functional.attention import _sdpa_ref

    g = q.shape[2] // k.shape[2]
    ke, ve = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    band = None
    if window is not None:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        band = ((cols <= rows) & (cols > rows - window))[None, None]
    return _sdpa_ref(q, ke, ve, causal=band is None, mask=band,
                     softcap=softcap)


class LlamaMLP(tnn.Module):
    """Gated MLP: SwiGLU (silu gate) or GeGLU (tanh-gelu gate)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.hidden_act = config.hidden_act
        self.gate_proj = nn.Linear(config.hidden_size, config.intermediate_size,
                                   device=device, dtype=dt)
        self.up_proj = nn.Linear(config.hidden_size, config.intermediate_size,
                                 device=device, dtype=dt)
        self.down_proj = nn.Linear(config.intermediate_size,
                                   config.hidden_size, device=device, dtype=dt)

    def forward(self, x):
        gate = self.gate_proj(x)
        up = self.up_proj(x)
        if self.hidden_act == "gelu_pytorch_tanh":
            act = torch.nn.functional.gelu(gate, approximate="tanh") * up
        else:
            act = torch.nn.functional.silu(gate) * up
        return self.down_proj(act)


def _rope_rows_for_cache(cos, sin, kv_cache, b, s=1):
    """cos / sin rows [B*S, D] at each row's current cache position: the
    fused kernel ropes in-register, so the table gather happens here.
    Paged caches decode at per-row ``lengths`` (token j of a verify chunk
    at lengths[b] + j), ragged dense caches at ``row_pos``, plain dense
    batches at the shared ``pos`` (the device int32 the dense caches
    carry). S > 1 is paged only (the gate keeps dense chunks on the
    discrete path)."""
    if "k_pages" in kv_cache:
        idx = kv_cache["lengths"].long()
        if s > 1:
            idx = (idx[:, None] + torch.arange(s, device=idx.device)[None]
                   ).reshape(-1)
    elif "row_pos" in kv_cache:
        idx = kv_cache["row_pos"].long()
    else:
        idx = torch.as_tensor(kv_cache["pos"], device=cos.device).reshape(
            1).long().expand(b)
    return cos[idx], sin[idx]


def fused_decode_structural(layer, dtype) -> bool:
    """The weight-structure half of the fused decode-tail gate
    (``llama.py:773``): Llama attention with no q/k norm, whose
    projections are the port's ``nn.Linear`` without a bias, and weights
    and RMSNorm scales all of ``dtype``; no q pre-multiplier
    (``query_pre_attn_scalar``)."""
    attn = getattr(layer, "self_attn", None)
    if not isinstance(attn, LlamaAttention):
        return False
    if attn.qk_norm_mode is not None or attn.q_premul is not None:
        return False
    lins = (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj)
    if any(type(lin) is not nn.Linear
           or getattr(lin, "bias", None) is not None for lin in lins):
        return False
    if any(lin.weight.dtype != dtype for lin in lins):
        return False
    norms = (getattr(layer, "input_layernorm", None),
             getattr(layer, "post_attention_layernorm", None))
    return all(isinstance(n, LlamaRMSNorm) and n.weight.dtype == dtype
               for n in norms)


def fused_decode_supported(layer, hidden_states, kv_cache, cos) -> bool:
    """Gate of the fused decode tail, read on every call (eager PyTorch has
    no trace time): the flag, a dict cache, S == 1 or a paged chunk, the
    structural half above, the kernels' types (float32, bfloat16) and
    ``decode_tail.supported``. Anything else keeps the discrete kernels."""
    if not decode_tail.enabled() or not isinstance(kv_cache, dict):
        return False
    b, s = hidden_states.shape[0], hidden_states.shape[1]
    if s != 1 and "k_pages" not in kv_cache:
        return False
    dtype = hidden_states.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if not fused_decode_structural(layer, dtype):
        return False
    attn = layer.self_attn
    return decode_tail.supported(b * s, attn.hidden_size, attn.num_heads,
                                 attn.num_kv_heads, attn.head_dim,
                                 cos.shape[-1], hidden_states.element_size())


class LlamaDecoderLayer(tnn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device=device)
        self.mlp = LlamaMLP(config, device=device)
        self.input_layernorm = LlamaRMSNorm(config, device=device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device)

    def _forward_fused_decode(self, hidden_states, cos, sin, kv_cache):
        """The decode tail as two kernel launches around attention:
        norm → qkv → rope fused, then o_proj → residual add → norm fused. A
        verify chunk takes the same kernels as B*S flattened rows."""
        attn = self.self_attn
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        q, k, v = attn.decode_fused_qkv(
            hidden_states, self.input_layernorm.effective_weight(),
            self.input_layernorm.variance_epsilon, cos, sin, kv_cache)
        out, new_cache = attn.cached_attn_core(q, k, v, cos, sin, kv_cache,
                                               rope_applied=True)
        norm = self.post_attention_layernorm
        normed, residual = decode_tail.fused_epilogue(
            out.reshape(b * s, attn.num_heads * attn.head_dim),
            attn.o_proj.weight,
            hidden_states.reshape(b * s, attn.hidden_size),
            norm.effective_weight(), norm.variance_epsilon)
        hidden_states = residual.reshape(b, s, attn.hidden_size) + self.mlp(
            normed.reshape(b, s, attn.hidden_size))
        return hidden_states, new_cache

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """Returns hidden, or (hidden, new cache) when given a cache."""
        if kv_cache is not None and fused_decode_supported(
                self, hidden_states, kv_cache, cos):
            return self._forward_fused_decode(hidden_states, cos, sin,
                                              kv_cache)
        residual = hidden_states
        hidden_states = self.input_layernorm(hidden_states)
        if kv_cache is not None:
            hidden_states, kv_cache = self.self_attn(hidden_states, cos, sin,
                                                     kv_cache)
        else:
            hidden_states = self.self_attn(hidden_states, cos, sin)
        # fused residual-add + RMSNorm: h = residual + attn_out is written
        # once and normed in the same pass; h is the next residual
        norm = self.post_attention_layernorm
        hidden_states, residual = fused_norm.add_rms_norm(
            hidden_states, residual, norm.effective_weight(),
            norm.variance_epsilon)
        hidden_states = residual + self.mlp(hidden_states)
        if kv_cache is not None:
            return hidden_states, kv_cache
        return hidden_states


class LlamaModel(tnn.Module):
    # ``config.recompute`` wraps each decoder layer (the MoE trunks say no:
    # their aux-loss walk reads ``layer.mlp``, as in the JAX package)
    wraps_recompute = True

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device,
                                         dtype=torch_dtype(config.dtype))
        layers = [self._make_layer(config, i, device)
                  for i in range(config.num_hidden_layers)]
        if config.recompute and self.wraps_recompute:
            layers = [RecomputeLayer(layer) for layer in layers]
        self.layers = tnn.ModuleList(layers)
        self.norm = LlamaRMSNorm(config, device=device)
        # plain tensors keyed by table length — nothing traced is cached
        self._rope_cache: dict = {}

    def _make_layer(self, config, layer_idx, device):
        """Decoder layer ``layer_idx``; families with another block (MoE,
        MLA) override this."""
        layer = LlamaDecoderLayer(config, device=device)
        layer.self_attn.window = layer_window(config, layer_idx)
        return layer

    def _rope_dim(self):
        """Rotary table width; MLA trunks override (RoPE rides only the
        decoupled qk_rope_head_dim slice)."""
        return rope_dim_of(self.config)

    def _rope(self, seq_len):
        pair = self._rope_cache.get(seq_len)
        if pair is None:
            pair = _rope_tables(seq_len, self._rope_dim(),
                                self.config.rope_theta,
                                scaling=self.config.rope_scaling,
                                device=self.embed_tokens.weight.device,
                                max_position=self.config.max_position_embeddings)
            self._rope_cache[seq_len] = pair
        return pair

    def forward(self, input_ids, return_prenorm=False):
        """Non-cached forward over [B, S] ids; returns the normed hidden, or
        (normed, pre-norm) with ``return_prenorm``: the last layer's output
        before the final norm, which DeepSeek-V3's multi-token prediction
        pairs with the next tokens (``llama.py:940-958``)."""
        cos, sin = self._rope(input_ids.shape[1])
        hidden = _scale_embed(self.embed_tokens(input_ids).to(
            torch_dtype(self.config.dtype)), self.config)
        for layer in self.layers:
            hidden = layer(hidden, cos, sin)
        if return_prenorm:
            return self.norm(hidden), hidden
        return self.norm(hidden)

    def forward_cached(self, input_ids, kv_caches, rope_len,
                       return_prenorm=False):
        """Forward over the static KV caches (one dict per layer, see
        ``generation.cached_attention``). Returns (normed hidden,
        new caches), or (normed, pre-norm, new caches) with
        ``return_prenorm`` (the MTP draft reads the pre-norm stream,
        ``llama.py:960-980``)."""
        cos, sin = self._rope(rope_len)
        hidden = _scale_embed(self.embed_tokens(input_ids).to(
            torch_dtype(self.config.dtype)), self.config)
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            inner = getattr(layer, "inner", layer)   # unwrap RecomputeLayer
            hidden, c = inner(hidden, cos, sin, cache)
            new_caches.append(c)
        if return_prenorm:
            return self.norm(hidden), hidden, new_caches
        return self.norm(hidden), new_caches


class LlamaForCausalLM(tnn.Module):
    """Causal LM. ``device=None`` means the current CUDA device,
    and raises where there is none (pass ``device="cpu"`` for the plain
    versions). Weights are drawn from ``generator`` (default: the port's
    generator on ``device``): Normal(0, initializer_range) for embeddings
    and projections, ones for norms (zeros for (1 + w) norms), zeros for
    projection biases."""

    model_cls = LlamaModel  # trunk hook (the MoE and MLA families swap it)

    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        self.config = config
        self.llama = type(self).model_cls(config, device=device)
        self.lm_head = (None if config.tie_word_embeddings else
                        nn.Linear(config.hidden_size, config.vocab_size,
                                  device=device,
                                  dtype=torch_dtype(config.dtype)))
        self._make_extra_modules(config, device)
        self.reset_parameters(generator)

    def _make_extra_modules(self, config, device):
        """Modules a family adds beside the trunk and the head, made before
        the weights are drawn (DeepSeek-V3's multi-token-prediction
        depths)."""

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        gen = generator or default_generator(self.device)
        std = self.config.initializer_range
        norm_init = 0.0 if getattr(self.config, "rms_norm_offset",
                                   False) else 1.0
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(norm_init)
            elif name.endswith("_proj.bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)

    def lm_head_logits(self, hidden):
        """Logits of the head (tied or not), tanh-capped with
        ``final_logit_softcapping`` (``llama.py:1003-1009``)."""
        if self.lm_head is None:
            logits = torch.matmul(hidden, self.llama.embed_tokens.weight.t())
        else:
            logits = self.lm_head(hidden)
        cap = getattr(self.config, "final_logit_softcapping", None)
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return logits

    def generate(self, input_ids, max_new_tokens=20, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 use_cache=True, attention_mask=None, paged=False,
                 page_size=16, prefill_chunk_size=None,
                 repetition_penalty=1.0, min_new_tokens=0,
                 num_beams=1, length_penalty=1.0, early_stopping=False,
                 no_repeat_ngram_size=0):
        """Batched autoregressive decode (see ``generation.generate``;
        ``llama.py:1012-1032``). The MoE, Mistral and DeepSeek families
        inherit it."""
        from ..generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                         use_cache=use_cache, attention_mask=attention_mask,
                         paged=paged, page_size=page_size,
                         prefill_chunk_size=prefill_chunk_size,
                         repetition_penalty=repetition_penalty,
                         min_new_tokens=min_new_tokens, num_beams=num_beams,
                         length_penalty=length_penalty,
                         early_stopping=early_stopping,
                         no_repeat_ngram_size=no_repeat_ngram_size)

    def forward(self, input_ids, labels=None):
        """Logits without labels; with labels (loss, None) through the fused
        chunked loss when ``fuse_linear_cross_entropy``, else (loss,
        logits)."""
        hidden = self.llama(input_ids)
        if labels is not None and self.config.fuse_linear_cross_entropy:
            if self.lm_head is None:   # tied: embedding weight [vocab, hidden]
                w, layout = self.llama.embed_tokens.weight, "vh"
            else:
                w, layout = self.lm_head.weight, "hv"
            return fused_linear_cross_entropy(hidden, w, labels, layout), None
        logits = self.lm_head_logits(hidden)
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels), logits


def causal_lm_loss(logits, labels):
    """Token-mean causal-LM cross entropy in f32; labels < 0 are ignored."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = labels.long()
    mask = idx >= 0
    nll = -logp.gather(-1, torch.where(mask, idx, 0)[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / torch.clamp(mask.float().sum(), min=1.0)


# ---------------------------------------------------------------------------
# HuggingFace checkpoint bridge (``llama.py:205-230, 1260-1501``)
# ---------------------------------------------------------------------------
#
# The JAX package converts a checkpoint through f32 numpy and swaps each
# array in. The port stays in torch and writes every tensor IN PLACE, one at
# a time: moved to the parameter's device as stored, permuted, transposed
# and cast there (``param.copy_``), so the device holds the model plus one
# tensor at most, the host never makes a transposed or upcast copy, and the
# storage a captured CUDA graph of the model reads stays the same.

#: checkpoint buffers no model represents (recomputed from the config)
_SKIPPED = ("rotary_emb.inv_freq",)


def _hf_get(hf_config):
    """Uniform accessor over a transformers config object or a raw
    ``config.json`` dict (``llama.py:214-219``)."""
    return (hf_config.get if isinstance(hf_config, dict)
            else lambda k, d=None: getattr(hf_config, k, d))


def mapped_rope_scaling(get) -> Optional[dict]:
    """``rope_scaling`` read through a mapper's ``get``, validated at
    convert time (``validate_rope_scaling``), as a dict or None
    (``llama.py:221-230``)."""
    scaling = get("rope_scaling")
    if scaling not in (None, {}):
        validate_rope_scaling(dict(scaling),
                              max_position=get("max_position_embeddings"))
    return dict(scaling) if scaling else None


def hf_tensor(value) -> torch.Tensor:
    """A checkpoint value as a torch tensor, copied nowhere: a tensor
    detached, a numpy array shared (an ml_dtypes bfloat16 array by its
    bits; a read-only one, a memory-mapped file's, is only read)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    arr = np.asarray(value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # non-writable arrays
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)


def _copy_in(target, value, transpose, who, name, fn=None):
    """Write checkpoint ``value`` into ``target`` (a parameter or a view of
    one) in place: moved to its device as stored, ``fn`` (a row
    permutation or reshape) and the transpose applied there, cast by
    ``copy_``. A wrong shape raises ValueError naming "shape" before
    anything is moved."""
    def check(shape):
        if tuple(shape) != tuple(target.shape):
            raise ValueError(f"{who}: shape mismatch for {name}: loading "
                             f"{tuple(shape)} into {tuple(target.shape)}")

    t = hf_tensor(value)
    if fn is None:
        check(t.shape[::-1] if transpose else t.shape)
    t = t.to(target.device)
    if fn is not None:
        try:
            t = fn(t)
        except RuntimeError as e:   # a reshape of the wrong size
            raise ValueError(f"{who}: shape mismatch for {name}: {e}") from e
        check(t.shape[::-1] if transpose else t.shape)
    with torch.no_grad():
        target.copy_(t.t() if transpose else t)


def _check_checkpoint(who, model, state, keys, covered, aliases=(),
                      skip=_SKIPPED, leftovers=True, require_covered=True,
                      ignore_missing_prefixes=()):
    """The refusals of the JAX loaders, before anything is written: a
    KeyError for a checkpoint key the plan needs and the state lacks, a
    ValueError for checkpoint tensors the model cannot represent
    (``leftovers``; ``aliases`` and keys ending in ``skip`` are allowed),
    a KeyError for model parameters no plan entry writes (``covered``)."""
    for key in keys:
        if key not in state:
            raise KeyError(f"{who}: checkpoint is missing {key!r}")
    if leftovers:
        used = set(keys) | set(aliases)
        left = [k for k in state
                if k not in used and not k.endswith(tuple(skip))]
        if left:
            raise ValueError(
                f"{who}: checkpoint tensors this model cannot represent "
                f"(silently dropping them would change logits): {left[:5]}"
                f"{'...' if len(left) > 5 else ''}")
    if require_covered:
        covered = set(covered)
        missing = [n for n, _ in model.named_parameters()
                   if n not in covered
                   and not n.startswith(tuple(ignore_missing_prefixes))]
        if missing:
            raise KeyError(f"{who}: model keys not covered: {missing[:5]}")


def _write_plan(who, model, state, plan, transforms=None):
    """Every ``{param name: (hf key, transpose)}`` entry written in place,
    one tensor at a time, ``transforms[name]`` applied on the device."""
    params = dict(model.named_parameters())
    transforms = transforms or {}
    for name, (hf_key, transpose) in plan.items():
        if name not in params:
            raise KeyError(f"{who}: model has no param {name!r}")
        _copy_in(params[name], state[hf_key], transpose, who, name,
                 transforms.get(name))


def _exported(param, transpose, dtype=None) -> torch.Tensor:
    """One parameter as a contiguous CPU tensor in the checkpoint's
    layout: cast and transposed where it lives, then copied to the host
    (a CPU parameter is copied, never shared)."""
    t = param.detach()
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    if transpose:
        t = t.t()
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous().cpu()


def hf_config_to_llama(hf_config, **overrides) -> LlamaConfig:
    """A transformers Llama config (object or ``config.json`` dict) as a
    ``LlamaConfig`` (``llama.py:1272-1330``), with its refusals: a Gemma
    checkpoint without the Gemma overrides (its (1 + w) norm deltas and
    unscaled embeddings would be misread), a per-layer window
    (``max_window_layers`` below the depth), a rope type or yarn /
    longrope parameters no table builder takes. HF Llama's
    ``attention_bias`` also puts a bias on o_proj, which no layer here
    holds: the flag maps to the q/k/v biases (Qwen2's default) and the
    loader refuses the leftover o_proj bias."""
    get = _hf_get(hf_config)
    if (str(get("model_type", "")).startswith("gemma")
            and "rms_norm_offset" not in overrides):
        raise NotImplementedError(
            "this checkpoint is a Gemma-family model — convert it with "
            "gemma_from_hf (llama_from_hf would misread its (1+w) norm "
            "deltas and unscaled embeddings)")
    scaling = mapped_rope_scaling(get)
    window = None
    if get("use_sliding_window", get("sliding_window") is not None
           and get("model_type") == "mistral"):
        window = get("sliding_window")
        # HF Qwen2 windows only the layers >= max_window_layers; the window
        # here is uniform (0: every layer windowed, exact)
        mwl = get("max_window_layers", 0) or 0
        if 0 < mwl < get("num_hidden_layers"):
            raise NotImplementedError(
                f"hf_config_to_llama: per-layer sliding window "
                f"(max_window_layers={mwl}) is not supported — this build "
                "applies sliding_window uniformly")
        if mwl >= get("num_hidden_layers"):
            window = None   # no layer is windowed in the HF semantics
    kw = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads",
                                get("num_attention_heads")),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=scaling,
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        attention_bias=bool(get("attention_bias",
                                get("model_type") == "qwen2")),
        head_dim=get("head_dim"),
        partial_rotary_factor=float(get("partial_rotary_factor") or 1.0),
        sliding_window=window,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


#: the classic per-layer norm pair of the Llama key layout (OLMo2 swaps in
#: its post-only pair, Gemma2 adds its sandwich norms)
_DEFAULT_LAYER_NORMS = ("input_layernorm", "post_attention_layernorm")


def _hf_llama_plan(model, extra_layer_norms=(), layer_norms=None):
    """``{param name: (hf key, transpose)}`` of the Llama key layout, the
    one map the loader and the exporter share (``llama.py:1335-1367``).
    The untied head maps to ``lm_head.weight``; the loader redirects it
    for a checkpoint with a tied head."""
    if layer_norms is None:
        layer_norms = _DEFAULT_LAYER_NORMS
    cfg = model.config
    plan = {"llama.embed_tokens.weight": ("model.embed_tokens.weight", False),
            "llama.norm.weight": ("model.norm.weight", False)}
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"model.layers.{i}", f"llama.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            plan[f"{ours}.self_attn.{proj}.weight"] = (
                f"{hf}.self_attn.{proj}.weight", True)
        if cfg.qk_norm:
            for norm in ("q_norm", "k_norm"):
                plan[f"{ours}.self_attn.{norm}.weight"] = (
                    f"{hf}.self_attn.{norm}.weight", False)
        if cfg.attention_bias:
            for proj in ("q_proj", "k_proj", "v_proj"):
                plan[f"{ours}.self_attn.{proj}.bias"] = (
                    f"{hf}.self_attn.{proj}.bias", False)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            plan[f"{ours}.mlp.{proj}.weight"] = (f"{hf}.mlp.{proj}.weight",
                                                 True)
        for norm in tuple(layer_norms) + tuple(extra_layer_norms):
            plan[f"{ours}.{norm}.weight"] = (f"{hf}.{norm}.weight", False)
    if model.lm_head is not None:
        plan["lm_head.weight"] = ("lm_head.weight", True)
    return plan


def export_hf_llama(model: "LlamaForCausalLM", extra_layer_norms=(),
                    layer_norms=None, dtype=None):
    """The reverse of ``load_hf_llama`` (``llama.py:1370-1394``): the
    model's weights under HF keys, ``{hf key: tensor}``, each a contiguous
    CPU tensor in torch's [out, in] layout and the parameter's dtype
    (``dtype`` forces one), ready for ``HFModel.load_state_dict``. A tied
    model leaves ``lm_head.weight`` out (HF ties it again)."""
    plan = _hf_llama_plan(model, extra_layer_norms=extra_layer_norms,
                          layer_norms=layer_norms)
    params = dict(model.named_parameters())
    out = {}
    for name, (hf_key, transpose) in plan.items():
        if name not in params:
            raise KeyError(f"export_hf_llama: model has no param {name!r}")
        out[hf_key] = _exported(params[name], transpose, dtype)
    return out


def load_hf_llama(model: "LlamaForCausalLM", hf_state_dict,
                  extra_layer_norms=(), layer_norms=None,
                  ignore_missing_prefixes=()) -> "LlamaForCausalLM":
    """A HuggingFace Llama-layout state dict (torch tensors or numpy
    arrays) written into ``model`` in place, on the model's device
    (``llama.py:1397-1446``): projections transposed from torch's [out,
    in], ``rotary_emb.inv_freq`` skipped; a tied-in-HF checkpoint feeds an
    untied head from the embedding, and a tied model accepts the
    ``lm_head.weight`` alias. Refuses (before writing) a missing key
    (KeyError), a tensor the model cannot represent (ValueError), a model
    parameter the plan leaves unwritten (KeyError, unless under
    ``ignore_missing_prefixes``), and a wrong shape (ValueError)."""
    plan = _hf_llama_plan(model, extra_layer_norms=extra_layer_norms,
                          layer_norms=layer_norms)
    aliases = ()
    if model.lm_head is None:
        aliases = ("lm_head.weight",)
    elif "lm_head.weight" not in hf_state_dict:
        plan["lm_head.weight"] = ("model.embed_tokens.weight", True)
    _check_checkpoint("load_hf_llama", model, hf_state_dict,
                      [k for k, _ in plan.values()], plan, aliases=aliases,
                      ignore_missing_prefixes=ignore_missing_prefixes)
    _write_plan("load_hf_llama", model, hf_state_dict, plan)
    return model


def _state_and_config(hf_model_or_state, hf_config):
    """(state dict, config) of a transformers model, or of a raw state dict
    with its config."""
    if hf_config is None:
        return hf_model_or_state.state_dict(), hf_model_or_state.config
    return hf_model_or_state, hf_config


def _from_hf(config_cls, model_cls, hf_model_or_state, hf_config=None,
             extra_layer_norms=(), layer_norms=None, device=None,
             **config_overrides):
    """The conversion of the Llama-layout families (``llama.py:1449-1465``):
    map the config, build the model on ``device`` (default: the current
    CUDA device; it raises where there is none), load."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    base = hf_config_to_llama(hf_config, **config_overrides)
    cfg = (base if config_cls is LlamaConfig
           else config_cls(**dataclasses.asdict(base)))
    return load_hf_llama(model_cls(cfg, device=device), state,
                         extra_layer_norms=extra_layer_norms,
                         layer_norms=layer_norms)


def llama_from_hf(hf_model_or_state, hf_config=None, device=None,
                  **config_overrides):
    """A ``LlamaForCausalLM`` from a transformers model, or from a state
    dict and its config (object or ``config.json`` dict), on ``device``."""
    return _from_hf(LlamaConfig, LlamaForCausalLM, hf_model_or_state,
                    hf_config, device=device, **config_overrides)


def llama_to_hf(model, dtype=None):
    """The HF Llama checkpoint layout of every family whose checkpoint IS
    that layout (Llama, Qwen2, Qwen3, Mistral, Gemma; Gemma2 adds its
    sandwich norms, OLMo2 its post-only pair; ``llama.py:1475-1501``).
    Phi-3 (fused projections) and GLM (interleaved rotary rows) refuse:
    their runtime weights under HF keys would be a wrong checkpoint."""
    from .gemma2 import Gemma2ForCausalLM
    from .glm import GlmForCausalLM
    from .olmo2 import _OLMO2_NORMS, Olmo2ForCausalLM
    from .phi3 import Phi3ForCausalLM

    if isinstance(model, (GlmForCausalLM, Phi3ForCausalLM)):
        raise NotImplementedError(
            f"llama_to_hf: {type(model).__name__} checkpoints are "
            "TRANSFORMED at load (fused projections / interleaved "
            "rotary); the reverse transform is not implemented — "
            "exporting raw runtime weights would be silently wrong")
    extra, norms = (), None
    if isinstance(model, Gemma2ForCausalLM):
        extra = ("pre_feedforward_layernorm", "post_feedforward_layernorm")
    if isinstance(model, Olmo2ForCausalLM):
        norms = _OLMO2_NORMS
    return export_hf_llama(model, extra_layer_norms=extra,
                           layer_norms=norms, dtype=dtype)
