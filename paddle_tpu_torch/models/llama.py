"""Llama-3 decoder — counterpart of ``paddle_tpu/models/llama.py``.

Ported: the config and its presets, rope tables (default, ``llama3``,
``linear`` and ``yarn`` scaling), RMSNorm (also over another width,
``_width_norm``), attention over the static KV caches (dense
prefill cache and paged pool) and without a cache (the training forward:
fused RoPE, then causal or sliding-window flash attention), the gated MLP,
the decoder layer on the discrete path, ``LlamaModel.forward`` /
``forward_cached``, the causal-LM head, ``LlamaForCausalLM.forward`` with
labels (the chunked fused lm-head + cross-entropy, or the logits and
``causal_lm_loss``), and the fused decode tail behind
``FLAGS_use_fused_decode_tail`` (two kernels per layer for a decode step
or a paged speculative-verify chunk). Not ported:
context parallelism (the port has no process group), attention
soft-capping, qk-norm and layer recompute.

Parameter names equal the JAX package's (``llama.layers.0.self_attn.
q_proj.weight``, ``lm_head.weight``, ...), and Linear weights keep Paddle's
[in, out] layout, so ``weights.from_jax_state`` moves a state across as is.

Every norm runs the fused-norm kernels; cached attention routes through
``generation.cached_attention`` / ``paged_cached_attention``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..framework.random import default_device, default_generator
from ..ops.fused_loss import fused_linear_cross_entropy
from ..ops.hopper import decode_tail, fused_norm
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
    # "factor": N} or {"rope_type": "yarn", ...}; longrope is not ported
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
    # not ported; each raises NotImplementedError when asked for
    attn_logit_softcapping: Optional[float] = None
    qk_norm: bool = False
    recompute: bool = False

    def __post_init__(self):
        for name, where in (
                ("attn_logit_softcapping", "paddle_tpu/models/llama.py:637, "
                 ":708 (_sdpa_ref softcap)"),
                ("qk_norm", "paddle_tpu/models/llama.py:624-632"),
                ("recompute", "paddle_tpu/models/llama.py:903-906 "
                 "(RecomputeLayer)")):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name} is not ported to paddle_tpu_torch (JAX: {where})")
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


SUPPORTED_ROPE_SCALING = ("default", "none", "llama3", "linear", "yarn")


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
    both are multiplied by its attention factor."""
    att = 1.0
    if _rope_type(scaling) == "yarn":
        inv_freq, att = _yarn_params(scaling, head_dim, theta,
                                     fallback_orig=max_position,
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
        self.weight = tnn.Parameter(
            torch.ones(config.hidden_size, device=device,
                       dtype=torch_dtype(config.dtype)))

    def effective_weight(self):
        """The scale every kernel call takes (the port has no offset norm,
        so it is the weight itself)."""
        return self.weight

    def forward(self, x):
        return fused_norm.rms_norm(x, self.weight, self.variance_epsilon)


def _width_norm(config, width, device=None):
    """RMSNorm over another trailing width (the MLA latents) built from the
    family config (``paddle_tpu/models/llama.py:195``)."""
    return LlamaRMSNorm(dataclasses.replace(config, hidden_size=width),
                        device=device)


class LlamaAttention(tnn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = head_dim_of(config)
        self.window = config.sliding_window
        dt = torch_dtype(config.dtype)
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        self.q_proj = nn.Linear(self.hidden_size, h * d, device=device, dtype=dt)
        self.k_proj = nn.Linear(self.hidden_size, hk * d, device=device, dtype=dt)
        self.v_proj = nn.Linear(self.hidden_size, hk * d, device=device, dtype=dt)
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
                rope_applied=rope_applied)
            new = dict(kv_cache)
            new.update(k_pages=kp, v_pages=vp,
                       lengths=kv_cache["lengths"] + s)
            return out.reshape(b, s, hd), new
        out, k_buf, v_buf = cached_attention(
            q, k, v, cos, sin, kv_cache["k"], kv_cache["v"], kv_cache["pos"],
            kv_cache.get("allowed"), kv_cache.get("row_pos"),
            use_flash=self.config.use_flash_attention,
            prefill=bool(kv_cache.get("prefill", False)), window=self.window,
            rope_applied=rope_applied)
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
        version runs, the same math as the JAX ``_sdpa_ref`` fallback."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(hidden_states).reshape(b, s, h, d)
        k = self.k_proj(hidden_states).reshape(b, s, hk, d)
        v = self.v_proj(hidden_states).reshape(b, s, hk, d)
        if isinstance(kv_cache, dict):
            out, new = self.cached_attn_core(q, k, v, cos, sin, kv_cache)
            return self.o_proj(out), new
        if kv_cache is not None:
            raise NotImplementedError(
                "the (k, v) tuple cache of the non-cached forward "
                "(paddle_tpu/models/llama.py:712-716) is not ported")
        q = fused_norm.apply_rope(q, cos, sin)
        k = fused_norm.apply_rope(k, cos, sin)
        out = flash_attention_bshd(q, k, v, causal=True, window=self.window)
        return self.o_proj(out.reshape(b, s, h * d))


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
    batches at the shared scalar ``pos``. S > 1 is paged only (the gate
    keeps dense chunks on the discrete path)."""
    if "k_pages" in kv_cache:
        idx = kv_cache["lengths"].long()
        if s > 1:
            idx = (idx[:, None] + torch.arange(s, device=idx.device)[None]
                   ).reshape(-1)
    elif "row_pos" in kv_cache:
        idx = kv_cache["row_pos"].long()
    else:
        pos = int(kv_cache["pos"])
        return (cos[pos:pos + 1].expand(b, -1), sin[pos:pos + 1].expand(b, -1))
    return cos[idx], sin[idx]


def fused_decode_structural(layer, dtype) -> bool:
    """The weight-structure half of the fused decode-tail gate: Llama
    attention whose projections are the port's bias-free ``nn.Linear``,
    and weights and RMSNorm scales all of ``dtype``. (The port builds no
    qk-norm or q pre-multiplier layer: ``LlamaConfig`` refuses them.)"""
    attn = getattr(layer, "self_attn", None)
    if not isinstance(attn, LlamaAttention):
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
            hidden_states, residual, norm.weight, norm.variance_epsilon)
        hidden_states = residual + self.mlp(hidden_states)
        if kv_cache is not None:
            return hidden_states, kv_cache
        return hidden_states


class LlamaModel(tnn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device,
                                         dtype=torch_dtype(config.dtype))
        self.layers = tnn.ModuleList(
            [self._make_layer(config, i, device)
             for i in range(config.num_hidden_layers)])
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

    def forward(self, input_ids):
        """Non-cached forward over [B, S] ids; returns the normed hidden."""
        cos, sin = self._rope(input_ids.shape[1])
        hidden = self.embed_tokens(input_ids).to(torch_dtype(self.config.dtype))
        for layer in self.layers:
            hidden = layer(hidden, cos, sin)
        return self.norm(hidden)

    def forward_cached(self, input_ids, kv_caches, rope_len):
        """Forward over the static KV caches (one dict per layer, see
        ``generation.cached_attention``). Returns (normed hidden,
        new caches)."""
        cos, sin = self._rope(rope_len)
        hidden = self.embed_tokens(input_ids).to(torch_dtype(self.config.dtype))
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            hidden, c = layer(hidden, cos, sin, cache)
            new_caches.append(c)
        return self.norm(hidden), new_caches


class LlamaForCausalLM(tnn.Module):
    """Causal LM. ``device=None`` means the current CUDA device,
    and raises where there is none (pass ``device="cpu"`` for the plain
    versions). Weights are drawn from ``generator`` (default: the port's
    generator on ``device``): Normal(0, initializer_range) for embeddings
    and projections, ones for norms."""

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
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        gen = generator or default_generator(self.device)
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)

    def lm_head_logits(self, hidden):
        if self.lm_head is None:
            return torch.matmul(hidden, self.llama.embed_tokens.weight.t())
        return self.lm_head(hidden)

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
