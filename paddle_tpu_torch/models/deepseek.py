"""DeepSeek-V2 / V3 causal LM (multi-head latent attention + DeepSeekMoE) —
counterpart of ``paddle_tpu/models/deepseek.py``, serving and training.

MLA projects each token to a shared latent ``c_kv`` (``kv_lora_rank``
wide) and one shared RoPE key ``k_pe`` (``qk_rope_head_dim``, broadcast to
every head); per-head keys and values are re-expanded from the latent by
``kv_b_proj``. Two regimes, as in the JAX package:

- expanded (the non-cached forward that training differentiates, and a
  prefill whose prompt fills its bucket): K/V re-inflated, causal
  attention at q/k width ``qk_nope + qk_rope`` (192) and v width
  ``v_head_dim`` (128) through ``flash_attention_bshd``: on CUDA the flash
  kernel at that width (``flash_attention_mla``) and, for an input that
  needs a gradient, its backward kernel (``flash_attention_mla_bwd``); on
  the CPU its plain version under autograd. The broadcast ``k_pe`` sums
  its gradient over the heads;
- absorbed (decode, padded prefills): the cache holds only the latent rows
  (``c_kv`` and ``k_pe``), q_nope is absorbed through the K half of
  ``kv_b_proj``, and the context is read back through its V half. A single
  token per row (S = 1) goes to ``ops/hopper/mla_decode`` (the CUDA kernel
  on every S = 1 step on CUDA, its plain version on the CPU); longer
  absorbed chunks are PyTorch einsums, as the JAX package runs them in
  XLA.

Ported: ``DeepseekV2Config`` with ``tiny_mla`` / ``tiny_v3``,
``mla_softmax_scale``, ``_mla_sdpa``, ``_absorbed_tail``,
``mla_cached_attention``, ``mla_serving_attention``, ``DeepseekV2Attention``
(both q variants; the non-cached forward and the two cache dicts),
``DeepseekV2DecoderLayer``, ``DeepseekV2Model`` (latent
``empty_cache_layer``) and ``DeepseekV2ForCausalLM``, whose
``forward(labels=...)`` is the MoE base's loss (LM loss plus the router
aux term) for ``num_nextn_predict_layers == 0``. Not ported: multi-token
prediction (the config raises), LoRA on MLA, ring context parallelism,
pipeline parallelism and HF loading.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..ops.hopper import fused_norm
from ..ops.hopper.flash_attention import flash_attention_bshd
from ..ops.hopper.mla_decode import mla_decode
from .llama import _rope_type, _width_norm, _yarn_get_mscale, torch_dtype
from .llama_moe import (LlamaMoEConfig, LlamaMoEDecoderLayer,
                        LlamaMoEForCausalLM, LlamaMoEModel)


@dataclasses.dataclass
class DeepseekV2Config(LlamaMoEConfig):
    """MLA widths on top of the DeepSeekMoE base (HF DeepseekV2Config
    names)."""

    q_lora_rank: Optional[int] = None      # None: full-rank q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # DeepSeek-V3 multi-token prediction: not ported, raises when > 0
    num_nextn_predict_layers: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.num_nextn_predict_layers > 0:
            raise NotImplementedError(
                "multi-token prediction (num_nextn_predict_layers > 0, "
                "paddle_tpu/models/deepseek.py:508-615) is not ported to "
                "paddle_tpu_torch")

    @staticmethod
    def tiny_mla(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=3, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=256,
                    dtype="float32", n_routed_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=64,
                    first_k_dense_replace=1, kv_lora_rank=32,
                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                    v_head_dim=32, q_lora_rank=None)
        base.update(kw)
        return DeepseekV2Config(**base)

    @staticmethod
    def tiny_v3(**kw):
        """V3-style routing on the tiny shape: sigmoid scores, aux-free
        correction bias, group-limited selection, routed scaling."""
        base = dict(moe_scoring_func="sigmoid", moe_correction_bias=True,
                    routed_scaling_factor=2.5, router_aux_loss_coef=0.0,
                    n_group=2, topk_group=1)
        base.update(kw)
        return DeepseekV2Config.tiny_mla(**base)


def mla_softmax_scale(cfg):
    """1/sqrt(d_qk), times the yarn mscale_all_dim factor squared when the
    checkpoint scales the softmax (``deepseek.py:109-122``)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    rs = cfg.rope_scaling
    if _rope_type(rs) == "yarn":
        mad = float(rs.get("mscale_all_dim", 0) or 0)
        if mad:
            m = _yarn_get_mscale(float(rs["factor"]), mad)
            scale = scale * m * m
    return scale


def _mla_sdpa(q, k, v, *, causal: bool, scale: float):
    """The expanded attention shared by the non-cached forward and the
    exact-bucket prefill: q/k at ``qk_nope + qk_rope`` width, v at
    ``v_head_dim``, through ``flash_attention_bshd`` at the true widths (the
    CUDA kernel has no lane rule to pad for). On CUDA that is always the
    kernel, with its backward kernel under autograd, whatever
    ``use_flash_attention`` says; the plain version runs only for CPU
    tensors."""
    return flash_attention_bshd(q, k, v, causal=causal, sm_scale=scale)


def _absorbed_tail(q_lat, q_pe, ckv_buf, kpe_buf, w_uv, scale, mask,
                   kernel_pos, allowed):
    """The absorbed attention over the latent buffer (``deepseek.py:
    146-174``): q_lat [B, S, H, r] f32 unscaled, q_pe [B, S, H, dr] roped,
    mask [B or 1, 1, S, T] bool (read only when S > 1), ``kernel_pos`` an
    int or [B] row limits. S = 1 goes to ``mla_decode`` (the kernel on
    CUDA, every such step), longer chunks to the masked-softmax einsums.
    Returns [B, S, H, dv] f32."""
    S = q_lat.shape[1]
    if S == 1:
        ctx = mla_decode(q_lat[:, 0] * scale, q_pe[:, 0].float() * scale,
                         ckv_buf, kpe_buf, kernel_pos, allowed=allowed)
        return torch.einsum("bhr,rhd->bhd", ctx, w_uv.float())[:, None]
    scores = (torch.einsum("bshr,btr->bhst", q_lat, ckv_buf.float())
              + torch.einsum("bshd,btd->bhst", q_pe.float(),
                             kpe_buf.float())) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv_buf.float())
    return torch.einsum("bshr,rhd->bshd", ctx, w_uv.float())


def mla_cached_attention(q_nope, q_pe, c_kv, k_pe, cos, sin, ckv_buf,
                         kpe_buf, pos, w_kv_b, *, nope_dim, v_dim,
                         allowed=None, row_pos=None, prefill=False,
                         sm_scale=None):
    """RoPE + latent-cache write + MLA attention against the compressed
    buffer (``deepseek.py:177-247``). q_nope [B,S,H,dn], q_pe [B,S,H,dr],
    c_kv [B,S,r] (normed), k_pe [B,S,dr] (before RoPE), cos/sin
    [>= T, dr], ckv_buf [B,T,r] and kpe_buf [B,T,dr] written IN PLACE at
    ``pos`` (JAX returns new buffers), w_kv_b [r, H*(dn+dv)]. An unpadded
    first prefill (``prefill``, S > 1, no ``allowed`` / ``row_pos``) takes
    the expanded path; every other chunk the absorbed one. Returns
    (out [B,S,H,dv], ckv_buf, kpe_buf)."""
    from ..generation import _rope_rows

    B, S, H, _ = q_nope.shape
    dr = q_pe.shape[-1]
    r = c_kv.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(nope_dim
                                                                  + dr)
    pos = int(pos)
    k_pe4 = k_pe[:, :, None, :]
    if row_pos is None:
        cos_s, sin_s = cos[pos:pos + S], sin[pos:pos + S]
        q_pe = fused_norm.rope_ref(q_pe, cos_s, sin_s)
        k_pe4 = fused_norm.rope_ref(k_pe4, cos_s, sin_s)
    else:
        q_pe = _rope_rows(q_pe, cos, sin, row_pos)
        k_pe4 = _rope_rows(k_pe4, cos, sin, row_pos)
    ckv_buf[:, pos:pos + S] = c_kv.to(ckv_buf.dtype)
    kpe_buf[:, pos:pos + S] = k_pe4[:, :, 0, :].to(kpe_buf.dtype)

    w3 = w_kv_b.reshape(r, H, nope_dim + v_dim)
    if prefill and S > 1 and allowed is None and row_pos is None:
        # expanded: re-inflate K/V for the S new tokens only (the rest of
        # the buffer is empty at pos 0)
        kv = torch.einsum("bsr,rhd->bshd", c_kv.to(w3.dtype), w3)
        k_nope, v = kv[..., :nope_dim], kv[..., nope_dim:]
        q = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
        k = torch.cat([k_nope, k_pe4.to(k_nope.dtype).expand(B, S, H, dr)],
                      dim=-1)
        out = _mla_sdpa(q, k, v, causal=True, scale=scale)
        return out, ckv_buf, kpe_buf

    w_uk, w_uv = w3[..., :nope_dim], w3[..., nope_dim:]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk.float())
    T = ckv_buf.shape[1]
    t_idx = torch.arange(T, device=q_nope.device)
    qpos = pos + torch.arange(S, device=q_nope.device)
    mask = (t_idx[None, :] <= qpos[:, None])[None, None]        # [1,1,S,T]
    if allowed is not None:
        mask = mask & allowed.bool()[:, None, None, :]
    out = _absorbed_tail(q_lat, q_pe, ckv_buf, kpe_buf, w_uv, scale,
                         mask, kernel_pos=pos, allowed=allowed)
    return out.to(q_nope.dtype), ckv_buf, kpe_buf


def mla_serving_attention(q_nope, q_pe, c_kv, k_pe, cos, sin, ckv_buf,
                          kpe_buf, lengths, w_kv_b, *, nope_dim, v_dim,
                          sm_scale=None):
    """Continuous-batching decode over the latent cache (``deepseek.py:
    250-292``): one token per slot row, written IN PLACE at ``lengths[b]``,
    roped there, attending to t <= lengths[b]. Rows of empty slots
    (length 0) compute one column the engine discards. Returns
    (out [B,1,H,dv], ckv_buf, kpe_buf)."""
    from ..generation import _rope_rows

    B, S, H, _ = q_nope.shape
    if S != 1:
        raise ValueError(f"mla_serving_attention decodes one token per slot "
                         f"per step, got S={S}")
    dr = q_pe.shape[-1]
    r = c_kv.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(nope_dim
                                                                  + dr)
    lengths = lengths.to(device=q_nope.device, dtype=torch.int32)
    q_pe = _rope_rows(q_pe, cos, sin, lengths)
    k_pe4 = _rope_rows(k_pe[:, :, None, :], cos, sin, lengths)
    rows = torch.arange(B, device=q_nope.device)
    at = lengths.long()
    ckv_buf[rows, at] = c_kv[:, 0].to(ckv_buf.dtype)
    kpe_buf[rows, at] = k_pe4[:, 0, 0, :].to(kpe_buf.dtype)

    w3 = w_kv_b.reshape(r, H, nope_dim + v_dim)
    w_uk, w_uv = w3[..., :nope_dim], w3[..., nope_dim:]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk.float())
    out = _absorbed_tail(q_lat, q_pe, ckv_buf, kpe_buf, w_uv, scale,
                         None, kernel_pos=lengths, allowed=None)
    return out.to(q_nope.dtype), ckv_buf, kpe_buf


class DeepseekV2Attention(tnn.Module):
    """MLA block: optional low-rank q, the shared compressed latent with
    its decoupled MQA RoPE key, per-head re-expansion (``deepseek.py:
    295-458``). Linear weights in Paddle's [in, out] layout under the JAX
    names."""

    def __init__(self, config: DeepseekV2Config, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        H = config.num_attention_heads
        dn, dr = config.qk_nope_head_dim, config.qk_rope_head_dim
        dv, r = config.v_head_dim, config.kv_lora_rank
        self.num_heads, self.nope_dim, self.rope_dim, self.v_dim = H, dn, dr, dv
        dt = torch_dtype(config.dtype)
        kw = dict(device=device, dtype=dt)
        if config.q_lora_rank:
            self.q_a_proj = nn.Linear(h, config.q_lora_rank, **kw)
            self.q_a_layernorm = _width_norm(config, config.q_lora_rank,
                                             device=device)
            self.q_b_proj = nn.Linear(config.q_lora_rank, H * (dn + dr), **kw)
            self.q_proj = None
        else:
            self.q_proj = nn.Linear(h, H * (dn + dr), **kw)
        self.kv_a_proj_with_mqa = nn.Linear(h, r + dr, **kw)
        self.kv_a_layernorm = _width_norm(config, r, device=device)
        self.kv_b_proj = nn.Linear(r, H * (dn + dv), **kw)
        self.o_proj = nn.Linear(H * dv, h, **kw)
        self.softmax_scale = mla_softmax_scale(config)

    def _project(self, hidden_states):
        """(q_nope, q_pe, c_kv, k_pe) of the hidden states; c_kv normed
        by ``kv_a_layernorm`` (the rms_norm kernel at the latent width)."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        H, dn, dr = self.num_heads, self.nope_dim, self.rope_dim
        r = self.config.kv_lora_rank
        if self.q_proj is not None:
            q = self.q_proj(hidden_states)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(hidden_states)))
        q = q.reshape(b, s, H, dn + dr)
        kv_a = self.kv_a_proj_with_mqa(hidden_states)
        c_kv = self.kv_a_layernorm(kv_a[..., :r].contiguous())
        return q[..., :dn], q[..., dn:], c_kv, kv_a[..., r:]

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """With a cache dict ({c_kv, k_pe, lengths} from the engine, or
        {c_kv, k_pe, pos, ...} from a prefill): returns (out, new cache).
        Without: the non-cached causal forward, returns out."""
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        H, dn, dr, dv = self.num_heads, self.nope_dim, self.rope_dim, self.v_dim
        cfg = self.config
        q_nope, q_pe, c_kv, k_pe = self._project(hidden_states)
        w_kv_b = self.kv_b_proj.weight
        if isinstance(kv_cache, dict) and "lengths" in kv_cache:
            out, ckv, kpe = mla_serving_attention(
                q_nope, q_pe, c_kv, k_pe, cos, sin, kv_cache["c_kv"],
                kv_cache["k_pe"], kv_cache["lengths"], w_kv_b, nope_dim=dn,
                v_dim=dv, sm_scale=self.softmax_scale)
            new = {"c_kv": ckv, "k_pe": kpe,
                   "lengths": kv_cache["lengths"] + s}
            return self.o_proj(out.reshape(b, s, H * dv)), new
        if isinstance(kv_cache, dict):
            out, ckv, kpe = mla_cached_attention(
                q_nope, q_pe, c_kv, k_pe, cos, sin, kv_cache["c_kv"],
                kv_cache["k_pe"], kv_cache["pos"], w_kv_b, nope_dim=dn,
                v_dim=dv, allowed=kv_cache.get("allowed"),
                row_pos=kv_cache.get("row_pos"),
                prefill=bool(kv_cache.get("prefill", False)),
                sm_scale=self.softmax_scale)
            new = {"c_kv": ckv, "k_pe": kpe, "pos": kv_cache["pos"] + s}
            if "allowed" in kv_cache:
                new["allowed"] = kv_cache["allowed"]
            if "row_pos" in kv_cache:
                new["row_pos"] = kv_cache["row_pos"] + s
            return self.o_proj(out.reshape(b, s, H * dv)), new
        if kv_cache is not None:
            raise NotImplementedError(
                "MLA takes the dict (static-buffer) cache only: a tuple "
                "cache would store expanded K/V")
        q_pe_r = fused_norm.rope_ref(q_pe, cos, sin).to(q_nope.dtype)
        k_pe_r = fused_norm.rope_ref(k_pe[:, :, None, :], cos, sin)
        kv = torch.einsum("bsr,rhd->bshd", c_kv,
                          w_kv_b.reshape(cfg.kv_lora_rank, H, dn + dv))
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q = torch.cat([q_nope, q_pe_r], dim=-1)
        k = torch.cat([k_nope, k_pe_r.to(k_nope.dtype).expand(b, s, H, dr)],
                      dim=-1)
        out = _mla_sdpa(q, k, v, causal=True, scale=self.softmax_scale)
        return self.o_proj(out.reshape(b, s, H * dv))


class DeepseekV2DecoderLayer(LlamaMoEDecoderLayer):
    """MLA attention + (dense | DeepSeekMoE) FFN."""

    attn_cls = DeepseekV2Attention


class DeepseekV2Model(LlamaMoEModel):
    """The trunk with MLA decoder layers and ``qk_rope_head_dim`` RoPE
    tables; its decode cache is the compressed latent."""

    layer_cls = DeepseekV2DecoderLayer

    def _rope_dim(self):
        return self.config.qk_rope_head_dim

    def empty_cache_layer(self, batch, max_len, dtype):
        """One layer's latent cache (``deepseek.py:488``):
        ``kv_lora_rank + qk_rope_head_dim`` values per token, at the true
        rope width (the JAX package pads it to 128 lanes on the TPU
        only)."""
        cfg = self.config
        dev = self.embed_tokens.weight.device
        dt = torch_dtype(dtype)
        return {"c_kv": torch.zeros(batch, max_len, cfg.kv_lora_rank,
                                    dtype=dt, device=dev),
                "k_pe": torch.zeros(batch, max_len, cfg.qk_rope_head_dim,
                                    dtype=dt, device=dev)}


class DeepseekV2ForCausalLM(LlamaMoEForCausalLM):
    """DeepSeek-V2 / V3 causal LM: MLA + MoE; served through
    ``ContinuousBatchEngine`` in latent mode, trained through
    ``forward(input_ids, labels=...)`` (``deepseek.py:560-606`` without
    multi-token prediction)."""

    model_cls = DeepseekV2Model
