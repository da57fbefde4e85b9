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

The kernel takes every head count the JAX gate takes (multiples of 8 up
to 128), so DeepSeek-V2 and V3 decode at their published 128 heads.

DeepSeek-V3's multi-token prediction (``num_nextn_predict_layers = D``):
``DeepseekMTPLayer`` k fuses ``[RMSNorm(h_prev) | RMSNorm(emb(t_{i+k}))]``
through ``eh_proj`` (2h -> h) into one more decoder block (layer index
``num_hidden_layers + k``, so MoE at V3's widths), sharing the main
embedding and head. ``forward(labels=...)`` adds ``mtp_loss_lambda`` times
the mean MTP loss and takes the router aux term over the MTP blocks too;
``generate``, the engine and ``speculative_generate`` ignore the MTP
modules, and ``speculative.mtp_speculative_generate`` drafts with the
first depth.

Routing capacity: the MoE layers drop routes past ``moe_capacity_factor``
(default 2.0, as in the JAX package), where the published V3 drops none.
At V3's 256 experts and 8 a token that gives a capacity of 1 at one decode
row, so a 2-token verify would drop routes that one-token decode keeps and
no greedy identity could hold: to serve V3 as published, set the factor to
256 / 8 = 32, where the capacity is the token count (``chip_smoke.py``'s
phase 28 does).

Ported: ``DeepseekV2Config`` with ``tiny_mla`` / ``tiny_v3``,
``mla_softmax_scale``, ``_mla_sdpa``, ``_absorbed_tail``,
``mla_cached_attention``, ``mla_serving_attention``, ``DeepseekV2Attention``
(both q variants; the non-cached forward and the two cache dicts),
``DeepseekV2DecoderLayer``, ``DeepseekV2Model`` (latent
``empty_cache_layer``), ``DeepseekMTPLayer`` and ``DeepseekV2ForCausalLM``
(the MoE base's loss for ``num_nextn_predict_layers == 0``, the MTP loss
beside it otherwise), and ``deepseek_from_hf`` (``deepseek.py:660-813``):
a HuggingFace DeepseekV2 / V3 state dict written in place, the
interleaved RoPE rows (each head's q_pe rows, the k_pe tail of
``kv_a_proj_with_mqa``) reordered to the half-split layout on the device
(``deinterleave_q``, ``deinterleave_rows``), the experts packed; like the
JAX converter it reads the trunk's keys only, so a V3 checkpoint's MTP
tensors (``model.layers.{num_hidden_layers}.*``) are left unused. Not
ported: LoRA on MLA, ring context parallelism, pipeline parallelism.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..framework.random import default_device
from ..ops.hopper import fused_norm
from ..ops.hopper.append_attention import chunk_positions
from ..ops.hopper.flash_attention import flash_attention_bshd
from ..ops.hopper.mla_decode import mla_decode
from .llama import (LlamaRMSNorm, _hf_get, _rope_type, _width_norm,
                    _yarn_get_mscale, causal_lm_loss, torch_dtype,
                    validate_rope_scaling)
from .llama_moe import (LlamaMoEConfig, LlamaMoEDecoderLayer,
                        LlamaMoEForCausalLM, LlamaMoEModel, _load_grouped)


@dataclasses.dataclass
class DeepseekV2Config(LlamaMoEConfig):
    """MLA widths on top of the DeepSeekMoE base (HF DeepseekV2Config
    names)."""

    q_lora_rank: Optional[int] = None      # None: full-rank q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # DeepSeek-V3 multi-token prediction: D extra depths, each predicting
    # token t+1+k from [RMSNorm(h_prev) | RMSNorm(emb(t+k))] through a
    # fusion projection and one decoder block, sharing the main embedding
    # and head; forward(labels=...) adds mtp_loss_lambda x the mean MTP loss
    num_nextn_predict_layers: int = 0
    mtp_loss_lambda: float = 0.3

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
    ``pos`` (JAX returns new buffers), w_kv_b [r, H*(dn+dv)]; ``pos`` an
    int or the device int32 the dense caches carry (rope rows and cache
    slots taken by index at ``pos + arange(S)``). An unpadded first
    prefill (``prefill``, S > 1, no ``allowed`` / ``row_pos``) takes the
    expanded path; every other chunk the absorbed one. Returns
    (out [B,S,H,dv], ckv_buf, kpe_buf)."""
    from ..generation import _rope_rows

    B, S, H, _ = q_nope.shape
    dr = q_pe.shape[-1]
    r = c_kv.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(nope_dim
                                                                  + dr)
    qpos = chunk_positions(pos, S, q_nope.device)
    k_pe4 = k_pe[:, :, None, :]
    if row_pos is None:
        cos_s, sin_s = cos.index_select(0, qpos), sin.index_select(0, qpos)
        q_pe = fused_norm.rope_ref(q_pe, cos_s, sin_s)
        k_pe4 = fused_norm.rope_ref(k_pe4, cos_s, sin_s)
    else:
        q_pe = _rope_rows(q_pe, cos, sin, row_pos)
        k_pe4 = _rope_rows(k_pe4, cos, sin, row_pos)
    ckv_buf.index_copy_(1, qpos, c_kv.to(ckv_buf.dtype))
    kpe_buf.index_copy_(1, qpos, k_pe4[:, :, 0, :].to(kpe_buf.dtype))

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


class DeepseekMTPLayer(tnn.Module):
    """One DeepSeek-V3 multi-token-prediction depth (``deepseek.py:
    508-539``): ``[RMSNorm(h_prev) | RMSNorm(emb_next)]`` through ``eh_proj``
    (2h -> h, no bias, [in, out]), then one decoder block. It owns the two
    input norms, the projection, the block and the pre-head norm; the
    embedding and the head are the main model's. The block's RoPE tables
    are 0-based over the shifted window: exact, RoPE attention being
    relative."""

    def __init__(self, config: DeepseekV2Config, layer_idx: int,
                 device=None):
        super().__init__()
        self.hnorm = LlamaRMSNorm(config, device=device)
        self.enorm = LlamaRMSNorm(config, device=device)
        self.eh_proj = nn.Linear(2 * config.hidden_size, config.hidden_size,
                                 device=device,
                                 dtype=torch_dtype(config.dtype))
        self.block = DeepseekV2DecoderLayer(config, layer_idx, device=device)
        self.norm = LlamaRMSNorm(config, device=device)

    def fuse(self, h_prev, emb_next):
        """The block's input, shared by the loss and the draft."""
        return self.eh_proj(torch.cat([self.hnorm(h_prev),
                                       self.enorm(emb_next)], dim=-1))

    def forward(self, h_prev, emb_next, cos, sin):
        return self.block(self.fuse(h_prev, emb_next), cos, sin)


class DeepseekV2ForCausalLM(LlamaMoEForCausalLM):
    """DeepSeek-V2 / V3 causal LM: MLA + MoE; served through
    ``ContinuousBatchEngine`` in latent mode, trained through
    ``forward(input_ids, labels=...)`` (``deepseek.py:553-606``).
    ``num_nextn_predict_layers = D > 0`` adds ``mtp_layers``: depth k
    predicts token t+1+k from the previous depth's hidden; the loss becomes
    ``L_main + mtp_loss_lambda * mean_k L_k``. Inference paths ignore the
    MTP modules (``speculative.mtp_speculative_generate`` drafts with
    them)."""

    model_cls = DeepseekV2Model

    def _make_extra_modules(self, config, device):
        D = int(config.num_nextn_predict_layers)
        self.mtp_layers = (tnn.ModuleList(
            [DeepseekMTPLayer(config, config.num_hidden_layers + k,
                              device=device) for k in range(D)])
            if D else None)

    def forward(self, input_ids, labels=None):
        """As the MoE base without labels or MTP depths; with both, (loss,
        None): the main loss, the MTP chain's mean loss times
        ``mtp_loss_lambda``, and the router aux term over every MoE layer
        that ran, the MTP blocks' included (``deepseek.py:560-606``)."""
        cfg = self.config
        D = int(cfg.num_nextn_predict_layers)
        if labels is None or not D:
            return super().forward(input_ids, labels=labels)
        if cfg.fuse_linear_cross_entropy:
            raise NotImplementedError(
                "multi-token prediction computes explicit logits per "
                "depth; unset fuse_linear_cross_entropy to train with "
                "num_nextn_predict_layers > 0")
        S = input_ids.shape[1]
        if D >= S:
            raise ValueError(
                f"num_nextn_predict_layers {D} needs sequences longer "
                f"than {D} tokens, got {S}")
        normed, pre = self.llama(input_ids, return_prenorm=True)
        loss = causal_lm_loss(self.lm_head_logits(normed), labels)
        # depth k pairs the pre-norm h_{k-1}[:, i] with emb(t_{i+k}) and
        # targets labels[:, i+k]; the embedding and the rope tables are
        # taken once at full length and sliced per depth
        emb_full = self.llama.embed_tokens(input_ids).to(
            torch_dtype(cfg.dtype))
        cos_full, sin_full = self.llama._rope(S)
        h_prev, mtp_total = pre, None
        for k, layer in enumerate(self.mtp_layers, start=1):
            n = S - k
            h_prev = layer(h_prev[:, :n], emb_full[:, k:], cos_full[:n],
                           sin_full[:n])
            l_k = causal_lm_loss(self.lm_head_logits(layer.norm(h_prev)),
                                 labels[:, k:])
            mtp_total = l_k if mtp_total is None else mtp_total + l_k
        loss = loss + cfg.mtp_loss_lambda * (mtp_total / D)
        aux = self.aux_loss(
            extra_layers=[layer.block for layer in self.mtp_layers])
        if aux is not None:
            loss = loss + cfg.router_aux_loss_coef * aux
        return loss, None


# ---------------------------------------------------------------------------
# HuggingFace checkpoints (``deepseek.py:660-813``)
# ---------------------------------------------------------------------------

def deinterleave_rows(w, dim):
    """The trailing ``dim`` output rows of a torch [out, in] weight from
    the interleaved pair layout (x0, y0, x1, y1, ...) to the half-split one
    (x..., y...): the k_pe tail of ``kv_a_proj_with_mqa``."""
    head, tail = w[:-dim], w[-dim:]
    tail = tail.reshape(dim // 2, 2, -1)
    return torch.cat([head, tail[:, 0], tail[:, 1]], dim=0)


def deinterleave_q(w, n_heads, nope_dim, rope_dim):
    """The same reorder on each head's q_pe rows of a q / q_b projection
    [H (dn + dr), in]: evens then odds after the dn pass-through rows."""
    w = w.reshape(n_heads, nope_dim + rope_dim, -1)
    pe = (w[:, nope_dim:].reshape(n_heads, rope_dim // 2, 2, -1)
          .transpose(1, 2).reshape(n_heads, rope_dim, -1))
    return torch.cat([w[:, :nope_dim], pe], dim=1).reshape(
        n_heads * (nope_dim + rope_dim), -1)


def _hf_config_to_deepseek(hc) -> DeepseekV2Config:
    """The config the JAX converter builds when given none: f32, every
    HF field read with its default (``deepseek.py:678-716``)."""
    get = _hf_get(hc)
    moe = get("n_routed_experts") is not None
    return DeepseekV2Config(
        vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings"),
        rms_norm_eps=get("rms_norm_eps"), rope_theta=get("rope_theta"),
        rope_scaling=(dict(get("rope_scaling"))
                      if get("rope_scaling") else None),
        dtype="float32",
        q_lora_rank=get("q_lora_rank"),
        kv_lora_rank=get("kv_lora_rank"),
        qk_nope_head_dim=get("qk_nope_head_dim"),
        qk_rope_head_dim=get("qk_rope_head_dim"),
        v_head_dim=get("v_head_dim"),
        n_routed_experts=(get("n_routed_experts") if moe else 0),
        n_shared_experts=(get("n_shared_experts", 0) or 0),
        num_experts_per_tok=(get("num_experts_per_tok") if moe else 2),
        moe_intermediate_size=get("moe_intermediate_size", 1408),
        first_k_dense_replace=(get("first_k_dense_replace", 0)
                               if moe else 10 ** 9),
        norm_topk_prob=bool(get("norm_topk_prob", False)),
        routed_scaling_factor=float(get("routed_scaling_factor", 1.0)),
        moe_scoring_func=str(get("scoring_func", "softmax")),
        moe_correction_bias=(get("topk_method", "") == "noaux_tc"),
        n_group=int(get("n_group", 1) or 1),
        topk_group=int(get("topk_group", 1) or 1),
        # aux-free checkpoints (noaux_tc) carry aux_loss_alpha 0: the HF
        # field is the authority, not the config default
        router_aux_loss_coef=float(get("aux_loss_alpha", 0.0) or 0.0),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)))


def deepseek_from_hf(hf_model, config=None, device=None):
    """A ``DeepseekV2ForCausalLM`` from a transformers DeepseekV2-style
    model (anything with ``state_dict()`` and ``config``, an object or a
    ``config.json`` dict), on ``device``. Without ``config`` it is mapped
    from the HF one, in f32. Every tensor is written in place; the q_pe
    rows and the k_pe tail are de-interleaved on the device. As in the
    JAX converter, only the trunk's keys are read: other tensors (a V3
    checkpoint's MTP layers) are left unused, and parameters no key
    writes (a config's own MTP depths) keep their initial values; a
    missing trunk key raises KeyError, a wrong shape ValueError."""
    device = default_device(device)
    sd = hf_model.state_dict()
    if config is None:
        config = _hf_config_to_deepseek(hf_model.config)
    validate_rope_scaling(config.rope_scaling,
                          max_position=config.max_position_embeddings)
    model = DeepseekV2ForCausalLM(config, device=device)
    H, dn, dr = (config.num_attention_heads, config.qk_nope_head_dim,
                 config.qk_rope_head_dim)

    def q_rows(t):
        return deinterleave_q(t, H, dn, dr)

    def kv_rows(t):
        return deinterleave_rows(t, dr)

    plan = {"llama.embed_tokens.weight": ("model.embed_tokens.weight", False),
            "llama.norm.weight": ("model.norm.weight", False)}
    if model.lm_head is not None:
        plan["lm_head.weight"] = ("lm_head.weight", True)
    transforms, experts = {}, {}
    for i, layer in enumerate(model.llama.layers):
        layer = getattr(layer, "inner", layer)
        hf, ours = f"model.layers.{i}", f"llama.layers.{i}"
        names = ["kv_a_proj_with_mqa", "kv_b_proj", "o_proj"]
        if layer.self_attn.q_proj is not None:
            names.append("q_proj")
            transforms[f"{ours}.self_attn.q_proj.weight"] = q_rows
        else:
            names += ["q_a_proj", "q_b_proj"]
            transforms[f"{ours}.self_attn.q_b_proj.weight"] = q_rows
            plan[f"{ours}.self_attn.q_a_layernorm.weight"] = (
                f"{hf}.self_attn.q_a_layernorm.weight", False)
        for proj in names:
            plan[f"{ours}.self_attn.{proj}.weight"] = (
                f"{hf}.self_attn.{proj}.weight", True)
        transforms[f"{ours}.self_attn.kv_a_proj_with_mqa.weight"] = kv_rows
        for norm in ("self_attn.kv_a_layernorm", "input_layernorm",
                     "post_attention_layernorm"):
            plan[f"{ours}.{norm}.weight"] = (f"{hf}.{norm}.weight", False)
        if not layer.is_moe:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                plan[f"{ours}.mlp.{proj}.weight"] = (
                    f"{hf}.mlp.{proj}.weight", True)
            continue
        plan[f"{ours}.mlp.gate_weight"] = (f"{hf}.mlp.gate.weight", True)
        if layer.mlp.e_score_correction_bias is not None:
            plan[f"{ours}.mlp.e_score_correction_bias"] = (
                f"{hf}.mlp.gate.e_score_correction_bias", False)
        experts[f"{ours}.mlp.experts"] = f"{hf}.mlp"
        if layer.mlp.shared_expert is not None:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                plan[f"{ours}.mlp.shared_expert.{proj}.weight"] = (
                    f"{hf}.mlp.shared_experts.{proj}.weight", True)
    return _load_grouped("deepseek_from_hf", model, sd, plan, experts,
                         transforms=transforms, leftovers=False,
                         require_covered=False)
