"""GPT-2 decoder family — counterpart of ``paddle_tpu/models/gpt2.py``.

Learned absolute positions (``wte`` + ``wpe``), pre-LN blocks with
LayerNorm (weight and bias), a fused ``c_attn`` projection with biases,
tanh-gelu MLP and a head tied to ``wte``. Cached decode rides the trunk's
machinery (``generation.cached_attention`` / ``paged_cached_attention``
and every unit, engine and ``generate`` route over them) through identity
rotation tables: RoPE with cos 1 and sin 0 is the identity, so the
position rides ``wpe`` while the caches, ragged masks and per-row
positions stay shared. The decoder sits at the ``llama`` slot the step
units drive; its ``_rope`` hands out the identity tables (the units call
``model.llama._rope(rope_len)``).

On CUDA its heads of 64 take the kernels' (64, 64) instances: the flash
forward in an exact prefill and the forward without a cache, append
attention for dense decode and padded prefills, ``paged_attention_64``
in the engine and ``generate_paged`` (JAX's gates send 64 to its einsum
and ``_sdpa_ref``; the paged decode is its bundled kernel). The block is
no ``LlamaDecoderLayer``, so it never reaches the fused decode tail.
Linear weights are [in, out] as in the JAX package (and as transformers'
Conv1D keeps them), so ``gpt2_from_hf`` (``gpt2.py:322``) writes a
HuggingFace checkpoint's tensors as they are, untransposed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..framework.random import default_device, default_generator
from ..ops.hopper.append_attention import chunk_positions, plain_width
from ..ops.hopper.flash_attention import flash_attention_bshd
from .llama import (_check_checkpoint, _hf_get, _state_and_config,
                    _write_plan, causal_lm_loss, torch_dtype)


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None      # default 4 * hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    # multi-head attention: the shared cache machinery reads the KV heads
    @property
    def num_key_value_heads(self):
        return self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=256,
                    dtype="float32")
        base.update(kw)
        return GPT2Config(**base)


class GPT2Attention(tnn.Module):
    """Causal self-attention through the fused ``c_attn`` (q | k | v, with
    a bias) and ``c_proj`` (``gpt2.py:67-136``)."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        dt = torch_dtype(config.dtype)
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.c_attn = nn.Linear(h, 3 * h, device=device, dtype=dt, bias=True)
        self.c_proj = nn.Linear(h, h, device=device, dtype=dt, bias=True)

    def forward(self, hidden, rope, kv_cache=None):
        """With a cache dict: the serving path through the trunk's cached
        attention at the identity ``rope`` tables, returns (out, new
        cache). Without: causal attention over the sequence (the flash
        forward, or ``_sdpa_ref`` where ``use_flash_attention`` is off or
        the width takes the plain route), returns out."""
        from ..generation import cached_attention, paged_cached_attention
        from ..nn.functional.attention import _sdpa_ref

        b, s = hidden.shape[0], hidden.shape[1]
        h, d = self.num_heads, self.head_dim
        q, k, v = (t.reshape(b, s, h, d)
                   for t in self.c_attn(hidden).split(h * d, dim=-1))
        cos, sin = rope
        if isinstance(kv_cache, dict):
            if "k_pages" in kv_cache:
                out, kp, vp = paged_cached_attention(
                    q, k, v, cos, sin, kv_cache["k_pages"],
                    kv_cache["v_pages"], kv_cache["page_indices"],
                    kv_cache["lengths"], kv_cache["page_size"])
                new = dict(kv_cache)
                new.update(k_pages=kp, v_pages=vp,
                           lengths=kv_cache["lengths"] + s)
                return self.c_proj(out.reshape(b, s, h * d)), new
            out, k_buf, v_buf = cached_attention(
                q, k, v, cos, sin, kv_cache["k"], kv_cache["v"],
                kv_cache["pos"], kv_cache.get("allowed"),
                kv_cache.get("row_pos"),
                use_flash=self.config.use_flash_attention,
                prefill=bool(kv_cache.get("prefill", False)))
            new = {"k": k_buf, "v": v_buf, "pos": kv_cache["pos"] + s}
            if "allowed" in kv_cache:
                new["allowed"] = kv_cache["allowed"]
            if "row_pos" in kv_cache:
                new["row_pos"] = kv_cache["row_pos"] + s
            return self.c_proj(out.reshape(b, s, h * d)), new
        if self.config.use_flash_attention and not plain_width(d, d):
            out = flash_attention_bshd(q, k, v, causal=True)
        else:
            out = _sdpa_ref(q, k, v, causal=True)
        return self.c_proj(out.reshape(b, s, h * d))


class GPT2MLP(tnn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.c_fc = nn.Linear(config.hidden_size, config.intermediate_size,
                              device=device, dtype=dt, bias=True)
        self.c_proj = nn.Linear(config.intermediate_size, config.hidden_size,
                                device=device, dtype=dt, bias=True)

    def forward(self, x):
        # gelu_new, the tanh approximation (jax.nn.gelu(approximate=True))
        return self.c_proj(torch.nn.functional.gelu(self.c_fc(x),
                                                    approximate="tanh"))


class GPT2Block(tnn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        dt = torch_dtype(config.dtype)
        eps = config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(config.hidden_size, eps, device=device,
                                 dtype=dt)
        self.attn = GPT2Attention(config, device=device)
        self.ln_2 = nn.LayerNorm(config.hidden_size, eps, device=device,
                                 dtype=dt)
        self.mlp = GPT2MLP(config, device=device)

    def forward(self, hidden, rope, kv_cache=None):
        """Returns hidden, or (hidden, new cache) when given a cache."""
        if kv_cache is not None:
            a, kv_cache = self.attn(self.ln_1(hidden), rope, kv_cache)
            hidden = hidden + a
            return hidden + self.mlp(self.ln_2(hidden)), kv_cache
        hidden = hidden + self.attn(self.ln_1(hidden), rope)
        return hidden + self.mlp(self.ln_2(hidden))


class GPT2Model(tnn.Module):
    """wte + wpe -> pre-LN blocks -> ln_f, with the cached-decode contract
    (``forward_cached``, ``_rope``) the step units and the engine drive."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        dt = torch_dtype(config.dtype)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                device=device, dtype=dt)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, device=device, dtype=dt)
        self.h = tnn.ModuleList([GPT2Block(config, device=device)
                                 for _ in range(config.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 config.layer_norm_epsilon, device=device,
                                 dtype=dt)
        # identity tables keyed by length
        self._rope_cache: dict = {}

    def _rope(self, seq_len):
        """cos 1 / sin 0 tables [seq_len, head_dim] f32: RoPE as the
        identity (``gpt2.py:218-230``)."""
        pair = self._rope_cache.get(seq_len)
        if pair is None:
            d = self.config.hidden_size // self.config.num_attention_heads
            dev = self.wte.weight.device
            pair = (torch.ones(seq_len, d, device=dev),
                    torch.zeros(seq_len, d, device=dev))
            self._rope_cache[seq_len] = pair
        return pair

    def _positions(self, s, caches):
        """Absolute positions of the chunk's tokens (``gpt2.py:232-243``):
        [B, s] from the ragged caches' ``row_pos`` or the paged
        ``lengths``, else [s] from the shared ``pos`` (the device int32 of
        the dense caches: read on the card, so one graph serves every
        step)."""
        c0 = caches[0]
        row_pos = c0.get("row_pos")
        if row_pos is None and "lengths" in c0:        # the paged layout
            row_pos = c0["lengths"]
        if row_pos is not None:
            return (row_pos.long()[:, None]
                    + torch.arange(s, device=row_pos.device)[None, :])
        return chunk_positions(c0["pos"], s, self.wte.weight.device)

    def _embed(self, input_ids, positions):
        tok = self.wte(input_ids)
        pe = self.wpe.weight[positions]
        if pe.dim() == 2:                               # [s, h] shared
            pe = pe[None]
        return (tok + pe).to(torch_dtype(self.config.dtype))

    def forward(self, input_ids):
        """Non-cached forward over [B, S] ids; returns the normed hidden."""
        s = input_ids.shape[1]
        if s > self.config.max_position_embeddings:
            # the learned position table has a fixed size
            raise ValueError(
                f"GPT2: sequence length {s} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}")
        rope = self._rope(s)
        hidden = self._embed(input_ids, torch.arange(
            s, device=self.wte.weight.device))
        for block in self.h:
            hidden = block(hidden, rope)
        return self.ln_f(hidden)

    def forward_cached(self, input_ids, kv_caches, rope_len):
        """Forward over the static KV caches (one dict per layer, see
        ``generation.cached_attention``). Positions past the ``wpe`` table
        cannot occur: ``generate`` and the engine bound their lengths by
        ``max_position_embeddings`` first. Returns (normed hidden, new
        caches)."""
        rope = self._rope(rope_len)
        hidden = self._embed(input_ids,
                             self._positions(input_ids.shape[1], kv_caches))
        new_caches = []
        for block, cache in zip(self.h, kv_caches):
            hidden, c = block(hidden, rope, kv_cache=cache)
            new_caches.append(c)
        return self.ln_f(hidden), new_caches


class GPT2LMHeadModel(tnn.Module):
    """GPT-2 causal LM with the head tied to ``wte``; the decoder at the
    ``llama`` slot (``transformer`` names it too). ``device=None`` means
    the current CUDA device (pass ``device="cpu"`` for the plain
    versions). Weights are drawn from ``generator`` by the GPT-2 recipe
    (``gpt2.py:180-197``): ``wte``, ``wpe``, ``c_attn`` and ``c_fc``
    Normal(0, initializer_range), the residual projections ``c_proj``
    Normal(0, initializer_range / sqrt(2 L)), biases zeros, LayerNorm
    weights ones."""

    def __init__(self, config: GPT2Config, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        self.config = config
        self.llama = GPT2Model(config, device=device)
        self.lm_head = None   # tied
        self.reset_parameters(generator)

    @property
    def transformer(self):
        return self.llama

    @property
    def device(self) -> torch.device:
        return self.llama.wte.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        gen = generator or default_generator(self.device)
        std = self.config.initializer_range
        resid = std / math.sqrt(2 * self.config.num_hidden_layers)
        for name, p in self.named_parameters():
            if name.endswith("c_proj.weight"):
                p.normal_(0.0, resid, generator=gen)
            elif name.endswith(("wte.weight", "wpe.weight", "c_attn.weight",
                                "c_fc.weight")):
                p.normal_(0.0, std, generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def lm_head_logits(self, hidden):
        return torch.matmul(hidden, self.llama.wte.weight.t())

    def forward(self, input_ids, labels=None):
        """Logits, or (loss, logits) with labels."""
        logits = self.lm_head_logits(self.llama(input_ids))
        if labels is None:
            return logits
        return causal_lm_loss(logits, labels), logits

    def generate(self, input_ids, **kw):
        """``generation.generate`` (every route the Llama trunk takes)."""
        from ..generation import generate as _generate

        return _generate(self, input_ids, **kw)


def gpt2_from_hf(hf_model_or_state, hf_config=None, device=None,
                 **config_overrides):
    """A ``GPT2LMHeadModel`` from a transformers GPT2LMHeadModel, or from a
    state dict and its config, on ``device`` (``gpt2.py:322-374``).
    Conv1D weights are [in, out], as here: nothing is transposed. The
    tied ``lm_head.weight`` and the causal-mask buffers are skipped."""
    device = default_device(device)
    state, hf_config = _state_and_config(hf_model_or_state, hf_config)
    get = _hf_get(hf_config)
    kw = dict(vocab_size=get("vocab_size"),
              hidden_size=get("n_embd", get("hidden_size")),
              num_hidden_layers=get("n_layer", get("num_hidden_layers")),
              num_attention_heads=get("n_head", get("num_attention_heads")),
              max_position_embeddings=get("n_positions",
                                          get("max_position_embeddings")),
              layer_norm_epsilon=get("layer_norm_epsilon", 1e-5))
    kw.update(config_overrides)
    cfg = GPT2Config(**kw)
    model = GPT2LMHeadModel(cfg, device=device)
    plan = {f"llama.{k}": (f"transformer.{k}", False)
            for k in ("wte.weight", "wpe.weight", "ln_f.weight",
                      "ln_f.bias")}
    for i in range(cfg.num_hidden_layers):
        for mod in ("ln_1", "ln_2", "attn.c_attn", "attn.c_proj",
                    "mlp.c_fc", "mlp.c_proj"):
            for part in ("weight", "bias"):
                plan[f"llama.h.{i}.{mod}.{part}"] = (
                    f"transformer.h.{i}.{mod}.{part}", False)
    _check_checkpoint("gpt2_from_hf", model, state,
                      [k for k, _ in plan.values()], plan,
                      aliases=("lm_head.weight",),
                      skip=(".attn.bias", ".attn.masked_bias"))
    _write_plan("gpt2_from_hf", model, state, plan)
    return model
