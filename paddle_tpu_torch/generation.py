"""Cached attention, sampling and the serving step units.

Counterpart of the parts of ``paddle_tpu/generation.py`` that
``serving.ContinuousBatchEngine`` uses: rope at per-row positions, attention
against a dense prefill cache (``cached_attention``) and the paged pool
(``paged_cached_attention`` for one token or a speculative-verify chunk,
``paged_decode_attention``), sampling, the prefill unit, the fused sample +
forward decode units and the greedy speculative decode unit.

There is no ``jit`` here: PyTorch runs eagerly, so the JAX package's jitted
step objects become plain callables with the same inputs and outputs. Where
JAX returns updated buffers functionally, the port writes the cache in
place and says so.
"""
from __future__ import annotations

import math

import torch

from .ops.hopper import fused_norm
from .ops.hopper.append_attention import (append_attention,
                                          append_attention_plain,
                                          grouped_attention_plain)
from .ops.hopper.flash_attention import flash_attention_bshd
from .ops.hopper.paged_attention import gather_pages, paged_attention


# ---------------------------------------------------------------------------
# cache attention (dense + paged)
# ---------------------------------------------------------------------------

def _rope_rows(x, cos, sin, row_pos):
    """RoPE with per-row positions: x [B,S,H,D], row_pos [B] — row b's token
    s sits at absolute position row_pos[b] + s."""
    return fused_norm.partial_rope(_rope_rows_full, x, cos, sin, row_pos)


def _rope_rows_full(x, cos, sin, row_pos):
    S = x.shape[1]
    idx = (row_pos.long()[:, None]
           + torch.arange(S, device=x.device)[None, :])      # [B, S]
    c = cos[idx][:, :, None, :]
    s = sin[idx][:, :, None, :]
    return (x.float() * c + fused_norm.rotate_half(x).float() * s).to(x.dtype)


def cached_attention(q, k, v, cos, sin, k_buf, v_buf, pos, allowed=None,
                     row_pos=None, use_flash=True, prefill=False, window=None,
                     rope_applied=False):
    """RoPE + cache write + masked grouped-query attention against a dense
    buffer. q [B,S,H,D]; k/v [B,S,hk,D]; cos/sin [>= T, rope_dim];
    k_buf/v_buf [B,T,hk,D], written IN PLACE at ``pos`` (JAX returns new
    buffers; the port updates the caller's); ``allowed`` optional [B,T]
    column mask (padded prompts); ``row_pos`` optional [B] per-row rope
    positions. Routing as in the JAX package (``generation.py:102-128``):

    - an unpadded pos=0 prefill of S > 1 tokens with ``use_flash`` takes
      ``flash_attention_bshd`` (causal attention over the prompt is causal
      self-attention on the S new tokens), with or without a sliding
      window: the causal or the LocalMask flash kernel;
    - any other windowless chunk the append-attention kernel (the mask
      counts buffer slots, so per-row rope positions do not change it). On
      CUDA it also takes single tokens and ``use_flash=False``;
    - any other windowed chunk (pos > 0, a padded prompt, a single token)
      the f32 einsum, ``append_attention_plain``, as the JAX package's
      einsum branch (no kernel there either).

    The wrappers run their plain versions on CPU tensors.
    ``rope_applied``: q and k arrive rotated (the fused decode tail).
    Returns (out [B,S,H,D], k_buf, v_buf)."""
    S = q.shape[1]
    pos = int(pos)
    if not rope_applied:
        if row_pos is None:
            q = fused_norm.rope_ref(q, cos[pos:pos + S], sin[pos:pos + S])
            k = fused_norm.rope_ref(k, cos[pos:pos + S], sin[pos:pos + S])
        else:
            q = _rope_rows(q, cos, sin, row_pos)
            k = _rope_rows(k, cos, sin, row_pos)
    k_buf[:, pos:pos + S] = k.to(k_buf.dtype)
    v_buf[:, pos:pos + S] = v.to(v_buf.dtype)

    if (use_flash and S > 1 and allowed is None and row_pos is None
            and (prefill or pos == 0)):
        out = flash_attention_bshd(q, k, v, causal=True, window=window)
    elif window is None:
        out = append_attention(q, k_buf, v_buf, pos, allowed=allowed)
    else:
        out = append_attention_plain(q, k_buf, v_buf, pos, allowed, window)
    return out, k_buf, v_buf


def paged_cached_attention(q, k, v, cos, sin, k_pages, v_pages, page_indices,
                           lengths, page_size, window=None,
                           rope_applied=False):
    """S tokens per row over the paged pool: row b's token j is roped at
    position lengths[b] + j (unless ``rope_applied``: the fused decode tail
    rotated q and k already) and written at its own page and slot
    (page_indices[b, pos // ps], pos % ps). The write is done IN PLACE on
    the pool with ``index_put_`` (JAX's ``.at[].set`` returns a new pool).
    S == 1 is the decode step over lengths[b] + 1 columns
    (``paged_decode_attention``). S > 1 is the speculative-verify chunk:
    chunk-causal attention over the gathered pages
    (``_paged_chunk_attention``). KV of rejected drafts lands above the
    row's post-accept frontier, where the next chunk's write overwrites it
    before lengths can reach it. Returns (out [B,S,H,D], k_pages,
    v_pages)."""
    B, S = q.shape[0], q.shape[1]
    lengths = lengths.to(torch.int32)
    if not rope_applied:
        q = _rope_rows(q, cos, sin, lengths)
        k = _rope_rows(k, cos, sin, lengths)
    pos = lengths.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    page = torch.div(pos, page_size, rounding_mode="floor")
    slot = pos % page_size
    rows = torch.gather(page_indices.long(), 1, page)            # [B, S]
    k_pages.index_put_(_pool_index(k_pages, rows, slot),
                       k.movedim(2, 0).to(k_pages.dtype))
    v_pages.index_put_(_pool_index(v_pages, rows, slot),
                       v.movedim(2, 0).to(v_pages.dtype))
    if S > 1:
        out = _paged_chunk_attention(q, k_pages, v_pages, lengths,
                                     page_indices, window=window)
        return out, k_pages, v_pages
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 lengths + 1, page_indices, window=window)
    return out[:, None], k_pages, v_pages


def _paged_chunk_attention(q, k_pages, v_pages, lengths, page_indices,
                           window=None):
    """Chunk attention over the paged pool: q [B,S,H,D] sits at positions
    lengths[b] + j; column t is visible from chunk position j iff
    t <= lengths[b] + j (and, windowed, t > lengths[b] + j - window). The
    JAX package runs this as XLA (gather + matmul) on every backend, since
    the paged decode kernel has no chunk-causal mask; here it is PyTorch on
    every device."""
    S = q.shape[1]
    k = gather_pages(k_pages, page_indices)                   # [B, hk, T, D]
    v = gather_pages(v_pages, page_indices)
    T = k.shape[2]
    qpos = lengths.long()[:, None] + torch.arange(S, device=q.device)[None]
    t_idx = torch.arange(T, device=q.device)[None, None, :]
    valid = t_idx <= qpos[:, :, None]                          # [B, S, T]
    if window is not None:
        valid = valid & (t_idx > qpos[:, :, None] - window)
    return _chunk_sdpa(q, k, v, valid)


def _chunk_sdpa(q, k, v, valid):
    """Decode / verify attention core: q [B,S,H,D] against gathered k / v
    [B,hk,T,D] with a column mask valid [B,S,T]; f32 scores and softmax."""
    return grouped_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   valid, 1.0 / math.sqrt(q.shape[-1]))


def _banded_sdpa(q, k, v, valid):
    """The S=1 view of :func:`_chunk_sdpa`: q [B,H,D] against gathered
    k / v [B,hk,T,D] with a column mask valid [B,T]."""
    return _chunk_sdpa(q[:, None], k, v, valid[:, None])[:, 0]


def _pool_index(pages, rows, slot):
    """Index tuple addressing pages[:, rows[b, j], slot[b, j]] for every KV
    head (``index_put_`` takes tensors only, so the head axis is spelled
    out)."""
    hk = pages.shape[0]
    heads = torch.arange(hk, device=pages.device)[:, None, None]
    return heads, rows[None], slot[None]


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           window=None):
    """Decode attention over the paged pool: the paged-attention kernel on
    CUDA (its plain version on the CPU). A sliding window narrower than the
    cache (``generation.py:260-266``) takes ``_paged_window_attention``,
    PyTorch on every device as it is XLA in the JAX package: the kernel has
    no lower edge, and the band gather reads O(window), not O(max_len). A
    window as wide as the cache never excludes a column: the kernel."""
    if window is not None and window < page_indices.shape[1] * k_pages.shape[2]:
        return _paged_window_attention(q, k_pages, v_pages, lengths,
                                       page_indices, window)
    return paged_attention(q, k_pages, v_pages, lengths.to(torch.int32),
                           page_indices)


def _paged_window_attention(q, k_pages, v_pages, lengths, page_indices,
                            window):
    """Sliding-window decode over the paged pool (``generation.py:
    295-322``): row b gathers only the ``min(ceil(window / ps) + 1, pages
    per row)`` pages the band [lengths[b] - window, lengths[b]) touches,
    from page ``max(lengths[b] - window, 0) // ps``, clamped so the last
    one stays in the row; columns outside the band are masked."""
    B = q.shape[0]
    ps = k_pages.shape[2]
    n_per_row = page_indices.shape[1]
    wp = min((window + ps - 1) // ps + 1, n_per_row)
    lengths = lengths.to(q.device).long()
    first = torch.div(torch.clamp(lengths - window, min=0), ps,
                      rounding_mode="floor")
    first = torch.clamp(first, max=max(n_per_row - wp, 0))        # [B]
    offs = first[:, None] + torch.arange(wp, device=q.device)[None]
    rows = torch.gather(page_indices.long(), 1, offs)             # [B, wp]
    k = gather_pages(k_pages, rows)                     # [B, hk, wp*ps, D]
    v = gather_pages(v_pages, rows)
    colpos = (offs[:, :, None] * ps
              + torch.arange(ps, device=q.device)[None, None]).reshape(B, -1)
    valid = ((colpos < lengths[:, None])
             & (colpos >= lengths[:, None] - window))
    return _banded_sdpa(q, k, v, valid)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _top_k_filter(logits, k):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return logits.masked_fill(logits < kth, float("-inf"))


def _top_p_filter(logits, p):
    if p >= 1.0:
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < p], dim=-1)
    min_logit = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                            ).min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < min_logit, float("-inf"))


def _categorical(logits, generator):
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_logits(logits, generator, do_sample=False, temperature=1.0,
                  top_k=0, top_p=1.0):
    """Next token from [B, V] logits; ``generator`` drives the draw."""
    logits = logits.float()
    if not do_sample or temperature <= 1e-6:
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    logits = _top_k_filter(logits, int(top_k))
    logits = _top_p_filter(logits, float(top_p))
    return _categorical(logits, generator)


def sample_logits_rows(logits, generator, do_sample, temperature, top_k,
                       top_p):
    """Per-row selection from [B, V] logits: every knob is a [B] tensor.
    Rows with do_sample False (or temperature ~ 0) take the argmax;
    top_k <= 0 means no k-filter; top_p >= 1 means no nucleus filter."""
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)
    V = lg.shape[-1]
    ninf = float("-inf")
    x = lg / torch.clamp(temperature, min=1e-6)[:, None]
    srt_desc = torch.sort(x, dim=-1, descending=True).values
    idx = torch.clamp(top_k - 1, 0, V - 1).long()
    kth = torch.gather(srt_desc, 1, idx[:, None])
    kth = kth.masked_fill(((top_k <= 0) | (top_k >= V))[:, None], ninf)
    x = x.masked_fill(x < kth, ninf)
    probs = torch.softmax(x, dim=-1)
    srt = torch.softmax(srt_desc.masked_fill(srt_desc < kth, ninf), dim=-1)
    cum = torch.cumsum(srt, dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < top_p[:, None]], dim=-1)
    min_prob = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                           ).min(dim=-1, keepdim=True).values
    min_prob = min_prob.masked_fill(top_p[:, None] >= 1.0, 0.0)
    x = x.masked_fill(probs < min_prob, ninf)
    sampled = _categorical(x, generator)
    return torch.where(do_sample & (temperature > 1e-6), sampled, greedy)


# ---------------------------------------------------------------------------
# step units
# ---------------------------------------------------------------------------

def _empty_caches(model, batch, max_len, allowed=None):
    """Fresh per-layer caches for a prefill (``generation.py:574-592``):
    dense K/V, or the trunk's own layout where it has an
    ``empty_cache_layer`` hook (MLA's compressed latent). ``pos`` starts at
    the int 0 and ``prefill`` marks the first forward, which routes the
    unpadded prompt to the flash kernel; the attention's returned cache
    leaves the marker out, so the first forward consumes it."""
    from .models.llama import head_dim_of, torch_dtype

    cfg = model.config
    shape = (batch, max_len, cfg.num_key_value_heads, head_dim_of(cfg))
    dt = torch_dtype(cfg.dtype)
    make = getattr(model.llama, "empty_cache_layer", None)
    caches = []
    for _ in range(cfg.num_hidden_layers):
        if make is not None:
            c = dict(make(batch, max_len, dt), pos=0, prefill=True)
        else:
            c = {"k": torch.zeros(shape, dtype=dt, device=model.device),
                 "v": torch.zeros(shape, dtype=dt, device=model.device),
                 "pos": 0, "prefill": True}
        if allowed is not None:
            c["allowed"] = allowed
        caches.append(c)
    return caches


class _PrefillStep:
    """The whole prefill as one call: empty caches -> all layers -> each
    row's last real logit. Returns (last [B, V], caches)."""

    def __init__(self, model, max_len, ragged, rope_len=None):
        self._model = model
        self._max_len = max_len
        self._ragged = ragged
        self._rope_len = max_len if rope_len is None else rope_len

    @torch.inference_mode()
    def __call__(self, ids, lengths, pad_mask):
        model = self._model
        caches = _empty_caches(model, ids.shape[0], self._max_len,
                               allowed=pad_mask if self._ragged else None)
        hidden, caches = model.llama.forward_cached(ids, caches,
                                                    rope_len=self._rope_len)
        idx = (lengths.long() - 1)[:, None, None].expand(-1, 1,
                                                         hidden.shape[-1])
        h_last = torch.gather(hidden, 1, idx)
        return model.lm_head_logits(h_last)[:, 0, :], caches


def _sample_and_forward(model, max_len, last, generator, caches, do_sample,
                        temperature, top_k, top_p, sampler=None):
    """Sample from ``last``, run one cached forward, return (token,
    chosen-token logprob under the raw distribution of ``last``, next
    logits, caches)."""
    if sampler is not None:
        nxt = sampler(last, generator)
    else:
        nxt = sample_logits(last, generator, do_sample=do_sample,
                            temperature=temperature, top_k=top_k, top_p=top_p)
    lp = torch.log_softmax(last.float(), dim=-1)[
        torch.arange(last.shape[0], device=last.device), nxt]
    token = nxt[:, None].to(torch.int32)
    hidden, new_caches = model.llama.forward_cached(token, caches,
                                                    rope_len=max_len)
    logits = model.lm_head_logits(hidden)
    return nxt, lp, logits[:, -1, :], new_caches


class _SelectDecodeStep:
    """Sample + one cached forward: the continuous-batching engine's
    per-step unit with engine-wide sampling settings."""

    def __init__(self, model, max_len, do_sample, temperature, top_k, top_p):
        self._model, self._max_len = model, max_len
        self._cfg = (do_sample, temperature, top_k, top_p)

    @torch.inference_mode()
    def __call__(self, last, generator, caches):
        nxt, lp, last_n, caches = _sample_and_forward(
            self._model, self._max_len, last, generator, caches, *self._cfg)
        return nxt, lp, last_n.float(), caches


class _SelectDecodeRowsStep:
    """``_SelectDecodeStep`` with per-row sampling settings ([B] tensors)."""

    def __init__(self, model, max_len):
        self._model, self._max_len = model, max_len

    @torch.inference_mode()
    def __call__(self, last, generator, do_s, temp, tk, tp, caches):
        nxt, lp, last_n, caches = _sample_and_forward(
            self._model, self._max_len, last, generator, caches,
            None, None, None, None,
            sampler=lambda lg, g: sample_logits_rows(lg, g, do_s, temp, tk,
                                                     tp))
        return nxt, lp, last_n.float(), caches


class _SpecDecodeStep:
    """Greedy speculative decode unit of the engine, one eager call per
    round: argmax of the carried logits (the token a one-token step would
    emit, g0), a k-token chunk [g0, d_1..d_{k-1}] of host-proposed drafts
    through the paged cache at per-row positions, and the longest accepted
    run computed on the device. Returns (chunk [B, k], emitted count
    [B] = accepted + 1, logprobs [B, k] under the raw distributions, the
    logits row after the last emitted token [B, V] f32, caches).

    Token identity holds by construction: draft j is emitted only when it
    equals the target's greedy choice at its position."""

    def __init__(self, model, max_len):
        self._model, self._max_len = model, max_len

    @torch.inference_mode()
    def __call__(self, last, drafts, caches):
        B = last.shape[0]
        rows = torch.arange(B, device=last.device)
        g0 = torch.argmax(last, dim=-1).to(torch.int32)
        chunk = torch.cat([g0[:, None], drafts], dim=1)          # [B, k]
        hidden, caches = self._model.llama.forward_cached(
            chunk, caches, rope_len=self._max_len)
        logits = self._model.lm_head_logits(hidden).float()    # [B, k, V]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = (drafts == greedy[:, :-1]).to(torch.int32)         # [B, k-1]
        n_acc = torch.cumprod(ok, dim=1).sum(dim=1)             # [B]
        # the logits after the last emitted token seed the next round
        new_last = logits[rows, n_acc]
        lp0 = torch.log_softmax(last.float(), dim=-1)[rows, g0.long()]
        lpd = torch.log_softmax(logits[:, :-1], dim=-1).gather(
            2, drafts.long()[:, :, None])[:, :, 0]
        lps = torch.cat([lp0[:, None], lpd], dim=1)
        return chunk, n_acc + 1, lps, new_last, caches
