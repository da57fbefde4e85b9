"""Cached attention, sampling, the step units and ``generate``.

Counterpart of the decoder-only parts of ``paddle_tpu/generation.py``: rope
at per-row positions, attention against a dense cache (``cached_attention``)
and the paged pool (``paged_cached_attention`` for one token or a
speculative-verify chunk, ``paged_decode_attention``), sampling (with the
repetition penalty, the eos block and the n-gram ban), the prefill units
(one-shot and chunked), the decode units (one token, the fused sample +
forward loop, the engine's per-row and speculative units, the beam step),
and ``generate`` / ``generate_paged`` with greedy, sampled and beam
decoding over dense, ragged, paged and chunked-prefill caches.

The JAX package's jitted step objects become ``jit.cuda_graph.GraphedStep``
units with the same inputs and outputs, memoized per model by the same
getters (``_memoized_step``): eager on CPU tensors, one captured CUDA graph
per input signature replayed on CUDA tensors. Its ``lax.scan`` loops are
Python loops over one unit. Where JAX returns updated buffers
functionally, the port writes the cache in place and says so. Where JAX
folds a step index into a ``jax.random`` key, the port draws from one
explicit ``torch.Generator`` (``framework.random.default_generator``).

The dense caches a prefill writes, and the paged pools ``generate_paged``
re-lays them into, are made once per shape and kept (``_cache_buffers``,
``_caches_to_paged``): a prefill writes them in place, so the decode
graph that reads them (their addresses are in a graph's signature) serves
every later call of the same batch and ``max_len``, whatever the prompt
length.

What stays eager, with its reason: the chunked prefill (a host loop over
chunks whose first chunk routes on the host; JAX scans it), the host-side
selection with a repetition penalty or an n-gram ban (``_next_token``; JAX
selects on the host there too, and only the forward, ``_DecodeStep``, is
replayed), the no-cache path and the paged re-layout of a prefill.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ops.hopper import fused_norm
from .jit.cuda_graph import GraphedStep
from .ops.hopper.append_attention import (append_attention,
                                          append_attention_plain,
                                          chunk_positions,
                                          grouped_attention_plain,
                                          plain_width)
from .ops.hopper.flash_attention import flash_attention_bshd
from .ops.hopper.paged_attention import (gather_pages, paged_attention,
                                         paged_attention_plain)


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
                     softcap=None, rope_applied=False):
    """RoPE + cache write + masked grouped-query attention against a dense
    buffer. q [B,S,H,D]; k/v [B,S,hk,D]; cos/sin [>= T, rope_dim];
    k_buf/v_buf [B,T,hk,D], written IN PLACE at ``pos`` (JAX returns new
    buffers; the port updates the caller's); ``pos`` the one-element int32
    tensor on q's device that the dense caches carry (as the Pallas append
    kernel takes it by scalar prefetch, so one CUDA graph of a decode step
    serves every position; an int is taken too); ``allowed`` optional
    [B,T] column mask (padded prompts); ``row_pos`` optional [B] per-row
    rope positions. Routing as in the JAX package
    (``generation.py:102-128``), decided on the host:

    - an unpadded first prefill (``prefill``) of S > 1 tokens with
      ``use_flash`` takes ``flash_attention_bshd``
      (causal attention over the prompt is causal self-attention on the S
      new tokens), with or without a sliding window: the causal or the
      LocalMask flash kernel;
    - any other windowless chunk the append-attention kernel (the mask
      counts buffer slots, so per-row rope positions do not change it). On
      CUDA it also takes single tokens and ``use_flash=False``;
    - any other windowed chunk (pos > 0, a padded prompt, a single token)
      the f32 einsum, ``append_attention_plain``, as the JAX package's
      einsum branch (no kernel there either);
    - any chunk with ``softcap`` (Gemma2's capped scores; the caller
      passes ``use_flash`` False, as JAX does) the same einsum with the
      cap applied before the masks (``generation.py:135-137``): no
      kernel computes capped scores, in JAX or here;
    - any chunk at a head width with no kernel instance that JAX's gates
      refuse too (``append_attention.plain_width``: not in ``WIDTHS`` and
      D % 128 != 0, Phi-3's 96) the same einsum, as JAX's flash and
      append gates send it there. At (64, 64) the port keeps its kernels
      (the flash forward, append attention) where JAX runs the einsum.

    The wrappers run their plain versions on CPU tensors. The rope rows
    and the cache slots are taken by index at ``pos + arange(S)``.
    ``rope_applied``: q and k arrive rotated (the fused decode tail).
    Returns (out [B,S,H,D], k_buf, v_buf)."""
    S = q.shape[1]
    idx = chunk_positions(pos, S, q.device)
    if not rope_applied:
        if row_pos is None:
            c, s = cos.index_select(0, idx), sin.index_select(0, idx)
            q = fused_norm.rope_ref(q, c, s)
            k = fused_norm.rope_ref(k, c, s)
        else:
            q = _rope_rows(q, cos, sin, row_pos)
            k = _rope_rows(k, cos, sin, row_pos)
    k_buf.index_copy_(1, idx, k.to(k_buf.dtype))
    v_buf.index_copy_(1, idx, v.to(v_buf.dtype))

    kernel = not plain_width(q.shape[-1], v_buf.shape[-1])
    if (kernel and use_flash and S > 1 and allowed is None
            and row_pos is None and prefill):
        out = flash_attention_bshd(q, k, v, causal=True, window=window)
    elif kernel and window is None and softcap is None:
        out = append_attention(q, k_buf, v_buf, pos, allowed=allowed)
    else:
        out = append_attention_plain(q, k_buf, v_buf, pos, allowed, window,
                                     softcap=softcap)
    return out, k_buf, v_buf


def paged_cached_attention(q, k, v, cos, sin, k_pages, v_pages, page_indices,
                           lengths, page_size, window=None, softcap=None,
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
                                     page_indices, window=window,
                                     softcap=softcap)
        return out, k_pages, v_pages
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 lengths + 1, page_indices, window=window,
                                 softcap=softcap)
    return out[:, None], k_pages, v_pages


def _paged_chunk_attention(q, k_pages, v_pages, lengths, page_indices,
                           window=None, softcap=None):
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
    return _chunk_sdpa(q, k, v, valid, softcap=softcap)


def _chunk_sdpa(q, k, v, valid, softcap=None):
    """Decode / verify attention core: q [B,S,H,D] against gathered k / v
    [B,hk,T,D] with a column mask valid [B,S,T]; f32 scores and softmax;
    ``softcap``: Gemma2's tanh cap on the scaled scores, before the mask."""
    return grouped_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                   valid, 1.0 / math.sqrt(q.shape[-1]),
                                   softcap)


def _banded_sdpa(q, k, v, valid, softcap=None):
    """The S=1 view of :func:`_chunk_sdpa`: q [B,H,D] against gathered
    k / v [B,hk,T,D] with a column mask valid [B,T]."""
    return _chunk_sdpa(q[:, None], k, v, valid[:, None],
                       softcap=softcap)[:, 0]


def _pool_index(pages, rows, slot):
    """Index tuple addressing pages[:, rows[b, j], slot[b, j]] for every KV
    head (``index_put_`` takes tensors only, so the head axis is spelled
    out)."""
    hk = pages.shape[0]
    heads = torch.arange(hk, device=pages.device)[:, None, None]
    return heads, rows[None], slot[None]


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           window=None, softcap=None):
    """Decode attention over the paged pool: the paged-attention kernel on
    CUDA (its plain version on the CPU). A sliding window narrower than the
    cache (``generation.py:260-266``) takes ``_paged_window_attention``,
    PyTorch on every device as it is XLA in the JAX package: the kernel has
    no lower edge, and the band gather reads O(window), not O(max_len). A
    window as wide as the cache never excludes a column: the kernel, unless
    the scores are capped (``softcap``, Gemma2): the kernel computes
    uncapped scores, so capped rows take the exact gather reference
    (``paged_attention_plain``, JAX's ``_paged_attention_ref``) on every
    device, as in JAX (``generation.py:271-276``)."""
    if window is not None and window < page_indices.shape[1] * k_pages.shape[2]:
        return _paged_window_attention(q, k_pages, v_pages, lengths,
                                       page_indices, window, softcap=softcap)
    if softcap is not None:
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_indices, softcap=softcap)
    return paged_attention(q, k_pages, v_pages, lengths.to(torch.int32),
                           page_indices)


def _paged_window_attention(q, k_pages, v_pages, lengths, page_indices,
                            window, softcap=None):
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
    return _banded_sdpa(q, k, v, valid, softcap=softcap)


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


def top_p_sampling(x, ps, threshold=None, seed=None):
    """``paddle.tensor.top_p_sampling`` (``generation.py:445``): nucleus
    sample one token per row of probabilities ``x`` [B, V] with per-row
    cutoffs ``ps`` [B]. ``seed`` >= 0 draws from a generator seeded with
    it, else from the port's default generator on ``x``'s device;
    ``threshold`` is accepted and unused, as in the JAX package. Returns
    (scores [B], ids [B])."""
    from .framework.random import default_generator

    if seed is not None and seed >= 0:
        generator = torch.Generator(device=x.device).manual_seed(int(seed))
    else:
        generator = default_generator(x.device)
    probs = x.float()
    logits = torch.log(torch.clamp(probs, min=1e-38))
    srt = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(srt, dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < ps.float()[..., None]], dim=-1)
    min_prob = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                           ).min(dim=-1, keepdim=True).values
    filtered = logits.masked_fill(probs < min_prob, float("-inf"))
    ids = _categorical(filtered, generator)
    return torch.gather(probs, -1, ids[:, None])[:, 0], ids


def _select(logits_last, generator, do_sample, temperature, top_k, top_p):
    return sample_logits(logits_last, generator, do_sample=do_sample,
                         temperature=temperature, top_k=top_k, top_p=top_p)


def _select_penalized(logits_last, seen, generator, do_sample, temperature,
                      top_k, top_p, rp, block_eos, eos_id):
    """``_select`` with the HF repetition penalty (positive logits of seen
    tokens divided by ``rp``, negative ones multiplied) and an optional
    eos block (the ``min_new_tokens`` phase)."""
    lg = logits_last.float()
    if rp != 1.0:
        pen = torch.where(lg > 0, lg / rp, lg * rp)
        lg = torch.where(seen, pen, lg)
    if block_eos:
        lg = lg.clone()
        lg[:, eos_id] = float("-inf")
    return sample_logits(lg, generator, do_sample=do_sample,
                         temperature=temperature, top_k=top_k, top_p=top_p)


class _NgramBan:
    """Incremental HF ``NoRepeatNGramLogitsProcessor`` (host code, exact):
    per row, (n-1)-gram prefix -> set of banned completions, updated in
    O(1) per appended token."""

    def __init__(self, histories, n: int):
        self.n = n
        self.hist = [list(h) for h in histories]
        self.maps = [{} for _ in self.hist]
        for b, h in enumerate(self.hist):
            for j in range(len(h) - n + 1):
                self.maps[b].setdefault(tuple(h[j:j + n - 1]),
                                        set()).add(h[j + n - 1])

    def append(self, b: int, tok: int):
        h = self.hist[b]
        h.append(tok)
        if len(h) >= self.n:
            self.maps[b].setdefault(tuple(h[-self.n:-1]), set()).add(h[-1])

    def banned(self, vocab: int):
        """[B, V] numpy mask of the tokens that would complete an n-gram
        each row has already seen after its current suffix."""
        out = np.zeros((len(self.hist), vocab), bool)
        for b, h in enumerate(self.hist):
            if len(h) < self.n - 1 and self.n > 1:
                continue
            prefix = tuple(h[-(self.n - 1):]) if self.n > 1 else ()
            for t in self.maps[b].get(prefix, ()):
                out[b, t] = True
        return out


def _ngram_banned(histories, n, vocab):
    """[B, V] mask (one-shot form; the decode loops keep a ``_NgramBan``)."""
    return _NgramBan(histories, n).banned(vocab)


def _select_next(last, seen, generator, do_sample, temperature, top_k,
                 top_p, rp, i, min_new, eos_token_id):
    """Next-token selection at step ``i``: the plain ``_select`` whenever
    no penalty applies (rp == 1 and the eos-block phase is over), else
    ``_select_penalized``."""
    if rp == 1.0 and i >= min_new:
        return _select(last, generator, do_sample, float(temperature),
                       int(top_k), float(top_p))
    if seen is None:
        seen = torch.zeros(last.shape[0], 1, dtype=torch.bool,
                           device=last.device)
    return _select_penalized(
        last, seen, generator, do_sample, float(temperature), int(top_k),
        float(top_p), rp, i < min_new,
        int(eos_token_id) if eos_token_id is not None else -1)


def _seen_from_prompt(ids, vocab, pad_mask=None):
    """[B, V] flag of the tokens present in each row's prompt (pad columns
    excluded): the repetition penalty's working set."""
    B, S0 = ids.shape
    upd = (pad_mask[:, :S0].bool() if pad_mask is not None
           else torch.ones(B, S0, dtype=torch.bool, device=ids.device))
    # pad columns scatter into a spare column past the vocabulary
    idx = torch.where(upd, ids.long(), vocab)
    seen = torch.zeros(B, vocab + 1, dtype=torch.bool, device=ids.device)
    seen.scatter_(1, idx, True)
    return seen[:, :vocab]


# ---------------------------------------------------------------------------
# step units and their memoization
# ---------------------------------------------------------------------------

def _trace_flags_key() -> tuple:
    """The flag values a unit's graph depends on, as THIS thread sees them
    (its ``flag_overrides`` included), folded into every memoization key
    (``generation.py:997``): a unit captured with the fused decode tail on
    is never replayed with it off."""
    from .utils.flags import flag

    return (bool(flag("FLAGS_use_fused_decode_tail")),)


def _lru(owner, attr, key, factory, maxsize=None):
    """``owner.<attr>[key]``, made by ``factory`` on a miss. ``maxsize``
    evicts the least recently used entry; a hit re-inserts its key at the
    back. Returns (value, hit)."""
    cache = owner.__dict__.get(attr)
    if cache is None:
        cache = {}
        object.__setattr__(owner, attr, cache)
    value = cache.get(key)
    if value is None:
        value = factory()
        if maxsize is not None and len(cache) >= maxsize:
            cache.pop(next(iter(cache)))
        cache[key] = value
        return value, False
    if maxsize is not None:
        cache.pop(key)
        cache[key] = value
    return value, True


def _memoized_step(model, attr, key, factory, maxsize=None):
    """Per-model step memoization (``generation.py:1009``): one unit per
    (key, flag fingerprint) in ``model.<attr>``, so its CUDA graphs are
    captured once and replayed by every later call. A hit re-checks the
    model's current weights (``refresh_weights``: a replaced parameter
    drops the unit's graphs, as JAX re-reads the state on a hit).
    ``maxsize`` evicts the least recently used entry: a hit re-inserts its
    key at the back."""
    step, hit = _lru(model, attr, (key, _trace_flags_key()), factory,
                     maxsize)
    refresh = getattr(step, "refresh_weights", None)
    if hit and refresh is not None:
        refresh()
    return step


#: cache buffer sets ``generate`` keeps per model (one per batch, max_len
#: and layout), least recently used dropped first
CACHE_SETS = 4


def _cache_buffers(model, batch, max_len, ragged, owner=None,
                   maxsize=None):
    """The per-layer cache buffers a prefill writes (``generation.py:
    565-592``): dense K/V [batch, max_len, hk, D], or the trunk's own layout
    where it has an ``empty_cache_layer`` hook (MLA's compressed latent);
    for a ragged prefill every layer's dict also holds one [batch,
    max_len] bool column mask ``allowed``. Made once per (batch, max_len)
    and kept in ``owner`` (LRU ``maxsize``), or made anew without one. A
    prefill zeroes and writes them in place, so the decode graphs over
    them serve every later call of the shape. Returns new dicts around the
    kept tensors."""
    from .models.llama import head_dim_of, torch_dtype

    def make():
        cfg = model.config
        shape = (batch, max_len, cfg.num_key_value_heads, head_dim_of(cfg))
        dt = torch_dtype(cfg.dtype)
        hook = getattr(model.llama, "empty_cache_layer", None)
        layers = [hook(batch, max_len, dt) if hook is not None else
                  {"k": torch.zeros(shape, dtype=dt, device=model.device),
                   "v": torch.zeros(shape, dtype=dt, device=model.device)}
                  for _ in range(cfg.num_hidden_layers)]
        return layers, torch.ones(batch, max_len, dtype=torch.bool,
                                  device=model.device)

    if owner is None:
        layers, allowed = make()
    else:
        (layers, allowed), _ = _lru(owner, "_cache_sets", (batch, max_len),
                                    make, maxsize)
    return [dict(c, allowed=allowed) if ragged else dict(c) for c in layers]


def _start_caches(caches, pad_mask, device):
    """The caches of a prefill's first forward over the buffers ``caches``
    (``_cache_buffers``): zeroed in place, as JAX makes them anew; a
    ragged prefill's ``pad_mask`` copied into their column mask; every
    layer at one device int32 ``pos`` of 0 with the ``prefill`` marker,
    which routes an unpadded first chunk to the flash kernel (the
    attention's returned cache leaves the marker out, so the first forward
    consumes it)."""
    torch._foreach_zero_([t for c in caches for n, t in c.items()
                          if n != "allowed"])
    if "allowed" in caches[0]:
        caches[0]["allowed"].copy_(pad_mask)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return [dict(c, pos=pos, prefill=True) for c in caches]


class _Step(GraphedStep):
    """A step unit of ``model`` over caches of ``max_len`` slots, its rope
    tables ``rope_len`` (default ``max_len``) long. Before a capture's
    warm-ups it makes the rope table and the decode tail's state of the
    capture stream (``prepare``)."""

    def __init__(self, model, max_len, rope_len=None):
        super().__init__(model)
        self._max_len = max_len
        self._rope_len = max_len if rope_len is None else rope_len

    def prepare(self, device):
        from .ops.hopper import decode_tail

        self._model.llama._rope(self._rope_len)
        decode_tail.prepare_stream(device)


class _PrefillStep(_Step):
    """The whole prefill as one call: the cache buffers zeroed -> all
    layers -> each row's last real logit. ``caches``: the buffers to write
    in place (``_cache_buffers``, with ``allowed`` when ``ragged``); new
    ones when not given. Returns (last [B, V], caches), the caches' ``pos``
    a device int32."""

    cache_arg = 3

    def __init__(self, model, max_len, ragged, rope_len=None):
        super().__init__(model, max_len, rope_len)
        self._ragged = ragged

    def __call__(self, ids, lengths, pad_mask, caches=None):
        if caches is None:
            caches = _cache_buffers(self._model, ids.shape[0],
                                    self._max_len, self._ragged)
        return super().__call__(ids, lengths, pad_mask, caches)

    @torch.inference_mode()
    def eager(self, ids, lengths, pad_mask, caches):
        model = self._model
        caches = _start_caches(caches, pad_mask, ids.device)
        hidden, caches = model.llama.forward_cached(ids, caches,
                                                    rope_len=self._rope_len)
        idx = (lengths.long() - 1)[:, None, None].expand(-1, 1,
                                                         hidden.shape[-1])
        h_last = torch.gather(hidden, 1, idx)
        return model.lm_head_logits(h_last)[:, 0, :], caches


def _get_prefill_step(model, max_len, ragged, rope_len=None):
    # max_len varies per request: bound the cache
    return _memoized_step(model, "_prefill_steps",
                          (max_len, ragged, rope_len),
                          lambda: _PrefillStep(model, max_len, ragged,
                                               rope_len=rope_len),
                          maxsize=16)


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


class _SelectDecodeStep(_Step):
    """Sample + one cached forward with one set of sampling settings: the
    engine's per-step unit and each step of ``generate``'s fixed-length
    loop. Returns (token [B], logprob [B], next logits [B, V] f32,
    caches)."""

    cache_arg = 2

    def __init__(self, model, max_len, do_sample, temperature, top_k, top_p):
        super().__init__(model, max_len)
        self._cfg = (do_sample, temperature, top_k, top_p)

    @torch.inference_mode()
    def eager(self, last, generator, caches):
        nxt, lp, last_n, caches = _sample_and_forward(
            self._model, self._max_len, last, generator, caches, *self._cfg)
        return nxt, lp, last_n.float(), caches


def _get_select_decode(model, max_len, do_sample, temperature, top_k, top_p):
    key = (max_len, do_sample, float(temperature), int(top_k), float(top_p))
    return _memoized_step(
        model, "_select_decode_steps", key,
        lambda: _SelectDecodeStep(model, max_len, do_sample,
                                  float(temperature), int(top_k),
                                  float(top_p)))


class _SelectDecodeRowsStep(_Step):
    """``_SelectDecodeStep`` with per-row sampling settings ([B] tensors)."""

    cache_arg = 6

    @torch.inference_mode()
    def eager(self, last, generator, do_s, temp, tk, tp, caches):
        nxt, lp, last_n, caches = _sample_and_forward(
            self._model, self._max_len, last, generator, caches,
            None, None, None, None,
            sampler=lambda lg, g: sample_logits_rows(lg, g, do_s, temp, tk,
                                                     tp))
        return nxt, lp, last_n.float(), caches


def _get_select_decode_rows(model, max_len):
    return _memoized_step(
        model, "_select_decode_rows_steps", (max_len,),
        lambda: _SelectDecodeRowsStep(model, max_len))


class _SpecDecodeStep(_Step):
    """Greedy speculative decode unit of the engine, one call per round:
    argmax of the carried logits (the token a one-token step would emit,
    g0), a k-token chunk [g0, d_1..d_{k-1}] of host-proposed drafts
    through the paged cache at per-row positions, and the longest accepted
    run computed on the device. Returns (chunk [B, k], emitted count
    [B] = accepted + 1, logprobs [B, k] under the raw distributions, the
    logits row after the last emitted token [B, V] f32, caches).

    Token identity holds by construction: draft j is emitted only when it
    equals the target's greedy choice at its position."""

    cache_arg = 2

    @torch.inference_mode()
    def eager(self, last, drafts, caches):
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


def _get_spec_decode(model, max_len, k):
    return _memoized_step(
        model, "_spec_decode_steps", (max_len, int(k)),
        lambda: _SpecDecodeStep(model, max_len), maxsize=8)


class _DecodeStep(_Step):
    """One cached forward for a generated token (``generation.py:631``):
    embed, all layers (the caches written in place), lm-head logits.
    Returns (logits [B, S, V], caches)."""

    cache_arg = 1

    @torch.inference_mode()
    def eager(self, token, caches):
        hidden, caches = self._model.llama.forward_cached(
            token, caches, rope_len=self._max_len)
        return self._model.lm_head_logits(hidden), caches


def _get_decode_step(model, max_len):
    return _memoized_step(model, "_decode_steps", max_len,
                          lambda: _DecodeStep(model, max_len))


class _ChunkedPrefillStep:
    """Prefill over fixed-size prompt chunks (``generation.py:1062``): chunk
    c writes cache slots [cC, cC + C) and attends to every earlier slot
    through the cache's position and column masks, so the result is the
    one-shot prefill's. The running last-real hidden [B, hidden] is carried
    from chunk to chunk, as the JAX scan carries it, and only it reaches
    the lm head. ``caches``: the buffers to write in place
    (``_cache_buffers``).

    Route: chunk 0 carries the ``prefill`` marker, so an unpadded prompt's
    first chunk (no column mask) takes the flash kernel, and every later
    chunk (or every chunk of a padded prompt) the append-attention kernel;
    windowed chunks past 0 take the f32 einsum. The JAX scan carries a
    traced pos, so there every chunk takes append attention; both routes
    are exact. A host loop over the chunks, run eagerly (never captured).
    Returns (last [B, V], caches)."""

    def __init__(self, model, max_len, chunk, n_chunks):
        self._model, self._max_len = model, max_len
        self._chunk, self._n = int(chunk), int(n_chunks)

    @torch.inference_mode()
    def __call__(self, ids_pad, lengths, allowed, caches):
        from .models.llama import torch_dtype

        model, C = self._model, self._chunk
        B = ids_pad.shape[0]
        caches = _start_caches(caches, allowed, ids_pad.device)
        h_last = torch.zeros(B, model.config.hidden_size,
                             dtype=torch_dtype(model.config.dtype),
                             device=ids_pad.device)
        for n in range(self._n):
            hidden, caches = model.llama.forward_cached(
                ids_pad[:, n * C:(n + 1) * C], caches,
                rope_len=self._max_len)
            idx = lengths.long() - 1 - n * C
            in_chunk = (idx >= 0) & (idx < C)
            picked = torch.gather(
                hidden, 1, torch.clamp(idx, 0, C - 1)[:, None, None].expand(
                    -1, 1, hidden.shape[-1]))[:, 0]
            h_last = torch.where(in_chunk[:, None], picked, h_last)
        return model.lm_head_logits(h_last[:, None, :])[:, 0, :], caches


def _rows_match(a, n):
    """True for tensors whose leading axis is the batch / beam rows: the
    one predicate of beam tiling and of the beam-reorder take."""
    return hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == n


class _BeamStep(_Step):
    """Beam-search decode unit (``generation.py:736``): take the cache rows
    each surviving beam came from (the buffers, and the ``allowed`` and
    ``row_pos`` rows; ``index_select`` makes new buffers, as JAX's take),
    run the cached forward on the chosen tokens, return the next position's
    f32 log-probs [B*K, V] and the caches."""

    cache_arg = 2

    @torch.inference_mode()
    def eager(self, token, row_idx, caches):
        n = row_idx.shape[0]
        caches = [{k: (torch.index_select(v, 0, row_idx)
                       if _rows_match(v, n) else v) for k, v in c.items()}
                  for c in caches]
        hidden, caches = self._model.llama.forward_cached(
            token, caches, rope_len=self._max_len)
        logits = self._model.lm_head_logits(hidden)
        return torch.log_softmax(logits[:, -1, :].float(), dim=-1), caches


def _get_beam_step(model, max_len):
    return _memoized_step(model, "_beam_steps", (max_len,),
                          lambda: _BeamStep(model, max_len))


class _BeamHyps:
    """Per-batch pool of finished hypotheses (HF ``BeamHypotheses``: scores
    are sum-logprob / len**length_penalty over the generated tokens)."""

    def __init__(self, k, length_penalty, early_stopping):
        self.k, self.lp, self.early = k, length_penalty, early_stopping
        self.items = []  # (score, tokens list)

    def add(self, sum_logprob, tokens):
        score = sum_logprob / (max(len(tokens), 1) ** self.lp)
        self.items.append((score, tokens))
        self.items.sort(key=lambda t: -t[0])
        del self.items[self.k:]

    def is_done(self, best_running_sum, cur_len):
        if len(self.items) < self.k:
            return False
        if self.early:
            return True
        return (best_running_sum / (max(cur_len, 1) ** self.lp)
                <= self.items[-1][0])


def _beam_search(model, last, caches, max_len, max_new_tokens, num_beams,
                 eos_token_id, length_penalty, early_stopping, rp=1.0,
                 histories0=None, min_new=0, ngram=0):
    """Host-scored beam search over the cached decode path
    (``generation.py:792``): ``last`` / ``caches`` come from the B-row
    prefill; the beams live as B*K cache rows, reordered by ``_BeamStep``.
    One device-to-host copy of the log-probs per step. Returns [B, width]
    int64 on the model's device."""
    B = last.shape[0]
    K = num_beams
    caches = [{k: (torch.repeat_interleave(v, K, dim=0)
                   if _rows_match(v, B) else v) for k, v in c.items()}
              for c in caches]
    step_fn = _get_beam_step(model, max_len)
    holder = {"caches": caches}
    dev = last.device

    def step(token, row_idx):
        logp, holder["caches"] = step_fn(
            token.to(dev), torch.from_numpy(row_idx).to(dev),
            holder["caches"])
        return logp.cpu().numpy()

    logp0 = torch.log_softmax(last.float(), dim=-1).cpu().numpy()
    arr = beam_search_loop(logp0, step, max_new_tokens, K, eos_token_id,
                           length_penalty, early_stopping, rp=rp,
                           histories0=histories0, min_new=min_new,
                           ngram=ngram)
    return torch.from_numpy(arr).to(dev)


def beam_search_loop(logp0, step, max_new_tokens, num_beams, eos_token_id,
                     length_penalty, early_stopping, rp=1.0, histories0=None,
                     min_new=0, ngram=0):
    """The host scoring loop of beam search (``generation.py:822``), apart
    from the model: ``logp0`` np [B, V] log-probs of the first position,
    ``step(token [B*K, 1] int64 CPU tensor, row_idx np [B*K]) -> np
    [B*K, V]`` the next position's, the beam-origin reorder being the
    step's own. numpy throughout, the JAX function's arithmetic and order,
    so the two agree bit for bit on the same log-probs. Returns np
    [B, width]."""
    B, V = logp0.shape
    K = num_beams
    logp0 = np.repeat(logp0, K, axis=0).reshape(B, K, V)
    # beam 0 seeds the search; the copies start at -inf so step 1's top-k
    # cannot pick the same token K times
    cum = np.full((B, K), -np.inf, np.float64)
    cum[:, 0] = 0.0
    hyps = [_BeamHyps(K, length_penalty, early_stopping) for _ in range(B)]
    done = [False] * B
    beams_tokens = [[[] for _ in range(K)] for _ in range(B)]
    logp = logp0

    # the prompts' n-gram maps are built once per row: each step hashes only
    # the generated tail (and the boundary n-grams through the prompt's
    # last n-1 tokens)
    base_maps = ([_NgramBan([h], ngram) for h in histories0]
                 if (ngram and histories0 is not None) else None)
    prompt_sets = ([set(h) for h in histories0]
                   if (rp != 1.0 and histories0 is not None) else None)

    def _process(scores, step_i):
        """HF beam-search processor order on the [B, K, V] scores."""
        eos_active = bool(min_new and eos_token_id is not None
                          and step_i < min_new)
        if (histories0 is None and not eos_active) or all(done):
            return scores
        out = np.array(scores, np.float64)
        for b in range(B):
            if done[b] or histories0 is None:
                continue
            prompt = histories0[b]
            tail = prompt[-(ngram - 1):] if ngram > 1 else []
            for j in range(K):
                gen = beams_tokens[b][j]
                row = out[b, j]
                if rp != 1.0 and (prompt or gen):
                    idx = np.fromiter(prompt_sets[b] | set(gen), np.int64)
                    vals = row[idx]
                    row[idx] = np.where(vals < 0, vals * rp, vals / rp)
                if ngram:
                    hist = prompt + gen
                    prefix = (tuple(hist[-(ngram - 1):]) if ngram > 1
                              else ())
                    banned = set(base_maps[b].maps[0].get(prefix, ()))
                    banned |= _NgramBan([tail + gen], ngram).maps[0].get(
                        prefix, set())
                    if banned:
                        row[list(banned)] = -np.inf
        if eos_active:
            out[:, :, eos_token_id] = -np.inf
        return out

    for i in range(max_new_tokens):
        logp_p = _process(logp, i)
        total = cum[:, :, None] + logp_p        # [B, K, V] float64 scores
        flat = total.reshape(B, K * V)
        # 2K candidates per batch row (eos hits may retire, HF convention)
        part = np.argpartition(-flat, 2 * K - 1, axis=1)[:, : 2 * K]
        order = np.argsort(-np.take_along_axis(flat, part, axis=1), axis=1)
        top = np.take_along_axis(part, order, axis=1)
        next_tokens = []
        next_origin = []
        next_cum = []
        for b in range(B):
            if done[b]:
                next_tokens.append([0] * K)
                next_origin.append([b * K] * K)
                next_cum.append([-np.inf] * K)
                continue
            toks, orig, cums = [], [], []
            for rank, cand in enumerate(top[b]):
                beam, tok = divmod(int(cand), V)
                score = flat[b, cand]
                if eos_token_id is not None and tok == eos_token_id:
                    if rank < K:  # only top-K eos candidates retire
                        hyps[b].add(score, beams_tokens[b][beam] + [tok])
                    continue
                toks.append(tok)
                orig.append(b * K + beam)
                cums.append(score)
                if len(toks) == K:
                    break
            next_tokens.append(toks)
            next_origin.append(orig)
            next_cum.append(cums)
            beams_tokens[b] = [beams_tokens[b][orig[j] - b * K] +
                               [toks[j]] for j in range(K)]
            # HF passes the max over all 2K candidates (eos hits included)
            # as the best running sum
            if hyps[b].is_done(float(flat[b, top[b][0]]), i + 1):
                done[b] = True
        if all(done) or i == max_new_tokens - 1:
            for b in range(B):
                if not done[b] or not hyps[b].items:
                    # flush the running beams at the length limit
                    for j in range(K):
                        if np.isfinite(next_cum[b][j]):
                            hyps[b].add(next_cum[b][j], beams_tokens[b][j])
            break
        cum = np.asarray(next_cum, np.float64)
        row_idx = np.asarray(next_origin, np.int32).reshape(-1)
        token = torch.from_numpy(
            np.asarray(next_tokens, np.int64).reshape(-1, 1))
        logp = step(token, row_idx).reshape(B, K, V)

    outs = []
    for b in range(B):
        if hyps[b].items:
            outs.append(hyps[b].items[0][1])
        else:  # no finished hypothesis: the best running beam
            outs.append(beams_tokens[b][int(np.argmax(cum[b]))])
    width = max(1, max(len(o) for o in outs))
    fill = eos_token_id if eos_token_id is not None else 0
    arr = np.full((B, width), fill, np.int64)
    for b, o in enumerate(outs):
        arr[b, : len(o)] = o
    return arr


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

#: defaults of the decoder-only ``generate`` below: encoder-decoder
#: families accept these keywords when passed at their default and raise
#: only on another value
GENERATE_DEFAULTS = {
    "use_cache": True, "paged": False, "page_size": 16,
    "prefill_chunk_size": None, "repetition_penalty": 1.0,
    "min_new_tokens": 0, "num_beams": 1, "length_penalty": 1.0,
    "early_stopping": False, "no_repeat_ngram_size": 0,
}


def reject_non_default_kwargs(family: str, kwargs: dict):
    """Raise for unsupported ``generate`` keywords unless the caller passed
    the shared default value."""
    for k, v in kwargs.items():
        if k in GENERATE_DEFAULTS and v == GENERATE_DEFAULTS[k]:
            continue
        raise NotImplementedError(
            f"{family}.generate does not support {k}={v!r} (decoder-only "
            "families carry the full strategy surface)")


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens=20, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             use_cache=True, attention_mask=None, paged=False,
             page_size=16, prefill_chunk_size=None,
             repetition_penalty=1.0, min_new_tokens=0,
             num_beams=1, length_penalty=1.0, early_stopping=False,
             no_repeat_ngram_size=0):
    """Batched autoregressive decode (``generation.py:1397``), on the
    model's device; the arguments, strategies and refusals are the JAX
    function's, raised in the same order.

    ``repetition_penalty`` (HF semantics): logits of the tokens already in
    the row (prompt and generated) are divided by it when positive,
    multiplied when negative. ``min_new_tokens`` blocks ``eos_token_id``
    for the first N generated tokens (needs eos). ``no_repeat_ngram_size=n``
    bans the tokens that would repeat an n-gram of the row.

    ``num_beams > 1`` runs beam search (greedy scoring over K beams a row,
    HF semantics: 2K candidates a step, eos hits retire into a pool scored
    by sum-logprob / len**length_penalty) and returns each row's best
    hypothesis.

    ``attention_mask`` [B, S0] (1 = real token; right- or left-padded rows,
    left pads rolled to the internal right-padded layout) makes ragged
    batches exact: pad columns are never attended, RoPE continues from each
    row's true length, the first token reads each row's last real logit.

    ``prefill_chunk_size``: the prompt runs as a loop over fixed-size
    chunks (``_ChunkedPrefillStep``); the output equals the one-shot
    prefill's.

    ``paged``: the prefilled caches are re-laid into pages of
    ``page_size`` and decode runs over the paged pool (not for MLA's
    latent caches, nor for beams).

    Sampling draws from the port's default generator on the model's device
    (``framework.random``). The whole call runs under one
    ``torch.inference_mode()``: the caches the prefill makes are written in
    place by every decode step. Returns the generated ids [B, <=
    max_new_tokens] (prompt excluded) on the model's device; stops early
    only when every row has emitted eos."""
    from .framework.random import default_generator

    dev = model.device
    ids = _as_tensor(input_ids, dev)
    B, S0 = ids.shape
    cfg = model.config
    if max_new_tokens <= 0:
        return torch.zeros(B, 0, dtype=ids.dtype, device=dev)
    rp = float(repetition_penalty)
    if rp <= 0:
        raise ValueError("repetition_penalty must be positive")
    min_new = int(min_new_tokens)
    if min_new > 0 and eos_token_id is None:
        raise ValueError("min_new_tokens requires eos_token_id (it only "
                         "delays the eos stop)")
    ngram = int(no_repeat_ngram_size)
    penalized = rp != 1.0 or min_new > 0 or ngram > 0
    if paged and getattr(model.llama, "empty_cache_layer", None) is not None:
        # before the prefill: the paged layout needs per-head k/v caches
        raise NotImplementedError(
            "the paged KV layout needs per-head k/v caches; MLA latent "
            "caches (c_kv/k_pe) decode through the dense buffer path "
            "(paged=False)")
    num_beams = int(num_beams)
    if num_beams > 1:
        if do_sample:
            raise NotImplementedError(
                "beam search with do_sample=True (beam sampling) is not "
                "supported; use num_beams>1 with do_sample=False")
        if paged:
            raise NotImplementedError(
                "beam search over the paged KV layout is not supported; "
                "use paged=False (beams reorder dense cache rows)")
        if not use_cache:
            raise NotImplementedError("beam search needs use_cache=True")
    chunk = int(prefill_chunk_size) if prefill_chunk_size else 0
    if chunk:
        if not use_cache:
            raise NotImplementedError(
                "prefill_chunk_size needs the cached path (use_cache=True)")
        n_chunks = -(-S0 // chunk)
        prompt_pad = n_chunks * chunk   # cache slots the padded prompt uses
    else:
        prompt_pad = S0
    max_len = prompt_pad + max_new_tokens
    if paged:
        max_len = -(-max_len // page_size) * page_size
    if max_len > cfg.max_position_embeddings:
        raise ValueError(
            f"generate: prompt+new tokens {max_len} exceeds "
            f"max_position_embeddings {cfg.max_position_embeddings}")

    pad_mask = None
    lengths = torch.full((B,), S0, dtype=torch.int32, device=dev)
    if attention_mask is not None:
        if not use_cache:
            raise NotImplementedError(
                "generate(use_cache=False) ignores attention_mask; use the "
                "cached path for padded prompts")
        am = _as_tensor(attention_mask, dev)
        lengths = am.to(torch.int32).sum(1).to(torch.int32)
        # the internal layout is right-padded (each row's real tokens a
        # prefix); left-padded rows roll their suffix to the front, which
        # leaves the generated tokens unchanged; interior holes fail
        cols = torch.arange(S0, device=dev)[None, :]
        prefix = cols < lengths[:, None]
        amb = am.bool()
        if bool((amb != prefix).any()):
            suffix = cols >= (S0 - lengths)[:, None]
            is_prefix = (amb == prefix).all(dim=1)
            is_suffix = (amb == suffix).all(dim=1)
            if not bool((is_prefix | is_suffix).all()):
                raise ValueError(
                    "generate(attention_mask=...) expects right- or "
                    "left-padded prompts (contiguous real tokens); got a "
                    "mask with interior holes.")
            shifts = torch.where(is_prefix, 0, S0 - lengths)[:, None]
            idx = (cols + shifts) % S0
            ids = torch.gather(ids, 1, idx.long())
            am = torch.gather(am, 1, idx.long())
        if bool((lengths < 1).any()):
            raise ValueError(
                "generate(attention_mask=...): every row needs at least one "
                "real token — an all-zero mask row would decode from a pad "
                "position's logits")
        pad_mask = torch.cat(
            [am.bool(), torch.ones(B, max_len - S0, dtype=torch.bool,
                                   device=dev)], dim=1)

    generator = default_generator(dev)
    if not use_cache:
        return _generate_no_cache(model, ids, max_new_tokens, do_sample,
                                  temperature, top_k, top_p, eos_token_id,
                                  rp=rp, min_new=min_new, ngram=ngram,
                                  generator=generator)

    # prefill: the cache fill and each row's last real logit
    if chunk:
        if pad_mask is not None or prompt_pad != S0:
            # chunked prompts are internally ragged: the pad columns between
            # each row's length and the padded prompt are never attended,
            # and decode RoPE continues per row
            am_eff = (pad_mask[:, :S0] if pad_mask is not None
                      else torch.ones(B, S0, dtype=torch.bool, device=dev))
            pad_mask = torch.cat(
                [am_eff,
                 torch.zeros(B, prompt_pad - S0, dtype=torch.bool,
                             device=dev),
                 torch.ones(B, max_len - prompt_pad, dtype=torch.bool,
                            device=dev)], dim=1)
        ids_pad = torch.cat(
            [ids, torch.zeros(B, prompt_pad - S0, dtype=ids.dtype,
                              device=dev)], dim=1)
    buffers = _cache_buffers(model, B, max_len, pad_mask is not None,
                             owner=model, maxsize=CACHE_SETS)
    if chunk:
        last, caches = _ChunkedPrefillStep(model, max_len, chunk, n_chunks)(
            ids_pad, lengths, pad_mask, buffers)
    else:
        last, caches = _get_prefill_step(model, max_len,
                                         pad_mask is not None)(
            ids, lengths, pad_mask, buffers)

    if paged:
        caches = _caches_to_paged(caches, page_size, lengths, owner=model)

    # per-row RoPE positions of the generated tokens (ragged rows continue
    # at their true lengths)
    if pad_mask is not None and not paged:
        for c in caches:
            c["row_pos"] = lengths

    if num_beams > 1:
        histories0 = None
        if rp != 1.0 or ngram > 0:
            ids_np, lens_np = ids.cpu().numpy(), lengths.cpu().numpy()
            histories0 = [list(map(int, ids_np[b, : lens_np[b]]))
                          for b in range(B)]
        return _beam_search(model, last, caches, max_len, max_new_tokens,
                            num_beams, eos_token_id, float(length_penalty),
                            bool(early_stopping), rp=rp,
                            histories0=histories0, min_new=min_new,
                            ngram=ngram)

    if eos_token_id is None and max_new_tokens > 1 and not penalized:
        # fixed length (``generation.py:1166``): the sample -> forward loop,
        # then a final sample. JAX scans the loop as one program; here each
        # step is one call of the select-decode unit (on CUDA one replay of
        # its graph), drawing from ``generator`` in step order where JAX
        # folds the step index into one key
        step = _get_select_decode(model, max_len, do_sample, temperature,
                                  top_k, top_p)
        toks = torch.empty(max_new_tokens, B, dtype=ids.dtype, device=dev)
        for i in range(max_new_tokens - 1):
            nxt, _lp, last, caches = step(last, generator, caches)
            toks[i] = nxt
        toks[-1] = _select(last, generator, do_sample, float(temperature),
                           int(top_k), float(top_p))
        return toks.t().contiguous()

    step = _get_decode_step(model, max_len)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    seen = (_seen_from_prompt(ids, cfg.vocab_size, pad_mask)
            if rp != 1.0 else None)
    tracker = None
    if ngram > 0:
        ids_np, lens_np = ids.cpu().numpy(), lengths.cpu().numpy()
        tracker = _NgramBan(
            [list(ids_np[b, : lens_np[b]]) for b in range(B)], ngram)
    out_tokens = []
    for i in range(max_new_tokens):
        last, nxt, finished = _next_token(
            last, seen, tracker, finished, generator, cfg.vocab_size,
            do_sample, temperature, top_k, top_p, rp, i, min_new,
            eos_token_id)
        out_tokens.append(nxt.reshape(B, 1).to(ids.dtype))
        if i == max_new_tokens - 1 or (
                eos_token_id is not None and bool(finished.all())):
            break
        logits, caches = step(out_tokens[-1], caches)
        last = logits[:, -1, :]
    return torch.cat(out_tokens, dim=1)


def _next_token(last, seen, tracker, finished, generator, vocab, do_sample,
                temperature, top_k, top_p, rp, i, min_new, eos_token_id):
    """One step of the host decode loops (cached and no-cache): the n-gram
    ban, the selection, the eos fill of finished rows, and the seen set and
    n-gram tracker updated in place. Returns (last, token [B],
    finished)."""
    B = last.shape[0]
    if tracker is not None:
        banned = tracker.banned(vocab)
        if banned.any():  # no transfer on a no-op step
            last = torch.where(torch.from_numpy(banned).to(last.device),
                               float("-inf"), last.float())
    nxt = _select_next(last, seen, generator, do_sample, temperature, top_k,
                       top_p, rp, i, min_new, eos_token_id)
    if eos_token_id is not None:
        nxt = torch.where(finished, eos_token_id, nxt)
        finished = finished | (nxt == eos_token_id)
    if seen is not None:
        seen[torch.arange(B, device=seen.device), nxt] = True
    if tracker is not None:
        for b, t in enumerate(nxt.cpu().numpy()):
            tracker.append(b, int(t))
    return last, nxt, finished


def _generate_no_cache(model, ids, max_new_tokens, do_sample, temperature,
                       top_k, top_p, eos_token_id, rp=1.0, min_new=0,
                       ngram=0, generator=None):
    """``use_cache=False`` (``generation.py:1633``): the non-cached forward
    over the whole sequence for every token. ``generator`` defaults to the
    port's default generator on ``ids``' device."""
    from .framework.random import default_generator

    generator = generator or default_generator(ids.device)
    B = ids.shape[0]
    vocab = model.config.vocab_size
    finished = torch.zeros(B, dtype=torch.bool, device=ids.device)
    seen = _seen_from_prompt(ids, vocab) if rp != 1.0 else None
    tracker = (_NgramBan([list(r) for r in ids.cpu().numpy()], ngram)
               if ngram > 0 else None)
    out_tokens = []
    full = ids
    for i in range(max_new_tokens):
        hidden = model.llama(full)
        last = model.lm_head_logits(hidden)[:, -1, :]
        last, nxt, finished = _next_token(
            last, seen, tracker, finished, generator, vocab, do_sample,
            temperature, top_k, top_p, rp, i, min_new, eos_token_id)
        out_tokens.append(nxt.reshape(B, 1).to(ids.dtype))
        full = torch.cat([full, out_tokens[-1]], dim=1)
        if eos_token_id is not None and bool(finished.all()):
            break
    return torch.cat(out_tokens, dim=1)


# ---------------------------------------------------------------------------
# paged cache construction
# ---------------------------------------------------------------------------

def _caches_to_paged(caches, page_size, lengths, owner):
    """Re-lay dense prefilled buffers [B, max_len, hk, D] into paged dicts
    (``generation.py:1674``): pools [hk, B * pages per row, page_size, D],
    row b owning pages [b * pps, (b + 1) * pps) through a contiguous page
    table. ``lengths`` [B] are each row's valid tokens; the right-pad
    garbage above them is never attended and is overwritten by decode.
    The pools and the page table are made once per shape and kept in
    ``owner``, as the dense buffers are."""
    k0 = caches[0]["k"]
    B, max_len, hk, D = k0.shape
    pps = max_len // page_size

    def make():
        pools = [{n: k0.new_empty(hk, B * pps, page_size, D)
                  for n in ("k_pages", "v_pages")} for _ in caches]
        return pools, torch.arange(B * pps, dtype=torch.int32,
                                   device=k0.device).reshape(B, pps)

    (pools, page_indices), _ = _lru(
        owner, "_cache_sets", ("paged", B, max_len, page_size), make,
        CACHE_SETS)
    for c, p in zip(caches, pools):
        for name, pool in (("k", p["k_pages"]), ("v", p["v_pages"])):
            pool.view(hk, B, pps, page_size, D).copy_(
                c[name].view(B, pps, page_size, hk, D).permute(3, 0, 1, 2,
                                                               4))
    lengths = lengths.to(torch.int32)
    return [dict(p, page_indices=page_indices, lengths=lengths,
                 page_size=page_size) for p in pools]


def generate_paged(model, input_ids, max_new_tokens=20, page_size=16,
                   **kwargs):
    """Paged-KV decode (``generation.py:1705``): ``generate`` with the
    paged cache layout."""
    return generate(model, input_ids, max_new_tokens=max_new_tokens,
                    paged=True, page_size=page_size, **kwargs)
