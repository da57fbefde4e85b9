"""Speculative decoding: the engine's n-gram drafter and the draft-model
``speculative_generate``. Counterpart of ``paddle_tpu/speculative.py``
(``_ngram_next``, ``ngram_propose``, ``:89-290``).

The n-gram drafter is host work only (numpy): it runs between engine
dispatches on a request's prompt and token history and never touches the
device.

``speculative_generate``: a small draft model proposes k tokens, the target
verifies them in one chunked forward, and the longest prefix the target's
greedy choice agrees with, plus the target's own next token, is emitted;
the output is exactly ``target.generate``'s greedy one. Both the proposal
(the seed, then k - 1 greedy single-token forwards, JAX's ``lax.scan``)
and the verify are step units (``generation._Step``): eager on CPU
tensors, one CUDA graph a signature on the card, memoized per model as
the JAX package memoizes its jitted steps. Both run over dense caches
whose every layer reads one device int32 ``pos``; rollback after a
rejected suffix writes that scalar in place, and columns past it are
masked, so the stale entries are inert until overwritten (JAX rebinds a
new scalar).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .generation import (CACHE_SETS, _cache_buffers, _get_prefill_step,
                         _memoized_step, _Step)


def _ngram_next(hist: np.ndarray, max_ngram: int):
    """One prompt-lookup step: the token that followed the most recent
    earlier occurrence of ``hist``'s trailing n-gram (n = ``max_ngram``
    down to 1), or None when nothing repeats."""
    L = int(hist.size)
    if L < 2:
        return None
    for n in range(min(int(max_ngram), L - 1), 0, -1):
        pat = hist[L - n:]
        # windows starting before the trailing n-gram itself, so a match
        # always has a continuation token
        view = np.lib.stride_tricks.sliding_window_view(hist, n)
        hits = np.nonzero((view[: L - n] == pat).all(axis=1))[0]
        if hits.size:
            return int(hist[int(hits[-1]) + n])  # most recent wins
    return None


def ngram_propose(history, k: int, max_ngram: int = 3) -> np.ndarray:
    """Iterated prompt lookup: each proposed token joins a working copy of
    the history before the next lookup, so a periodic stream extends past
    the history's end. ``c[0]`` predicts the next position. Returns int32
    of length <= k (empty when the history is too short or nothing
    repeats; the caller pads)."""
    work = np.asarray(history).reshape(-1)
    out = []
    for _ in range(int(k)):
        nxt = _ngram_next(work, max_ngram)
        if nxt is None:
            break
        out.append(nxt)
        work = np.append(work, nxt)
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# draft-model speculative decoding
# ---------------------------------------------------------------------------

class _ProposeStep(_Step):
    """Draft proposal: feed ``seed`` (1 or 2 catch-up tokens), then k - 1
    greedy single-token forwards. Returns (tokens [B, k] int32, caches)."""

    cache_arg = 1

    def __init__(self, model, max_len, k):
        super().__init__(model, max_len)
        self._k = int(k)

    @torch.inference_mode()
    def eager(self, seed, caches):
        model = self._model
        hidden, caches = model.llama.forward_cached(seed, caches,
                                                    rope_len=self._max_len)
        tok = torch.argmax(model.lm_head_logits(hidden[:, -1:])[:, -1, :],
                           dim=-1).to(torch.int32)
        toks = [tok]
        for _ in range(self._k - 1):
            hidden, caches = model.llama.forward_cached(
                tok[:, None], caches, rope_len=self._max_len)
            tok = torch.argmax(model.lm_head_logits(hidden)[:, -1, :],
                               dim=-1).to(torch.int32)
            toks.append(tok)
        return torch.stack(toks, dim=1), caches


class _VerifyStep(_Step):
    """Target verify: one chunked forward over [last, d_1..d_k]; returns
    (the target's greedy token at every chunk position [B, k + 1] int32,
    caches)."""

    cache_arg = 1

    @torch.inference_mode()
    def eager(self, chunk, caches):
        hidden, caches = self._model.llama.forward_cached(
            chunk, caches, rope_len=self._max_len)
        logits = self._model.lm_head_logits(hidden)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches


def _set_pos(caches, pos_t, pos):
    """Every layer's ``pos`` set to ``pos``: written in place into the one
    device int32 ``pos_t`` that all layers then share (the graphed units
    copy it in at each replay, with no host sync)."""
    pos_t.fill_(int(pos))
    for c in caches:
        c["pos"] = pos_t
    return caches


def _prefill(model, ids, max_len, owner):
    """Whole-prompt prefill (generation's one-shot step) into the dense
    buffers ``owner`` keeps for (batch, ``max_len``); returns (greedy next
    token as an int, caches). The int is read before any other unit of the
    model runs: a unit's outputs last until the model's next call."""
    step = _get_prefill_step(model, max_len, ragged=False)
    buffers = _cache_buffers(model, ids.shape[0], max_len, False,
                             owner=owner, maxsize=CACHE_SETS)
    lengths = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                         device=ids.device)
    last, caches = step(ids, lengths, None, buffers)
    return int(torch.argmax(last, dim=-1)[0]), caches


def _normalize_request(input_ids):
    """Batch-1 request normalization: returns (ids [1, P] numpy, the
    output dtype); raises on batched input (the dense cache keeps one
    write position)."""
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.detach().cpu().numpy()
    else:
        ids = np.asarray(input_ids)
    out_dtype = ids.dtype
    if ids.ndim == 1:
        ids = ids[None]
    if ids.shape[0] != 1:
        raise ValueError(
            "speculative decoding is per-request (batch 1); run rows "
            "separately or use model.generate for batched decode")
    return ids, out_dtype


def _finish(emitted, max_new_tokens, eos_token_id, out_dtype, device):
    """Truncate to the budget, cut at eos, and return [1, n] in the
    request's dtype on ``device``."""
    emitted = emitted[:max_new_tokens]
    if eos_token_id is not None and eos_token_id in emitted:
        emitted = emitted[: emitted.index(eos_token_id) + 1]
    return torch.from_numpy(np.asarray(emitted, out_dtype)[None]).to(device)


def _draft_owner(model):
    """The keeper of the draft's cache buffers, apart from the ones its own
    ``generate`` (or its use as the target) keeps: with draft = target the
    two caches must not share buffers."""
    owner = model.__dict__.get("_spec_draft_owner")
    if owner is None:
        owner = types.SimpleNamespace()
        object.__setattr__(model, "_spec_draft_owner", owner)
    return owner


@torch.inference_mode()
def speculative_generate(target, draft, input_ids, max_new_tokens=20,
                         draft_k=4, eos_token_id=None, return_stats=False):
    """Greedy speculative decode of ``input_ids`` [1, P] on the target's
    device; returns the new tokens [1, <= max_new_tokens] in the input's
    dtype, exactly ``target.generate``'s greedy ones.

    Batch 1 (per-request serving): the dense cache keeps one write
    position. ``return_stats=True`` returns ``(out, stats)``: ``rounds``
    (verify dispatches), ``hits`` (draft tokens the target accepted) and
    ``acceptance`` (hits / (rounds * draft_k)). The metrics histogram of
    the JAX package is not ported."""
    ids, out_dtype = _normalize_request(input_ids)
    B, P = ids.shape
    k = int(draft_k)
    if k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    max_len = P + max_new_tokens + k + 2
    for name, m in (("target", target), ("draft", draft)):
        limit = m.config.max_position_embeddings
        if max_len > limit:
            raise ValueError(
                f"speculative_generate: prompt+new(+{k + 2} speculation "
                f"slack) = {max_len} exceeds the {name} model's "
                f"max_position_embeddings {limit}")
    dev = target.device
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)

    t0, tgt_caches = _prefill(target, ids_t, max_len, target)
    _, dft_caches = _prefill(draft, ids_t.to(draft.device), max_len,
                             _draft_owner(draft))
    tgt_pos_t = torch.zeros((), dtype=torch.int32, device=dev)
    dft_pos_t = torch.zeros((), dtype=torch.int32, device=draft.device)
    tgt_pos, dft_pos = P, P

    emitted = [t0]
    last = t0
    catchup = []  # accepted tokens not yet written to the draft cache
    rounds = hits = 0

    def propose_step(seed_len):
        return _memoized_step(
            draft, "_spec_propose_steps", (max_len, k, seed_len),
            lambda: _ProposeStep(draft, max_len, k), maxsize=8)

    # keyed as the JAX steps are (the seed length and the chunk width are
    # also in each graph's signature)
    verify_step = _memoized_step(
        target, "_spec_verify_steps", (max_len, k + 1),
        lambda: _VerifyStep(target, max_len), maxsize=8)

    while len(emitted) < max_new_tokens and \
            (eos_token_id is None or emitted[-1] != eos_token_id):
        seed = torch.tensor([catchup + [last]], dtype=torch.int32,
                            device=draft.device)                  # [1, 1|2]
        dft_caches = _set_pos(dft_caches, dft_pos_t, dft_pos)
        proposals, dft_caches = propose_step(seed.shape[1])(seed, dft_caches)
        props = proposals[0].tolist()                             # d_1..d_k

        chunk = torch.tensor([[last] + props], dtype=torch.int32,
                             device=dev)                          # [1, k+1]
        tgt_caches = _set_pos(tgt_caches, tgt_pos_t, tgt_pos)
        greedy, tgt_caches = verify_step(chunk, tgt_caches)
        g = greedy[0].tolist()                                    # g_0..g_k

        m = 0
        while m < k and props[m] == g[m]:
            m += 1
        accepted = props[:m] + [g[m]]                             # <= k+1
        rounds += 1
        hits += m

        # the context now ends ...last, d_1..d_m, g_m; g_m is the new last
        ctx_len_old = tgt_pos + 1        # context length before the round
        tgt_pos = ctx_len_old + m        # the target holds ctx + d_1..d_m
        if m == k:                       # the draft never wrote d_k's entry
            dft_pos = ctx_len_old + (k - 1)
            catchup = [props[-1]]
        else:                            # d_1..d_m are all in its cache
            dft_pos = ctx_len_old + m
            catchup = []
        last = accepted[-1]
        emitted.extend(accepted)
        if eos_token_id is not None and eos_token_id in accepted:
            break

    out = _finish(emitted, max_new_tokens, eos_token_id, out_dtype, dev)
    if return_stats:
        return out, {"rounds": rounds, "hits": hits,
                     "acceptance": (hits / (rounds * k)) if rounds else 0.0}
    return out
