"""Speculative decoding: the engine's n-gram drafter, the draft-model
``speculative_generate`` and DeepSeek-V3's self-drafting
``mtp_speculative_generate``. Counterpart of ``paddle_tpu/speculative.py``
(``_ngram_next``, ``ngram_propose``, ``:89-446``).

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

``mtp_speculative_generate``: the model's first multi-token-prediction
depth drafts one token a round from the main model's pre-norm hidden
stream, keeping a latent cache of its own over the shifted sequence, and
a 2-token cached verify accepts the draft or corrects it; the output is
exactly ``model.generate``'s greedy one. Its prefill (the main prompt, then
the MTP cache seeded with the prompt's pairs) and each round (the MTP block
over the round's one or two pairs, the draft, the verify) are step units,
the round keyed on ``(max_len, n)`` as JAX's ``_MTPRoundStep``; a miss is
rolled back by the host's ``pos``, as above. Every part of a round stays on
the device (routing, argmax, the verify's tokens), so the whole round is
one graph; the ``[g0, g1, draft]`` fetch is its one host sync.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .generation import (CACHE_SETS, _cache_buffers, _get_prefill_step,
                         _lru, _memoized_step, _start_caches, _Step)


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


# ---------------------------------------------------------------------------
# MTP self-speculative decoding (DeepSeek-V3)
# ---------------------------------------------------------------------------

class _MTPPrefillStep(_Step):
    """The prompt through the main model, its pre-norm stream kept, then
    the MTP cache seeded with the prompt's pairs (h_i, t_{i+1}), i < P - 1,
    at 0-based positions (``speculative.py:380-405``). ``caches``: the
    main model's latent buffers and, last, the MTP block's. Returns (the
    greedy first token [1] int32, the last pre-norm hidden [1, 1, h],
    caches)."""

    cache_arg = 1

    @torch.inference_mode()
    def eager(self, ids, caches):
        model = self._model
        mtp = model.mtp_layers[0]
        caches = _start_caches(caches, None, ids.device)
        normed, pre, main = model.llama.forward_cached(
            ids, caches[:-1], rope_len=self._max_len, return_prenorm=True)
        t1 = torch.argmax(model.lm_head_logits(normed[:, -1, :]),
                          dim=-1).to(torch.int32)
        mtp_cache = caches[-1]
        P = ids.shape[1]
        if P > 1:
            cos, sin = model.llama._rope(self._max_len)
            x = mtp.fuse(pre[:, :P - 1], _embed(model, ids[:, 1:]))
            _, mtp_cache = mtp.block(x, cos, sin, kv_cache=mtp_cache)
        return t1, pre[:, -1:], main + [mtp_cache]


class _MTPRoundStep(_Step):
    """One round (``speculative.py:293-338``): the MTP block over the
    ``n`` pairs (h_tail rows, toks) extends its cache and drafts one token
    (one pair: the MLA decode kernel; two: the absorbed einsums), then the
    2-token cached verify [toks[-1], draft] on the main model. ``caches``
    as ``_MTPPrefillStep``'s, each at its host-set ``pos``. Returns
    ([g0, g1, draft] int32, the verify's pre-norm hidden [1, 2, h],
    caches)."""

    cache_arg = 2

    @torch.inference_mode()
    def eager(self, h_tail, toks, caches):
        model = self._model
        mtp = model.mtp_layers[0]
        cos, sin = model.llama._rope(self._max_len)
        x = mtp.fuse(h_tail, _embed(model, toks))
        h_m, mtp_cache = mtp.block(x, cos, sin, kv_cache=caches[-1])
        draft = torch.argmax(model.lm_head_logits(mtp.norm(h_m[:, -1, :])),
                             dim=-1).to(torch.int32)                   # [1]
        verify = torch.cat([toks[:, -1], draft])[None]                 # [1, 2]
        normed2, pre2, main = model.llama.forward_cached(
            verify, caches[:-1], rope_len=self._max_len, return_prenorm=True)
        g = torch.argmax(model.lm_head_logits(normed2)[0], dim=-1).to(
            torch.int32)                                               # [2]
        return torch.cat([g, draft]), pre2, main + [mtp_cache]


def _embed(model, ids):
    """The main embedding of ``ids`` in the compute dtype (the MTP block's
    input, unscaled as in JAX)."""
    from .models.llama import torch_dtype

    return model.llama.embed_tokens(ids).to(torch_dtype(model.config.dtype))


def _mtp_buffers(model, max_len):
    """The MTP block's latent buffers for ``max_len`` slots (batch 1), kept
    on the model as ``generate`` keeps the main ones."""
    from .models.llama import torch_dtype

    def make():
        return model.llama.empty_cache_layer(
            1, max_len, torch_dtype(model.config.dtype))

    return _lru(model, "_mtp_cache_sets", max_len, make, CACHE_SETS)[0]


@torch.inference_mode()
def mtp_speculative_generate(model, input_ids, max_new_tokens=20,
                             eos_token_id=None, return_stats=False):
    """Self-speculative greedy decode for DeepSeek models with multi-token
    prediction (``num_nextn_predict_layers >= 1``), ``speculative.py:
    341-446``: the first MTP depth drafts one token a round, a 2-token
    verify accepts or corrects it. Returns the new tokens [1, <=
    max_new_tokens] in the input's dtype on the model's device, exactly
    ``model.generate``'s greedy ones.

    Batch 1; ``max_len = P + max_new_tokens + 3``. ``return_stats=True``
    returns ``(out, stats)``: ``rounds``, ``hits`` (drafts accepted) and
    ``acceptance`` (hits / rounds). Each round observes its 0/1 hit in
    ``serving_spec_accepted_tokens`` (engine="mtp")."""
    from .observability import catalog

    mtp_layers = getattr(model, "mtp_layers", None)
    if not mtp_layers:
        raise ValueError(
            "mtp_speculative_generate needs a model built with "
            "num_nextn_predict_layers >= 1 (the MTP draft module)")
    ids, out_dtype = _normalize_request(input_ids)
    P = ids.shape[1]
    max_len = P + max_new_tokens + 3
    if max_len > model.config.max_position_embeddings:
        raise ValueError(
            f"prompt+new(+3 speculation slack) = {max_len} exceeds "
            f"max_position_embeddings "
            f"{model.config.max_position_embeddings}")
    dev = model.device
    accept_hist = catalog.SERVING_SPEC_ACCEPTED.labels(engine="mtp")
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
    mtp_bufs = _mtp_buffers(model, max_len)
    caches = _cache_buffers(model, 1, max_len, False, owner=model,
                            maxsize=CACHE_SETS) + [dict(mtp_bufs)]
    prefill = _memoized_step(model, "_mtp_prefill_steps", max_len,
                             lambda: _MTPPrefillStep(model, max_len),
                             maxsize=8)
    t1, h_tail, caches = prefill(ids_t, caches)
    emitted = [int(t1[0])]
    main = caches[:-1]
    pos_t = torch.zeros((), dtype=torch.int32, device=dev)
    mtp_pos_t = torch.zeros((), dtype=torch.int32, device=dev)
    pos_main, pos_mtp = P, max(P - 1, 0)
    rounds = hits = 0
    toks = emitted[:]              # tokens pairing the h_tail rows
    while len(emitted) < max_new_tokens and (
            eos_token_id is None or emitted[-1] != eos_token_id):
        n = len(toks)
        step = _memoized_step(model, "_mtp_round_steps", (max_len, n),
                              lambda: _MTPRoundStep(model, max_len),
                              maxsize=8)
        main = _set_pos(main, pos_t, pos_main)
        mtp_pos_t.fill_(pos_mtp)
        g_t, pre2, caches = step(
            h_tail, torch.tensor([toks], dtype=torch.int32, device=dev),
            main + [dict(mtp_bufs, pos=mtp_pos_t)])
        main = caches[:-1]
        g0, g1, draft = g_t.tolist()     # the round's one host sync
        rounds += 1
        pos_mtp += n                     # the MTP stream grew by n pairs
        if draft == g0:                  # a hit: two tokens from one verify
            hits += 1
            emitted.extend([draft, g1])
            pos_main += 2
            h_tail, toks = pre2, [draft, g1]
        else:                            # a miss: the draft's entry is
            emitted.append(g0)           # stale, the host's pos parks it
            pos_main += 1
            h_tail, toks = pre2[:, :1], [g0]
        accept_hist.observe(1 if draft == g0 else 0)
        if eos_token_id is not None and eos_token_id in emitted[-2:]:
            break                        # eos inside a hit pair stops it

    out = _finish(emitted, max_new_tokens, eos_token_id, out_dtype, dev)
    if return_stats:
        return out, {"rounds": rounds, "hits": hits,
                     "acceptance": (hits / rounds) if rounds else 0.0}
    return out
