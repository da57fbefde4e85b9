"""Continuous batching over a paged KV pool — counterpart of
``paddle_tpu/serving.py`` ``ContinuousBatchEngine`` (first sub-slice).

Requests join at any time; every ``step()`` decodes one token for every
active slot (sample + forward in one call), a finished request frees its
slot at once, and the FIFO queue refills it. The step units come from the
model's memoized getters (``generation._get_select_decode`` and the rest,
keyed with the flag fingerprint as in the JAX engine): on CUDA each is a
replayed CUDA graph over the engine's pool, its page table and one
``lengths`` tensor that every layer's cache holds. Admission runs one bucketed
prefill into a dense cache (flash kernel for a prompt that fills its
power-of-two bucket, append-attention kernel for a padded one) and copies
that cache into the slot's pages of the pool.

With ``speculative_k=k`` every greedy dispatch is a multi-token step: the
host n-gram drafter proposes up to k-1 tokens per slot, one verify call
forwards each slot's chunk [greedy, d_1..d_{k-1}] at per-row paged
positions, and each slot advances by its accepted run (token-identical to
the one-token step by construction).

A model whose trunk has an ``empty_cache_layer`` hook (DeepSeek's MLA)
serves in latent mode (``serving.py:1041-1047``): each layer keeps per-slot
rows of its compressed buffers (``c_kv`` [max_batch, max_len, r], ``k_pe``
[max_batch, max_len, dr]) in place of the K/V pages, admission copies the
prompt's latent rows into the slot's row, and decode attends over the rows
at each slot's length. Latent mode refuses speculation, as the JAX engine
does (the port has none of the other paged-only features: preemption,
handoff, migration).

Ported: the pool layout, ``add_request``, FIFO admission, ``_bucket``,
``_bucketed_prefill``, ``_prefill_into``, ``_scatter_prefill``, ``step``,
``run_until_done``, ``cancel``, ``finish_reason``, ``logprobs``, ``stats``
and speculation with an integer k (``_spec_eligible``,
``_step_speculative``). Not ported yet: ``speculative_k="auto"`` (the
autotune search), prefix cache, chunked prefill, priorities and deadlines,
preemption, migration and handoff, OOM degradation, the flight recorder,
tracing, the KV atlas, the step-anatomy clock and metrics.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional

import numpy as np
import torch

from .framework.random import default_generator
from .generation import (_cache_buffers, _get_prefill_step,
                         _get_select_decode, _get_select_decode_rows,
                         _get_spec_decode)
from .models.llama import head_dim_of, torch_dtype
from .speculative import ngram_propose


def _page_tiles(buf, page_size):
    """[n_tokens, hk, D] dense rows -> [hk, n_pages, page_size, D] page
    tiles (the pool layout)."""
    n_pages = buf.shape[0] // page_size
    hk, d = buf.shape[1], buf.shape[2]
    return buf.reshape(n_pages, page_size, hk, d).movedim(2, 0)


def _on_token_arity(on_token) -> int:
    """4 when the streaming callback takes the chosen-token logprob as a
    4th argument: four REQUIRED positional parameters, or ``*args``; else
    3 (a defaulted 4th parameter keeps the 3-argument call), as the JAX
    engine detects it at admission (``serving.py:259-279``)."""
    try:
        params = inspect.signature(on_token).parameters.values()
    except (TypeError, ValueError):
        return 3
    required = sum(1 for p in params
                   if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                   and p.default is p.empty)
    varargs = any(p.kind == p.VAR_POSITIONAL for p in params)
    return 4 if varargs or required >= 4 else 3


class _Request:
    __slots__ = ("rid", "ids", "max_new_tokens", "tokens", "sampling",
                 "on_token", "on_token_arity", "stop_token_ids", "logprobs",
                 "want_logprobs", "spec_rounds", "spec_accepted")

    def __init__(self, rid, ids, max_new_tokens, sampling=None, on_token=None,
                 stop_token_ids=None, want_logprobs=False):
        self.rid = rid
        self.ids = np.asarray(ids).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.sampling = sampling  # (do_sample, temperature, top_k, top_p)
        # callback (rid, token, done) or (rid, token, done, logprob)
        self.on_token = on_token
        self.on_token_arity = (_on_token_arity(on_token)
                               if on_token is not None else 3)
        # additive to the engine eos
        self.stop_token_ids = (frozenset(int(s) for s in stop_token_ids)
                               if stop_token_ids else None)
        self.want_logprobs = bool(want_logprobs)
        self.logprobs: List[float] = []
        # speculative rounds this request rode, and drafts it accepted
        self.spec_rounds = self.spec_accepted = 0


class ContinuousBatchEngine:
    """In-flight batching: ``add_request()`` any time, ``step()`` decodes one
    token for every active slot.

    >>> eng = ContinuousBatchEngine(model, max_batch=4, max_len=256)
    >>> rid = eng.add_request(prompt_ids, max_new_tokens=64)
    >>> done = eng.run_until_done()   # {rid: np.ndarray of generated ids}

    The engine runs where the model's weights lie. ``speculative_k`` (an
    int >= 1, or None for off) is the chunk width of a speculative dispatch:
    one verified token plus up to k-1 drafts from an n-gram lookup of
    length up to ``speculative_ngram``. Dispatches with a sampling slot
    active take the one-token step."""

    def __init__(self, model, max_batch: int, max_len: int,
                 page_size: int = 16, eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, speculative_k=None,
                 speculative_ngram: int = 3):
        if max_len % page_size != 0:
            raise ValueError("max_len must be a multiple of page_size")
        if speculative_k == "auto":
            raise NotImplementedError(
                "speculative_k='auto' needs the autotune search, which is "
                "not ported (paddle_tpu/serving.py _resolve_spec_k, "
                ":816-907); pass an int")
        if speculative_k is not None:
            speculative_k = int(speculative_k)
            if speculative_k < 1:
                raise ValueError(f"speculative_k must be >= 1, got "
                                 f"{speculative_k}")
            if speculative_k > max_len:
                raise ValueError(f"speculative_k {speculative_k} exceeds "
                                 f"max_len {max_len}")
        # models with a latent decode cache (MLA) serve through per-slot
        # rows of the compressed buffers instead of the paged K/V pool
        make = getattr(model.llama, "empty_cache_layer", None)
        self._latent_mode = make is not None
        if self._latent_mode and speculative_k is not None:
            raise NotImplementedError(
                "engine speculative decoding needs the paged KV layout — the "
                "latent (MLA) compressed rows have no multi-token ragged "
                "append path")
        self.speculative_k = speculative_k or None
        self.speculative_ngram = int(speculative_ngram)
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature} "
                             "(0 decodes greedily)")
        self.model = model
        self.device = model.device
        self.max_batch, self.max_len, self.page_size = (max_batch, max_len,
                                                        page_size)
        self.eos_token_id = eos_token_id
        self._sample_cfg = (bool(do_sample), float(temperature), int(top_k),
                            float(top_p))
        self._generator = default_generator(self.device)

        # the pool: slot s owns pages [s*pps, (s+1)*pps) of every layer
        self._pages_per_slot = max_len // page_size
        hk, d = cfg.num_key_value_heads, head_dim_of(cfg)
        n_pages = max_batch * self._pages_per_slot
        dt = torch_dtype(cfg.dtype)
        page_indices = torch.arange(n_pages, dtype=torch.int32,
                                    device=self.device).reshape(
                                        max_batch, self._pages_per_slot)
        self._lengths = np.zeros(max_batch, np.int32)   # tokens per slot
        # their device copy, refreshed each step: one tensor that every
        # layer's cache dict holds
        self._lengths_dev = torch.zeros(max_batch, dtype=torch.int32,
                                        device=self.device)
        if self._latent_mode:
            self._caches = [dict(make(max_batch, max_len, dt),
                                 lengths=self._lengths_dev)
                            for _ in range(cfg.num_hidden_layers)]
        else:
            self._caches = [{
                "k_pages": torch.zeros(hk, n_pages, page_size, d, dtype=dt,
                                       device=self.device),
                "v_pages": torch.zeros(hk, n_pages, page_size, d, dtype=dt,
                                       device=self.device),
                "page_indices": page_indices,
                "page_size": page_size,
                "lengths": self._lengths_dev,
            } for _ in range(cfg.num_hidden_layers)]
        self._last = torch.zeros(max_batch, cfg.vocab_size,
                                 dtype=torch.float32, device=self.device)
        self._slots: List[Optional[_Request]] = [None] * max_batch
        self._queue: List[_Request] = []
        self._finished: Dict[int, np.ndarray] = {}
        self._finished_reason: Dict[int, str] = {}
        self._finished_logprobs: Dict[int, list] = {}
        self._next_rid = 0
        self._n_requests = self._n_finished = self._n_cancelled = 0
        self._n_tokens = self._n_steps = 0
        self._n_spec_steps = self._n_spec_emitted = 0
        self._n_spec_accepted = self._n_spec_slot_rounds = 0

    # ---- public API -----------------------------------------------------
    def add_request(self, ids, max_new_tokens: int = 64, do_sample=None,
                    temperature=None, top_k=None, top_p=None,
                    stop_token_ids=None, logprobs=False,
                    on_token=None) -> int:
        """Queue one request (admitted at once when a slot is free).
        Sampling knobs default to the engine's; any override routes decoding
        through the per-row program. ``stop_token_ids`` retires the request
        on any of them, in addition to the engine eos; ``logprobs`` keeps
        the chosen-token logprobs; ``on_token(rid, token, done)`` streams
        each token, and a callback with four required positional
        parameters (or ``*args``) also gets the token's logprob as the 4th
        argument. The keywords are the JAX engine's."""
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids).reshape(-1)
        self._require_fit(ids.size, int(max_new_tokens))
        if temperature is not None and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature} "
                             "(0 decodes greedily)")
        sampling = self._merge_sampling(do_sample, temperature, top_k, top_p)
        rid = self._next_rid
        self._next_rid += 1
        self._n_requests += 1
        self._queue.append(_Request(rid, ids, max_new_tokens, sampling,
                                    on_token, stop_token_ids, logprobs))
        self._admit()
        return rid

    def finish_reason(self, rid: int):
        """"stop" | "length" | "cancelled" once finished, else None."""
        return self._finished_reason.get(rid)

    def logprobs(self, rid: int):
        """Chosen-token logprobs of a finished request that asked for them."""
        return self._finished_logprobs.get(rid)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    def stats(self) -> dict:
        active = self.num_active
        return {
            "requests_admitted": self._n_requests,
            "requests_finished": self._n_finished,
            "requests_cancelled": self._n_cancelled,
            "requests_active": active,
            "requests_queued": len(self._queue),
            "decode_steps": self._n_steps,
            "tokens_generated": self._n_tokens,
            "slot_utilization": active / self.max_batch,
            # tokens retired per slot per speculative dispatch (1.0 = no
            # gain); zeros while speculation is off
            "spec_dispatches": self._n_spec_steps,
            "spec_emitted_tokens": self._n_spec_emitted,
            "spec_accepted_tokens": self._n_spec_accepted,
            "accepted_tokens_per_dispatch": (
                self._n_spec_emitted / self._n_spec_slot_rounds
                if self._n_spec_slot_rounds else 0.0),
        }

    def cancel(self, rid: int) -> bool:
        """Drop a queued request or free an active one's slot; True if it
        was live."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self._record_reason(rid, "cancelled")
                return True
        for s, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._release_slot(s)
                self._record_reason(rid, "cancelled")
                self._admit()
                return True
        return False

    def step(self) -> Dict[int, np.ndarray]:
        """Decode one token for every active slot; returns the requests
        that finished {rid: generated ids}."""
        self._admit()
        if self.num_active == 0:
            return self._drain_finished()
        self._lengths_dev.copy_(torch.from_numpy(self._lengths))
        if self.speculative_k is not None and self._spec_eligible():
            return self._step_speculative()
        if any(r is not None and r.sampling is not None for r in self._slots):
            rows = [(r.sampling or self._sample_cfg) if r is not None
                    else self._sample_cfg for r in self._slots]
            dev = self.device
            step = _get_select_decode_rows(self.model, self.max_len)
            nxt, logps, last, _ = step(
                self._last, self._generator,
                torch.tensor([r[0] for r in rows], dtype=torch.bool, device=dev),
                torch.tensor([r[1] for r in rows], dtype=torch.float32,
                             device=dev),
                torch.tensor([r[2] for r in rows], dtype=torch.int32,
                             device=dev),
                torch.tensor([r[3] for r in rows], dtype=torch.float32,
                             device=dev),
                self._caches)
        else:
            step = _get_select_decode(self.model, self.max_len,
                                      *self._sample_cfg)
            nxt, logps, last, _ = step(self._last, self._generator,
                                       self._caches)
        self._keep_last(last)
        # the one device -> host sync of the step
        toks = nxt.cpu().numpy()[:, None]
        lps = logps.cpu().numpy()[:, None]
        self._n_steps += 1
        return self._commit(toks, np.ones(self.max_batch, np.int64), lps)

    def run_until_done(self, max_steps: Optional[int] = None
                       ) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while self._queue or self.num_active:
            out.update(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        out.update(self._drain_finished())
        return out

    # ---- speculative decoding -------------------------------------------
    def _spec_eligible(self) -> bool:
        """Speculation verifies against the greedy choice, so it runs only
        while every active slot decodes greedily (temperature ~ 0 counts as
        greedy, as in ``sample_logits``)."""
        for r in self._slots:
            if r is None:
                continue
            do_sample, temperature, _, _ = r.sampling or self._sample_cfg
            if do_sample and temperature > 1e-6:
                return False
        return True

    def _step_speculative(self) -> Dict[int, np.ndarray]:
        """One multi-token step: drafts from each slot's history, one verify
        call, and each slot's accepted run committed (``_commit``)."""
        k = self.speculative_k
        drafts = np.zeros((self.max_batch, k - 1), np.int32)
        for s, r in enumerate(self._slots):
            if r is None or k == 1:
                continue
            hist = (np.concatenate([r.ids, np.asarray(r.tokens, np.int64)])
                    if r.tokens else r.ids)
            # the lookup's first token predicts the position the in-call
            # argmax decides, so its continuation rides the chunk
            prop = ngram_propose(hist, k, self.speculative_ngram)
            if prop.size > 1:
                drafts[s, :prop.size - 1] = prop[1:]
        step = _get_spec_decode(self.model, self.max_len, k)
        emitted, n_emit, logps, last, _ = step(
            self._last, torch.from_numpy(drafts).to(self.device),
            self._caches)
        self._keep_last(last)
        # the one device -> host sync of the step
        toks = emitted.cpu().numpy()
        n_row = n_emit.cpu().numpy()
        lps = logps.cpu().numpy()
        self._n_steps += 1
        self._n_spec_steps += 1
        before = [(r, len(r.tokens)) for r in self._slots if r is not None]
        out = self._commit(toks, n_row, lps)
        for req, n0 in before:
            got = len(req.tokens) - n0
            req.spec_rounds += 1
            req.spec_accepted += got - 1
            self._n_spec_accepted += got - 1
            self._n_spec_emitted += got
            self._n_spec_slot_rounds += 1
        return out

    def _commit(self, toks, n_emit, lps) -> Dict[int, np.ndarray]:
        """Hand each active slot s its emitted run toks[s, :n_emit[s]]
        (logprobs lps[s, j]), cut at the request's stop condition (eos,
        stop set, token budget); retire finished requests, advance the
        others' lengths by what they took, stream, then refill the slots.
        Returns the requests that finished {rid: generated ids}."""
        retiring, events = [], []
        adv = np.zeros(self.max_batch, np.int32)
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            deliver, stopped = [], False
            for j in range(int(n_emit[s])):
                t = int(toks[s, j])
                deliver.append(t)
                if ((self.eos_token_id is not None and t == self.eos_token_id)
                        or (req.stop_token_ids is not None
                            and t in req.stop_token_ids)):
                    stopped = True
                    break
                if len(req.tokens) + len(deliver) >= req.max_new_tokens:
                    break
            req.tokens.extend(deliver)
            if req.want_logprobs:
                req.logprobs.extend(float(lp) for lp in lps[s, :len(deliver)])
            self._n_tokens += len(deliver)
            finished = stopped or len(req.tokens) >= req.max_new_tokens
            if finished:
                self._record_reason(
                    req.rid, "stop" if stopped else "length",
                    logprobs=list(req.logprobs) if req.want_logprobs else None)
                retiring.append(s)
            else:
                adv[s] = len(deliver)
            if req.on_token is not None:
                for j, t in enumerate(deliver):
                    events.append((req.on_token, req.on_token_arity, req.rid,
                                   t, float(lps[s, j]),
                                   finished and j == len(deliver) - 1))
        self._lengths = (self._lengths + adv).astype(np.int32)
        for s in retiring:
            req = self._slots[s]
            self._finished[req.rid] = np.asarray(req.tokens, np.int64)
            self._n_finished += 1
            self._release_slot(s)
        for cb, arity, rid, t, lp, done in events:   # state is consistent
            if arity == 4:
                cb(rid, t, done, lp)
            else:
                cb(rid, t, done)
        self._admit()
        return self._drain_finished()

    # ---- internals ------------------------------------------------------
    def _require_fit(self, n_prompt: int, max_new: int):
        """Slot capacity at admission. With speculation every dispatch
        writes a k-token chunk from the row's frontier, so the last one
        needs k-1 positions of slack for the rejected drafts' KV."""
        slack = (self.speculative_k - 1) if self.speculative_k else 0
        if n_prompt + max_new + slack > self.max_len:
            extra = f" + speculation slack ({slack})" if slack else ""
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({max_new})"
                f"{extra} exceeds engine max_len {self.max_len}")

    def _merge_sampling(self, do_sample, temperature, top_k, top_p):
        """Engine defaults overlaid with the request's overrides; None when
        the result equals the engine config."""
        if all(v is None for v in (do_sample, temperature, top_k, top_p)):
            return None
        eng_s, eng_t, eng_k, eng_p = self._sample_cfg
        sampling = (bool(eng_s if do_sample is None else do_sample),
                    float(eng_t if temperature is None else temperature),
                    int(eng_k if top_k is None else top_k),
                    float(eng_p if top_p is None else top_p))
        return None if sampling == self._sample_cfg else sampling

    @torch.inference_mode()
    def _keep_last(self, last):
        """Keep a copy of a decode unit's next logits as the engine's own:
        a unit's outputs last only until the model's next unit call (its
        CUDA graphs share one pool), and admission replays prefills. A new
        tensor, so a reference to the previous ``_last`` keeps its
        values."""
        self._last = last.clone()

    def _record_reason(self, rid, reason, logprobs=None):
        if reason == "cancelled":
            self._n_cancelled += 1
        self._finished_reason[rid] = reason
        if logprobs is not None:
            self._finished_logprobs[rid] = logprobs

    def _drain_finished(self):
        done, self._finished = self._finished, {}
        return done

    def _alloc_slot(self) -> int:
        for s, r in enumerate(self._slots):
            if r is None:
                return s
        return -1

    def _release_slot(self, s: int) -> None:
        self._slots[s] = None
        self._lengths[s] = 0

    def _bucket(self, n: int) -> int:
        """Prompt-length bucket: next power of two times the page size,
        capped at max_len."""
        b = self.page_size
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _admit(self):
        """FIFO admission: prefill queued requests into free slots."""
        while self._queue:
            slot = self._alloc_slot()
            if slot < 0:
                return
            req = self._queue.pop(0)
            self._prefill_into(slot, req)
            self._slots[slot] = req

    def _bucketed_prefill(self, req: _Request):
        """One prompt through the bucketed prefill. Returns (last [1, V],
        per-layer dense caches, S0, bucket)."""
        S0 = int(req.ids.size)
        bucket = self._bucket(S0)
        ragged = S0 != bucket
        pad_mask = None
        if ragged:
            pad_mask = torch.zeros(1, bucket, dtype=torch.bool,
                                   device=self.device)
            pad_mask[0, :S0] = True
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :S0] = req.ids
        prefill = _get_prefill_step(self.model, bucket, ragged,
                                    rope_len=self.max_len)
        # the engine keeps one set of dense buffers a bucket
        last, caches = prefill(torch.from_numpy(ids).to(self.device),
                               torch.tensor([S0], dtype=torch.int32,
                                            device=self.device), pad_mask,
                               _cache_buffers(self.model, 1, bucket, ragged,
                                              owner=self))
        return last, caches, S0, bucket

    def _prefill_into(self, slot: int, req: _Request):
        """Admission of one prompt in either mode (the JAX package's
        ``_prefill_into_latent`` differs only by the prefix cache, which is
        not ported): bucketed prefill, then its caches copied into the
        slot."""
        last, caches, S0, bucket = self._bucketed_prefill(req)
        self._scatter_prefill(slot, last, caches, bucket)
        self._lengths[slot] = S0

    @torch.inference_mode()
    def _scatter_prefill(self, slot: int, last, caches, bucket: int):
        """Copy one prefill's caches into ``slot`` (in place): its first
        pages of every layer, or in latent mode the first ``bucket``
        positions of its row (``_latent_scatter_fn``, ``serving.py:2891``,
        as a plain row copy); seed its last-logit row."""
        if self._latent_mode:
            for c_eng, c_new in zip(self._caches, caches):
                for key in ("c_kv", "k_pe"):
                    c_eng[key][slot, :bucket].copy_(c_new[key][0])
        else:
            ps = self.page_size
            n = bucket // ps
            base = slot * self._pages_per_slot
            for c_eng, c_new in zip(self._caches, caches):
                for key, pool in (("k", "k_pages"), ("v", "v_pages")):
                    c_eng[pool][:, base:base + n].copy_(
                        _page_tiles(c_new[key][0], ps))
        self._last[slot] = last[0].float()
