"""Continuous batching over a paged KV pool — counterpart of
``paddle_tpu/serving.py`` ``ContinuousBatchEngine``.

Requests join at any time; every ``step()`` decodes one token for every
active slot (sample + forward in one call), a finished request frees its
slot at once, and the queue refills it. The step units come from the
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
at each slot's length. Latent mode refuses speculation, preemption,
handoff and migration, as the JAX engine does.

Scheduling (``serving.py:423-443``, ``:1300-1420``, ``:2273-2564``): the
queue admits by (aged priority class, EDF deadline, rid); ``max_queue``
bounds it (``QueueFull``, or a capacity shed of a less important queued
request); a request whose deadline passed, or whose remaining budget is
below the observed admission-to-first-token floor, is shed before it takes
a slot; a strictly more important request may evict a slot's KV to the
host (``enable_preemption``) and the victim restores token-identically;
``prefill_chunk_tokens`` lands a long prompt one chunk a step with a decode
dispatch between chunks; ``enable_prefix_cache`` copies the longest
page-aligned prefix shared with an active slot and prefills only the
suffix. ``export_prefill`` / ``admit_prefilled`` hand a prefill to a peer
engine, ``export_slot`` / ``admit_migrated`` move a live stream; both seal
their host bundles with a CRC (``seal_bundle`` / ``verify_bundle``, the JAX
package's format and checksum). A ``torch.cuda.OutOfMemoryError`` at
admission or in a decode dispatch sheds the triggering request and shrinks
``max_active_slots``; a failure while the pool is being written poisons the
engine.

``speculative_k="auto"`` picks k from the autotune cost table
(``_resolve_spec_k``): the verify dispatch of each candidate width timed on
a throwaway pool, then ranked by ms per expected retired token.

Observability (``paddle_tpu_torch/observability``, the JAX engine's hooks
site for site): the catalog's metrics, the request spans (request, queue
wait, prefill, sampled decode steps, prefix lookup, slot free), the flight
recorder's events, the KV atlas fed from the host page accounting (never
from a device page table), the step-anatomy clock (``profiler``), the
per-request ``usage`` block (``request_usage``), ``debug_state`` and the
correctness sentinel (``sentinel``). Every hook guards on one attribute
(``enabled``) and costs nothing more while its subscriber is off, the
default when the engine is driven from Python; none adds a device sync.
The step and each admission hold ``cuda_graph.DEVICE_LOCK``, a host lock
that keeps the sentinel's reference replays off the engine's captures and
replays (``observability/sentinel.py``).

Not ported: multimodal ``pixel_values``, ``preflight``, the deathnote and
the chaos hooks (the sentinel's drill is ``FLAGS_perturb_decode_token``);
``Seq2SeqBatchEngine`` neither.
"""
from __future__ import annotations

import inspect
import math
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .framework.random import default_generator
from .generation import (_cache_buffers, _get_prefill_step,
                         _get_select_decode, _get_select_decode_rows,
                         _get_spec_decode)
from .jit.cuda_graph import DEVICE_LOCK
from .models.llama import head_dim_of, torch_dtype
from .observability import catalog as _metrics
from .observability import flightrecorder as _frec
from .observability import kvatlas as _kvatlas
from .observability import perf as _perf
from .observability import sentinel as _sentinel
from .observability import tracing as _tracing
from .speculative import ngram_propose
from .utils import flags as _flags

#: default priority class — lower value is MORE important (0 interactive,
#: 1 default, 2+ batch traffic)
PRIORITY_DEFAULT = 1

#: finish reasons (and logprobs) kept for the last this many requests
_REASON_KEEP = 4096

#: schema version stamped on every handoff / preemption / migration bundle
#: (an engine admits only bundles of its own version)
HANDOFF_SCHEMA_VERSION = 2


class HandoffCorrupt(RuntimeError):
    """A handoff / preemption / migration bundle failed its integrity
    check: checksum mismatch, schema version skew, the wrong kind, or an
    inconsistent payload. A RuntimeError, as in the JAX package: a fresh
    export makes a fresh bundle, so the fault is retryable upstream."""


def _bundle_digest(bundle: dict) -> int:
    """CRC32 over a bundle's leaves in sorted-key order: numpy leaves hash
    dtype + shape + raw bytes, scalars their repr; the top-level
    ``checksum`` is left out. The JAX package's digest, line for line, so
    both packages compute one checksum for one bundle."""
    crc = 0

    def upd(b: bytes):
        nonlocal crc
        crc = zlib.crc32(b, crc)

    def walk(path, o):
        if isinstance(o, np.ndarray):
            upd(f"{path}:{o.dtype.str}:{o.shape}".encode())
            upd(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                if path == "" and k == "checksum":
                    continue
                walk(f"{path}/{k}", o[k])
        elif isinstance(o, (list, tuple)):
            for i, x in enumerate(o):
                walk(f"{path}[{i}]", x)
        else:
            upd(f"{path}={o!r}".encode())

    walk("", bundle)
    return crc


def seal_bundle(bundle: dict) -> dict:
    """Stamp ``version`` + ``checksum`` onto a bundle (in place)."""
    bundle["version"] = HANDOFF_SCHEMA_VERSION
    bundle.pop("checksum", None)
    bundle["checksum"] = _bundle_digest(bundle)
    return bundle


def verify_bundle(bundle, kind: Optional[str] = None) -> dict:
    """The integrity gate in front of every bundle admission: schema
    version, checksum and (when given) the bundle ``kind``. Raises
    :class:`HandoffCorrupt`."""
    if not isinstance(bundle, dict):
        raise HandoffCorrupt(
            f"bundle is a {type(bundle).__name__}, not a dict")
    v = bundle.get("version")
    if v != HANDOFF_SCHEMA_VERSION:
        raise HandoffCorrupt(
            f"bundle schema version skew: bundle says {v!r}, this engine "
            f"speaks {HANDOFF_SCHEMA_VERSION} — prefill and decode tiers "
            "must run the same bundle schema")
    if kind is not None and bundle.get("kind", "prefill") != kind:
        raise HandoffCorrupt(
            f"bundle kind {bundle.get('kind')!r} where {kind!r} was "
            "expected")
    got = bundle.get("checksum")
    if got is None:
        raise HandoffCorrupt("bundle carries no checksum")
    want = _bundle_digest(bundle)
    if int(got) != want:
        raise HandoffCorrupt(
            f"bundle checksum mismatch (stored {int(got):#010x}, "
            f"computed {want:#010x}) — corrupted in transport or host "
            "memory; discard and re-export")
    return bundle


class QueueFull(RuntimeError):
    """Typed admission rejection: the bounded queue (``max_queue``) is at
    capacity and no slot is free. ``retry_after_s`` comes from the queue
    depth and the observed drain rate (``_retry_after_estimate``)."""

    def __init__(self, engine: str, depth: int, max_queue: int,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"{engine} engine admission queue is full "
            f"({depth}/{max_queue} queued, no free slot); retry later")
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(RuntimeError):
    """Typed deadline rejection: the request was submitted with no budget
    left (``slo_ms <= 0``)."""

    def __init__(self, engine: str, miss_ms: Optional[float] = None,
                 rid: Optional[int] = None):
        miss = (f" (deadline missed by {miss_ms:.0f}ms)"
                if miss_ms is not None else "")
        super().__init__(
            f"{engine} engine request deadline exceeded{miss}; "
            "the SLO budget was spent before decoding could start")
        self.miss_ms = miss_ms
        self.rid = rid


def _page_tiles(buf, page_size):
    """[n_tokens, hk, D] dense rows -> [hk, n_pages, page_size, D] page
    tiles (the pool layout)."""
    n_pages = buf.shape[0] // page_size
    hk, d = buf.shape[1], buf.shape[2]
    return buf.reshape(n_pages, page_size, hk, d).movedim(2, 0)


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A bundle leaf: a host copy of ``t`` in memory of its own (never a
    view of the pool or of a kept buffer, which later admissions
    overwrite). numpy has no bfloat16 without ml_dtypes, so a bf16 tensor
    is written as its raw 16-bit words, ``np.uint16``; other dtypes as
    themselves."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _leaf_tensor(a, device) -> torch.Tensor:
    """A bundle leaf on ``device``: raw bf16 words (the port's ``uint16``,
    or an ml_dtypes ``bfloat16`` array as the JAX package writes it, whose
    dtype is a 2-byte void, ``'<V2'``) read by their bits as
    ``torch.bfloat16``; any other dtype as itself."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype == np.uint16):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _bundle_nbytes(bundle: dict) -> int:
    """Host bytes of a bundle's per-layer K / V leaves (the bundle-size
    histogram and the KV atlas's parked bytes)."""
    return int(sum(k.nbytes + v.nbytes for k, v in bundle["layers"]))


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
    __slots__ = ("rid", "ids", "max_new_tokens", "tokens", "slot",
                 "sampling", "on_token", "on_token_arity", "stop_token_ids",
                 "logprobs", "want_logprobs", "spec_rounds", "spec_accepted",
                 "t_enqueue", "t_admit", "t_last", "handoff", "priority",
                 "deadline", "resume", "n_preempted", "on_shed", "ext_id",
                 "audit", "span", "queue_span", "dispatches")

    def __init__(self, rid, ids, max_new_tokens, sampling=None, on_token=None,
                 stop_token_ids=None, want_logprobs=False, priority=None,
                 slo_ms=None, request_id=None):
        self.rid = rid
        # the caller's request identity (engine rids are process-local)
        self.ext_id = None if request_id is None else str(request_id)
        self.ids = np.asarray(ids).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.slot = -1
        # submission -> admission -> first token -> each later token
        self.t_enqueue = time.perf_counter()
        self.t_admit = None
        self.t_last = None
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
        self.handoff = None         # prefilled-KV bundle from a peer
        # admission order: (aged priority, deadline, rid)
        self.priority = PRIORITY_DEFAULT if priority is None else int(priority)
        self.deadline = (self.t_enqueue + float(slo_ms) / 1000.0
                         if slo_ms is not None else math.inf)
        self.resume = None          # host KV bundle after a preemption
        self.n_preempted = 0
        self.on_shed = None         # callback (rid, info dict) or None
        # the sentinel's mark: None (unaudited), "shadow" (rate-sampled)
        # or "ondemand" (X-Audit forced), carried through preemption and
        # migration, consumed at retirement
        self.audit = None
        # the request's root span and its queue-wait child (None while
        # tracing is off)
        self.span = None
        self.queue_span = None
        # decode dispatches this request rode (the usage block)
        self.dispatches = 0


class _ChunkState:
    """A request mid chunked prefill: it has reserved a slot (invisible to
    ``_alloc_slot``) but does not decode yet; ``pos`` tokens of its prompt
    are in the slot's pages, the rest lands one chunk per ``step()``."""

    __slots__ = ("req", "slot", "pos", "t_admit", "span")

    def __init__(self, req: _Request, slot: int, t_admit: float, span=None):
        self.req = req
        self.slot = slot
        self.pos = 0          # prompt tokens already prefilled (page-aligned)
        self.t_admit = t_admit
        self.span = span      # the serving.prefill span, open across chunks


def spec_verify_params(cfg, max_batch: int) -> dict:
    """The shape params of the ``"spec_verify"`` cost table's signature, as
    the JAX package records them."""
    h, hk = cfg.num_attention_heads, cfg.num_key_value_heads
    return {"batch": int(max_batch), "hidden": int(cfg.hidden_size),
            "layers": int(cfg.num_hidden_layers),
            "intermediate": int(cfg.intermediate_size),
            "wtot": int((h + 2 * hk) * head_dim_of(cfg)),
            "vocab": int(cfg.vocab_size), "dtype": str(cfg.dtype)}


def _resolve_spec_k(model, max_batch: int, max_len: int,
                    page_size: int = 16, default: int = 4,
                    acceptance: float = 0.7) -> int:
    """The speculation chunk width k for this device from the autotune cost
    table (``serving.py:816-907``): kernel ``"spec_verify"``, candidates
    the chunk widths 2, 3, 4, 6 and 8 (up to ``max_len``), ranked by the
    registered cost model; the runner times one graphed verify dispatch
    (``_get_spec_decode``) on a throwaway pool of ``max_batch`` slots made
    for that candidate and dropped with it. The measured table is then
    re-ranked by ms over the expected retired tokens of a dispatch under a
    geometric acceptance model (sum of ``acceptance**i``), since the raw
    time of a dispatch always favours the narrowest chunk. With
    ``FLAGS_use_autotune`` off this returns ``default`` without touching
    the card; a persisted table re-ranks without measuring."""
    from .ops.hopper import autotune

    if not autotune.enabled():
        return default
    cfg = model.config
    try:
        params = spec_verify_params(cfg, max_batch)
    except (AttributeError, TypeError):
        return default  # not Llama-shaped: the default
    hd, hk = head_dim_of(cfg), cfg.num_key_value_heads
    sig = autotune.signature(params)
    cands = [(c,) for c in (2, 3, 4, 6, 8) if c <= max_len]
    dev = model.device
    probe = torch.empty(0, device=dev)
    can = autotune.can_measure(probe) and max_len % page_size == 0

    def runner(choice):
        (kk,) = choice
        step = _get_spec_decode(model, max_len, kk)
        pps = max_len // page_size
        n_pages = max_batch * pps
        dt = torch_dtype(cfg.dtype)
        lengths = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        page_indices = torch.arange(n_pages, dtype=torch.int32,
                                    device=dev).reshape(max_batch, pps)
        caches = [{
            "k_pages": torch.zeros(hk, n_pages, page_size, hd, dtype=dt,
                                   device=dev),
            "v_pages": torch.zeros(hk, n_pages, page_size, hd, dtype=dt,
                                   device=dev),
            "page_indices": page_indices, "lengths": lengths,
            "page_size": page_size,
        } for _ in range(cfg.num_hidden_layers)]
        last = torch.zeros(max_batch, cfg.vocab_size, dtype=torch.float32,
                           device=dev)
        drafts = torch.zeros(max_batch, max(kk - 1, 0), dtype=torch.int32,
                             device=dev)
        # every call writes the same pages at lengths 0: one graph serves
        # the candidate's timed calls
        return lambda: step(last, drafts, caches)[0]

    choice = autotune.search(
        "spec_verify", sig, (default,), cands, runner, can, params=params,
        cost_model=lambda c: autotune.analytical_cost("spec_verify", params,
                                                      c))
    ent = autotune.get_cache().entry("spec_verify",
                                     autotune.full_key(sig)) or {}
    table = ent.get("table") or {}
    best_k, best_score = int(choice[0]), None
    for (kk,) in cands:
        row = table.get(str(kk))
        if not row or row.get("status") != "ok":
            continue
        score = row["ms"] / sum(acceptance ** i for i in range(kk))
        if best_score is None or score < best_score:
            best_k, best_score = kk, score
    return best_k


def _preflight_kv_bytes(cfg, max_batch: int, max_len: int) -> Optional[int]:
    """The predicted pool footprint the KV atlas joins its measured
    occupancy against (``analysis/graph/cost.py`` ``kv_cache_bytes`` of
    the JAX package): layers x 2 (K+V) x kv heads x max_batch x max_len x
    head_dim x itemsize; None for a config without those fields."""
    try:
        layers, hk = int(cfg.num_hidden_layers), int(cfg.num_key_value_heads)
        d = int(head_dim_of(cfg))
        item = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    except (AttributeError, TypeError, ValueError, KeyError):
        return None
    return layers * 2 * hk * max_batch * max_len * d * item or None


class ContinuousBatchEngine:
    """In-flight batching: ``add_request()`` any time, ``step()`` decodes one
    token for every active slot.

    >>> eng = ContinuousBatchEngine(model, max_batch=4, max_len=256)
    >>> rid = eng.add_request(prompt_ids, max_new_tokens=64)
    >>> done = eng.run_until_done()   # {rid: np.ndarray of generated ids}

    The engine runs where the model's weights lie. ``enable_prefix_cache``
    reuses a page-aligned prompt prefix shared with an active slot;
    ``prefill_chunk_tokens`` (a multiple of ``page_size``) admits longer
    prompts one chunk a step; ``max_queue`` bounds the waiting queue;
    ``enable_preemption`` lets a strictly more important request evict a
    slot's KV to the host; ``aging_s`` improves a waiting request's class
    by one per ``aging_s`` seconds (0: strict classes).
    ``speculative_k`` (an int >= 1, None for off, or ``"auto"``: the
    autotune cost table's width, ``_resolve_spec_k``) is the chunk width of
    a speculative dispatch: one verified token plus up to k-1 drafts from
    an n-gram lookup of length up to ``speculative_ngram``. Dispatches with
    a sampling slot active take the one-token step."""

    # decode-step spans are sampled: a request's first token, then every
    # Nth (a full-length request traces O(tokens / N) spans)
    trace_decode_every = 16

    def __init__(self, model, max_batch: int, max_len: int,
                 page_size: int = 16, eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 enable_prefix_cache: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 enable_preemption: bool = False, aging_s: float = 5.0,
                 speculative_k=None, speculative_ngram: int = 3):
        if max_len % page_size != 0:
            raise ValueError("max_len must be a multiple of page_size")
        if speculative_k == "auto":
            speculative_k = _resolve_spec_k(model, max_batch, max_len,
                                            page_size=page_size)
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
                "append path (use mtp_speculative_generate for MLA "
                "self-drafting)")
        self.speculative_k = speculative_k or None
        self.speculative_ngram = int(speculative_ngram)
        if prefill_chunk_tokens is not None:
            prefill_chunk_tokens = int(prefill_chunk_tokens)
            if (prefill_chunk_tokens <= 0
                    or prefill_chunk_tokens % page_size != 0):
                raise ValueError(
                    f"prefill_chunk_tokens must be a positive multiple of "
                    f"page_size ({page_size}), got {prefill_chunk_tokens} "
                    "— later chunks continue at page-aligned positions")
        if max_queue is not None and int(max_queue) < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature} "
                             "(0 decodes greedily)")
        if enable_preemption and self._latent_mode:
            raise ValueError(
                "enable_preemption requires the paged KV layout — the "
                "latent (MLA) compressed rows have no host eviction path")
        self.model = model
        self.device = model.device
        self.max_batch, self.max_len, self.page_size = (max_batch, max_len,
                                                        page_size)
        self.eos_token_id = eos_token_id
        self._sample_cfg = (bool(do_sample), float(temperature), int(top_k),
                            float(top_p))
        self._generator = default_generator(self.device)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.max_queue = None if max_queue is None else int(max_queue)
        self.enable_preemption = bool(enable_preemption)
        self.aging_s = float(aging_s)

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
        self._poisoned = False
        self._slots: List[Optional[_Request]] = [None] * max_batch
        # slot -> _ChunkState, in service order
        self._chunking: Dict[int, _ChunkState] = {}
        # queue and finish state and the lifetime counters
        # (``serving.py:334-419``, without the metrics registry)
        self._engine_label = "decoder"
        self._next_rid = 0
        # the admission budget: max_batch until an OOM degrade shrinks it
        self.max_active_slots = int(self.max_batch)
        self._queue: List[_Request] = []
        self._finished: Dict[int, np.ndarray] = {}
        self._finished_reason: Dict[int, str] = {}
        self._finished_logprobs: Dict[int, list] = {}
        self._reason_order = deque()   # the retention window's order
        self._n_requests = self._n_finished = self._n_cancelled = 0
        self._n_rejected = self._n_preempted = 0
        self._n_migrated_out = self._n_migrated_in = 0
        self._n_shed = self._n_deadline_misses = self._n_degraded = 0
        self._n_slo_good = self._n_slo_late = 0
        self._n_tokens = self._n_steps = 0
        self._n_spec_steps = self._n_spec_emitted = 0
        self._n_spec_accepted = self._n_spec_slot_rounds = 0
        self.prefix_pages_reused = 0   # pages copied by prefix hits
        # per-request usage, kept over the finish reasons' window
        self._finished_usage: Dict[int, dict] = {}
        self._bind_metrics(self._engine_label)
        # the step-anatomy clock, the KV atlas and the correctness
        # sentinel: constructed disabled (each hot site reads one
        # ``enabled`` attribute); the HTTP server or a harness enables
        self.profiler = _perf.StepProfiler(self._engine_label)
        self.profiler.set_cost_params(
            _perf.decode_step_params(cfg, max_batch))
        self.kvatlas = _kvatlas.KvAtlas(
            self._engine_label, max_batch=max_batch, page_size=page_size,
            pages_per_slot=self._pages_per_slot,
            bytes_per_token=_kvatlas.kv_bytes_per_token(cfg),
            paged=not self._latent_mode,
            preflight_bytes=_preflight_kv_bytes(cfg, max_batch, max_len))
        self.sentinel = _sentinel.CorrectnessSentinel(self._engine_label,
                                                      self)
        # the reference replay reproduces this engine's decode
        self.sentinel.auditable = True
        # overload estimators: the best admission -> first token ever seen
        # (the provably-unmeetable floor) and the EWMA gap between
        # finishes (the drain rate behind Retry-After)
        self._ttft_admit_floor: Optional[float] = None
        self._ttft_admit_n = 0
        self._finish_interval_ewma: Optional[float] = None
        self._t_last_finish: Optional[float] = None

    # ---- public API -----------------------------------------------------
    def add_request(self, ids, max_new_tokens: int = 64, do_sample=None,
                    temperature=None, top_k=None, top_p=None,
                    stop_token_ids=None, logprobs=False,
                    on_token=None, priority=None, slo_ms=None,
                    on_shed=None, request_id=None, trace_ctx=None,
                    audit=None) -> int:
        """Queue one request (admitted at once when a slot is free).
        Sampling knobs default to the engine's; any override routes decoding
        through the per-row program. ``stop_token_ids`` retires the request
        on any of them, in addition to the engine eos; ``logprobs`` keeps
        the chosen-token logprobs; ``on_token(rid, token, done)`` streams
        each token, and a callback with four required positional
        parameters (or ``*args``) also gets the token's logprob as the 4th
        argument. ``priority`` (lower is more important, default
        ``PRIORITY_DEFAULT``) and ``slo_ms`` order admission; ``slo_ms`` is
        also a deadline: a request still queued when it passes is shed
        (``on_shed(rid, info)``), and ``slo_ms <= 0`` raises
        :class:`DeadlineExceeded`. With ``max_queue`` a request that would
        wait behind a full queue raises :class:`QueueFull`, unless a less
        important queued request can be shed for it. ``trace_ctx``, an
        inbound ``(trace_id, parent_span_id)`` (the HTTP layer's W3C
        ``traceparent``), parents the request's root span. ``audit``
        drives the correctness sentinel: True forces an on-demand audit
        (its verdict waitable through ``sentinel.wait_verdict``), False
        opts out, None leaves it to the sentinel's sampling rate. The
        keywords are the JAX engine's."""
        self._gate(priority, slo_ms)
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids).reshape(-1)
        self._require_fit(ids.size, int(max_new_tokens))
        sampling = self._request_sampling(do_sample, temperature, top_k,
                                          top_p)
        rid = self._enqueue(_Request(
            -1, ids, max_new_tokens, sampling, on_token,
            stop_token_ids, logprobs, priority=priority, slo_ms=slo_ms,
            request_id=request_id), on_shed, trace_ctx=trace_ctx,
            audit=audit)
        self._admit()
        return rid

    def finish_reason(self, rid: int):
        """"stop" | "length" | "cancelled" | "shed" | "migrated" once
        finished (kept for the last ``_REASON_KEEP`` requests), else
        None."""
        return self._finished_reason.get(rid)

    def logprobs(self, rid: int):
        """Chosen-token logprobs of a finished request that asked for them."""
        return self._finished_logprobs.get(rid)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    def stats(self) -> dict:
        """Lifetime counters and current occupancy (the front-end's
        /health payload), host values only. Reading it also refreshes the
        occupancy gauges, so /health and /metrics see one snapshot."""
        active = self.num_active
        self._m_active.set(active)
        self._m_depth.set(len(self._queue))
        return {
            "requests_admitted": self._n_requests,
            "requests_finished": self._n_finished,
            "requests_cancelled": self._n_cancelled,
            "requests_rejected": self._n_rejected,
            "requests_preempted": self._n_preempted,
            "requests_shed": self._n_shed,
            "deadline_misses": self._n_deadline_misses,
            "requests_migrated_out": self._n_migrated_out,
            "requests_migrated_in": self._n_migrated_in,
            "requests_slo_good": self._n_slo_good,
            "requests_slo_late": self._n_slo_late,
            "requests_active": active,
            "requests_queued": len(self._queue),
            "requests_prefilling": len(self._chunking),
            "decode_steps": self._n_steps,
            "tokens_generated": self._n_tokens,
            "slot_utilization": active / self.max_batch,
            # the live admission budget (an OOM degrade shrinks it)
            "max_active_slots": self.max_active_slots,
            "requests_degraded": self._n_degraded,
            "prefix_pages_reused": self.prefix_pages_reused,
            # tokens retired per slot per speculative dispatch (1.0 = no
            # gain); zeros while speculation is off
            "spec_dispatches": self._n_spec_steps,
            "spec_emitted_tokens": self._n_spec_emitted,
            "spec_accepted_tokens": self._n_spec_accepted,
            "accepted_tokens_per_dispatch": (
                self._n_spec_emitted / self._n_spec_slot_rounds
                if self._n_spec_slot_rounds else 0.0),
            # the step-anatomy, KV-atlas and sentinel scalars (zeros until
            # enabled and fed)
            **self.profiler.federated(),
            **self.kvatlas.federated(),
            **self.sentinel.federated(),
        }

    def debug_state(self) -> dict:
        """Host-side engine state for incident bundles and /debug/dump:
        the slot table, the queue, the chunked admissions and the
        ``stats()`` snapshot."""
        slots = []
        for s, r in enumerate(self._slots):
            if r is None:
                slots.append(None)
                continue
            row = {"rid": r.rid, "prompt_tokens": int(r.ids.size),
                   "generated": len(r.tokens),
                   "max_new_tokens": r.max_new_tokens, "slot": s,
                   "priority": r.priority}
            row.update(self.kvatlas.slot_info(
                s, int(r.ids.size) + len(r.tokens)))
            slots.append(row)
        return {
            "engine": self._engine_label,
            "max_batch": self.max_batch,
            "max_active_slots": self.max_active_slots,
            "slots": slots,
            "queue": [r.rid for r in self._queue],
            "prefilling": {
                s: {"rid": st.req.rid, "pos": st.pos,
                    "prompt_tokens": int(st.req.ids.size)}
                for s, st in self._chunking.items()},
            "poisoned": bool(self._poisoned),
            "prefix_pages_reused": self.prefix_pages_reused,
            "stats": self.stats(),
        }

    def request_usage(self, rid: int) -> Optional[dict]:
        """The usage block of a finished request (token counts, queue and
        compute ms, dispatches ridden); None while in flight or once out
        of the retention window."""
        return self._finished_usage.get(rid)

    def cancel(self, rid: int) -> bool:
        """Drop a queued request, free an active one's slot, or release a
        slot reserved mid chunked prefill; True if it was live."""
        rec = _frec.RECORDER
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                if self.kvatlas.enabled:
                    self.kvatlas.unpark(rid)   # a preempted request dies
                if rec.enabled:
                    rec.record(_frec.EV_CANCEL, rid=rid,
                               engine=self._engine_label, where="queued")
                self._record_reason(rid, "cancelled")
                self._trace_end(req, "cancelled")
                return True
        for s, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._release_slot(s)
                if rec.enabled:
                    rec.record(_frec.EV_CANCEL, rid=rid,
                               engine=self._engine_label, where="active")
                self._record_reason(rid, "cancelled")
                self._trace_end(req, "cancelled")
                self._admit()
                return True
        for s, st in list(self._chunking.items()):
            if st.req.rid == rid:
                del self._chunking[s]
                self._release_slot(s)
                if st.span is not None:
                    st.span.end("cancelled")
                if rec.enabled:
                    rec.record(_frec.EV_CANCEL, rid=rid,
                               engine=self._engine_label,
                               where="prefilling")
                self._record_reason(rid, "cancelled")
                self._trace_end(st.req, "cancelled")
                self._admit()
                return True
        return False

    def step(self) -> Dict[int, np.ndarray]:
        """Admit, advance at most one prefill chunk, then decode one token
        for every active slot; returns the requests that finished {rid:
        generated ids}. The final chunk's logits row is consumed by the
        same step's decode. Holds ``DEVICE_LOCK`` throughout."""
        with DEVICE_LOCK:
            return self._step()

    def _step(self) -> Dict[int, np.ndarray]:
        self._check_poisoned()
        # the step-anatomy clock: one attribute read while profiling is
        # off; its laps read the host clock and never wait on the card
        prof = self.profiler
        clk = prof.clock if prof.enabled else None
        if clk is not None:
            clk.begin()
        self._admit()
        if clk is not None:
            clk.lap("admit")
        self._advance_chunk()
        if clk is not None:
            clk.lap("prefill")
        if self.num_active == 0:
            return self._drain_finished()
        # reserved (mid-chunk) slots hold their length at the chunk
        # frontier: the fixed-shape decode writes a throwaway token's KV
        # there, and the next chunk overwrites it (a length of 0 would put
        # it inside the prefix that chunk gathers)
        self._lengths_dev.copy_(torch.from_numpy(self._lengths))
        if self.speculative_k is not None and self._spec_eligible():
            return self._step_speculative(clk)
        t_dispatch = time.perf_counter()
        try:
            with _frec.incident_scope("engine.step"):
                if any(r is not None and r.sampling is not None
                       for r in self._slots):
                    rows = [(r.sampling or self._sample_cfg)
                            if r is not None else self._sample_cfg
                            for r in self._slots]
                    dev = self.device
                    step = _get_select_decode_rows(self.model, self.max_len)
                    nxt, logps, last, _ = step(
                        self._last, self._generator,
                        torch.tensor([r[0] for r in rows], dtype=torch.bool,
                                     device=dev),
                        torch.tensor([r[1] for r in rows],
                                     dtype=torch.float32, device=dev),
                        torch.tensor([r[2] for r in rows], dtype=torch.int32,
                                     device=dev),
                        torch.tensor([r[3] for r in rows],
                                     dtype=torch.float32, device=dev),
                        self._caches)
                else:
                    step = _get_select_decode(self.model, self.max_len,
                                              *self._sample_cfg)
                    nxt, logps, last, _ = step(self._last, self._generator,
                                               self._caches)
        except torch.cuda.OutOfMemoryError as e:
            # shed the most recently admitted slot and shrink the budget;
            # its throwaway KV writes sit above every frontier
            self._degrade_on_oom(None, where="step", exc=e)
            return self._drain_finished()
        self._keep_last(last)
        if clk is not None:
            clk.lap("dispatch")
        # the one device -> host sync of the step
        toks = nxt.cpu().numpy()[:, None]
        lps = logps.cpu().numpy()[:, None]
        if clk is not None:
            clk.lap("sync")
        toks = self._perturb_drill(toks)
        now = time.perf_counter()
        self._m_step.observe(now - t_dispatch)
        self._n_steps += 1
        fr_seq = 0
        rec = _frec.RECORDER
        if rec.enabled:
            # one event per dispatch, not per token
            fr_seq = rec.record(_frec.EV_STEP, engine=self._engine_label,
                                active=self.num_active,
                                seconds=now - t_dispatch)
        return self._commit(toks, np.ones(self.max_batch, np.int64), lps,
                            t_dispatch, now, clk, fr_seq)

    def run_until_done(self, max_steps: Optional[int] = None
                       ) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while self._queue or self.num_active or self._chunking:
            out.update(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        out.update(self._drain_finished())
        return out

    # ---- disaggregated serving: prefill export / prefilled admission ----
    def export_prefill(self, ids, max_new_tokens: int = 64) -> dict:
        """Run the bucketed prefill of one prompt and return its KV as a
        sealed host bundle instead of admitting it (``serving.py:1436``):
        the prompt ids, each layer's dense K / V at the prefill bucket (bf16
        as raw 16-bit words) and the last-logit row. No slot is taken and no
        engine state changes."""
        if self._latent_mode:
            raise NotImplementedError(
                "KV handoff is not supported in latent (MLA) mode — the "
                "compressed cache rows are engine-layout-specific")
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids).reshape(-1)
        if ids.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_len {self.max_len}")
        req = _Request(-1, ids, max_new_tokens)
        with DEVICE_LOCK:
            last, caches, S0, bucket = self._bucketed_prefill(req)
            layers = [(_host_leaf(c["k"][0]), _host_leaf(c["v"][0]))
                      for c in caches]
            last = _host_leaf(last[0].float())
        return seal_bundle({
            "kind": "prefill",
            "ids": np.asarray(ids, np.int64),
            "prompt_tokens": int(S0),
            "bucket": int(bucket),
            "page_size": int(self.page_size),
            "layers": layers,
            "last": last,
        })

    def admit_prefilled(self, handoff: dict, max_new_tokens: int = 64,
                        do_sample=None, temperature=None, top_k=None,
                        top_p=None, on_token=None, stop_token_ids=None,
                        logprobs=False, priority=None, slo_ms=None,
                        on_shed=None, request_id=None,
                        trace_ctx=None) -> int:
        """Queue a request whose prefill ran on a peer engine
        (``export_prefill`` over the same weights): admission copies the
        bundle's K / V into the slot's pages and decoding starts from the
        shipped last-logit row. The other knobs are ``add_request``'s."""
        self._gate(priority, slo_ms)
        if self._latent_mode:
            raise NotImplementedError(
                "KV handoff is not supported in latent (MLA) mode")
        verify_bundle(handoff, kind="prefill")
        bucket = int(handoff["bucket"])
        if bucket % self.page_size != 0 or bucket > self.max_len:
            raise ValueError(
                f"handoff bucket {bucket} does not fit this engine "
                f"(page_size {self.page_size}, max_len {self.max_len}) — "
                f"prefill and decode engines must share the serving shape")
        if len(handoff["layers"]) != len(self._caches):
            raise ValueError(
                f"handoff carries {len(handoff['layers'])} layers, engine "
                f"has {len(self._caches)} — different models?")
        ids = np.asarray(handoff["ids"]).reshape(-1)
        self._require_fit(int(ids.size), int(max_new_tokens))
        sampling = self._request_sampling(do_sample, temperature, top_k,
                                          top_p)
        req = _Request(-1, ids, max_new_tokens, sampling,
                       on_token, stop_token_ids, logprobs, priority=priority,
                       slo_ms=slo_ms, request_id=request_id)
        req.handoff = handoff
        rid = self._enqueue(req, on_shed, trace_ctx=trace_ctx, audit=False)
        self._admit()
        return rid

    def _admit_handoff(self, slot: int, req: _Request):
        """Admission from a handoff bundle: the shipped buffers go to the
        card, then through the same page write as a local prefill; no
        model forward runs."""
        h, req.handoff = req.handoff, None
        self._m_bundle["handoff"].observe(float(_bundle_nbytes(h)))
        self._write_bundle(slot, h, "handoff admission")
        self._lengths[slot] = int(h["prompt_tokens"])

    # ---- live migration: export a decoding slot / admit it elsewhere -----
    def export_slot(self, rid: int) -> dict:
        """Export a request that is decoding as a sealed migration bundle
        and release its slot (``serving.py:1566``): its KV pages densified
        to host numpy, the last-logit row, the prompt, the tokens so far and
        the decode-side state (sampling, stops, logprobs, priority,
        remaining SLO, the sentinel mark). ``admit_migrated`` on a peer over
        the same weights continues the stream token-identically. Queued or
        prefilling requests raise ValueError."""
        if self._latent_mode:
            raise NotImplementedError(
                "migration is not supported in latent (MLA) mode — the "
                "compressed cache rows are engine-layout-specific")
        slot = next((s for s, r in enumerate(self._slots)
                     if r is not None and r.rid == rid), None)
        if slot is None:
            raise ValueError(
                f"request {rid} holds no decoding slot (queued, "
                "prefilling, finished or unknown) — only active slots "
                "migrate; re-place queued requests from scratch")
        req = self._slots[slot]
        with DEVICE_LOCK:
            kv = self._slot_kv_bundle(slot, req)
        now = time.perf_counter()
        bundle = seal_bundle({
            "kind": "migrate",
            "ids": np.asarray(req.ids, np.int64),
            "prompt_tokens": int(req.ids.size),
            "tokens": np.asarray(req.tokens, np.int64),
            "max_new_tokens": int(req.max_new_tokens),
            "sampling": list(req.sampling or self._sample_cfg),
            "stop_token_ids": (sorted(req.stop_token_ids)
                               if req.stop_token_ids else None),
            "want_logprobs": bool(req.want_logprobs),
            "logprobs": [float(x) for x in req.logprobs],
            "audit": req.audit,
            "priority": int(req.priority),
            "slo_remaining_s": (None if req.deadline == math.inf
                                else float(req.deadline - now)),
            "page_size": int(self.page_size),
            "bucket": int(kv["bucket"]),
            "kv_len": int(kv["kv_len"]),
            "layers": kv["layers"],
            "last": kv["last"],
        })
        nbytes = _bundle_nbytes(kv)
        self._release_slot(slot)
        self._m_bundle["migrate"].observe(float(nbytes))
        self._n_migrated_out += 1
        self._m_sched["migrate_out"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_MIGRATE_OUT, rid=rid,
                       engine=self._engine_label, slot=slot,
                       kv_len=int(kv["kv_len"]),
                       generated=len(req.tokens), bytes=nbytes)
        self._record_reason(rid, "migrated")
        self._trace_end(req, "migrated")
        req.slot = -1
        self._admit()     # the freed slot can refill at once
        return bundle

    def admit_migrated(self, handoff: dict, on_token=None,
                       on_shed=None, trace_ctx=None) -> int:
        """Admit a mid-stream request exported by a peer's
        :meth:`export_slot`: the KV restores through the preemption-restore
        path and decoding resumes where the source stopped. The decode-side
        knobs come from the bundle; ``on_token`` fires for new tokens
        only."""
        if not isinstance(handoff, dict):
            raise HandoffCorrupt(
                f"bundle is a {type(handoff).__name__}, not a dict")
        self._check_queue_bound(
            priority=int(handoff.get("priority", PRIORITY_DEFAULT)))
        if self._latent_mode:
            raise NotImplementedError(
                "migration is not supported in latent (MLA) mode")
        verify_bundle(handoff, kind="migrate")
        bucket = int(handoff["bucket"])
        if bucket % self.page_size != 0 or bucket > self.max_len:
            raise ValueError(
                f"migration bucket {bucket} does not fit this engine "
                f"(page_size {self.page_size}, max_len {self.max_len}) — "
                "source and destination engines must share the serving "
                "shape")
        if len(handoff["layers"]) != len(self._caches):
            raise ValueError(
                f"migration bundle carries {len(handoff['layers'])} "
                f"layers, engine has {len(self._caches)} — different "
                "models?")
        ids = np.asarray(handoff["ids"]).reshape(-1)
        tokens = [int(t) for t in np.asarray(handoff["tokens"]).reshape(-1)]
        kv_len = int(handoff["kv_len"])
        if kv_len != ids.size + len(tokens):
            raise HandoffCorrupt(
                f"migration bundle is inconsistent: kv_len {kv_len} != "
                f"prompt {ids.size} + generated {len(tokens)}")
        max_new = int(handoff["max_new_tokens"])
        self._require_fit(int(ids.size), max_new)
        samp = handoff.get("sampling")
        sampling = self._merge_sampling(*samp) if samp else None
        slo_rem = handoff.get("slo_remaining_s")
        req = _Request(-1, ids, max_new, sampling, on_token,
                       handoff.get("stop_token_ids"),
                       bool(handoff.get("want_logprobs")),
                       priority=handoff.get("priority"),
                       slo_ms=(slo_rem * 1000.0 if slo_rem is not None
                               else None))
        req.tokens = tokens
        req.logprobs = [float(x) for x in handoff.get("logprobs") or []]
        # the restore path takes it: no model forward runs
        req.resume = seal_bundle({
            "bucket": bucket, "kv_len": kv_len,
            "layers": handoff["layers"], "last": handoff["last"]})
        # the sentinel's mark rides the bundle: a migrated-in stream
        # finishes here, so the audit obligation lands on this engine
        rid = self._enqueue(req, on_shed, trace_ctx=trace_ctx,
                            carried_audit=handoff.get("audit"))
        if self.kvatlas.enabled:
            # parked host-side until the restore consumes it
            self.kvatlas.park(rid, _bundle_nbytes(handoff))
        self._n_migrated_in += 1
        self._m_sched["migrate_in"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_MIGRATE_IN, rid=rid,
                       engine=self._engine_label, generated=len(tokens),
                       kv_len=kv_len, prompt_tokens=int(ids.size))
        self._admit()
        return rid

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

    def _step_speculative(self, clk=None) -> Dict[int, np.ndarray]:
        """One multi-token step: drafts from each slot's history, one verify
        call, and each slot's accepted run committed (``_commit``).
        Reserved slots hold their length, so the k throwaway tokens written
        for them park where the next chunk lands."""
        k = self.speculative_k
        t_dispatch = time.perf_counter()
        drafts = np.zeros((self.max_batch, k - 1), np.int32)
        n_drafted = 0
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
                n_drafted += int(prop.size - 1)
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SPEC_PROPOSE, engine=self._engine_label,
                       active=self.num_active, k=k, drafted=n_drafted)
        if clk is not None:
            clk.lap("draft")
        try:
            with _frec.incident_scope("engine.step"):
                step = _get_spec_decode(self.model, self.max_len, k)
                emitted, n_emit, logps, last, _ = step(
                    self._last, torch.from_numpy(drafts).to(self.device),
                    self._caches)
        except torch.cuda.OutOfMemoryError as e:
            self._degrade_on_oom(None, where="step", exc=e)
            return self._drain_finished()
        self._keep_last(last)
        if clk is not None:
            clk.lap("dispatch")
        # the one device -> host sync of the step
        toks = emitted.cpu().numpy()
        n_row = n_emit.cpu().numpy()
        lps = logps.cpu().numpy()
        if clk is not None:
            clk.lap("sync")
        toks = self._perturb_drill(toks)
        now = time.perf_counter()
        self._m_step.observe(now - t_dispatch)
        self._n_steps += 1
        self._n_spec_steps += 1
        fr_seq = 0
        if rec.enabled:
            fr_seq = rec.record(_frec.EV_STEP, engine=self._engine_label,
                                active=self.num_active,
                                seconds=now - t_dispatch)
            rec.record(_frec.EV_SPEC_VERIFY, engine=self._engine_label,
                       active=self.num_active, k=k,
                       seconds=now - t_dispatch)
        return self._commit(toks, n_row, lps, t_dispatch, now, clk, fr_seq,
                            spec_k=k)

    def _perturb_drill(self, toks):
        """``FLAGS_perturb_decode_token`` (the sentinel's drill, as this
        thread sees it): the first active slot's first emitted token
        becomes (token + 1) mod vocab, skipping eos, after the host copy.
        The device state keeps the model's own token, so only the
        reported stream leaves the reference."""
        if not _flags.flag("FLAGS_perturb_decode_token"):
            return toks
        s0 = next((s for s, r in enumerate(self._slots) if r is not None),
                  None)
        if s0 is None:
            return toks
        vocab = int(self.model.config.vocab_size)
        t_new = (int(toks[s0, 0]) + 1) % vocab
        if self.eos_token_id is not None and t_new == int(self.eos_token_id):
            t_new = (t_new + 1) % vocab
        toks = toks.copy()
        toks[s0, 0] = t_new
        return toks

    def _commit(self, toks, n_emit, lps, t_dispatch: float, now: float,
                clk=None, fr_seq: int = 0,
                spec_k: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Hand each active slot s its emitted run toks[s, :n_emit[s]]
        (logprobs lps[s, j]), cut at the request's stop condition (eos,
        stop set, token budget); retire finished requests, advance the
        others' lengths by what they took (reserved slots hold theirs),
        stream, then refill the slots. ``spec_k``: a speculative
        dispatch's width (its acceptance accounting). Returns the requests
        that finished {rid: generated ids}."""
        retiring, events = [], []
        adv = np.zeros(self.max_batch, np.int32)
        # span bounds from the timestamps the step metric already took
        trace_on = _tracing.get_tracer().enabled
        t0_ns, t1_ns = ((int(t_dispatch * 1e9), int(now * 1e9))
                        if trace_on else (0, 0))
        at = self.kvatlas
        at_on = at.enabled
        accepted_total = emitted_total = slot_rounds = 0
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            req.dispatches += 1
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
            for j, t in enumerate(deliver):
                req.tokens.append(t)
                if req.want_logprobs:
                    req.logprobs.append(float(lps[s, j]))
                self._observe_token(req, now)
            if at_on and deliver:
                # the ledger's frontier: delivered tokens only
                at.advance(s, len(deliver))
            if spec_k is not None:
                got = len(deliver) - 1
                req.spec_rounds += 1
                req.spec_accepted += got
                accepted_total += got
                emitted_total += len(deliver)
                slot_rounds += 1
                self._m_spec_accept.observe(got)
            if trace_on:
                self._trace_decode_step(req, t0_ns, t1_ns)
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
        if spec_k is not None:
            self._n_spec_emitted += emitted_total
            self._n_spec_accepted += accepted_total
            self._n_spec_slot_rounds += slot_rounds
            rec = _frec.RECORDER
            if rec.enabled:
                proposed = max(slot_rounds * (spec_k - 1), 1)
                rec.record(_frec.EV_SPEC_ACCEPT, engine=self._engine_label,
                           accepted=accepted_total, emitted=emitted_total,
                           rate=accepted_total / proposed)
        active = int(sum(r is not None for r in self._slots))
        self._lengths = (self._lengths + adv).astype(np.int32)
        for s in retiring:
            req = self._slots[s]
            self._finished[req.rid] = np.asarray(req.tokens, np.int64)
            self._count_finished(req)
            self._release_slot(s)
            self._trace_end(req, "ok")
        # stream after the state is consistent: every callback fires, the
        # first exception then propagates
        first_exc = None
        for cb, arity, rid, t, lp, done in events:
            try:
                if arity == 4:
                    cb(rid, t, done, lp)
                else:
                    cb(rid, t, done)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        if clk is not None:
            clk.lap("retire")
        self._admit()
        if clk is not None:
            clk.lap("admit")   # the trailing refill adds to admit
            self.profiler.commit(
                active=active,
                kv_len=max((int(r.ids.size) + len(r.tokens)
                            for r in self._slots if r is not None),
                           default=0),
                fr_seq=fr_seq)
        return self._drain_finished()

    # ---- bookkeeping ----------------------------------------------------
    def _gate(self, priority, slo_ms):
        """The checks every submission runs first: a budget already spent
        raises :class:`DeadlineExceeded` (counted as a shed), a full queue
        :class:`QueueFull` (``_check_queue_bound``)."""
        if slo_ms is not None and float(slo_ms) <= 0:
            self._count_deadline_reject(float(slo_ms))
            raise DeadlineExceeded(self._engine_label,
                                   miss_ms=-float(slo_ms))
        self._check_queue_bound(
            priority=PRIORITY_DEFAULT if priority is None else int(priority))

    def _enqueue(self, req: _Request, on_shed, trace_ctx=None, audit=None,
                 carried_audit=None) -> int:
        """Give a built request the next rid, count it, mark its audit
        (``audit`` as ``add_request`` takes it, or the mark a migration
        bundle carried), open its spans and queue it; the caller admits."""
        req.rid = self._next_rid
        self._next_rid += 1
        self._n_requests += 1
        self._m_req_admitted.inc()
        req.on_shed = on_shed
        if carried_audit is not None:
            self._carry_audit(req, carried_audit)
        else:
            self._mark_audit(req, audit)
        self._trace_submit(req, trace_ctx)
        self._queue.append(req)
        self._fr_submit(req)
        return req.rid

    def _mark_audit(self, req: _Request, audit):
        """Admission-time sentinel decision (``serving.py:1267``): mark
        the request for a shadow (rate-sampled) or on-demand (forced)
        audit. Only effectively greedy requests are auditable (the
        reference replay is greedy); a forced audit of a sampled one
        records a typed ``skipped`` verdict. Audited requests keep their
        logprobs, so the verdict carries the drift."""
        sn = self.sentinel
        if audit is False or not sn.enabled:
            return
        forced = bool(audit)
        if not forced and not sn.should_sample():
            return
        if not sn.auditable or (req.sampling or self._sample_cfg)[0]:
            if forced:
                sn.register_forced(req.rid)
                sn.skip(req.rid, "unsupported" if not sn.auditable
                        else "sampling", "ondemand", req.ext_id)
            return
        req.audit = "ondemand" if forced else "shadow"
        req.want_logprobs = True
        if forced:
            sn.register_forced(req.rid)

    def _carry_audit(self, req: _Request, mark):
        """A migration bundle's sentinel mark, taken when this engine's
        sentinel is on."""
        sn = self.sentinel
        if mark in ("shadow", "ondemand") and sn.enabled and sn.auditable:
            req.audit = mark
            req.want_logprobs = True
            if mark == "ondemand":
                sn.register_forced(req.rid)

    def _request_sampling(self, do_sample, temperature, top_k, top_p):
        """A submission's sampling overrides, checked, over the engine's."""
        if temperature is not None and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature} "
                             "(0 decodes greedily)")
        return self._merge_sampling(do_sample, temperature, top_k, top_p)

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

    def _sched_key(self, req: _Request, now: float):
        """Admission order: (aged priority class, deadline, rid). Aging
        takes one class off per ``aging_s`` waited; within a class the
        earliest deadline wins; rid keeps the rest FIFO."""
        eff = req.priority
        if self.aging_s > 0:
            eff -= int((now - req.t_enqueue) / self.aging_s)
        return (eff, req.deadline, req.rid)

    def _peek_next(self, now: float) -> Optional[_Request]:
        if not self._queue:
            return None
        return min(self._queue, key=lambda r: self._sched_key(r, now))

    def _pop_next(self, now: float) -> _Request:
        req = self._peek_next(now)
        self._queue.remove(req)
        return req

    def _count_finished(self, req: _Request):
        """Retirement accounting: the counter, the usage block, the
        sentinel's hand-off of an audited request and, for a request that
        carried an ``slo_ms``, whether it retired inside it."""
        self._n_finished += 1
        self._m_req_finished.inc()
        self._record_usage(req)
        sn = self.sentinel
        if sn.enabled and req.audit is not None:
            # a snapshot and an enqueue; the replay runs on the worker
            sn.on_finish(req, self._finished_reason.get(req.rid))
        if req.deadline != math.inf:
            if time.perf_counter() <= req.deadline:
                self._n_slo_good += 1
                self._m_slo_good.inc()
            else:
                self._n_slo_late += 1
                self._m_slo_late.inc()

    def _record_usage(self, req: _Request):
        """The usage block at retirement: token counts, queue and compute
        milliseconds, dispatches ridden."""
        now = time.perf_counter()
        t_admit = req.t_admit if req.t_admit is not None else now
        done = req.t_last if req.t_last is not None else now
        n_disp, n_tok = req.dispatches, len(req.tokens)
        self._finished_usage[req.rid] = {
            "prompt_tokens": int(req.ids.size),
            "completion_tokens": n_tok,
            "queue_ms": max(0.0, (t_admit - req.t_enqueue) * 1e3),
            "compute_ms": max(0.0, (done - t_admit) * 1e3),
            "dispatches": n_disp,
            "accepted_tokens_per_dispatch": (n_tok / n_disp
                                             if n_disp else 0.0),
        }

    def _observe_admission(self, req: _Request, now: float):
        """Queue-wait accounting as a request takes a slot, under its root
        span (the histogram's exemplar)."""
        with _tracing.get_tracer().use(req.span):
            self._m_queue_wait.observe(now - req.t_enqueue)
        req.t_admit = now

    def _observe_token(self, req: _Request, now: float):
        """Per-token accounting (after the append), under the request's
        root span: the first token is TTFT and lowers the service floor
        (admission -> first token), later ones the inter-token gap."""
        with _tracing.get_tracer().use(req.span):
            if len(req.tokens) == 1:
                self._m_ttft.observe(now - req.t_enqueue)
                if req.t_admit is not None:
                    x = now - req.t_admit
                    f = self._ttft_admit_floor
                    self._ttft_admit_floor = x if f is None else min(f, x)
                    self._ttft_admit_n += 1
            elif req.t_last is not None:
                self._m_inter.observe(now - req.t_last)
        req.t_last = now
        self._n_tokens += 1
        self._m_tokens.inc()

    # ---- metrics, flight recorder and spans (``serving.py:334-679``) -----
    def _bind_metrics(self, engine: str):
        """The catalog's children, bound once (no label lookups on the
        decode path)."""
        M = _metrics
        self._m_queue_wait = M.SERVING_QUEUE_WAIT.labels(engine=engine)
        self._m_ttft = M.SERVING_TTFT.labels(engine=engine)
        self._m_inter = M.SERVING_INTER_TOKEN.labels(engine=engine)
        self._m_prefill = M.SERVING_PREFILL.labels(engine=engine)
        self._m_step = M.SERVING_DECODE_STEP.labels(engine=engine)
        self._m_tokens = M.SERVING_TOKENS.labels(engine=engine)
        req = {ev: M.SERVING_REQUESTS.labels(engine=engine, event=ev)
               for ev in ("admitted", "finished", "cancelled", "rejected",
                          "shed")}
        self._m_req_admitted = req["admitted"]
        self._m_req_finished = req["finished"]
        self._m_req_cancelled = req["cancelled"]
        self._m_req_rejected = req["rejected"]
        self._m_req_shed = req["shed"]
        self._m_slo_good = M.SERVING_SLO_OUTCOMES.labels(engine=engine,
                                                         outcome="good")
        self._m_slo_late = M.SERVING_SLO_OUTCOMES.labels(engine=engine,
                                                         outcome="late")
        self._m_deadline = M.SERVING_DEADLINE_MISSES.labels(engine=engine)
        self._m_sched_shed = M.SERVING_SCHED.labels(engine=engine,
                                                    decision="shed")
        self._m_active = M.SERVING_ACTIVE_SLOTS.labels(engine=engine)
        self._m_depth = M.SERVING_QUEUE_DEPTH.labels(engine=engine)
        self._m_bundle = {
            k: M.SERVING_BUNDLE_BYTES.labels(engine=engine, kind=k)
            for k in ("preempt", "migrate", "handoff")}
        self._m_sched = {
            d: M.SERVING_SCHED.labels(engine=engine, decision=d)
            for d in ("chunk", "preempt", "restore", "migrate_out",
                      "migrate_in", "degrade")}
        self._m_spec_accept = M.SERVING_SPEC_ACCEPTED.labels(engine=engine)
        self._m_prefix_hit = M.SERVING_PREFIX_LOOKUPS.labels(engine=engine,
                                                             result="hit")
        self._m_prefix_miss = M.SERVING_PREFIX_LOOKUPS.labels(engine=engine,
                                                              result="miss")
        self._m_prefix_pages = M.SERVING_PREFIX_PAGES.labels(engine=engine)

    def _fr_submit(self, req: _Request):
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SUBMIT, rid=req.rid,
                       engine=self._engine_label,
                       prompt_tokens=int(req.ids.size),
                       max_new_tokens=req.max_new_tokens,
                       queue_depth=len(self._queue))

    def _fr_page_pressure(self):
        """Page-pool pressure after an admission, from the host lengths
        (never a device array)."""
        rec = _frec.RECORDER
        if not rec.enabled:
            return
        ps = self.page_size
        used = sum(-(-(int(r.ids.size) + len(r.tokens)) // ps)
                   for r in self._slots if r is not None)
        rec.record(_frec.EV_PAGE_PRESSURE, engine=self._engine_label,
                   pages_used=used,
                   pages_total=self.max_batch * self._pages_per_slot,
                   free_slots=self._slots.count(None))

    def _trace_submit(self, req: _Request, trace_ctx=None):
        """The request's root span and its queue-wait child, continuing an
        inbound ``(trace_id, parent_span_id)``; nothing while tracing is
        off."""
        tracer = _tracing.get_tracer()
        if not tracer.enabled:
            return
        trace_id, parent_id = trace_ctx if trace_ctx else (None, None)
        req.span = tracer.start_span(
            _tracing.SPAN_REQUEST, trace_id=trace_id, parent_id=parent_id,
            attrs={"rid": req.rid, "engine": self._engine_label,
                   "prompt_tokens": int(req.ids.size),
                   "max_new_tokens": req.max_new_tokens})
        req.queue_span = tracer.start_span(_tracing.SPAN_QUEUE_WAIT,
                                           parent=req.span)

    def _trace_admit(self, req: _Request, slot: int):
        """The admit event; the queue-wait child ends as the request takes
        a slot, and the slot lands on the root span."""
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_ADMIT, rid=req.rid,
                       engine=self._engine_label, slot=slot,
                       queue_wait_s=(req.t_admit - req.t_enqueue
                                     if req.t_admit is not None else None),
                       free_slots=(self._slots.count(None)
                                   - len(self._chunking)))
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        if req.span is not None:
            req.span.set_attr("slot", slot)

    def _trace_decode_step(self, req: _Request, start_ns: int, end_ns: int):
        """The dispatch as a sampled child span of the request."""
        n = len(req.tokens)
        if req.span is not None and (n == 1
                                     or n % self.trace_decode_every == 0):
            _tracing.get_tracer().add_span(
                _tracing.SPAN_DECODE_STEP, start_ns, end_ns,
                parent=req.span, attrs={"token_index": n})

    def _trace_end(self, req: _Request, status: str):
        """The slot-free event, an open queue-wait child ended, an instant
        slot-free span when it held a slot, then the root."""
        rec = _frec.RECORDER
        if rec.enabled and req.slot >= 0:
            rec.record(_frec.EV_SLOT_FREE, rid=req.rid,
                       engine=self._engine_label, slot=req.slot,
                       status=status, generated=len(req.tokens))
        if req.queue_span is not None:
            req.queue_span.end(status)
            req.queue_span = None
        span = req.span
        if span is None:
            return
        req.span = None
        if req.slot >= 0:
            now = time.perf_counter_ns()
            _tracing.get_tracer().add_span(
                _tracing.SPAN_SLOT_FREE, now, now, parent=span,
                attrs={"slot": req.slot})
        span.set_attr("generated_tokens", len(req.tokens))
        if req.spec_rounds:
            span.set_attr("spec_rounds", req.spec_rounds)
            span.set_attr("spec_accepted_tokens", req.spec_accepted)
        span.end(status)

    def _record_reason(self, rid, reason, logprobs=None):
        if reason == "cancelled":
            self._n_cancelled += 1
            self._m_req_cancelled.inc()
        elif reason in ("stop", "length"):
            # drain rate: EWMA of the gap between finishes
            now = time.perf_counter()
            if self._t_last_finish is not None:
                iv = now - self._t_last_finish
                e = self._finish_interval_ewma
                self._finish_interval_ewma = (iv if e is None
                                              else 0.7 * e + 0.3 * iv)
            self._t_last_finish = now
        self._finished_reason[rid] = reason
        if logprobs is not None:
            self._finished_logprobs[rid] = logprobs
        self._reason_order.append(rid)
        while len(self._reason_order) > _REASON_KEEP:
            old = self._reason_order.popleft()
            self._finished_reason.pop(old, None)
            self._finished_logprobs.pop(old, None)
            self._finished_usage.pop(old, None)

    def _drain_finished(self):
        done, self._finished = self._finished, {}
        return done

    def _alloc_slot(self) -> int:
        """A free slot that no chunked admission has reserved, or -1."""
        for s, r in enumerate(self._slots):
            if r is None and s not in self._chunking:
                return s
        return -1

    def _release_slot(self, s: int) -> None:
        """Slot teardown in one place: the request binding, the length,
        and the slot's pages back to the KV atlas."""
        self._slots[s] = None
        self._lengths[s] = 0
        if self.kvatlas.enabled:
            self.kvatlas.free_slot(s)

    def _bucket(self, n: int) -> int:
        """Prompt-length bucket: next power of two times the page size,
        capped at max_len."""
        b = self.page_size
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _check_poisoned(self):
        if self._poisoned:
            raise RuntimeError(
                "ContinuousBatchEngine: a failed admission invalidated the "
                "page pool; rebuild the engine and resubmit requests")

    # ---- bounded queue, deadlines, shedding -----------------------------
    def _retry_after_estimate(self) -> float:
        """Queue depth times the EWMA gap between finishes, clamped to
        [0.5 s, 30 s]; 1 s before the first finish."""
        iv = self._finish_interval_ewma
        if not iv:
            return 1.0
        est = (len(self._queue) + 1) * iv
        return min(30.0, max(0.5, est))

    def _check_queue_bound(self, priority: Optional[int] = None):
        """With the queue at ``max_queue`` and no free slot, shed the least
        important queued request for a strictly more important newcomer,
        else raise :class:`QueueFull`."""
        if (self.max_queue is None
                or len(self._queue) < self.max_queue
                or self._alloc_slot() >= 0):
            return
        if priority is not None and self._queue:
            # lowest class first, latest deadline within a class
            victim = max(self._queue,
                         key=lambda r: (r.priority, r.deadline, r.rid))
            if victim.priority > int(priority):
                self._shed_request(victim, where="capacity")
                return
        self._n_rejected += 1
        self._m_req_rejected.inc()
        raise QueueFull(self._engine_label, len(self._queue),
                        self.max_queue,
                        retry_after_s=self._retry_after_estimate())

    def _shed_request(self, req: _Request, where: str):
        """Drop one queued request, typed: ``where`` is "expired",
        "unmeetable" or "capacity"; ``req.on_shed`` hears of it."""
        self._queue.remove(req)
        if self.kvatlas.enabled:
            # a preempted request shed from the queue abandons its bundle
            self.kvatlas.unpark(req.rid)
        now = time.perf_counter()
        miss_ms = ((now - req.deadline) * 1000.0
                   if req.deadline != math.inf else None)
        self._n_shed += 1
        self._m_req_shed.inc()
        self._m_sched_shed.inc()
        if where == "expired":
            msg = (f"request {req.rid} deadline expired "
                   f"{miss_ms:.0f}ms before admission")
        elif where == "unmeetable":
            msg = (f"request {req.rid} shed: remaining budget "
                   f"{-miss_ms:.0f}ms is below the engine's observed "
                   "service floor")
        else:
            msg = (f"request {req.rid} displaced by a higher-priority "
                   "arrival at a full admission queue; retry later")
        info = {"where": where, "miss_ms": miss_ms, "error": msg}
        if where != "capacity":
            self._n_deadline_misses += 1
            self._m_deadline.inc()
        else:
            info["retry_after"] = self._retry_after_estimate()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_SHED, rid=req.rid,
                       engine=self._engine_label, priority=req.priority,
                       where=where, miss_ms=miss_ms,
                       queue_depth=len(self._queue))
        self._record_reason(req.rid, "shed")
        self._trace_end(req, "shed")
        if req.on_shed is not None:
            req.on_shed(req.rid, info)

    def _shed_expired(self, now: float):
        """Shed every queued request whose deadline passed, or whose
        remaining budget is below the observed admission -> first-token
        floor (armed after three first tokens)."""
        if not self._queue:
            return
        est = (self._ttft_admit_floor
               if self._ttft_admit_n >= 3 else None) or 0.0
        for req in [r for r in self._queue if r.deadline != math.inf]:
            if now >= req.deadline:
                self._shed_request(req, where="expired")
            elif est and now + est > req.deadline:
                self._shed_request(req, where="unmeetable")

    def _count_deadline_reject(self, slo_ms: float):
        """A request submitted with its budget spent: counted as a shed."""
        self._n_shed += 1
        self._m_req_shed.inc()
        self._m_sched_shed.inc()
        self._n_deadline_misses += 1
        self._m_deadline.inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_SHED, rid=None,
                       engine=self._engine_label, priority=None,
                       where="expired", miss_ms=-float(slo_ms),
                       queue_depth=len(self._queue))

    def _degrade_on_oom(self, req: Optional[_Request], where: str, exc):
        """A ``torch.cuda.OutOfMemoryError`` caught before any pool write
        (``where`` "admit" or "step", ``serving.py:2219``): shed the
        triggering request (the admitting one, or the most recently
        admitted slot), and shrink ``max_active_slots`` to one below the
        occupancy that ran out (floor 1); ``sched.degrade`` and the shed's
        ``sched.shed`` go to the flight recorder. The dispatch's
        ``incident_scope`` already wrote the incident bundle."""
        occupancy = (self.num_active + len(self._chunking)
                     + (1 if req is not None else 0))
        prev = self.max_active_slots
        self.max_active_slots = max(1, min(prev, occupancy - 1))
        victim = req
        if victim is None:
            cands = [r for r in self._slots if r is not None]
            victim = max(cands, key=lambda r: (r.t_admit or 0.0, r.rid)) \
                if cands else None
        if self.kvatlas.enabled:
            self.kvatlas.set_budget(self.max_active_slots)
        if (victim is not None and victim.slot >= 0
                and self._slots[victim.slot] is victim):
            self._release_slot(victim.slot)
            victim.slot = -1
        self._n_degraded += 1
        self._m_sched["degrade"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_DEGRADE, engine=self._engine_label,
                       rid=(victim.rid if victim is not None else None),
                       where=where,
                       max_active_slots=self.max_active_slots,
                       previous=prev)
        if victim is None:
            return
        self._n_shed += 1
        self._m_req_shed.inc()
        self._m_sched_shed.inc()
        msg = (f"request {victim.rid} shed: device out of memory during "
               f"{where}; engine degraded max_active_slots "
               f"{prev} -> {self.max_active_slots} ({exc})")
        if rec.enabled:
            rec.record(_frec.EV_SCHED_SHED, rid=victim.rid,
                       engine=self._engine_label,
                       priority=victim.priority, where="oom",
                       miss_ms=None, queue_depth=len(self._queue))
        self._record_reason(victim.rid, "shed")
        self._trace_end(victim, "shed")
        if victim.on_shed is not None:
            victim.on_shed(victim.rid, {
                "where": "oom", "error": msg, "miss_ms": None,
                "retry_after": self._retry_after_estimate()})

    # ---- admission ------------------------------------------------------
    def _admit(self):
        """Fill free slots from the queue (``serving.py:2273``): shed what
        expired, respect a degraded budget, preempt under a full pool,
        then restore, start a chunked prefill, or prefill (an OOM there
        sheds the request). Holds ``DEVICE_LOCK``."""
        with DEVICE_LOCK:
            self._admit_locked()

    def _admit_locked(self):
        if self._poisoned and self._queue:
            self._check_poisoned()
        while self._queue:
            now = time.perf_counter()
            self._shed_expired(now)
            if not self._queue:
                return
            if (self.max_active_slots < self.max_batch
                    and self.num_active + len(self._chunking)
                    >= self.max_active_slots):
                return
            slot = self._alloc_slot()
            if slot < 0:
                if not self._maybe_preempt(now):
                    return
                slot = self._alloc_slot()
                if slot < 0:
                    return
            req = self._pop_next(now)
            t_adm = time.perf_counter()
            self._observe_admission(req, t_adm)
            self._trace_admit(req, slot)
            tracer = _tracing.get_tracer()
            if req.resume is not None:
                with tracer.span(_tracing.SPAN_PREFILL, parent=req.span,
                                 attrs={"slot": slot, "restore": True}):
                    self._restore_into(slot, req)
                with tracer.use(req.span):
                    self._m_prefill.observe(time.perf_counter() - t_adm)
                self._slots[slot] = req
                req.slot = slot
                if self.kvatlas.enabled:
                    self.kvatlas.set_slot(
                        slot, int(req.ids.size) + len(req.tokens))
                self._fr_page_pressure()
                continue
            if self._start_chunked(slot, req, t_adm):
                continue
            try:
                with _frec.incident_scope("engine.admit"):
                    with tracer.span(
                            _tracing.SPAN_PREFILL, parent=req.span,
                            attrs={"slot": slot,
                                   "prompt_tokens": int(req.ids.size)}):
                        self._prefill_into(slot, req)
            except torch.cuda.OutOfMemoryError as e:
                self._degrade_on_oom(req, where="admit", exc=e)
                continue
            with tracer.use(req.span):
                self._m_prefill.observe(time.perf_counter() - t_adm)
            self._slots[slot] = req
            req.slot = slot
            if self.kvatlas.enabled:
                self.kvatlas.set_slot(
                    slot, int(req.ids.size) + len(req.tokens))
            self._fr_page_pressure()

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
        """Admission of one prompt in either layout: a handoff bundle's
        copy; with a prefix-cache hit, the prefix copy and the suffix
        prefill; else the bucketed prefill copied into the slot."""
        if req.handoff is not None:
            return self._admit_handoff(slot, req)
        if self.enable_prefix_cache:
            src, n_pref = self._find_shared_prefix(req)
            if n_pref > 0:
                return self._run_prefix_admission(slot, req, src, n_pref)
        last, caches, S0, bucket = self._bucketed_prefill(req)
        self._scatter_prefill(slot, last, caches, bucket)
        self._lengths[slot] = S0

    @torch.inference_mode()
    def _scatter_prefill(self, slot: int, last, caches, bucket: int,
                         what: str = "admission"):
        """Copy one prefill's caches into ``slot`` (in place): its first
        pages of every layer, or in latent mode the first ``bucket``
        positions of its row (``_latent_scatter_fn``, ``serving.py:2891``,
        as a plain row copy); seed its last-logit row. Does not set the
        slot's length. A failure once the writes began leaves the pool
        half written: the engine is poisoned."""
        try:
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
        except Exception as e:
            self._poison(what, e)

    def _poison(self, what: str, exc):
        self._poisoned = True
        raise RuntimeError(
            f"ContinuousBatchEngine: {what} failed while writing the KV "
            "pool in place; the engine's cache state is invalid — rebuild "
            "the engine and resubmit in-flight requests") from exc

    # ---- preemption: KV eviction to host, restore on re-admission -------
    def _maybe_preempt(self, now: float) -> bool:
        """Under a full pool, evict the least important active slot when a
        strictly more important request is queued (raw classes: aging
        never preempts). Returns True if a slot was freed."""
        if not self.enable_preemption or not self._queue:
            return False
        cand = self._peek_next(now)
        victim_slot, victim_key = -1, None
        for s, r in enumerate(self._slots):
            if r is None or r.priority <= cand.priority:
                continue
            # least important first; within a class the most recently
            # admitted loses
            key = (r.priority, r.t_admit if r.t_admit is not None else now)
            if victim_key is None or key > victim_key:
                victim_slot, victim_key = s, key
        if victim_slot < 0:
            return False
        self._preempt_slot(victim_slot, by=cand)
        return True

    @torch.inference_mode()
    def _slot_kv_bundle(self, s: int, req: _Request):
        """Slot ``s``'s state as a sealed host bundle: each layer's KV
        pages densified to [bucket, hk, D] host copies (bf16 as 16-bit
        words), the last-logit row, the kv length. The one serializer
        behind preemption and migration."""
        ps = self.page_size
        kv_len = int(req.ids.size) + len(req.tokens)
        bucket = self._bucket(kv_len)
        n_pages = bucket // ps
        base = s * self._pages_per_slot
        layers = []
        for c in self._caches:
            pair = []
            for key in ("k_pages", "v_pages"):
                tiles = c[key][:, base:base + n_pages]
                hk, n, _, d = tiles.shape
                pair.append(_host_leaf(
                    tiles.movedim(0, 2).reshape(n * ps, hk, d)))
            layers.append(tuple(pair))
        return seal_bundle({"bucket": bucket, "kv_len": kv_len,
                            "layers": layers,
                            "last": _host_leaf(self._last[s].float())})

    def _preempt_slot(self, s: int, by: Optional[_Request] = None):
        """Evict slot ``s`` to a host bundle, free it, and requeue its
        request with its tokens; ``_restore_into`` brings it back."""
        req = self._slots[s]
        req.resume = self._slot_kv_bundle(s, req)
        nbytes = _bundle_nbytes(req.resume)
        req.n_preempted += 1
        self._n_preempted += 1
        self._release_slot(s)
        req.slot = -1
        self._queue.append(req)
        self._m_bundle["preempt"].observe(float(nbytes))
        if self.kvatlas.enabled:
            # device pages freed above; the host bundle parks until restore
            self.kvatlas.park(req.rid, nbytes)
        self._m_sched["preempt"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_PREEMPT, rid=req.rid,
                       engine=self._engine_label, slot=s,
                       kv_len=int(req.resume["kv_len"]),
                       generated=len(req.tokens), bytes=nbytes,
                       priority=req.priority,
                       by_priority=(by.priority if by is not None
                                    else None))

    def _restore_into(self, slot: int, req: _Request):
        """Re-admission of a preempted or migrated-in request: its bundle
        copied back into the slot's pages and its last-logit row seeded;
        decoding continues where it stopped."""
        r, req.resume = req.resume, None
        verify_bundle(r)
        self._write_bundle(slot, r, "preemption restore")
        self._lengths[slot] = int(r["kv_len"])
        if self.kvatlas.enabled:
            # the bundle is consumed; the slot publishes at _admit
            self.kvatlas.unpark(req.rid)
        self._m_sched["restore"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_RESTORE, rid=req.rid,
                       engine=self._engine_label, slot=slot,
                       kv_len=int(r["kv_len"]), generated=len(req.tokens))

    def _write_bundle(self, slot: int, bundle: dict, what: str):
        """A bundle's layers and last row onto the card (before any pool
        write), then the prefill's page write of its bucket into
        ``slot``."""
        caches = [{"k": _leaf_tensor(k, self.device)[None],
                   "v": _leaf_tensor(v, self.device)[None]}
                  for k, v in bundle["layers"]]
        last = _leaf_tensor(bundle["last"], self.device)[None]
        self._scatter_prefill(slot, last, caches, int(bundle["bucket"]),
                              what=what)

    # ---- chunked prefill: admission interleaved with decode -------------
    def _start_chunked(self, slot: int, req: _Request, t_adm: float) -> bool:
        """Reserve ``slot`` for a chunked admission when the prompt is
        longer than one chunk (handoff admissions run no prefill); its
        prefill span stays open across the chunks."""
        ct = self.prefill_chunk_tokens
        if (ct is None or req.handoff is not None
                or int(req.ids.size) <= ct):
            return False
        span = None
        tracer = _tracing.get_tracer()
        if tracer.enabled:
            span = tracer.start_span(
                _tracing.SPAN_PREFILL, parent=req.span,
                attrs={"slot": slot, "chunked": True,
                       "prompt_tokens": int(req.ids.size)})
        self._chunking[slot] = _ChunkState(req, slot, t_adm, span)
        req.slot = slot
        return True

    def _advance_chunk(self) -> bool:
        """Advance one prefill chunk of the oldest reserved slot. The first
        chunk runs the bucketed prefill (or, on a prefix-cache hit, the
        prefix copy and the suffix's first chunk); later ones the suffix
        prefill with the slot as its own source. The last one publishes the
        slot."""
        if not self._chunking:
            return False
        slot, st = next(iter(self._chunking.items()))
        req = st.req
        ps = self.page_size
        S0 = int(req.ids.size)
        ct = self.prefill_chunk_tokens
        t0 = time.perf_counter()
        if st.pos == 0:
            src, n_pref = (-1, 0)
            if self.enable_prefix_cache:
                with _tracing.get_tracer().use(st.span):
                    src, n_pref = self._find_shared_prefix(req)
            if n_pref > 0:
                pref_len = n_pref * ps
                take = min(ct, S0 - pref_len)
                self._run_suffix_chunk(slot, src, n_pref,
                                       req.ids[pref_len:pref_len + take])
                self.prefix_pages_reused += n_pref
                self._m_prefix_pages.inc(n_pref)
                if self.kvatlas.enabled:
                    self.kvatlas.note_prefix_hit(slot, req.ids, n_pref)
                st.pos = pref_len + take
            else:
                take = min(ct, S0)
                first = _Request(-1, req.ids[:take], 0)
                last, caches, _, bucket = self._bucketed_prefill(first)
                self._scatter_prefill(slot, last, caches, bucket)
                st.pos = take
        else:
            take = min(ct, S0 - st.pos)
            self._run_suffix_chunk(slot, slot, st.pos // ps,
                                   req.ids[st.pos:st.pos + take])
            st.pos += take
        done = st.pos >= S0
        if not done:
            # park the reserved slot's length at the chunk frontier
            self._lengths[slot] = st.pos
            if self.kvatlas.enabled:
                # the ledger counts the landed chunks only
                self.kvatlas.set_slot(slot, st.pos, chunk=True)
        self._m_sched["chunk"].inc()
        rec = _frec.RECORDER
        if rec.enabled:
            rec.record(_frec.EV_SCHED_CHUNK, rid=req.rid,
                       engine=self._engine_label, slot=slot, pos=st.pos,
                       tokens=int(take), final=done,
                       seconds=time.perf_counter() - t0)
        if done:
            del self._chunking[slot]
            self._lengths[slot] = S0
            self._slots[slot] = req
            if self.kvatlas.enabled:
                self.kvatlas.set_slot(slot, S0)  # the chunk flag clears
            if st.span is not None:
                st.span.end()
            with _tracing.get_tracer().use(req.span):
                self._m_prefill.observe(time.perf_counter() - st.t_admit)
            self._fr_page_pressure()
        return True

    # ---- prefix caching -------------------------------------------------
    def _find_shared_prefix(self, req: _Request):
        """Longest page-aligned token prefix shared with an active slot's
        prompt, capped one token short of the whole prompt (the suffix
        prefill needs a token to give the slot its logits). Traced as a
        child of the span current on the engine thread. Returns (source
        slot, pages)."""
        with _tracing.get_tracer().span(_tracing.SPAN_PREFIX_LOOKUP) as sp:
            ps = self.page_size
            cap = (int(req.ids.size) - 1) // ps
            best_slot, best_n = -1, 0
            for s, r in enumerate(self._slots):
                if r is None or cap <= 0:
                    continue
                c = min(cap * ps, (int(r.ids.size) // ps) * ps)
                if c <= 0:
                    continue
                neq = req.ids[:c] != r.ids[:c]
                common = c if not neq.any() else int(np.argmax(neq))
                n = common // ps
                if n > best_n:
                    best_slot, best_n = s, n
            (self._m_prefix_hit if best_n > 0 else self._m_prefix_miss).inc()
            if best_n <= 0 and self.kvatlas.enabled:
                # hits index at the slot-aware admission sites
                self.kvatlas.note_prefix_miss()
            sp.set_attr("pages", best_n)
            return best_slot, best_n

    @torch.inference_mode()
    def _suffix_forward(self, src: int, n_pref: int, ids, suffix_len: int):
        """The model over a suffix chunk at pos = n_pref * page_size against
        a dense buffer that holds the prefix copied from slot ``src``
        (``_suffix_prefill_fn`` ``serving.py:2670``, ``_latent_suffix_
        prefill_fn`` ``:2763``): pages (or latent rows) gathered into
        [1, pref_len + sb, ...] buffers, the column mask ``allowed`` over
        pref_len + suffix_len columns, the forward (append attention on
        the paged layout, the absorbed einsum on the latent one), and the
        last real token's logits. Nothing is written into the pool here.

        Eager, not a CUDA graph: the JAX package compiles one program per
        (n_pref, sb), up to 64 of them; a capture costs two warm-ups and a
        capture each, and the model's graph pool keeps the largest
        intermediates of any capture. Returns (last [1, V], per-layer dense
        caches)."""
        ps = self.page_size
        pref_len = n_pref * ps
        sb = ids.shape[1]
        total = pref_len + sb
        dev = self.device
        allowed = (torch.arange(total, device=dev)[None, :]
                   < pref_len + suffix_len)
        pos = torch.full((), pref_len, dtype=torch.int32, device=dev)
        caches = []
        for c in self._caches:
            if self._latent_mode:
                new = {}
                for key in ("c_kv", "k_pe"):
                    buf = c[key]
                    t = buf.new_empty(1, total, buf.shape[-1])
                    t[0, :pref_len].copy_(buf[src, :pref_len])
                    new[key] = t
            else:
                new = {}
                base = src * self._pages_per_slot
                for key, pool in (("k", "k_pages"), ("v", "v_pages")):
                    pg = c[pool]
                    hk, d = pg.shape[0], pg.shape[-1]
                    t = pg.new_empty(1, total, hk, d)
                    t[0, :pref_len].view(n_pref, ps, hk, d).copy_(
                        pg[:, base:base + n_pref].movedim(0, 2))
                    new[key] = t
            caches.append(dict(new, allowed=allowed, pos=pos))
        hidden, caches = self.model.llama.forward_cached(
            torch.from_numpy(ids).to(dev), caches, rope_len=self.max_len)
        h_last = hidden[:, suffix_len - 1:suffix_len]
        return self.model.lm_head_logits(h_last)[:, 0, :], caches

    def _run_suffix_chunk(self, slot: int, src: int, n_pref: int, suf):
        """One suffix prefill: ``n_pref`` prefix pages (or rows) copied from
        slot ``src`` (``slot`` itself for a chunk continuation), the model
        over ``suf`` at pos = n_pref * page_size, and prefix + suffix
        written into ``slot``; its last-logit row seeded. Does not set the
        slot's length. An error in the forward leaves the pool as it was;
        one during the write poisons the engine."""
        ps = self.page_size
        pref_len = n_pref * ps
        suf = np.asarray(suf).reshape(-1)
        sb = min(self._bucket(int(suf.size)), self.max_len - pref_len)
        ids = np.zeros((1, sb), np.int32)
        ids[0, :suf.size] = suf
        last, caches = self._suffix_forward(src, n_pref, ids, int(suf.size))
        # the dense buffers hold exactly the prefix and the suffix bucket
        self._scatter_prefill(slot, last, caches, pref_len + sb,
                              what="suffix prefill")

    def _run_prefix_admission(self, slot, req, src, n_pref):
        """Prefix-cached monolithic admission: the prefix copy and the
        whole remaining suffix in one prefill, then the slot's length."""
        S0 = int(req.ids.size)
        self._run_suffix_chunk(slot, src, n_pref,
                               req.ids[n_pref * self.page_size:])
        self._lengths[slot] = S0
        self.prefix_pages_reused += n_pref
        self._m_prefix_pages.inc(n_pref)
        if self.kvatlas.enabled:
            # the reuse depth rides to the slot's publish in _admit
            self.kvatlas.note_prefix_hit(slot, req.ids, n_pref)
