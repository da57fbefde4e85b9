"""KV & memory atlas: a live ledger of the serving engines' memory story.

perf.py explains where each decode step's *milliseconds* go; this module
explains where the KV pool's *bytes* go — the measured side of the
memory story whose predicted side is ``analysis.graph.cost
.kv_cache_bytes`` (the preflight estimate), joined continuously the way
the step profiler joins measured dispatch time against the roofline
model:
The port's copy of ``paddle_tpu/observability/kvatlas.py``.

- ``KvAtlas`` — one per engine, registered by label like the
  StepProfiler. Disabled by default and guarded Tracer-style at every
  hot site (one attribute check per step when off; the enabled overhead
  bar is < 1% of a decode step). The ENGINE THREAD feeds it
  incrementally from every slot mutation — admission scatter, decode
  advance, chunk-frontier progress, retirement, cancellation,
  preemption→restore and migration — so its totals track per-slot KV
  pages/bytes, pool occupancy and free-slot headroom, chunk-frontier
  parked pages and host-side bytes parked by preemption without ever
  rescanning the slot table. The exactness invariant (pinned by
  tests/test_kvatlas.py at every step of a chunked/speculative/
  preempted/migrated run): the incremental totals equal
  :func:`recompute` over engine config + slot lengths.
- Prefix-reuse index — a bounded LRU of page-aligned prefix hashes with
  hit counts and reuse depth (pages), fed by the engine's prefix-cache
  hit/miss sites. Its compact top-K summary is what a cluster worker
  publishes through ``elastic.register_metadata`` (the prefix-affinity
  routing feedstock), and the hit ratio rides ``stats()`` into the
  router's ``cluster_prefix_hit_ratio`` federation.
- Capacity forecast — time-to-full from the TSDB admission/finish-rate
  window: at the current net slot-fill rate, when does headroom reach
  zero (the autoscaler's capacity sensor).
- ``kvstate_payload()`` — the JSON surface behind ``GET /kvstate``,
  router-side ``GET /kvstate/cluster`` federation, and the KVSTATE
  section of incident bundles.

Threading discipline (same as the profiler): every mutation runs on the
engine thread only; ``self._lock`` exists solely so snapshot readers
(``payload()``/``federated()`` on an HTTP thread) see consistent dicts.

See docs/SERVING.md "KV & memory atlas".
"""
from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from . import catalog as _cat

__all__ = ["KvAtlas", "get_atlas", "kvstate_payload",
           "kv_bytes_per_token", "recompute", "KVSTATE_SCHEMA_VERSION"]

KVSTATE_SCHEMA_VERSION = 1

#: bounded prefix-reuse index: most-recently-hit page-aligned prefix
#: hashes kept, LRU-evicted past this cap — memory stays O(1) whatever
#: the prompt diversity
PREFIX_INDEX_CAP = 256

#: cadence (in ledger mutations) of occupancy-gauge refresh — batched
#: like the profiler's roofline gauges so the per-token cost stays far
#: under the 1% overhead bar (snapshot reads also refresh them)
_GAUGE_EVERY = 32

#: forecast window over the TSDB admission/finish counters
_FORECAST_WINDOW_S = 60.0


def _dtype_bytes(dtype) -> int:
    """Itemsize from a dtype spelled as a string (np.dtype can't parse
    "bfloat16" without ml_dtypes registration, and the config may carry
    either spelling)."""
    s = str(dtype)
    if "bfloat16" in s or "float16" in s:
        return 2
    if "float64" in s or "int64" in s:
        return 8
    if "int8" in s or "uint8" in s:
        return 1
    return 4


def kv_bytes_per_token(cfg) -> int:
    """Resident KV-cache bytes one token costs across all layers, from
    the model config — the per-token coefficient behind every byte
    figure the atlas reports. Paged layout: K+V per kv-head per layer;
    latent (MLA) layout: the compressed c_kv + k_pe row per layer."""
    item = _dtype_bytes(getattr(cfg, "dtype", "bfloat16"))
    layers = int(getattr(cfg, "num_hidden_layers", 0) or 0)
    rank = getattr(cfg, "kv_lora_rank", None)
    if rank:
        rope = int(getattr(cfg, "qk_rope_head_dim", 0) or 0)
        return layers * (int(rank) + rope) * item
    hk = int(getattr(cfg, "num_key_value_heads", 0)
             or getattr(cfg, "num_attention_heads", 0) or 0)
    try:
        from ..models.llama import head_dim_of

        d = int(head_dim_of(cfg))
    except Exception:  # non-llama configs fall back to the hidden/heads quotient
        hidden = int(getattr(cfg, "hidden_size", 0) or 0)
        heads = int(getattr(cfg, "num_attention_heads", 1) or 1)
        d = hidden // max(1, heads)
    return 2 * layers * hk * d * item


class KvAtlas:
    """Live page-pool ledger for one engine (see module doc).

    Constructed DISABLED; every engine hot site guards on
    ``atlas.enabled`` first, so an unsubscribed engine pays one
    attribute read per step. The HTTP server (or a bench harness)
    enables it, exactly like the tracer/recorder/profiler.
    """

    def __init__(self, engine: str, *, max_batch: int = 0,
                 page_size: int = 1, pages_per_slot: int = 0,
                 bytes_per_token: int = 0, paged: bool = False,
                 preflight_bytes: Optional[int] = None):
        self.engine = engine
        self.enabled = False
        self.max_batch = int(max_batch)
        self.page_size = max(1, int(page_size))
        self.pages_per_slot = int(pages_per_slot)
        self.bytes_per_token = int(bytes_per_token)
        self.bytes_per_page = self.bytes_per_token * self.page_size
        self.paged = bool(paged)
        self.preflight_bytes = (None if preflight_bytes is None
                                else int(preflight_bytes))
        # the LIVE admission budget mirror (max_active_slots shrinks on
        # OOM degrade) — headroom is measured against it, not max_batch
        self._budget = self.max_batch
        # snapshot readers vs engine-thread mutations only — mutations
        # never contend with each other (single writer)
        self._lock = threading.Lock()
        # slot -> [kv_tokens, pages, prefix_pages, is_chunk_frontier]
        self._slots: Dict[int, list] = {}
        self._pages = 0          # running sum of per-slot pages
        self._chunk_pages = 0    # subset parked at chunk frontiers
        self._peak_pages = 0
        self._parked: Dict[int, int] = {}   # rid -> host bundle bytes
        self._parked_bytes = 0
        # prefix reuse noted before the slot's ledger entry publishes
        self._pending_prefix: Dict[int, int] = {}
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_evicted = 0
        # prefix hash -> [reuse depth in pages (max seen), hit count]
        self._index: "OrderedDict[str, list]" = OrderedDict()
        self._mutations = 0
        self._g_pages = _cat.SERVING_KV_PAGES_IN_USE.labels(engine=engine)
        self._g_bytes = _cat.SERVING_KV_BYTES.labels(engine=engine)
        self._g_headroom = _cat.SERVING_KV_HEADROOM_SLOTS.labels(
            engine=engine)
        self._g_headroom_frac = _cat.SERVING_KV_HEADROOM_FRAC.labels(
            engine=engine)
        self._g_hit_ratio = _cat.SERVING_PREFIX_HIT_RATIO.labels(
            engine=engine)
        _ATLASES[engine] = self

    # ---- lifecycle ------------------------------------------------------
    def enable(self) -> "KvAtlas":
        self.enabled = True
        return self

    def disable(self) -> "KvAtlas":
        self.enabled = False
        return self

    # ---- ledger mutations (ENGINE THREAD ONLY; callers guard .enabled) --
    def _pages_for(self, tokens: int) -> int:
        if not self.paged or tokens <= 0:
            return 0
        return -(-int(tokens) // self.page_size)

    def set_slot(self, slot: int, kv_tokens: int, *, chunk: bool = False,
                 prefix_pages: Optional[int] = None):
        """Publish slot ``slot`` at a ``kv_tokens`` frontier: admission
        scatter, restore, handoff, and every chunk advance land here.
        ``chunk=True`` marks a reserved chunk-prefill frontier (parked
        pages, not yet decoding). ``prefix_pages`` defaults to the
        reuse depth a preceding :meth:`note_prefix_hit` recorded."""
        pages = self._pages_for(kv_tokens)
        with self._lock:
            if prefix_pages is None:
                prefix_pages = self._pending_prefix.pop(slot, None)
            e = self._slots.get(slot)
            if e is None:
                e = [0, 0, 0, False]
                self._slots[slot] = e
            if prefix_pages is not None:
                e[2] = int(prefix_pages)
            self._pages += pages - e[1]
            if e[3]:
                self._chunk_pages -= e[1]
            if chunk:
                self._chunk_pages += pages
            e[0], e[1], e[3] = int(kv_tokens), pages, bool(chunk)
            if self._pages > self._peak_pages:
                self._peak_pages = self._pages
        self._tick()

    def advance(self, slot: int, n: int = 1):
        """Decode advanced slot ``slot`` by ``n`` tokens (1 on the
        one-token step, the accepted run on a speculative step)."""
        with self._lock:
            e = self._slots.get(slot)
            if e is None:
                return
            e[0] += int(n)
            pages = self._pages_for(e[0])
            if pages != e[1]:
                self._pages += pages - e[1]
                e[1] = pages
                if self._pages > self._peak_pages:
                    self._peak_pages = self._pages
        self._tick()

    def free_slot(self, slot: int):
        """Slot released: retirement, cancel, preemption, migration out,
        OOM shed, or a dropped chunk reservation."""
        with self._lock:
            e = self._slots.pop(slot, None)
            self._pending_prefix.pop(slot, None)
            if e is None:
                return
            self._pages -= e[1]
            if e[3]:
                self._chunk_pages -= e[1]
        self._tick()

    def park(self, rid: int, nbytes: int):
        """Host-side KV bundle now holds request ``rid``'s state
        (preemption eviction, or a migrate-in awaiting its restore)."""
        with self._lock:
            old = self._parked.pop(rid, 0)
            self._parked[rid] = int(nbytes)
            self._parked_bytes += int(nbytes) - old
        self._tick()

    def unpark(self, rid: int):
        """The parked bundle was consumed (restore) or abandoned
        (cancel/shed of a preempted request) — no-op when ``rid`` never
        parked, so every queue-drop site may call it unconditionally."""
        with self._lock:
            old = self._parked.pop(rid, None)
            if old is not None:
                self._parked_bytes -= old
        self._tick()

    def set_budget(self, n: int):
        """Mirror the engine's live admission budget (OOM degrade)."""
        self._budget = int(n)

    # ---- prefix-reuse index ---------------------------------------------
    def prefix_key(self, ids, n_pages: int) -> str:
        """Stable hash of the page-aligned token prefix ``ids[:n_pages *
        page_size]`` — the identity two workers' published summaries
        agree on for the same prompt family."""
        arr = np.ascontiguousarray(
            np.asarray(ids)[: n_pages * self.page_size], dtype=np.int64)
        return format(zlib.crc32(arr.tobytes()) & 0xFFFFFFFF, "08x")

    def note_prefix_hit(self, slot: int, ids, n_pages: int):
        """A prefix-cache admission reused ``n_pages`` page-aligned
        pages for ``slot``: index the prefix hash (LRU-bounded), bump
        its hit count, and remember the reuse depth for the slot's next
        :meth:`set_slot` publish."""
        h = self.prefix_key(ids, n_pages)
        with self._lock:
            self._prefix_hits += 1
            self._pending_prefix[slot] = int(n_pages)
            e = self._index.pop(h, None)
            if e is None:
                e = [int(n_pages), 0]
                if len(self._index) >= PREFIX_INDEX_CAP:
                    self._index.popitem(last=False)
                    self._prefix_evicted += 1
            e[0] = max(e[0], int(n_pages))
            e[1] += 1
            self._index[h] = e
        self._tick()

    def note_prefix_miss(self):
        with self._lock:
            self._prefix_misses += 1
        self._tick()

    # ---- gauges ---------------------------------------------------------
    def _tick(self):
        self._mutations += 1
        if self._mutations % _GAUGE_EVERY == 0:
            self._publish_gauges(*self._read_totals())

    def _headroom_locked(self):
        budget = self._budget if self._budget > 0 else self.max_batch
        free = max(0, budget - len(self._slots))
        frac = (free / budget) if budget > 0 else 1.0
        return budget, free, frac

    def _read_totals(self):
        with self._lock:
            _, free, frac = self._headroom_locked()
            return (self._pages, free, frac,
                    self._prefix_hits, self._prefix_misses)

    def _publish_gauges(self, pages, free, frac, hits, misses):
        self._g_pages.set(pages)
        self._g_bytes.set(pages * self.bytes_per_page)
        self._g_headroom.set(free)
        self._g_headroom_frac.set(frac)
        total = hits + misses
        self._g_hit_ratio.set(hits / total if total else 0.0)

    # ---- snapshot reads (any thread) ------------------------------------
    def federated(self) -> dict:
        """Scalar view merged into the engine's ``stats()`` — rides
        /health into the pool's probe cache, where the router's TSDB
        collector federates it per replica as ``cluster_kv_*`` series
        with zero extra network I/O (same transport as the profiler
        scalars). Reading it also refreshes the occupancy gauges."""
        pages, free, frac, hits, misses = self._read_totals()
        self._publish_gauges(pages, free, frac, hits, misses)
        total = hits + misses
        return {
            "kv_pages_in_use": float(pages),
            "kv_bytes": float(pages * self.bytes_per_page),
            "kv_headroom_slots": float(free),
            "kv_headroom_frac": float(frac),
            "prefix_hit_ratio": (hits / total) if total else 0.0,
        }

    def slot_info(self, slot: int, kv_tokens: int = 0) -> dict:
        """Per-slot ledger columns for ``debug_state()``; falls back to
        a direct page count from ``kv_tokens`` when the atlas is
        disabled (the debug surface stays truthful either way)."""
        if self.enabled:
            with self._lock:
                e = self._slots.get(slot)
                if e is not None:
                    return {"kv_pages": e[1],
                            "kv_bytes": e[1] * self.bytes_per_page,
                            "prefix_pages": e[2]}
        pages = self._pages_for(kv_tokens)
        return {"kv_pages": pages, "kv_bytes": pages * self.bytes_per_page,
                "prefix_pages": 0}

    def prefix_summary(self, top: int = 8) -> list:
        """Top-``top`` reused prefixes by hit count — the compact
        summary a cluster worker publishes via pool metadata."""
        with self._lock:
            index = [{"hash": h, "pages": e[0], "hits": e[1]}
                     for h, e in self._index.items()]
        index.sort(key=lambda d: (-d["hits"], d["hash"]))
        return index[:max(0, int(top))]

    def cluster_summary(self, top: int = 8) -> dict:
        """The ``kv`` entry of a worker's ``register_metadata`` payload:
        headroom + bytes + hit ratio + the top reused prefixes."""
        vals = self.federated()
        return {
            "kv_pages_in_use": vals["kv_pages_in_use"],
            "kv_bytes": vals["kv_bytes"],
            "headroom_slots": vals["kv_headroom_slots"],
            "headroom_frac": vals["kv_headroom_frac"],
            "prefix_hit_ratio": vals["prefix_hit_ratio"],
            "prefixes": self.prefix_summary(top),
        }

    def forecast(self, store=None, now: Optional[float] = None,
                 window_s: float = _FORECAST_WINDOW_S) -> dict:
        """Time-to-full from the TSDB admission-rate window: at the net
        slot-fill rate (admit rate - finish rate over ``window_s``),
        seconds until free-slot headroom reaches zero. ``eta_s`` is None
        while the store has no data or the pool is draining."""
        out = {"window_s": float(window_s), "admit_rate": None,
               "finish_rate": None, "headroom_slots": None,
               "net_slots_per_s": None, "eta_s": None}
        with self._lock:
            _, free, _ = self._headroom_locked()
        out["headroom_slots"] = free
        if store is None:
            from . import timeseries as _ts

            store = _ts.get_store()
        now = store.now() if now is None else float(now)
        adm = store.rate("serving_requests_total", window_s,
                         labels={"engine": self.engine,
                                 "event": "admitted"}, now=now)
        fin = store.rate("serving_requests_total", window_s,
                         labels={"engine": self.engine,
                                 "event": "finished"}, now=now)
        out["admit_rate"], out["finish_rate"] = adm, fin
        if adm is None or fin is None:
            return out
        net = adm - fin
        out["net_slots_per_s"] = net
        if net > 1e-9:
            out["eta_s"] = free / net
        return out

    def payload(self) -> dict:
        """The full ``GET /kvstate`` entry for this engine: pool
        occupancy, per-slot ledger, host-parked residency, the prefix
        index, the measured-vs-preflight join, and the capacity
        forecast."""
        with self._lock:
            slots = {str(s): {"tokens": e[0], "pages": e[1],
                              "bytes": e[1] * self.bytes_per_page,
                              "prefix_pages": e[2], "chunk": e[3]}
                     for s, e in sorted(self._slots.items())}
            pages = self._pages
            chunk_pages = self._chunk_pages
            peak = self._peak_pages
            parked_n, parked_b = len(self._parked), self._parked_bytes
            hits, misses = self._prefix_hits, self._prefix_misses
            evicted = self._prefix_evicted
            n_index = len(self._index)
            budget, free, frac = self._headroom_locked()
        capacity_pages = self.max_batch * self.pages_per_slot
        capacity_bytes = capacity_pages * self.bytes_per_page
        total = hits + misses
        return {
            "engine": self.engine,
            "enabled": self.enabled,
            "paged": self.paged,
            "page_size": self.page_size,
            "pages_per_slot": self.pages_per_slot,
            "max_batch": self.max_batch,
            "budget_slots": budget,
            "bytes_per_token": self.bytes_per_token,
            "bytes_per_page": self.bytes_per_page,
            "pages_in_use": pages,
            "pages_peak": peak,
            "bytes_in_use": pages * self.bytes_per_page,
            "capacity_pages": capacity_pages,
            "capacity_bytes": capacity_bytes,
            "headroom_slots": free,
            "headroom_frac": frac,
            "chunk_parked_pages": chunk_pages,
            "host_parked_requests": parked_n,
            "host_parked_bytes": parked_b,
            "slots": slots,
            "prefix": {"hits": hits, "misses": misses,
                       "hit_ratio": (hits / total) if total else 0.0,
                       "index_size": n_index, "evicted": evicted,
                       "index": self.prefix_summary(16)},
            "preflight": {
                "kv_cache_bytes": self.preflight_bytes,
                "capacity_bytes": capacity_bytes,
                "capacity_vs_preflight": (
                    capacity_bytes / self.preflight_bytes
                    if self.preflight_bytes else None)},
            "forecast": self.forecast(),
        }


def recompute(engine) -> dict:
    """Ground truth for the exactness invariant: pool pages/bytes
    recomputed from engine config + slot lengths (active slots at their
    prompt+generated frontier, chunk-reserved slots at their chunk
    frontier). tests/test_kvatlas.py pins the atlas's incremental totals
    against THIS after every step."""
    at = engine.kvatlas
    pages = 0
    for r in getattr(engine, "_slots", ()):
        if r is not None:
            pages += at._pages_for(int(r.ids.size) + len(r.tokens))
    for st in getattr(engine, "_chunking", {}).values():
        pages += at._pages_for(int(st.pos))
    return {"pages": pages, "bytes": pages * at.bytes_per_page}


# one atlas per engine label, latest registration wins — exactly the
# profiler registry's contract (a rebuilt engine re-registers itself)
_ATLASES: Dict[str, KvAtlas] = {}


def get_atlas(engine: str) -> Optional[KvAtlas]:
    return _ATLASES.get(engine)


def kvstate_payload() -> dict:
    """Every registered engine's atlas payload — the ``GET /kvstate``
    body and the ``kvstate`` section of incident bundles."""
    return {"schema_version": KVSTATE_SCHEMA_VERSION,
            "engines": {name: atlas.payload()
                        for name, atlas in sorted(_ATLASES.items())}}
