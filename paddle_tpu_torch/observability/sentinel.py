"""Correctness sentinel: shadow audits, pinned canary probes, and
divergence forensics for the serving engines. The port's copy of
``paddle_tpu/observability/sentinel.py``, with the reference replay
rebuilt on the port's own step units and a flag drill in place of the
JAX package's chaos plans (the port has no ``chaos/``).

Every hot-path feature the engines ship — the fused decode tail,
engine-integrated speculation, chunked prefill, preemption/migration,
the prefix cache — is sold on "token-identical to the discrete greedy
path". This module is the live enforcement of that invariant, the
correctness axis of the observability stack next to the step profiler
(milliseconds), the KV atlas (bytes), and the flight recorder
(failures):

- **Shadow audits** — on request finish, with configurable probability
  (``audit_rate``) or on demand (the HTTP layer's ``X-Audit: 1``), the
  finished request is re-run greedy on the REFERENCE path — fused tail
  off (a thread-local flag override, so live traces are untouched),
  speculation off, solo one-token decode, fresh dense caches (no prefix
  reuse, no chunking, no paging) — and the token streams are compared
  exactly, plus per-position logprob drift. Audits run on ONE bounded
  named "audit-worker" thread with a strict budget: a backlog cap and
  load gates (engine queue depth, KV-atlas headroom) shed sampled
  audits BEFORE they can cost user goodput. Sheds are counted as
  ``verdict=skipped`` with a reason — never silent — so audit coverage
  is itself auditable.
- **Canary probes** — a fixed-seed pinned prompt set whose expected
  outputs are captured once per (engine config, flag-set) at sentinel
  start and re-executed through the LIVE engine every
  ``canary_interval_s`` seconds on idle capacity, catching drift from
  flag flips, restarts, or nondeterminism without waiting for traffic.
- **Divergence forensics** — any mismatch seals a
  ``paddle_tpu.divergence/1`` bundle through the same seal/CRC
  machinery as KV handoffs (prompt ids, both token streams, both
  per-position logprob series, first-divergence index, the engine
  config and the live run's full flag snapshot).
  :func:`replay_bundle` re-runs the bundle offline and BISECTS over the
  recorded feature set (fused tail / speculation / chunked prefill /
  prefix cache / the ``FLAGS_perturb_decode_token`` drill) to blame the
  exact feature that diverged.
- **Surfaces** — ``serving_audit_total{verdict=...}``,
  ``serving_audit_logprob_drift``,
  ``serving_audit_first_divergence_position`` metrics;
  ``audit.pass`` / ``audit.diverge`` / ``audit.skip`` flight-recorder
  events; the ``audit_divergence`` alert objective; ``GET /audit`` per
  worker and ``GET /audit/cluster`` + ``cluster_audit_*`` federation on
  the router; an additive ``audit`` section on incident bundles.

Threading discipline: ``on_finish``/``skip`` run on the engine thread
and only snapshot + enqueue (the budget gates are attribute reads);
the reference replay, canary execution, verdict bookkeeping, and
bundle sealing all happen on the audit worker. ``self._lock`` exists
so snapshot readers (``payload()``/``federated()`` on an HTTP thread)
see consistent state. Flags fold into the step-memoization key, so the
worker's fused-off units are never the engine thread's live ones.

The worker's device work against the engine's CUDA graphs
(``jit/cuda_graph.py``): a capture runs in torch's global
capture-error mode, where a CUDA call from another thread can
invalidate it, and the graphs of one model share a memory pool, so a
unit's outputs last only until the next replay of any unit of that
model. Both are kept by one process-wide reentrant lock,
``cuda_graph.DEVICE_LOCK``: every capture holds it, the engine holds it
across each ``step()`` and each admission, and :func:`reference_decode`
holds it across its prefill and across each decode token, taking its
own copies of what a unit returned before it lets go. So an audit's
device work never overlaps a capture or an engine step, the engine
decodes between an audit's tokens (the worker sleeps ``YIELD_S`` before
each token: a lock released and taken back at once would keep a
waiting engine thread out), and the worker's cache buffers are its own
(``owner``), never a unit's outputs.

See docs/SERVING.md "Correctness sentinel".
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import flags as _flags
from . import catalog as _cat
from . import flightrecorder as _frec

__all__ = ["CorrectnessSentinel", "get_sentinel", "audit_payload",
           "reference_decode", "replay_bundle", "save_bundle",
           "load_bundle", "AUDIT_SCHEMA_VERSION", "DIVERGENCE_SCHEMA"]

AUDIT_SCHEMA_VERSION = 1

#: schema tag stamped on (and required of) every divergence bundle
DIVERGENCE_SCHEMA = "paddle_tpu.divergence/1"

#: recent-verdict ring kept for GET /audit and wait_verdict
_VERDICT_KEEP = 64

#: seconds the reference replay sleeps before each token, outside
#: ``DEVICE_LOCK``, so that a waiting engine thread takes the lock
YIELD_S = 0.001

#: sealed divergence bundles kept in memory (each also hits
#: divergence_dir when configured)
_BUNDLE_KEEP = 8

#: bundle fields restored to np.int64 arrays by load_bundle — the
#: canonical sealed form, so a JSON round-trip re-verifies bit-exact
_ARRAY_FIELDS = ("prompt_ids", "live_tokens", "ref_tokens")


def _bucket(n: int, mult: int) -> int:
    return -(-int(n) // mult) * mult


def reference_decode(model, ids, max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     stop_token_ids=None,
                     owner=None) -> Tuple[List[int], List[float]]:
    """Greedy solo decode on the REFERENCE path: one-shot (ragged)
    prefill into dense caches, then the engine's own sample+forward
    unit one token at a time — fused tail forced OFF for this thread
    only (``flag_overrides``, part of the units' memo key), no
    speculation, no chunking, no paging, no prefix reuse. Returns
    (tokens, per-token logprobs); the logprob is the same log_softmax
    gather the live path records, so live-vs-reference drift reflects
    the numerics under test, not a definition skew.

    Stop semantics mirror the engine exactly: the eos/stop token is
    emitted, then generation ends; otherwise ``max_new_tokens``. Prompt
    length is padded to a 16 bucket and max_len to a 64 bucket so the
    number of captured units stays bounded under diverse audited
    traffic. ``owner`` keeps the dense buffers between calls (their
    addresses are the graphs' state, so a new set would capture anew);
    None makes a set for this call. Device work runs under
    ``cuda_graph.DEVICE_LOCK`` (module doc)."""
    from .. import generation as _gen
    from ..framework.random import default_generator
    from ..jit.cuda_graph import DEVICE_LOCK

    ids = np.asarray(ids).reshape(-1)
    S0 = int(ids.size)
    max_new = int(max_new_tokens)
    if S0 == 0 or max_new <= 0:
        return [], []
    stop = frozenset(int(t) for t in (stop_token_ids or ()))
    s_pad = _bucket(S0, 16)
    max_len = _bucket(s_pad + max_new, 64)
    dev = model.device
    ids_pad = np.zeros((1, s_pad), np.int32)
    ids_pad[0, :S0] = ids
    gen = default_generator(dev)   # greedy: never drawn from
    toks: List[int] = []
    lps: List[float] = []
    with _flags.flag_overrides({"use_fused_decode_tail": False}), \
            torch.inference_mode():
        with DEVICE_LOCK:
            bufs = _gen._cache_buffers(model, 1, max_len, True,
                                       owner=owner, maxsize=2)
            # the column-validity mask spans the WHOLE cache (width
            # max_len): prompt pads are dead, the decode region (written
            # at the shared offset s_pad) is live
            pad_mask = torch.ones(1, max_len, dtype=torch.bool, device=dev)
            pad_mask[0, S0:s_pad] = False
            lengths = torch.full((1,), S0, dtype=torch.int32, device=dev)
            prefill = _gen._get_prefill_step(model, max_len, True)
            last, _ = prefill(torch.from_numpy(ids_pad).to(dev), lengths,
                              pad_mask, bufs)
            # f32, as the decode unit returns it (and as the engine keeps
            # its rows): one signature, so one capture, for every token
            last = last.to(torch.float32, copy=True)
            sel = _gen._get_select_decode(model, max_len, False, 1.0, 0,
                                          1.0)
        for i in range(max_new):
            # the lock is not fair: re-taken at once, it would hold a
            # waiting engine thread off for the whole audit
            time.sleep(YIELD_S)
            with DEVICE_LOCK:
                # cache positions as this call's own tensors: the dense
                # write offset and, for RoPE, the row's true length
                pos = torch.full((), s_pad + i, dtype=torch.int32,
                                 device=dev)
                row_pos = torch.full((1,), S0 + i, dtype=torch.int32,
                                     device=dev)
                caches = [dict(b, pos=pos, row_pos=row_pos) for b in bufs]
                nxt, lp, last, _ = sel(last, gen, caches)
                t = int(nxt.cpu()[0])
                lps.append(float(lp.cpu()[0]))
                last = last.clone()
            toks.append(t)
            if (eos_token_id is not None and t == int(eos_token_id)) \
                    or t in stop:
                break
        with DEVICE_LOCK:     # this call's tensors go under the lock too
            del last, pad_mask, lengths, caches, pos, row_pos, nxt, lp
    return toks, lps


def _compare(live: List[int], ref: List[int],
             live_lp: List[float], ref_lp: List[float]):
    """(first_divergence, max |logprob drift| over the matched prefix).
    A length mismatch with an identical common prefix diverges at the
    common length; drift is measured up to the first divergence so a
    post-divergence tail (different tokens, incomparable distributions)
    can't inflate it."""
    n = min(len(live), len(ref))
    first = None
    for i in range(n):
        if int(live[i]) != int(ref[i]):
            first = i
            break
    if first is None and len(live) != len(ref):
        first = n
    upto = first if first is not None else n
    drift = 0.0
    for i in range(min(upto, len(live_lp), len(ref_lp))):
        d = abs(float(live_lp[i]) - float(ref_lp[i]))
        if d > drift:
            drift = d
    return first, drift


class CorrectnessSentinel:
    """Per-engine correctness sentinel (see module doc).

    Constructed DISABLED by the engine bookkeeping (one attribute read
    on the finish path when off — the tracer/profiler/atlas contract).
    The HTTP server (or a bench/test harness) calls :meth:`enable` +
    :meth:`start`; ``auditable`` is set by engines whose decode path the
    reference replay can reproduce (the continuous-batching decoder)."""

    def __init__(self, engine: str, owner=None):
        self.engine = engine
        # the engine, held weakly: the process-wide registry below keeps
        # the latest sentinel of each label, and it must not keep a
        # replaced engine (its model, pool and graphs) alive
        self._owner = weakref.ref(owner) if owner is not None else None
        self.enabled = False
        self.auditable = False
        self.audit_rate = 0.0
        self.canary_interval_s = 0.0
        self.max_pending = 4
        self.min_headroom_frac = 0.05
        self.max_queue_depth = 0
        self.divergence_dir: Optional[str] = None
        #: blocking live-engine runner for canaries, injected by the
        #: HTTP server: (ids, max_new_tokens) -> (tokens, logprobs|None)
        #: — None leaves canaries baseline-only
        self.submitter: Optional[Callable] = None
        #: model spec (worker cfg["model"]) recorded into divergence
        #: bundles so replay_divergence can rebuild the model offline
        self.model_spec: Optional[dict] = None
        self._rng = random.Random(0xA0D17)
        self._lock = threading.Lock()
        self._jobs: "queue.Queue[dict]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._n = {"pass": 0, "diverged": 0, "skipped": 0}
        self._skip_reasons: Dict[str, int] = {}
        self._drift_last = 0.0
        self._verdicts: "OrderedDict[int, dict]" = OrderedDict()
        self._events: Dict[int, threading.Event] = {}
        self._bundles: deque = deque(maxlen=_BUNDLE_KEEP)
        self._bundle_paths: deque = deque(maxlen=_BUNDLE_KEEP * 4)
        self._canaries: List[dict] = []
        self._canary_cfg = (2, 8, 8, 1234)  # (n, prompt_len, max_new, seed)
        self._canary_fingerprint: Optional[str] = None
        self._canary_runs = 0
        self._canary_deferred = 0
        self._t_last_canary = 0.0
        self._m_pass = _cat.SERVING_AUDIT.labels(engine=engine,
                                                 verdict="pass")
        self._m_diverged = _cat.SERVING_AUDIT.labels(engine=engine,
                                                     verdict="diverged")
        self._m_skipped = _cat.SERVING_AUDIT.labels(engine=engine,
                                                    verdict="skipped")
        self._m_drift = _cat.SERVING_AUDIT_DRIFT.labels(engine=engine)
        self._m_firstdiv = _cat.SERVING_AUDIT_FIRST_DIVERGENCE.labels(
            engine=engine)
        _SENTINELS[engine] = self

    @property
    def owner(self):
        """The engine this sentinel audits; None once it is gone."""
        return self._owner() if self._owner is not None else None

    # ---- lifecycle ------------------------------------------------------
    def enable(self, audit_rate: Optional[float] = None,
               canary_interval_s: Optional[float] = None,
               max_pending: Optional[int] = None,
               min_headroom_frac: Optional[float] = None,
               divergence_dir: Optional[str] = None,
               n_canaries: Optional[int] = None,
               canary_prompt_len: Optional[int] = None,
               canary_max_new: Optional[int] = None,
               canary_seed: Optional[int] = None) -> "CorrectnessSentinel":
        with self._lock:
            if audit_rate is not None:
                self.audit_rate = max(0.0, min(1.0, float(audit_rate)))
            if canary_interval_s is not None:
                self.canary_interval_s = max(0.0, float(canary_interval_s))
            if max_pending is not None:
                self.max_pending = max(1, int(max_pending))
            if min_headroom_frac is not None:
                self.min_headroom_frac = float(min_headroom_frac)
            if divergence_dir is not None:
                self.divergence_dir = divergence_dir
            n, plen, mnew, seed = self._canary_cfg
            self._canary_cfg = (
                int(n_canaries) if n_canaries is not None else n,
                int(canary_prompt_len)
                if canary_prompt_len is not None else plen,
                int(canary_max_new)
                if canary_max_new is not None else mnew,
                int(canary_seed)
                if canary_seed is not None else seed)
            self.enabled = True
        return self

    def disable(self) -> "CorrectnessSentinel":
        with self._lock:
            self.enabled = False
        return self

    def start(self) -> "CorrectnessSentinel":
        """Spawn the audit worker (idempotent). All replay work — shadow
        audits, canary baselines, canary probes — happens on this ONE
        named thread: audit concurrency is structurally 1, and the
        backlog cap (``max_pending``) is the whole budget."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"audit-worker-{self.engine}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self._jobs.put(None)  # wake the worker
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    # ---- engine-thread hooks (cheap: snapshot + enqueue) ----------------
    def should_sample(self) -> bool:
        return self.audit_rate > 0.0 and self._rng.random() < self.audit_rate

    def skip(self, rid: int, reason: str, source: str = "shadow",
             ext_id: Optional[str] = None):
        """Record a shed audit: counted, evented, and visible to
        ``wait_verdict`` — never silent."""
        self._finish_verdict({
            "schema_version": AUDIT_SCHEMA_VERSION, "rid": int(rid),
            "ext_id": ext_id, "source": source, "verdict": "skipped",
            "reason": reason, "n_tokens": None, "first_divergence": None,
            "logprob_drift": None, "t": time.time()})

    def register_forced(self, rid: int):
        """Pre-register the verdict event for an on-demand audit so the
        HTTP thread can block on it the moment the stream finishes."""
        with self._lock:
            self._events[int(rid)] = threading.Event()

    def on_finish(self, req, reason: Optional[str]):
        """ENGINE THREAD: called from retirement accounting for requests
        marked ``req.audit``. Applies the budget gates (sampled audits
        shed FIRST — a loaded engine never pays for its own audit),
        snapshots the request, and enqueues. On-demand audits bypass the
        load gates: the caller asked, the caller waits."""
        forced = req.audit == "ondemand"
        source = req.audit or "shadow"
        if reason not in ("stop", "length"):
            self.skip(req.rid, "reason", source, req.ext_id)
            return
        if not forced:
            if self._jobs.qsize() >= self.max_pending:
                self.skip(req.rid, "queue_full", source, req.ext_id)
                return
            eng = self.owner
            depth = len(getattr(eng, "_queue", ()) or ())
            if depth > self.max_queue_depth:
                self.skip(req.rid, "load", source, req.ext_id)
                return
            atlas = getattr(eng, "kvatlas", None)
            if atlas is not None and atlas.enabled:
                frac = atlas.federated().get("kv_headroom_frac", 1.0)
                if frac < self.min_headroom_frac:
                    self.skip(req.rid, "headroom", source, req.ext_id)
                    return
        self._jobs.put({
            "kind": "audit", "rid": int(req.rid), "ext_id": req.ext_id,
            "source": source,
            "ids": np.asarray(req.ids).reshape(-1).astype(np.int64),
            "tokens": [int(t) for t in req.tokens],
            "logprobs": [float(x) for x in (req.logprobs or ())],
            "max_new_tokens": int(req.max_new_tokens),
            "stop_token_ids": (sorted(int(t) for t in req.stop_token_ids)
                               if req.stop_token_ids else None),
            "reason": reason,
            # the flags the live run decoded under, as the engine thread
            # sees them (its thread-local overrides included)
            "flags": _flags.get_flags()})

    # ---- the audit worker ----------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            try:
                try:
                    job = self._jobs.get(timeout=self._tick_s())
                except queue.Empty:
                    self._maybe_canary()
                    continue
                if job is None:
                    continue
                try:
                    self._run_audit(job)
                except Exception as e:
                    # an audit must never take serving down; the failure
                    # is itself a counted, typed verdict
                    self.skip(job["rid"], f"error:{type(e).__name__}",
                              job["source"], job.get("ext_id"))
            except Exception as e:
                # root guard: the audit daemon must outlive any canary or
                # bookkeeping failure — a dead sentinel is silent
                # non-coverage
                try:
                    from logging import getLogger as get_logger

                    get_logger("paddle_tpu_torch.observability").warning(
                        "audit worker: %s: %s", type(e).__name__, e)
                except Exception:  # pdlint: disable=silent-exception -- a logging failure must not kill the root guard; the original error is already lost either way
                    pass

    def _tick_s(self) -> float:
        with self._lock:
            interval = self.canary_interval_s
            t_last = self._t_last_canary
        if interval <= 0 or self.submitter is None:
            return 1.0
        due = t_last + interval - time.time()
        return max(0.05, min(1.0, due))

    def _run_audit(self, job: dict):
        eng = self.owner
        if eng is None:
            raise RuntimeError("the audited engine is gone")
        ref_t, ref_lp = reference_decode(
            eng.model, job["ids"], job["max_new_tokens"],
            eng.eos_token_id, job["stop_token_ids"], owner=self)
        first, drift = _compare(job["tokens"], ref_t,
                                job["logprobs"], ref_lp)
        verdict = {
            "schema_version": AUDIT_SCHEMA_VERSION, "rid": job["rid"],
            "ext_id": job["ext_id"], "source": job["source"],
            "verdict": "diverged" if first is not None else "pass",
            "reason": None, "n_tokens": len(job["tokens"]),
            "first_divergence": first, "logprob_drift": drift,
            "t": time.time()}
        if first is not None:
            verdict["bundle"] = self._seal_divergence(
                job["source"], job["rid"], job["ext_id"], job["ids"],
                job["tokens"], ref_t, job["logprobs"], ref_lp, first,
                drift, job["stop_token_ids"], job["max_new_tokens"],
                flags=job["flags"])
        self._finish_verdict(verdict)

    def _finish_verdict(self, verdict: dict):
        """Count + publish one verdict (any thread): metrics, flight-
        recorder event, the recent-verdict ring, and the wait event."""
        kind = verdict["verdict"]
        drift = verdict.get("logprob_drift")
        with self._lock:
            self._n[kind] += 1
            if kind == "skipped":
                r = verdict.get("reason") or "unknown"
                self._skip_reasons[r] = self._skip_reasons.get(r, 0) + 1
            if drift is not None:
                self._drift_last = float(drift)
            rid = int(verdict["rid"])
            self._verdicts[rid] = verdict
            while len(self._verdicts) > _VERDICT_KEEP:
                self._verdicts.popitem(last=False)
            ev = self._events.pop(rid, None)
        if kind == "pass":
            self._m_pass.inc()
        elif kind == "diverged":
            self._m_diverged.inc()
            if verdict.get("first_divergence") is not None:
                self._m_firstdiv.observe(
                    float(verdict["first_divergence"]) + 1.0)
        else:
            self._m_skipped.inc()
        if drift is not None:
            self._m_drift.observe(float(drift))
        rec = _frec.RECORDER
        if rec.enabled:
            ev_kind = {"pass": _frec.EV_AUDIT_PASS,
                       "diverged": _frec.EV_AUDIT_DIVERGE,
                       "skipped": _frec.EV_AUDIT_SKIP}[kind]
            rec.record(ev_kind, engine=self.engine, rid=verdict["rid"],
                       source=verdict["source"],
                       reason=verdict.get("reason"),
                       first_divergence=verdict.get("first_divergence"),
                       drift=drift)
        if ev is not None:
            ev.set()

    def wait_verdict(self, rid: int,
                     timeout: float = 30.0) -> Optional[dict]:
        """Block until the audit for ``rid`` reaches a verdict (the
        on-demand contract); None only on timeout."""
        rid = int(rid)
        with self._lock:
            v = self._verdicts.get(rid)
            ev = self._events.get(rid)
        if v is not None:
            return v
        if ev is None or not ev.wait(timeout):
            with self._lock:
                return self._verdicts.get(rid)
        with self._lock:
            return self._verdicts.get(rid)

    # ---- divergence bundles --------------------------------------------
    def _seal_divergence(self, source, rid, ext_id, ids, live_t, ref_t,
                         live_lp, ref_lp, first, drift, stop_ids,
                         max_new, flags=None) -> Optional[str]:
        from .. import serving as _serving

        eng = self.owner
        bundle = {
            "kind": "divergence", "schema": DIVERGENCE_SCHEMA,
            "source": source, "rid": int(rid), "ext_id": ext_id,
            "engine": self.engine,
            "prompt_ids": np.asarray(ids, np.int64),
            "live_tokens": np.asarray(live_t, np.int64),
            "ref_tokens": np.asarray(ref_t, np.int64),
            "live_logprobs": [float(x) for x in live_lp],
            "ref_logprobs": [float(x) for x in ref_lp],
            "first_divergence": int(first),
            "logprob_drift": float(drift),
            "max_new_tokens": int(max_new),
            "stop_token_ids": stop_ids,
            "config": _engine_config(eng),
            "flags": flags if flags is not None else _flags.get_flags(),
            # the JAX package's chaos-plan record; the port has no chaos
            # plans (its drill is a flag, recorded under "flags")
            "chaos": None,
            "model_spec": self.model_spec,
        }
        _serving.seal_bundle(bundle)
        path = None
        with self._lock:
            ddir = self.divergence_dir
        if ddir:
            try:
                os.makedirs(ddir, exist_ok=True)
                path = os.path.join(
                    ddir,
                    f"divergence-{int(time.time() * 1000):013d}-"
                    f"{int(rid)}.json")
                save_bundle(bundle, path)
            except OSError:
                # a full/readonly incident disk must not break the
                # in-memory forensics ring; GET /audit still serves it
                path = None
        with self._lock:
            self._bundles.append(bundle)
            if path:
                self._bundle_paths.append(path)
        return path

    def divergence_bundles(self) -> List[dict]:
        with self._lock:
            return list(self._bundles)

    # ---- canary probes --------------------------------------------------
    def _canary_prompts(self):
        with self._lock:
            n, plen, mnew, seed = self._canary_cfg
        rng = random.Random(seed)
        vocab = int(self.owner.model.config.vocab_size)
        eos = self.owner.eos_token_id
        out = []
        for _ in range(max(0, n)):
            ids = []
            while len(ids) < plen:
                t = rng.randrange(1, vocab)
                if eos is not None and t == int(eos):
                    continue
                ids.append(t)
            out.append((np.asarray(ids, np.int64), mnew))
        return out

    def _fingerprint(self) -> str:
        import zlib

        with self._lock:
            canary_cfg = list(self._canary_cfg)
        blob = json.dumps({"config": _engine_config(self.owner),
                           "flags": _flags.get_flags(),
                           "canary": canary_cfg},
                          sort_keys=True, default=str)
        return f"{zlib.crc32(blob.encode()):08x}"

    def _ensure_canary_baseline(self):
        """Pin the expected canary outputs once per (config, flag-set):
        a flag flip or config change re-baselines (and is visible as a
        fingerprint change in /audit), a drifting engine is not."""
        fp = self._fingerprint()
        with self._lock:
            if fp == self._canary_fingerprint and self._canaries:
                return
        eng = self.owner
        canaries = []
        for idx, (ids, mnew) in enumerate(self._canary_prompts()):
            toks, lps = reference_decode(eng.model, ids, mnew,
                                         eng.eos_token_id, None, owner=self)
            canaries.append({"idx": idx, "ids": ids,
                             "max_new_tokens": mnew,
                             "tokens": toks, "logprobs": lps})
        with self._lock:
            self._canaries = canaries
            self._canary_fingerprint = fp

    def _maybe_canary(self):
        with self._lock:
            interval = self.canary_interval_s
            t_last = self._t_last_canary
        if (not self.enabled or not self.auditable
                or interval <= 0 or self.submitter is None):
            return
        if time.time() - t_last < interval:
            return
        self.run_canaries()

    def run_canaries(self) -> List[dict]:
        """One canary sweep: ensure the pinned baseline, then run each
        canary through the LIVE engine (via the injected submitter) and
        compare. Deferred (not skipped) when the engine has real work —
        canaries only ever spend idle capacity."""
        with self._lock:
            self._t_last_canary = time.time()
        if self.submitter is None or not self.auditable:
            return []
        eng = self.owner
        if eng.num_active or getattr(eng, "_queue", None):
            with self._lock:
                self._canary_deferred += 1
            return []
        self._ensure_canary_baseline()
        results = []
        with self._lock:
            canaries = list(self._canaries)
        for c in canaries:
            out = self.submitter(c["ids"], c["max_new_tokens"])
            if out is None:      # engine saturated mid-sweep: defer
                with self._lock:
                    self._canary_deferred += 1
                continue
            live_t, live_lp = out
            first, drift = _compare(list(live_t), c["tokens"],
                                    list(live_lp or ()), c["logprobs"])
            verdict = {
                "schema_version": AUDIT_SCHEMA_VERSION,
                "rid": -(c["idx"] + 1), "ext_id": f"canary-{c['idx']}",
                "source": "canary",
                "verdict": "diverged" if first is not None else "pass",
                "reason": None, "n_tokens": len(live_t),
                "first_divergence": first, "logprob_drift": drift,
                "t": time.time()}
            if first is not None:
                verdict["bundle"] = self._seal_divergence(
                    "canary", -(c["idx"] + 1), f"canary-{c['idx']}",
                    c["ids"], list(live_t), c["tokens"],
                    list(live_lp or ()), c["logprobs"], first, drift,
                    None, c["max_new_tokens"])
            self._finish_verdict(verdict)
            results.append(verdict)
        with self._lock:
            self._canary_runs += 1
        return results

    # ---- snapshot surfaces ----------------------------------------------
    def federated(self) -> dict:
        """Scalar view merged into the engine's ``stats()`` — rides
        /health into the router's TSDB collector as ``cluster_audit_*``
        series, the same zero-extra-I/O transport as the profiler and
        KV-atlas scalars."""
        with self._lock:
            return {"audit_pass": float(self._n["pass"]),
                    "audit_diverged": float(self._n["diverged"]),
                    "audit_skipped": float(self._n["skipped"]),
                    "audit_drift": float(self._drift_last)}

    def payload(self) -> dict:
        """The full ``GET /audit`` entry for this engine."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "auditable": self.auditable,
                "audit_rate": self.audit_rate,
                "budget": {"max_pending": self.max_pending,
                           "pending": self._jobs.qsize(),
                           "max_queue_depth": self.max_queue_depth,
                           "min_headroom_frac": self.min_headroom_frac},
                "verdicts": dict(self._n),
                "skip_reasons": dict(self._skip_reasons),
                "logprob_drift_last": self._drift_last,
                "canary": {"interval_s": self.canary_interval_s,
                           "n": self._canary_cfg[0],
                           "fingerprint": self._canary_fingerprint,
                           "runs": self._canary_runs,
                           "deferred": self._canary_deferred,
                           "last_t": self._t_last_canary},
                "recent": list(self._verdicts.values()),
                "divergence_bundles": len(self._bundles),
                "divergence_paths": list(self._bundle_paths),
            }


def _engine_config(eng) -> dict:
    """The engine-geometry + feature-flag snapshot a divergence bundle
    records — everything replay needs to rebuild an equivalent engine."""
    s = getattr(eng, "_sample_cfg", (False, 1.0, 0, 1.0))
    return {"max_batch": int(getattr(eng, "max_batch", 1) or 1),
            "max_len": int(getattr(eng, "max_len", 0) or 0),
            "page_size": int(getattr(eng, "page_size", 16) or 16),
            "eos_token_id": getattr(eng, "eos_token_id", None),
            "do_sample": bool(s[0]), "temperature": float(s[1]),
            "top_k": int(s[2]), "top_p": float(s[3]),
            "speculative_k": getattr(eng, "speculative_k", None),
            "speculative_ngram": getattr(eng, "speculative_ngram", 3),
            "prefill_chunk_tokens": getattr(eng, "prefill_chunk_tokens",
                                            None),
            "enable_prefix_cache": bool(getattr(eng, "enable_prefix_cache",
                                                False)),
            "enable_preemption": bool(getattr(eng, "enable_preemption",
                                              False))}


# ---- registry ---------------------------------------------------------------

_SENTINELS: Dict[str, CorrectnessSentinel] = {}


def get_sentinel(engine: str) -> Optional[CorrectnessSentinel]:
    return _SENTINELS.get(engine)


def audit_payload() -> dict:
    """The JSON surface behind ``GET /audit`` (and the AUDIT section of
    incident bundles): every registered engine's sentinel state."""
    return {"schema_version": AUDIT_SCHEMA_VERSION,
            "engines": {name: s.payload()
                        for name, s in sorted(_SENTINELS.items())}}


# ---- divergence-bundle persistence ------------------------------------------

def save_bundle(bundle: dict, path: str):
    """Write a SEALED divergence bundle as JSON. Token arrays serialize
    as lists; :func:`load_bundle` restores them to the canonical
    ``np.int64`` form, so the stored checksum re-verifies bit-exact
    after the round-trip."""
    out = dict(bundle)
    for k in _ARRAY_FIELDS:
        if k in out:
            out[k] = [int(x) for x in np.asarray(out[k]).reshape(-1)]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_bundle(path: str) -> dict:
    """Load + integrity-check a divergence bundle written by
    :func:`save_bundle` (checksum, schema version, kind — the same gate
    every KV bundle admission runs)."""
    from .. import serving as _serving

    with open(path) as f:
        bundle = json.load(f)
    for k in _ARRAY_FIELDS:
        if k in bundle:
            bundle[k] = np.asarray(bundle[k], np.int64)
    _serving.verify_bundle(bundle, kind="divergence")
    if bundle.get("schema") != DIVERGENCE_SCHEMA:
        raise _serving.HandoffCorrupt(
            f"divergence bundle schema {bundle.get('schema')!r} where "
            f"{DIVERGENCE_SCHEMA!r} was expected")
    return bundle


# ---- offline replay + flag bisection ----------------------------------------

def bundle_features(bundle: dict) -> List[str]:
    """The feature set that was ACTIVE when the bundle was captured —
    the bisection search space, in a fixed blame-priority order."""
    cfg = bundle.get("config") or {}
    flags = bundle.get("flags") or {}
    feats = []
    if flags.get("FLAGS_use_fused_decode_tail"):
        feats.append("fused_tail")
    if cfg.get("speculative_k"):
        feats.append("speculation")
    if cfg.get("prefill_chunk_tokens"):
        feats.append("chunked_prefill")
    if cfg.get("enable_prefix_cache"):
        feats.append("prefix_cache")
    if flags.get("FLAGS_perturb_decode_token"):
        feats.append("perturb_token")
    return feats


def _replay_engine_run(model, bundle: dict, features) -> List[int]:
    """Re-run the bundle's request through a freshly built engine with
    EXACTLY the named features enabled (everything else reference), and
    return the emitted tokens. The flags (the fused tail, the
    perturbation drill) apply through the thread-local overlay, so the
    run's units stay private to this thread's flag fingerprint."""
    from .. import serving as _serving

    features = set(features)
    cfg = bundle["config"]
    ids = np.asarray(bundle["prompt_ids"]).reshape(-1)
    max_new = int(bundle["max_new_tokens"])
    page = int(cfg.get("page_size") or 16)
    spec_k = cfg.get("speculative_k") if "speculation" in features else None
    slack = (int(spec_k) - 1) if spec_k else 0
    max_len = _bucket(ids.size + max_new + slack, page)
    chunk = (cfg.get("prefill_chunk_tokens")
             if "chunked_prefill" in features else None)
    if chunk:
        max_len = max(max_len, _bucket(int(chunk), page))
    engine = _serving.ContinuousBatchEngine(
        model, max_batch=1, max_len=max_len, page_size=page,
        eos_token_id=cfg.get("eos_token_id"),
        do_sample=bool(cfg.get("do_sample")),
        temperature=float(cfg.get("temperature", 1.0)),
        top_k=int(cfg.get("top_k", 0)), top_p=float(cfg.get("top_p", 1.0)),
        enable_prefix_cache="prefix_cache" in features,
        prefill_chunk_tokens=int(chunk) if chunk else None,
        speculative_k=int(spec_k) if spec_k else None,
        speculative_ngram=int(cfg.get("speculative_ngram") or 3))
    overlay = {"use_fused_decode_tail": "fused_tail" in features,
               "perturb_decode_token": "perturb_token" in features}
    with _flags.flag_overrides(overlay):
        rid = engine.add_request(
            ids, max_new_tokens=max_new,
            stop_token_ids=bundle.get("stop_token_ids"))
        out = engine.run_until_done()
    return [int(t) for t in out[rid]]


def replay_bundle(bundle: dict, model, log=None) -> dict:
    """Offline divergence forensics: re-derive the reference stream,
    reproduce the recorded divergence under the full recorded feature
    set, then BISECT — re-run with each recorded feature enabled alone
    and blame every feature that independently reproduces a divergence
    (an empty singleton blame falls back to the full combination: an
    interaction bug). Deterministic by construction: greedy decode and
    a drill that flips every emitted token it sees."""
    say = log or (lambda *_: None)
    feats = bundle_features(bundle)
    ref_want = [int(t) for t in np.asarray(bundle["ref_tokens"])]
    live_want = [int(t) for t in np.asarray(bundle["live_tokens"])]
    ref_t, _ = reference_decode(
        model, bundle["prompt_ids"], bundle["max_new_tokens"],
        (bundle.get("config") or {}).get("eos_token_id"),
        bundle.get("stop_token_ids"))
    ref_ok = ref_t == ref_want
    say(f"reference replay: {'MATCHES' if ref_ok else 'DIFFERS FROM'} "
        f"the bundle's reference stream ({len(ref_t)} tokens)")
    runs: Dict[str, dict] = {}

    def run(name, enabled):
        toks = _replay_engine_run(model, bundle, enabled)
        first, _ = _compare(toks, ref_t, [], [])
        runs[name] = {"features": sorted(enabled), "tokens": toks,
                      "diverged": first is not None,
                      "first_divergence": first,
                      "matches_live": toks == live_want}
        say(f"  [{name}] features={sorted(enabled) or ['<none>']} -> "
            f"{'DIVERGED at ' + str(first) if first is not None else 'matches reference'}")
        return runs[name]

    say(f"recorded feature set: {feats or ['<none>']}")
    full = run("full", feats)
    blame: List[str] = []
    if full["diverged"]:
        for f in feats:
            if run(f"only:{f}", [f])["diverged"]:
                blame.append(f)
        if not blame and feats:
            blame = ["+".join(feats)]
    return {"schema_version": AUDIT_SCHEMA_VERSION,
            "features": feats,
            "ref_reproduced": ref_ok,
            "diverged_reproduced": full["diverged"],
            "blame": blame,
            "first_divergence_recorded": bundle.get("first_divergence"),
            "first_divergence_replayed": full.get("first_divergence"),
            "runs": runs}
