"""Kernel geometry autotune: a staged search with a persistent per-device
cost table. The port's own copy of ``paddle_tpu/ops/pallas/autotune.py``,
with its stages and its JSON schema, for the geometry of the CUDA kernels
(rows a block, slices of a contraction, blocks of a split launch) where the
JAX package searches Pallas block shapes.

1. **cache stage**: a persisted winner for (kernel, signature, device
   kind) that is still in the candidate space is returned without touching
   the card. A call inside a step unit's warm-ups or capture can take only
   this stage (``can_measure``), as a jitted JAX step.
2. **generate stage**: the caller supplies its geometry space as candidate
   tuples, each within the kernel's own limits (the wrappers refuse any
   other before a launch).
3. **prune stage**: candidates the cost table records as failed or
   infeasible are dropped; a cost model (bytes over the card's memory rate,
   operations over its peak, and ``GRID_STEP_MS`` for each *wave* of
   blocks: on the card the blocks of a wave run side by side, where the TPU
   walks its grid in sequence) ranks the rest, and only the best
   ``max_measure`` are timed. A candidate whose shared memory a block
   exceeds ``smem_limit()`` is recorded as infeasible unlaunched (the cost
   models keep JAX's key ``vmem_bytes`` for it).
4. **measure stage**: every survivor's time, or its failure, lands in the
   signature's cost table, not just the winner.

Times are the card's (``_measure``): the first call is left out (it may
build the kernels or capture a graph), then CUDA events around a loop of
back-to-back calls queued behind a spin kernel, so that the host's pace
does not stand in for a microsecond kernel's; the best of three loops. A
sweep's launches are taken out of the launch counts.

The cache file is ``.pd_autotune_torch.json`` at the root of the checkout
(``PD_AUTOTUNE_CACHE`` overrides it), not the JAX package's
``.pd_autotune.json``: one kernel name means another geometry in each
package. Signatures are spelled as the JAX package spells them
(``"bfloat16"``), so one table reads the same in both. Writes are batched
in memory and flushed write-temp-then-rename at the end of a sweep and at
exit.

``FLAGS_use_autotune`` (``utils/flags.py``, off by default) gates the
search: off, every caller keeps its fixed geometry. ``stages`` counts the
stage each search ended in, by ``"<kernel> <stage>"``, as ``_build.
launches`` counts launches.
"""
from __future__ import annotations

import atexit
import json
import logging
import math
import os
import time
from collections import Counter
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

from . import _build

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    ".pd_autotune_torch.json")

#: modeled cost of one wave of blocks (launch, ramp, tail), in ms: what
#: separates two candidates that move the same bytes
GRID_STEP_MS = 2e-3

#: the H100's streaming multiprocessors and shared memory a block may use,
#: where no card is present to ask
H100_SMS, H100_SMEM = 132, 232448

#: the stage each search ended in: "off", "cache", "default" (a miss that
#: could not measure), "measured" or "failed" (nothing ran)
stages: Counter = Counter()


def cache_path() -> str:
    return os.environ.get("PD_AUTOTUNE_CACHE", _DEFAULT_PATH)


def _logger():
    return logging.getLogger("paddle_tpu_torch.ops.autotune")


# ---------------------------------------------------------------------------
# roofline device model
# ---------------------------------------------------------------------------

#: device-kind substring -> (memory bytes/s, peak bf16 operations/s),
#: matched against ``device_kind()`` lowercased, first hit wins. The H100
#: row is the SXM data sheet's (the rates ``chip_smoke.py`` divides by);
#: the CPU row is the JAX package's, which only ranks.
_ROOFLINE_CAPS: List[Tuple[str, Tuple[float, float]]] = [
    ("h100", (3.35e12, 989e12)),
    ("cpu", (5e10, 1e11)),
]
_DEFAULT_CAPS = (3.35e12, 989e12)


def roofline_caps(device: Optional[str] = None) -> Tuple[float, float]:
    kind = (device or device_kind()).lower()
    for sub, caps in _ROOFLINE_CAPS:
        if sub in kind:
            return caps
    return _DEFAULT_CAPS


def _card(attr: str, fallback: int) -> int:
    import torch

    if not torch.cuda.is_available():
        return fallback
    return int(getattr(torch.cuda.get_device_properties(0), attr))


def sm_count() -> int:
    return _card("multi_processor_count", H100_SMS)


def smem_limit() -> int:
    """Shared memory a block may use on the card (its opt-in maximum): the
    feasibility ceiling of the prune stage, where the JAX package has its
    VMEM limit."""
    return _card("shared_memory_per_block_optin", H100_SMEM)


def roofline_ms(bytes_hbm: float, flops: float,
                device: Optional[str] = None, grid: int = 0,
                blocks_per_sm: int = 0) -> float:
    """Least time of a launch: the slower of the memory and compute
    ceilings, plus ``GRID_STEP_MS`` per wave of ``SMs * blocks_per_sm``
    blocks (per block of ``grid`` when ``blocks_per_sm`` is 0, the JAX
    package's sequential grid)."""
    bw, peak = roofline_caps(device)
    grid = int(grid)
    waves = (math.ceil(grid / (sm_count() * int(blocks_per_sm)))
             if blocks_per_sm else grid)
    return max(bytes_hbm / bw, flops / peak) * 1e3 + waves * GRID_STEP_MS


def _roofline_of(est: dict) -> float:
    return roofline_ms(est.get("bytes", 0), est.get("flops", 0),
                       grid=est.get("grid", 0),
                       blocks_per_sm=est.get("blocks_per_sm", 0))


# ---- per-kernel analytical cost models --------------------------------------
# fn(params: dict, choice: tuple) -> {"bytes", "flops", "vmem_bytes",
# "grid", "blocks_per_sm"} (any subset); ``params`` is what the kernel
# recorded with its signature (shape ints and a dtype string)

_COST_MODELS: Dict[str, Callable[[dict, tuple], dict]] = {}


def register_cost_model(kernel: str,
                        fn: Callable[[dict, tuple], dict]) -> None:
    _COST_MODELS[kernel] = fn


def analytical_cost(kernel: str, params: dict,
                    choice: Sequence[int]) -> Optional[dict]:
    """The registered cost model at ``choice``; None for a kernel without
    one."""
    fn = _COST_MODELS.get(kernel)
    if fn is None:
        return None
    return fn(dict(params), tuple(int(c) for c in choice))


# ---------------------------------------------------------------------------
# the persisted cost table
# ---------------------------------------------------------------------------

def _choice_key(choice: Sequence[int]) -> str:
    return ",".join(str(int(c)) for c in choice)


class AutotuneCache:
    """kernel -> {signature -> entry} with JSON persistence; the JAX
    package's schema:

    - ``choice`` / ``ms`` / ``measured_at``: the winner;
    - ``params``: the shape and dtype the signature was built from;
    - ``est``: the winner's modeled ``bytes`` / ``flops`` / ``roofline_ms``;
    - ``table``: each candidate's outcome, ``{"<c0,c1>": {"ms": ...,
      "status": "ok"}}``, ``{"status": "fail", "error": "..."}`` or
      ``{"status": "infeasible", "reason": "..."}``; failed and infeasible
      geometries are pruned from every later search on this device.

    Writes batch in memory; :meth:`flush` persists write-temp-then-rename.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or cache_path()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._loaded = False
        self._dirty = False

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._data = json.load(f)
        except FileNotFoundError:
            self._data = {}
        except (OSError, ValueError) as e:
            # a torn or corrupt file must not stop the kernel path; the
            # searches measure again
            _logger().warning("autotune cache %s unreadable (%s: %s); "
                              "starting empty", self.path,
                              type(e).__name__, e)
            self._data = {}

    # ---- reads ---------------------------------------------------------
    def entry(self, kernel: str, key: str) -> Optional[dict]:
        self._load()
        return self._data.get(kernel, {}).get(key)

    def get(self, kernel: str, key: str):
        ent = self.entry(kernel, key)
        return None if ent is None else ent.get("choice")

    def failures(self, kernel: str, key: str) -> Set[Tuple[int, ...]]:
        """Geometries this device has proven bad (fail or infeasible)."""
        ent = self.entry(kernel, key) or {}
        out: Set[Tuple[int, ...]] = set()
        for ck, rec in (ent.get("table") or {}).items():
            if rec.get("status") in ("fail", "infeasible"):
                try:
                    out.add(tuple(int(p) for p in ck.split(",")))
                except ValueError:
                    continue  # a hand-edited key matches nothing
        return out

    # ---- writes (in memory; flush() persists) --------------------------
    def _entry_for_write(self, kernel: str, key: str) -> dict:
        self._load()
        ent = self._data.setdefault(kernel, {}).setdefault(key, {})
        self._dirty = True
        return ent

    def record_result(self, kernel: str, key: str, choice: Sequence[int],
                      ms: Optional[float] = None,
                      error: Optional[BaseException] = None,
                      infeasible: Optional[str] = None):
        """One candidate's outcome into the cost table."""
        ent = self._entry_for_write(kernel, key)
        table = ent.setdefault("table", {})
        if error is not None:
            rec = {"status": "fail",
                   "error": f"{type(error).__name__}: {error}"[:200]}
        elif infeasible is not None:
            rec = {"status": "infeasible", "reason": infeasible[:200]}
        else:
            rec = {"status": "ok", "ms": round(float(ms), 4)}
        table[_choice_key(choice)] = rec

    def put(self, kernel: str, key: str, choice: Sequence[int], ms: float,
            params: Optional[dict] = None, est: Optional[dict] = None):
        """Record the winner, with the shape params and its estimate."""
        ent = self._entry_for_write(kernel, key)
        ent.update({"choice": [int(c) for c in choice],
                    "ms": round(float(ms), 4),
                    "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
        if params is not None:
            ent["params"] = dict(params)
        if est is not None:
            ent["est"] = {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in est.items()}

    def flush(self):
        """Persist if dirty, write-temp-then-rename (a concurrent reader
        never sees a torn file)."""
        if not self._dirty:
            return
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            self._dirty = False
        except OSError as e:
            _logger().warning("autotune cache flush to %s failed (%s: %s)",
                              self.path, type(e).__name__, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass


_cache: Optional[AutotuneCache] = None
_ATEXIT_REGISTERED = False


def flush_cache() -> None:
    """Flush the live cache, if any (the atexit hook)."""
    if _cache is not None:
        _cache.flush()


def get_cache() -> AutotuneCache:
    global _cache, _ATEXIT_REGISTERED
    if _cache is None or _cache.path != cache_path():
        if _cache is not None:
            _cache.flush()  # a path swap keeps the batched rows
        _cache = AutotuneCache()
        if not _ATEXIT_REGISTERED:
            _ATEXIT_REGISTERED = True
            atexit.register(flush_cache)
        # incident bundles flush every tracked writer first: a crash in
        # the middle of a search keeps the sweep's rows
        from ...observability.snapshot import track_flushable

        track_flushable(_cache)
    return _cache


def enabled() -> bool:
    from ...utils.flags import flag

    return bool(flag("FLAGS_use_autotune"))


_kind: list = []


def device_kind() -> str:
    """The card's name with spaces as ``_`` (``NVIDIA_H100_80GB_HBM3``), or
    ``"cpu"`` where no card is present: part of every cache key, since a
    winner is a property of the card."""
    if not _kind:
        import torch

        _kind.append(torch.cuda.get_device_name().replace(" ", "_")
                     if torch.cuda.is_available() else "cpu")
    return _kind[0]


def full_key(key: str) -> str:
    return f"{key} @{device_kind()}"


def can_measure(*tensors) -> bool:
    """Whether a timed sweep may run now: every operand a CUDA tensor, no
    stream capturing a graph, and not inside a step unit's warm-ups or
    capture (``_build.unit_scope``), which read the cost table only. The
    analog of the JAX package's ``is_concrete``."""
    if not tensors or not all(getattr(t, "is_cuda", False)
                              for t in tensors):
        return False
    return not (_build.in_unit() or _build.capturing(tensors[0].device))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

#: a timed loop spans at least this much device time, in MIN_CALLS to
#: MAX_CALLS calls; the spin kernel runs this many cycles per ms
LOOP_MS, MIN_CALLS, MAX_CALLS = 1.0, 3, 200
SPIN_CYCLES_PER_MS = 2_000_000


def _on_cuda(out) -> bool:
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(o) for o in out)
    if isinstance(out, dict):
        return any(_on_cuda(o) for o in out.values())
    return bool(getattr(out, "is_cuda", False))


def _device_ms(fn, loops: int = 3) -> float:
    """Device ms a call of ``fn``: CUDA events around ``n`` back-to-back
    calls queued behind a spin kernel long enough for the host to enqueue
    them all, best of ``loops``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    one = start.elapsed_time(end)
    n = max(MIN_CALLS, min(MAX_CALLS, math.ceil(LOOP_MS / max(one, 1e-4))))
    best = float("inf")
    for _ in range(loops):
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * (1.5 * n * host_ms
                                                    + 0.1)))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def _measure(fn: Callable[[], Any], reps: int = 3) -> float:
    """ms a call of ``fn``. The first call is not timed (it may build the
    kernels or capture a graph). On the card the device's time
    (``_device_ms``); elsewhere wall time over ``reps`` calls, as the JAX
    package measures. The launches it makes are taken out of the counts."""
    saved = Counter(_build.launches)
    try:
        out = fn()
        if _on_cuda(out):
            return _device_ms(fn)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1000 / reps
    finally:
        _build.launches.clear()
        _build.launches.update(saved)


def _record_sweep(kernel: str, key: str, choice: Tuple[int, ...],
                  ms: float, measured: int, failed: int, pruned: int,
                  log: bool):
    """Audit one sweep: the log line and the ``autotune.sweep``
    flight-recorder event."""
    if log:
        _logger().info(
            "autotune[%s] %s -> %s (%.3f ms; measured=%d failed=%d "
            "pruned=%d)", kernel, key, choice, ms, measured, failed,
            pruned)
    from ...observability import flightrecorder as _frec

    rec = _frec.get_recorder()
    if rec.enabled:
        rec.record(_frec.EV_AUTOTUNE_SWEEP, kernel=kernel, key=key,
                   choice=list(choice), ms=round(ms, 4),
                   measured=measured, failed=failed, pruned=pruned)


def _end(kernel: str, stage: str, choice):
    stages[f"{kernel} {stage}"] += 1
    return choice


def search(kernel: str, key: str, default: Tuple[int, ...],
           candidates: Sequence[Tuple[int, ...]],
           runner: Callable[[Tuple[int, ...]], Callable[[], Any]],
           can_measure: bool, *, params: Optional[dict] = None,
           cost_model: Optional[Callable[[tuple], dict]] = None,
           max_measure: Optional[int] = None,
           vmem_limit: Optional[int] = None,
           log: bool = True) -> Tuple[int, ...]:
    """Staged geometry search for (kernel, key); see the module docstring.

    ``cost_model(cfg)`` (optional) returns ``{"bytes", "flops",
    "vmem_bytes", "grid", "blocks_per_sm"}`` estimates, used to drop a
    geometry whose block needs more shared memory than ``vmem_limit``
    (default ``smem_limit()``) unlaunched, to rank the rest and keep the
    ``max_measure`` best (8 by default), and to persist the winner's
    estimate. A sweep times each survivor through ``runner(cfg)()``; a
    candidate that raises in Python is recorded as failed (the wrappers
    check every geometry before a launch, so no candidate reaches the card
    outside its kernel's limits)."""
    if not enabled():
        return _end(kernel, "off", default)
    key = full_key(key)
    cache = get_cache()
    hit = cache.get(kernel, key)
    if hit is not None:
        hit = tuple(hit)
        # a stale or hand-edited winner outside the space is not launched
        if not candidates or hit in {tuple(c) for c in candidates}:
            return _end(kernel, "cache", hit)
    if not can_measure:
        return _end(kernel, "default", default)
    cands = list(dict.fromkeys(tuple(c) for c in candidates))
    known_bad = cache.failures(kernel, key)
    pruned = sum(1 for c in cands if c in known_bad)
    cands = [c for c in cands if c not in known_bad]
    if cost_model is not None:
        limit = smem_limit() if vmem_limit is None else vmem_limit
        feasible = []
        for c in cands:
            est = cost_model(c) or {}
            if est.get("vmem_bytes", 0) > limit:
                cache.record_result(
                    kernel, key, c,
                    infeasible=f"vmem {est['vmem_bytes']} > {limit}")
                pruned += 1
                continue
            feasible.append((_roofline_of(est), c))
        feasible.sort(key=lambda t: t[0])
        keep = max_measure if max_measure is not None else 8
        pruned += max(len(feasible) - keep, 0)
        cands = [c for _, c in feasible[:keep]]
    elif max_measure is not None:
        pruned += max(len(cands) - max_measure, 0)
        cands = cands[:max_measure]
    best, best_ms = default, float("inf")
    failed = 0
    for cfg in cands:
        try:
            ms = _measure(runner(cfg))
        except Exception as e:
            # its failure is evidence: no later search on this device
            # launches the same geometry again
            failed += 1
            cache.record_result(kernel, key, cfg, error=e)
            _logger().debug("autotune[%s] %s candidate %s failed (%s: %s)",
                            kernel, key, cfg, type(e).__name__, e)
            continue
        cache.record_result(kernel, key, cfg, ms=ms)
        if ms < best_ms:
            best, best_ms = tuple(cfg), ms
    if best_ms == float("inf"):
        cache.flush()  # the failures are worth keeping without a winner
        return _end(kernel, "failed", default)
    est = None
    if cost_model is not None:
        e = cost_model(best)
        est = {"bytes": int(e.get("bytes", 0)),
               "flops": int(e.get("flops", 0)),
               "roofline_ms": _roofline_of(e)}
    cache.put(kernel, key, best, best_ms, params=params, est=est)
    cache.flush()
    _record_sweep(kernel, key, best, best_ms,
                  measured=len(cands) - failed, failed=failed,
                  pruned=pruned, log=log)
    return _end(kernel, "measured", best)


def pick(kernel: str, key: str, default: Tuple[int, ...],
         candidates: Sequence[Tuple[int, ...]],
         runner: Callable[[Tuple[int, ...]], Callable[[], Any]],
         can_measure: bool, log: bool = True,
         params: Optional[dict] = None) -> Tuple[int, ...]:
    """``search`` without a cost model: every candidate is measured."""
    return search(kernel, key, default, candidates, runner, can_measure,
                  params=params, log=log)


def signature(params: dict) -> str:
    """The JAX package's signature of a params dict: ``"<key><value>"``
    sorted by key, joined by spaces."""
    return " ".join(f"{k}{v}" for k, v in sorted(params.items()))


def tuned(kernel: str, key: str, default: Tuple[int, ...],
          candidates: Sequence[Tuple[int, ...]], runner, operands,
          params: Optional[dict] = None,
          cost: bool = True) -> Tuple[int, ...]:
    """A hooked kernel's geometry: ``default`` with the flag off, else the
    search with the registered cost model of ``kernel`` (``cost``), a
    sweep allowed when ``can_measure(*operands)``."""
    if not enabled():
        return default
    model = None
    if cost:
        def model(cfg):
            return analytical_cost(kernel, params, cfg)
    return search(kernel, key, default, candidates, runner,
                  can_measure(*operands), params=params, cost_model=model)
