"""Rank-aware JSONL metric snapshots.

Multihost runs write one file PER RANK (the distributed/log_utils
convention: rank from PADDLE_TRAINER_ID, falling back to RANK) so
concurrent processes never interleave lines in one file; a single-process
run writes an unsuffixed file. Each line is one self-contained snapshot:
``{"ts": ..., "rank": ..., "step": ..., "metrics": {...}}``.
The port's copy of ``paddle_tpu/observability/snapshot.py``.

Writers default to unbuffered (open-append-close per line: crash-safe).
``buffer_lines=N`` batches lines to amortise the open/write/close
syscalls on high-frequency snapshot loops; buffered tails are flushed on
clean interpreter exit (one atexit hook over every live writer) and by
the IncidentReporter the moment it activates a dump — a crash must not
eat the snapshots that describe it.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref
from typing import Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["SnapshotWriter", "flush_all_writers", "track_flushable"]


def _rank() -> Optional[int]:
    r = os.environ.get("PADDLE_TRAINER_ID") or os.environ.get("RANK")
    return int(r) if r is not None else None


# every live writer, so atexit and the incident reporter can flush
# buffered tails; weak refs so tracking never pins a writer alive
_LIVE_WRITERS: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def track_flushable(obj) -> None:
    """Enroll any object with a ``flush()`` method (and a ``path``
    attribute for error lines) into the atexit/incident flush set — the
    autotune cost table rides the same buffered-tail lifecycle as the
    snapshot writers."""
    _LIVE_WRITERS.add(obj)


def flush_all_writers() -> None:
    """Flush every live SnapshotWriter's buffered lines (atexit hook,
    and the IncidentReporter's first act when dumping a bundle)."""
    for w in list(_LIVE_WRITERS):
        try:
            w.flush()
        except Exception as e:
            # one broken writer (deleted dir, full disk) must not stop
            # the others from flushing at exit / mid-incident
            try:
                from logging import getLogger as get_logger

                get_logger("paddle_tpu_torch.observability").warning(
                    "snapshot flush failed for %s (%s: %s)",
                    getattr(w, "path", "?"), type(e).__name__, e)
            except Exception:  # pdlint: disable=silent-exception -- logging infra itself may be torn down during interpreter exit
                pass


class SnapshotWriter:
    """Append registry snapshots to ``<dir>/<prefix>[.rankN].jsonl``.

    >>> w = SnapshotWriter("logs/metrics")
    >>> w.write(step=10)            # one JSON line, flushed
    >>> w = SnapshotWriter("logs/metrics", buffer_lines=64)
    >>> w.write(step=11)            # buffered; flushed at 64 lines,
    ...                             # on flush(), atexit, or incident
    """

    def __init__(self, directory: str, prefix: str = "metrics",
                 registry: Optional[MetricsRegistry] = None,
                 buffer_lines: int = 0):
        self.registry = registry or get_registry()
        self.rank = _rank()
        self.buffer_lines = int(buffer_lines)
        self._pending = []
        self._lock = threading.Lock()
        suffix = f".rank{self.rank}" if self.rank is not None else ""
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{prefix}{suffix}.jsonl")
        global _ATEXIT_REGISTERED
        _LIVE_WRITERS.add(self)
        if not _ATEXIT_REGISTERED:
            _ATEXIT_REGISTERED = True
            atexit.register(flush_all_writers)

    def write(self, step: Optional[int] = None, extra: Optional[dict] = None):
        """Append one snapshot line (unbuffered writers open per write:
        crash-safe, and rank isolation means no other process holds this
        path)."""
        rec = {"ts": time.time(), "rank": self.rank,
               "metrics": self.registry.snapshot()}
        if step is not None:
            rec["step"] = int(step)
        if extra:
            rec.update(extra)
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._pending.append(line)
            if len(self._pending) < self.buffer_lines:
                return self.path
            lines, self._pending = self._pending, []
        with open(self.path, "a") as f:
            f.writelines(lines)
        return self.path

    def flush(self):
        """Write any buffered lines out now."""
        with self._lock:
            lines, self._pending = self._pending, []
        if lines:
            with open(self.path, "a") as f:
                f.writelines(lines)
        return self.path

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)
