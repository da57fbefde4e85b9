"""The n-gram drafter of the engine's speculative decoding — counterpart of
``paddle_tpu/speculative.py`` ``_ngram_next`` / ``ngram_propose``.

Host work only (numpy): it runs between engine dispatches on a request's
prompt + token history and never touches the device.
"""
from __future__ import annotations

import numpy as np


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
