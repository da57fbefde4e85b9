"""The port's correctness sentinel (``observability/sentinel.py``): its
``reference_decode`` against the JAX package's in f32 on the same numpy
weights, a shadow audit of an engine request, a forced audit of a sampled
request (a typed skip), and the divergence drill: the engine decoding
under ``FLAGS_perturb_decode_token`` (a thread-local flag override) is
audited, the divergence bundle is sealed, survives a save / load round
trip, and ``replay_bundle`` reproduces it and blames the drill. Last,
audits on the worker against steps on the caller's thread: every step
unit's body runs under ``cuda_graph.DEVICE_LOCK``."""
import sys
import threading

import numpy as np
import pytest
from test_torch_engine_sched import llama_pair

from paddle_tpu.observability import sentinel as jax_sentinel
from paddle_tpu_torch.observability import sentinel
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.utils import flags


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 512, (n,))


@pytest.fixture
def audited():
    """An engine with its sentinel on and its audit worker running."""
    _, model = llama_pair()
    eng = ContinuousBatchEngine(model, max_batch=2, max_len=64, page_size=8)
    eng.sentinel.enable()
    eng.sentinel.start()
    yield eng
    eng.sentinel.stop()
    eng.sentinel.disable()


def test_reference_decode_matches_jax():
    jax_model, port_model = llama_pair()
    ids = _prompt(30, 9)
    toks, lps = sentinel.reference_decode(port_model, ids, 8)
    want_t, want_lp = jax_sentinel.reference_decode(jax_model, ids, 8)
    assert toks == want_t
    np.testing.assert_allclose(lps, want_lp, rtol=0, atol=1e-4)
    # stop semantics: the stop token is emitted, then decoding ends
    stop = toks[3]
    got, _ = sentinel.reference_decode(port_model, ids, 8,
                                       stop_token_ids=[stop])
    assert got == toks[:toks.index(stop) + 1]


def test_audit_of_engine_request_passes(audited):
    eng = audited
    rid = eng.add_request(_prompt(31, 7), max_new_tokens=6, audit=True)
    # a sampled request can't be audited: a typed skip, never silence
    rid_s = eng.add_request(_prompt(32, 5), max_new_tokens=3,
                            do_sample=True, temperature=0.9, audit=True)
    eng.run_until_done()
    v = eng.sentinel.wait_verdict(rid, timeout=60)
    assert v["verdict"] == "pass", v
    assert v["first_divergence"] is None and v["logprob_drift"] < 1e-4
    assert v["n_tokens"] == 6
    s = eng.sentinel.wait_verdict(rid_s, timeout=5)
    assert s["verdict"] == "skipped" and s["reason"] == "sampling"
    fed = eng.stats()
    assert fed["audit_pass"] >= 1 and fed["audit_skipped"] >= 1


def test_forced_divergence_is_sealed_and_blamed(audited, tmp_path):
    eng = audited
    eng.sentinel.enable(divergence_dir=str(tmp_path))
    with flags.flag_overrides({"perturb_decode_token": True}):
        rid = eng.add_request(_prompt(33, 6), max_new_tokens=5, audit=True)
        out = eng.run_until_done()
    v = eng.sentinel.wait_verdict(rid, timeout=60)
    assert v["verdict"] == "diverged" and v["first_divergence"] == 0
    bundle = eng.sentinel.divergence_bundles()[-1]
    assert bundle["flags"]["FLAGS_perturb_decode_token"] is True
    assert bundle["live_tokens"].tolist() == out[rid].tolist()
    loaded = sentinel.load_bundle(v["bundle"])
    assert loaded["checksum"] == bundle["checksum"]
    assert sentinel.bundle_features(loaded) == ["perturb_token"]
    report = sentinel.replay_bundle(loaded, eng.model)
    assert report["ref_reproduced"] and report["diverged_reproduced"]
    assert report["blame"] == ["perturb_token"]
    assert report["runs"]["full"]["matches_live"]


class _CheckedLock:
    """``DEVICE_LOCK`` with its holder tracked: the test asserts that each
    step unit's body runs while its thread holds it."""

    def __init__(self):
        self._lock = threading.RLock()
        self.owner, self.depth, self.threads = None, 0, set()

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        self.depth += 1
        self.threads.add(threading.current_thread().name)
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        if self.depth == 0:
            self.owner = None
        self._lock.release()

    def held(self):
        return self.owner == threading.get_ident()


def test_audits_and_steps_share_the_device_lock(audited, monkeypatch):
    """Audit replays on the worker and engine steps on this thread, with a
    short switch interval: every unit body runs under the lock on both
    threads, and every audit passes."""
    from paddle_tpu_torch import generation, serving
    from paddle_tpu_torch.jit import cuda_graph

    lock = _CheckedLock()
    monkeypatch.setattr(cuda_graph, "DEVICE_LOCK", lock)
    monkeypatch.setattr(serving, "DEVICE_LOCK", lock)
    outside = []
    for cls in (generation._PrefillStep, generation._SelectDecodeStep):
        real = cls.eager

        def eager(self, *a, _real=real, **k):
            if not lock.held():
                outside.append(threading.current_thread().name)
            return _real(self, *a, **k)

        monkeypatch.setattr(cls, "eager", eager)
    eng = audited
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rids = [eng.add_request(_prompt(40 + i, 5 + i % 4), max_new_tokens=4,
                                audit=True) for i in range(8)]
        eng.run_until_done()
        verdicts = [eng.sentinel.wait_verdict(r, timeout=120) for r in rids]
    finally:
        sys.setswitchinterval(prev)
    assert [v["verdict"] for v in verdicts] == ["pass"] * len(rids)
    assert not outside, outside
    assert {threading.current_thread().name,
            "audit-worker-decoder"} <= lock.threads


def test_sentinel_registry_does_not_keep_the_engine():
    """The process-wide registry keeps the latest sentinel of a label; it
    holds its engine weakly, so a dropped engine (and its model, pool and
    graphs on the card) is freed."""
    import gc
    import weakref

    _, model = llama_pair()
    eng = ContinuousBatchEngine(model, max_batch=2, max_len=64, page_size=8)
    ref = weakref.ref(eng)
    assert sentinel.get_sentinel("decoder").owner is eng
    del eng
    gc.collect()
    assert ref() is None
    assert sentinel.get_sentinel("decoder").owner is None
