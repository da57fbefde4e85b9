"""Port parity of the engine's scheduler: chunked prefill, the prefix cache,
priorities, deadlines and aging, the bounded queue, shedding, preemption,
and their mixes with speculation, against the JAX ``ContinuousBatchEngine``
on the same f32 weights (``test_torch_pair.build_pair`` and the DeepSeek /
Mistral pairs, whose JAX rope tables are built eagerly).

Each case runs one script on both engines: greedy tokens identical,
logprobs within atol 1e-4, finish reasons, shed payloads and the listed
``stats()`` keys equal. Every case runs on an injected clock:
``time.perf_counter`` fixed, advanced only by the time-dependent cases
(aging, deadlines); both packages' engines read it."""
import functools
import math
import time

import numpy as np
import pytest
from test_torch_deepseek import _pair as deepseek_pair
from test_torch_mistral import _pair as mistral_pair
from test_torch_pair import build_pair

import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.serving as port_serving

ENG = dict(max_batch=2, max_len=64, page_size=8)
V = 512
STATS = ("requests_admitted", "requests_finished", "requests_cancelled",
         "requests_rejected", "requests_preempted", "requests_shed",
         "deadline_misses", "requests_migrated_out", "requests_migrated_in",
         "requests_slo_good", "requests_slo_late", "requests_active",
         "requests_queued", "requests_prefilling", "decode_steps",
         "tokens_generated", "max_active_slots", "requests_degraded",
         "prefix_pages_reused", "spec_dispatches", "spec_emitted_tokens",
         "spec_accepted_tokens")


@functools.lru_cache(maxsize=None)
def llama_pair():
    """The Llama pair of this file and ``test_torch_engine_bundles``, one
    per process: the JAX engine's programs are memoized on its model, so
    the two files trace each shape once."""
    jax_model, port_model, _ = build_pair(max_len=ENG["max_len"])
    return jax_model, port_model


@pytest.fixture(scope="module")
def llama():
    return llama_pair()


@pytest.fixture(scope="module")
def deepseek():
    jax_model, port_model, _ = deepseek_pair(max_len=ENG["max_len"])
    return jax_model, port_model


class _Clock:
    """A fixed ``time.perf_counter``, advanced only by the test."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """Every case runs on the fixed clock: on the real one, a JAX trace
    slower than ``aging_s`` (5 s by default) would age a queued request
    on one side only."""
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def both(pair, scenario):
    """``scenario(module, model)`` on the JAX engine and the port's; the
    two outcomes held equal (``same``). Returns the port's."""
    jax_model, port_model = pair
    want = scenario(jax_serving, jax_model)
    got = scenario(port_serving, port_model)
    same(got, want)
    return got


def same(got, want, path="outcome"):
    """Equal structure and values; logprob lists (keys ``lp``) and floats
    within 1e-4."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k == "lp" and want[k] is not None:
                assert len(got[k]) == len(want[k]), path
                for g, w in zip(got[k], want[k]):
                    if w is None:
                        assert g is None, path
                    else:
                        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                                   err_msg=f"{path}/{k}")
            else:
                same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not math.isinf(want):
        assert got == pytest.approx(want, abs=1e-4), (path, got, want)
    else:
        assert got == want, (path, got, want)


def outcome(eng, rids, done, **extra):
    """What a scenario is judged on: each request's tokens, logprobs and
    finish reason, and the listed stats."""
    st = eng.stats()
    return dict(tok=[done[r].tolist() if r in done else None for r in rids],
                lp=[eng.logprobs(r) for r in rids],
                reason=[eng.finish_reason(r) for r in rids],
                stats={k: st[k] for k in STATS}, **extra)


def drive(eng, done, steps):
    for _ in range(steps):
        done.update(eng.step())


def prompts(seed, *lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, (n,)) for n in lengths]


def repetitive(reps):
    return np.tile(np.asarray([3, 5, 7, 9]), reps)


# ---- chunked prefill ---------------------------------------------------------

def _chunked(mod, m, chunk=16, **kw):
    """A 41-token prompt in 16-token chunks while a short request decodes
    (``test_scheduler.py:57``)."""
    long_p, short_p = prompts(4, 41, 5)
    eng = mod.ContinuousBatchEngine(m, **ENG, prefill_chunk_tokens=chunk,
                                    **kw)
    done = {}
    a = eng.add_request(short_p, max_new_tokens=12, logprobs=True)
    drive(eng, done, 2)
    b = eng.add_request(long_p, max_new_tokens=6, logprobs=True)
    prefilling = [eng.stats()["requests_prefilling"]]
    drive(eng, done, 1)
    prefilling.append(eng.stats()["requests_prefilling"])
    done.update(eng.run_until_done())
    return outcome(eng, [a, b], done, prefilling=prefilling)


def test_chunked_prefill_paged(llama):
    got = both(llama, _chunked)
    assert got["prefilling"] == [1, 1]
    # chunked = monolithic, token for token
    mono = _chunked(port_serving, llama[1], chunk=None)
    assert mono["tok"] == got["tok"]


def test_chunked_prefill_latent(deepseek):
    """Latent mode: chunk continuations through the latent suffix prefill
    (``test_scheduler.py:78``)."""
    def scenario(mod, m, chunk=16):
        long_p, short_p = prompts(9, 41, 5)
        eng = mod.ContinuousBatchEngine(m, **ENG, prefill_chunk_tokens=chunk)
        assert eng._latent_mode
        done = {}
        a = eng.add_request(short_p, max_new_tokens=10, logprobs=True)
        drive(eng, done, 2)
        b = eng.add_request(long_p, max_new_tokens=6, logprobs=True)
        done.update(eng.run_until_done())
        return outcome(eng, [a, b], done)

    got = both(deepseek, scenario)
    assert scenario(port_serving, deepseek[1], chunk=None)["tok"] == got["tok"]


def test_chunked_prefill_with_prefix_hit(llama):
    """The first chunk copies the shared prefix from the active slot and
    runs one chunk of the suffix; later chunks continue in place
    (``test_scheduler.py:100``)."""
    def scenario(mod, m):
        (p_a,), (tail,) = prompts(4, 41), prompts(11, 25)
        p_b = np.concatenate([p_a[:16], tail])
        eng = mod.ContinuousBatchEngine(m, **ENG, prefill_chunk_tokens=16,
                                        enable_prefix_cache=True)
        done = {}
        a = eng.add_request(p_a, max_new_tokens=8, logprobs=True)
        drive(eng, done, 4)
        b = eng.add_request(p_b, max_new_tokens=8, logprobs=True)
        done.update(eng.run_until_done())
        return outcome(eng, [a, b], done)

    got = both(llama, scenario)
    assert got["stats"]["prefix_pages_reused"] == 2


def test_short_prompts_skip_chunking(llama):
    """A prompt no longer than one chunk admits whole: no slot is reserved
    (``test_scheduler.py:122``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, **ENG, prefill_chunk_tokens=16)
        rid = eng.add_request(np.arange(1, 6), max_new_tokens=4,
                              logprobs=True)
        reserved = len(eng._chunking)
        active = eng.num_active
        return outcome(eng, [rid], eng.run_until_done(),
                       reserved=reserved, active=active)

    got = both(llama, scenario)
    assert (got["reserved"], got["active"]) == (0, 1)


def test_cancel_mid_chunk_frees_reserved_slot(llama):
    """``test_scheduler.py:403``."""
    def scenario(mod, m):
        (long_p,) = prompts(4, 41)
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, prefill_chunk_tokens=16)
        rid = eng.add_request(long_p, max_new_tokens=6)
        eng.step()
        mid = eng.stats()["requests_prefilling"]
        cancelled = eng.cancel(rid)
        nxt = eng.add_request(np.arange(1, 6), max_new_tokens=2,
                              logprobs=True)
        return outcome(eng, [rid, nxt], eng.run_until_done(), mid=mid,
                       cancelled=cancelled)

    got = both(llama, scenario)
    assert got["mid"] == 1 and got["cancelled"] is True
    assert got["reason"] == ["cancelled", "length"]
    assert got["stats"]["requests_prefilling"] == 0


def test_finish_reasons_kept_for_a_window(llama, monkeypatch):
    """Finish reasons and logprobs are kept for the last ``_REASON_KEEP``
    requests, the oldest dropped first (``test_scheduler.py:423``)."""
    def scenario(mod, m):
        monkeypatch.setattr(mod, "_REASON_KEEP", 4)
        eng = mod.ContinuousBatchEngine(m, **ENG)
        rids = [eng.add_request(np.arange(1, 6), max_new_tokens=1,
                                logprobs=True) for _ in range(6)]
        return outcome(eng, rids, eng.run_until_done())

    got = both(llama, scenario)
    assert got["reason"] == [None] * 2 + ["length"] * 4
    assert got["lp"][:2] == [None, None]


# ---- prefix cache ------------------------------------------------------------

def _shared(seed, n_shared, *tails):
    shared, *rest = prompts(seed, n_shared, *tails)
    return [np.concatenate([shared, t]) for t in rest]


def test_prefix_cache_token_parity(llama):
    """A request sharing 17 tokens (two pages) with an active slot copies
    its pages and prefills the suffix (``test_serving.py:199``)."""
    def scenario(mod, m):
        p1, p2 = _shared(5, 17, 4, 7)
        eng = mod.ContinuousBatchEngine(m, **ENG, enable_prefix_cache=True)
        r1 = eng.add_request(p1, max_new_tokens=6, logprobs=True)
        r2 = eng.add_request(p2, max_new_tokens=6, logprobs=True)
        reused = eng.prefix_pages_reused
        return outcome(eng, [r1, r2], eng.run_until_done(), reused=reused)

    got = both(llama, scenario)
    assert got["reused"] == 2
    # prefix-cached = uncached
    p1, p2 = _shared(5, 17, 4, 7)
    eng = port_serving.ContinuousBatchEngine(llama[1], **ENG)
    rids = [eng.add_request(p, max_new_tokens=6) for p in (p1, p2)]
    done = eng.run_until_done()
    assert [done[r].tolist() for r in rids] == got["tok"]


def test_prefix_cache_identical_prompt_capped(llama):
    """An identical 24-token prompt (three pages) shares two: the suffix
    prefill needs a token (``test_serving.py:223``)."""
    def scenario(mod, m):
        (p,) = prompts(6, 24)
        eng = mod.ContinuousBatchEngine(m, **ENG, enable_prefix_cache=True)
        r1 = eng.add_request(p, max_new_tokens=5, logprobs=True)
        r2 = eng.add_request(p.copy(), max_new_tokens=5, logprobs=True)
        reused = eng.prefix_pages_reused
        return outcome(eng, [r1, r2], eng.run_until_done(), reused=reused)

    got = both(llama, scenario)
    assert got["reused"] == 2 and got["tok"][0] == got["tok"][1]


def test_prefix_cache_disabled_by_default(llama):
    """``test_serving.py:243``."""
    def scenario(mod, m):
        (p,) = prompts(7, 16)
        eng = mod.ContinuousBatchEngine(m, **ENG)
        rids = [eng.add_request(p, max_new_tokens=3, logprobs=True),
                eng.add_request(p.copy(), max_new_tokens=3, logprobs=True)]
        return outcome(eng, rids, eng.run_until_done())

    assert both(llama, scenario)["stats"]["prefix_pages_reused"] == 0


def test_mla_prefix_cache(deepseek):
    """Latent mode: the prefix rows copied from the active slot
    (``test_serving.py:67``)."""
    def scenario(mod, m):
        base, tail = prompts(11, 16, 16)
        p2 = np.concatenate([base, tail])
        eng = mod.ContinuousBatchEngine(m, **ENG, enable_prefix_cache=True)
        done = {}
        r1 = eng.add_request(base, max_new_tokens=6, logprobs=True)
        drive(eng, done, 1)
        r2 = eng.add_request(p2, max_new_tokens=6, logprobs=True)
        done.update(eng.run_until_done())
        return outcome(eng, [r1, r2], done)

    assert both(deepseek, scenario)["stats"]["prefix_pages_reused"] == 2


def test_prefix_cache_with_sliding_window():
    """Mistral, window 8: the suffix prefill at pos > 0 takes the windowed
    einsum, as the JAX package's (``test_serving.py:333``)."""
    jax_model, port_model, _ = mistral_pair(ENG["max_len"], sliding_window=8,
                                            use_flash_attention=False)

    def scenario(mod, m):
        sys_prompt, t1, t2 = prompts(0, 16, 6, 6)
        eng = mod.ContinuousBatchEngine(m, **ENG, enable_prefix_cache=True)
        rids = [eng.add_request(np.concatenate([sys_prompt, t]), 5,
                                logprobs=True) for t in (t1, t2)]
        return outcome(eng, rids, eng.run_until_done())

    got = both((jax_model, port_model), scenario)
    assert got["stats"]["prefix_pages_reused"] == 2


# ---- priorities, deadlines, aging ------------------------------------------

def _order(mod, m, specs, aging_s=0.0, between=None):
    """A busy request on one slot, then ``specs`` (keyword dicts) queued;
    returns the finish order (one slot: the admission order)."""
    eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64, page_size=8,
                                    aging_s=aging_s)
    order = []

    def cb(rid, tok, done):
        if done:
            order.append(rid)

    busy = eng.add_request(np.arange(1, 6), max_new_tokens=6, on_token=cb)
    rids = []
    for i, kw in enumerate(specs):
        if i and between is not None:
            between()
        rids.append(eng.add_request(np.arange(1, 6), max_new_tokens=2,
                                    on_token=cb, logprobs=True, **kw))
    done = eng.run_until_done()
    return outcome(eng, [busy] + rids, done,
                   order=[([busy] + rids).index(r) for r in order])


def test_priority_admission_order(llama):
    """Queued requests admit by class, lower first (``test_scheduler.py:
    194``)."""
    got = both(llama, lambda mod, m: _order(
        mod, m, [dict(priority=5), {}, dict(priority=0)]))
    assert got["order"] == [0, 3, 2, 1]
    assert port_serving.PRIORITY_DEFAULT == jax_serving.PRIORITY_DEFAULT == 1


def test_deadline_tiebreak_within_class(llama):
    """Same class: the earlier deadline first (``test_scheduler.py:213``);
    both deadlines met."""
    got = both(llama, lambda mod, m: _order(
        mod, m, [dict(slo_ms=60000.0), dict(slo_ms=50.0), {}]))
    assert got["order"] == [0, 2, 1, 3]
    assert got["stats"]["requests_slo_good"] == 2


def test_aging_bounds_starvation(llama, clock):
    """A class-5 request that waited 50 aging periods beats a fresh class-0
    arrival (``test_scheduler.py:233``), on the injected clock."""
    got = both(llama, lambda mod, m: _order(
        mod, m, [dict(priority=5), dict(priority=0)], aging_s=0.001,
        between=lambda: clock.advance(0.05)))
    assert got["order"] == [0, 1, 2]


# ---- preemption --------------------------------------------------------------

def test_preempt_restore(llama):
    """A class-0 arrival evicts the class-2 slot to the host; it restores
    and both finish as uninterrupted runs; its stream has no gap or repeat
    (``test_scheduler.py:252``, ``:305``)."""
    def scenario(mod, m, preempt=True):
        long_p, short_p = prompts(4, 41, 5)
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8,
                                        enable_preemption=preempt)
        streamed, done = [], {}
        victim = eng.add_request(
            short_p, max_new_tokens=12, priority=2, logprobs=True,
            on_token=lambda rid, t, d: streamed.append(int(t)))
        drive(eng, done, 3)
        hi = eng.add_request(long_p, max_new_tokens=6, priority=0,
                             logprobs=True)
        queued = eng.stats()["requests_queued"]
        done.update(eng.run_until_done())
        return outcome(eng, [victim, hi], done, streamed=streamed,
                       queued=queued)

    got = both(llama, scenario)
    assert got["stats"]["requests_preempted"] == 1 and got["queued"] == 1
    assert got["streamed"] == got["tok"][0]
    # preempted and restored = never preempted
    plain = scenario(port_serving, llama[1], preempt=False)
    assert plain["tok"] == got["tok"]
    assert plain["stats"]["requests_preempted"] == 0


def test_equal_priority_never_preempts(llama, clock):
    """Aging credit never preempts (``test_scheduler.py:281``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, enable_preemption=True,
                                        aging_s=0.001)
        done = {}
        first = eng.add_request(np.arange(1, 6), max_new_tokens=6,
                                logprobs=True)
        drive(eng, done, 1)
        clock.advance(0.05)
        second = eng.add_request(np.arange(2, 7), max_new_tokens=2,
                                 logprobs=True)
        done.update(eng.run_until_done())
        return outcome(eng, [first, second], done)

    assert both(llama, scenario)["stats"]["requests_preempted"] == 0


def test_preemption_refused_in_latent_mode(deepseek):
    """``test_scheduler.py:296``: the same ValueError in both packages."""
    for mod, m in zip((jax_serving, port_serving), deepseek):
        with pytest.raises(ValueError, match="paged"):
            mod.ContinuousBatchEngine(m, max_batch=1, max_len=64, page_size=8,
                                      enable_preemption=True)


# ---- the bounded queue and shedding --------------------------------------

def test_bounded_queue_rejects_typed(llama):
    """``test_scheduler.py:329``."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, max_queue=1)
        rids = [eng.add_request(np.arange(1, 6), max_new_tokens=6,
                                logprobs=True),
                eng.add_request(np.arange(1, 6), max_new_tokens=2,
                                logprobs=True)]
        with pytest.raises(mod.QueueFull) as ei:
            eng.add_request(np.arange(1, 6), max_new_tokens=2)
        return outcome(eng, rids, eng.run_until_done(),
                       retry=ei.value.retry_after_s, msg=str(ei.value))

    got = both(llama, scenario)
    assert got["retry"] > 0 and got["stats"]["requests_rejected"] == 1
    assert got["reason"] == ["length", "length"]


def test_bound_ignores_free_slots(llama):
    """``max_queue=0`` still admits into a free slot
    (``test_scheduler.py:349``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, **ENG, max_queue=0)
        rid = eng.add_request(np.arange(1, 6), max_new_tokens=2,
                              logprobs=True)
        return outcome(eng, [rid], eng.run_until_done())

    assert both(llama, scenario)["reason"] == ["length"]


def test_expired_deadline_sheds_before_admission(llama, clock):
    """A queued request whose deadline passed is shed at the admission
    gate, typed, and never admitted (``test_scheduler.py:528``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8)
        done, sheds = {}, []
        hold = eng.add_request(np.arange(1, 6), max_new_tokens=24,
                               logprobs=True)
        drive(eng, done, 1)
        rid = eng.add_request(np.arange(1, 8), max_new_tokens=4, priority=2,
                              slo_ms=30.0,
                              on_shed=lambda r, info: sheds.append((r, info)))
        clock.advance(0.06)
        done.update(eng.run_until_done())
        return outcome(eng, [hold, rid], done, sheds=sheds)

    got = both(llama, scenario)
    assert got["reason"] == ["length", "shed"] and got["tok"][1] is None
    info = got["sheds"][0][1]
    assert info["where"] == "expired" and info["miss_ms"] > 0
    assert got["stats"]["requests_shed"] == got["stats"]["deadline_misses"] == 1


def test_unmeetable_budget_sheds(llama):
    """A remaining budget below the armed service floor sheds
    (``test_scheduler.py:569``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8)
        eng._ttft_admit_floor, eng._ttft_admit_n = 10.0, 1
        done, sheds = {}, []
        hold = eng.add_request(np.arange(1, 6), max_new_tokens=6,
                               logprobs=True)
        drive(eng, done, 1)
        ok = eng.add_request(np.arange(1, 8), max_new_tokens=2,
                             slo_ms=5000.0)
        drive(eng, done, 1)
        not_shed = eng.finish_reason(ok)
        eng.cancel(ok)
        eng._ttft_admit_floor, eng._ttft_admit_n = 10.0, 3
        rid = eng.add_request(np.arange(1, 8), max_new_tokens=2,
                              slo_ms=5000.0,
                              on_shed=lambda r, info: sheds.append(info))
        drive(eng, done, 1)
        done.update(eng.run_until_done())
        return outcome(eng, [hold, ok, rid], done, sheds=sheds,
                       not_shed=not_shed)

    got = both(llama, scenario)
    assert got["not_shed"] is None
    assert got["reason"] == ["length", "cancelled", "shed"]
    assert got["sheds"][0]["where"] == "unmeetable"


def test_capacity_shed_prefers_lowest_class(llama):
    """At a full bounded queue a strictly more important arrival displaces
    the least important queued request (``test_scheduler.py:598``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, max_queue=1)
        done, sheds = {}, []
        hold = eng.add_request(np.arange(1, 6), max_new_tokens=30,
                               logprobs=True)
        drive(eng, done, 1)
        victim = eng.add_request(np.arange(1, 6), max_new_tokens=2,
                                 priority=2,
                                 on_shed=lambda r, i: sheds.append((r, i)))
        vip = eng.add_request(np.arange(1, 6), max_new_tokens=2, priority=0,
                              logprobs=True)
        with pytest.raises(mod.QueueFull):
            eng.add_request(np.arange(1, 6), max_new_tokens=2, priority=0)
        done.update(eng.run_until_done())
        return outcome(eng, [hold, victim, vip], done, sheds=sheds)

    got = both(llama, scenario)
    assert got["reason"] == ["length", "shed", "length"]
    info = got["sheds"][0][1]
    assert info["where"] == "capacity" and info["retry_after"] >= 0.5
    assert got["stats"]["deadline_misses"] == 0


def test_deadline_exceeded_typed_at_submission(llama):
    """``test_scheduler.py:628``."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8)
        with pytest.raises(mod.DeadlineExceeded) as ei:
            eng.add_request(np.arange(1, 6), max_new_tokens=2, slo_ms=-5.0)
        return outcome(eng, [], {}, miss=ei.value.miss_ms)

    got = both(llama, scenario)
    assert got["miss"] == 5.0
    assert got["stats"]["deadline_misses"] == got["stats"]["requests_shed"] == 1


def test_retry_after_estimate_bounds(llama):
    """Queue depth over the drain rate, clamped to [0.5 s, 30 s], 1 s
    before any finish, riding ``QueueFull`` (``test_scheduler.py:643``)."""
    def scenario(mod, m):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, max_queue=0)
        est = [eng._retry_after_estimate()]
        for iv in (1000.0, 1e-6, 2.0):
            eng._finish_interval_ewma = iv
            est.append(eng._retry_after_estimate())
        rid = eng.add_request(np.arange(1, 6), max_new_tokens=20,
                              logprobs=True)
        eng.step()
        with pytest.raises(mod.QueueFull) as ei:
            eng.add_request(np.arange(1, 6), max_new_tokens=2)
        return outcome(eng, [rid], eng.run_until_done(), est=est,
                       retry=ei.value.retry_after_s)

    got = both(llama, scenario)
    assert got["est"] == [1.0, 30.0, 0.5, 2.0] and got["retry"] == 2.0


# ---- with speculation ----------------------------------------------------

def test_spec_with_prefix_cache_hit(llama):
    """``test_serving_spec.py:120``."""
    def scenario(mod, m):
        p1, p2 = _shared(5, 17, 4, 7)
        eng = mod.ContinuousBatchEngine(m, **ENG, enable_prefix_cache=True,
                                        speculative_k=4)
        rids = [eng.add_request(p, max_new_tokens=6, logprobs=True)
                for p in (p1, p2)]
        return outcome(eng, rids, eng.run_until_done())

    assert both(llama, scenario)["stats"]["prefix_pages_reused"] == 2


def test_spec_with_chunked_prefill_interleaved(llama):
    """Multi-token dispatches between the chunks: the reserved slot's k
    throwaway writes park at its frontier (``test_serving_spec.py:139``)."""
    def scenario(mod, m):
        (long_p,) = prompts(7, 40)
        eng = mod.ContinuousBatchEngine(m, **ENG, prefill_chunk_tokens=16,
                                        speculative_k=4)
        done = {}
        live = eng.add_request(repetitive(4), max_new_tokens=12,
                               logprobs=True)
        drive(eng, done, 2)
        r_long = eng.add_request(long_p, max_new_tokens=6, logprobs=True)
        done.update(eng.run_until_done())
        return outcome(eng, [live, r_long], done)

    st = both(llama, scenario)["stats"]
    assert st["spec_dispatches"] == st["decode_steps"] > 0


def test_spec_with_preempt_restore_cycle(llama):
    """The victim's bundle holds prompt + delivered tokens; rejected-draft
    KV past it is overwritten after the restore
    (``test_serving_spec.py:158``)."""
    def scenario(mod, m):
        (long_p,) = prompts(4, 41)
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8, enable_preemption=True,
                                        speculative_k=3)
        done = {}
        victim = eng.add_request(repetitive(6), max_new_tokens=12,
                                 priority=2, logprobs=True)
        drive(eng, done, 3)
        n_gen = len(eng._slots[0].tokens)
        hi = eng.add_request(long_p, max_new_tokens=6, priority=0,
                             logprobs=True)
        kv_len = int(next(r for r in eng._queue
                          if r.rid == victim).resume["kv_len"])
        done.update(eng.run_until_done())
        return outcome(eng, [victim, hi], done, n_gen=n_gen, kv_len=kv_len)

    got = both(llama, scenario)
    assert got["n_gen"] >= 3 and got["kv_len"] == 24 + got["n_gen"]
    assert got["stats"]["requests_preempted"] == 1
