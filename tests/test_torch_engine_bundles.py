"""Port parity of the engine's KV bundles (handoff, migration, preemption)
and its OOM degrade, against the JAX ``ContinuousBatchEngine`` on the same
weights.

- The port's ``_bundle_digest`` is the JAX one: equal on one bundle, f32
  leaves and ml_dtypes bf16 leaves alike.
- Bundles cross both ways: a bundle the JAX engine exported continues on
  the port token-identically to the JAX engine's own admission (f32), a
  port-written f32 bundle on the JAX engine, and a JAX bf16 bundle lands
  in the port's bf16 pool bit for bit.
- A flipped byte, schema skew or the wrong kind raises ``HandoffCorrupt``.
- A ``torch.cuda.OutOfMemoryError`` at admission or in a decode step sheds
  the request and shrinks ``max_active_slots`` as the JAX engine's XLA OOM
  does (``test_supervisor.py:217-323``); a failure while the pool is being
  written poisons the engine.
- A bundle taken on the CPU is its own memory: reusing the slot's pages or
  the kept prefill buffers does not change it.

Every case runs on ``test_torch_engine_sched``'s fixed clock (``clock``,
autouse)."""
import copy

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_engine_sched import (ENG, both, clock,  # noqa: F401
                                     llama_pair, outcome, prompts,
                                     repetitive, same)
from test_torch_pair import SMALL

import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.weights import from_jax_state

J, P = jax_serving, port_serving


@pytest.fixture(scope="module")
def llama():
    return llama_pair()


@pytest.fixture(scope="module")
def bf16_pair():
    """A JAX bf16 model and the port's with its bits (``from_jax_state`` is
    bit-exact in bf16)."""
    import paddle_tpu
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    paddle_tpu.seed(2)
    jax_model = LlamaForCausalLM(LlamaConfig.tiny(**SMALL, dtype="bfloat16"))
    jax_model.llama._rope(ENG["max_len"])
    state = {k: np.asarray(v)
             for k, v in jax_model.functional_state().items()}
    port_model = from_jax_state(state, PortConfig.tiny(**SMALL,
                                                       dtype="bfloat16"),
                                device="cpu")
    return jax_model, port_model


def _leaves(bundle):
    """Every numpy leaf of a bundle, by path."""
    out = {}

    def walk(path, o):
        if isinstance(o, np.ndarray):
            out[path] = o
        elif isinstance(o, dict):
            for k in o:
                walk(f"{path}/{k}", o[k])
        elif isinstance(o, (list, tuple)):
            for i, x in enumerate(o):
                walk(f"{path}[{i}]", x)

    walk("", bundle)
    return out


# ---- the digest ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_digest_matches_jax(dtype):
    """One bundle, both digests; seal in one package, verify in the other.
    bf16 leaves as ml_dtypes arrays (``'<V2'``), as the JAX engine writes
    them; the port reads them by their bits, as it reads its own uint16
    words."""
    rng = np.random.RandomState(0)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    leaf = lambda *s: rng.randn(*s).astype(np.float32).astype(dt)  # noqa: E731
    bundle = {"kind": "migrate", "ids": np.arange(7, dtype=np.int64),
              "tokens": np.asarray([3, 4], np.int64),
              "layers": [(leaf(16, 2, 8), leaf(16, 2, 8)) for _ in range(2)],
              "last": rng.randn(32).astype(np.float32),
              "sampling": [False, 1.0, 0, 1.0], "stop_token_ids": None,
              "slo_remaining_s": 1.25, "logprobs": [-0.5, -1.75],
              "audit": None, "priority": 1}
    assert P._bundle_digest(bundle) == J._bundle_digest(bundle)
    sealed = P.seal_bundle(copy.deepcopy(bundle))
    assert sealed["checksum"] == J.seal_bundle(copy.deepcopy(bundle))[
        "checksum"]
    J.verify_bundle(sealed, kind="migrate")
    P.verify_bundle(J.seal_bundle(copy.deepcopy(bundle)), kind="migrate")
    if dtype == "bfloat16":
        k = bundle["layers"][0][0]
        got = P._leaf_tensor(k, "cpu")
        words = P._leaf_tensor(k.view(np.uint16), "cpu")
        want = torch.from_numpy(k.astype(np.float32)).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(words.view(torch.int16), want.view(torch.int16))
        assert np.array_equal(P._host_leaf(got), k.view(np.uint16))


# ---- handoff ---------------------------------------------------------------

def test_handoff_crosses_both_ways(llama):
    """``export_prefill`` on one engine, ``admit_prefilled`` on a peer over
    the same weights (``test_serving_cluster.py:233``), in all four
    pairings: the same tokens as the JAX engine's own handoff and as a
    local prefill; the exporting engine takes no slot."""
    jax_model, port_model = llama
    (prompt,) = prompts(0, 9)
    models = {J: jax_model, P: port_model}

    def handoff(src, dst):
        pre = src.ContinuousBatchEngine(models[src], **ENG)
        bundle = pre.export_prefill(prompt, max_new_tokens=6)
        idle = (pre.num_active, len(pre._queue), bundle["prompt_tokens"],
                bundle["bucket"])
        dec = dst.ContinuousBatchEngine(models[dst], **ENG)
        rid = dec.admit_prefilled(bundle, max_new_tokens=6, logprobs=True)
        return outcome(dec, [rid], dec.run_until_done(), idle=idle), bundle

    want, b_jax = handoff(J, J)
    assert want["idle"] == (0, 0, 9, 16) and want["reason"] == ["length"]
    for src, dst in ((J, P), (P, J), (P, P)):
        got, bundle = handoff(src, dst)
        same(got, want, f"{src.__name__} -> {dst.__name__}")
    # the port's export = the JAX export (f32, within the prefill's sums)
    for (path, a), (_, b) in zip(sorted(_leaves(bundle).items()),
                                 sorted(_leaves(b_jax).items())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)
    local = P.ContinuousBatchEngine(port_model, **ENG)
    rid = local.add_request(prompt, max_new_tokens=6)
    assert local.run_until_done()[rid].tolist() == want["tok"][0]


def test_export_admit_validation(llama):
    """The same refusals in both packages (``test_serving_cluster.py:
    252``): a prompt past max_len, another page size, another depth."""
    import paddle_tpu
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    paddle_tpu.seed(0)
    deeper = {J: LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=3)),
              P: PortLlama(PortConfig.tiny(num_hidden_layers=3),
                           device="cpu")}
    errors = {}
    for mod, m in zip((J, P), llama):
        eng = mod.ContinuousBatchEngine(m, **ENG)
        got = []
        with pytest.raises(ValueError, match="max_len") as ei:
            eng.export_prefill([1] * 60, max_new_tokens=10)
        got.append(str(ei.value))
        bundle = eng.export_prefill([1, 2, 3], max_new_tokens=4)
        other = mod.ContinuousBatchEngine(m, max_batch=2, max_len=60,
                                          page_size=12)
        with pytest.raises(ValueError, match="page_size") as ei:
            other.admit_prefilled(bundle, max_new_tokens=4)
        got.append(str(ei.value))
        deep = mod.ContinuousBatchEngine(deeper[mod], **ENG)
        with pytest.raises(ValueError, match="layers") as ei:
            deep.admit_prefilled(bundle, max_new_tokens=4)
        got.append(str(ei.value))
        errors[mod] = got
    assert errors[J] == errors[P]


# ---- migration -------------------------------------------------------------

def test_migration_crosses_both_ways(llama):
    """``export_slot`` mid-decode, ``admit_migrated`` on a peer
    (``test_serving_cluster.py:315``): the source's streamed tokens plus the
    destination's equal the JAX pair's, in all four pairings; the bundle
    carries priority, SLO, stops and logprobs; the destination streams new
    tokens only."""
    jax_model, port_model = llama
    (prompt,) = prompts(11, 9)
    models = {J: jax_model, P: port_model}

    def migrate(src_mod, dst_mod):
        src = src_mod.ContinuousBatchEngine(models[src_mod], **ENG)
        dst = dst_mod.ContinuousBatchEngine(models[dst_mod], **ENG)
        src_toks, dst_toks = [], []
        rid = src.add_request(prompt, max_new_tokens=10,
                              on_token=lambda r, t, d: src_toks.append(t),
                              priority=0, slo_ms=600_000.0,
                              stop_token_ids=[99999], logprobs=True)
        for _ in range(4):
            src.step()
        bundle = src.export_slot(rid)
        head = dict(idle=(src.num_active, len(src._queue)),
                    kind=bundle["kind"], n=len(bundle["tokens"]),
                    reason=src.finish_reason(rid),
                    out=src.stats()["requests_migrated_out"],
                    priority=bundle["priority"],
                    stops=bundle["stop_token_ids"])
        rid2 = dst.admit_migrated(
            bundle, on_token=lambda r, t, d: dst_toks.append(t))
        return outcome(dst, [rid2], dst.run_until_done(), head=head,
                       streamed=src_toks + dst_toks), bundle

    want, _ = migrate(J, J)
    assert want["head"] == dict(idle=(0, 0), kind="migrate", n=4,
                                reason="migrated", out=1, priority=0,
                                stops=[99999])
    assert want["streamed"] == want["tok"][0] and len(want["lp"][0]) == 10
    assert want["stats"]["requests_migrated_in"] == 1
    for src, dst in ((J, P), (P, J), (P, P)):
        got, bundle = migrate(src, dst)
        same(got, want, f"{src.__name__} -> {dst.__name__}")
    # migrated = stayed
    stay = P.ContinuousBatchEngine(port_model, **ENG)
    rid = stay.add_request(prompt, max_new_tokens=10)
    assert stay.run_until_done()[rid].tolist() == want["tok"][0]


def test_export_slot_only_active_slots_migrate(llama):
    """``test_serving_cluster.py:498``."""
    for mod, m in zip((J, P), llama):
        eng = mod.ContinuousBatchEngine(m, max_batch=1, max_len=64,
                                        page_size=8)
        r_active = eng.add_request([1, 2, 3], max_new_tokens=4)
        r_queued = eng.add_request([4, 5, 6], max_new_tokens=4)
        eng.step()
        with pytest.raises(ValueError, match="no decoding slot"):
            eng.export_slot(r_queued)
        with pytest.raises(ValueError, match="no decoding slot"):
            eng.export_slot(12345)
        assert eng.export_slot(r_active)["kind"] == "migrate"


def test_spec_slot_migrates_mid_speculation(llama):
    """``test_serving_spec.py:186``: a slot exported between speculative
    dispatches continues on a peer; the delivered prefix plus the peer's
    tokens equal the JAX pair's."""
    def scenario(mod, m):
        src = mod.ContinuousBatchEngine(m, **ENG, speculative_k=4)
        rid = src.add_request(repetitive(8), max_new_tokens=16)
        for _ in range(2):
            src.step()
        delivered = list(src._slots[0].tokens)
        bundle = src.export_slot(rid)
        dst = mod.ContinuousBatchEngine(m, **ENG, speculative_k=4)
        rid2 = dst.admit_migrated(bundle)
        done = dst.run_until_done()
        return outcome(dst, [rid2], done, delivered=delivered,
                       kv_len=bundle["kv_len"])

    got = both(llama, scenario)
    assert got["delivered"] and got["tok"][0][:len(got["delivered"])] == \
        got["delivered"]


def test_bf16_bundles_land_bit_for_bit(bf16_pair):
    """A bf16 JAX engine's ``export_slot`` (ml_dtypes leaves) admitted by
    the port's bf16 engine: the pool and the last-logit row hold the
    bundle's bits, the first token (the argmax of the shipped row) is the
    JAX engine's, and the stream runs out its budget. The port's own bf16
    export (uint16 words) round-trips the same way and continues as the
    unmigrated run."""
    jax_model, port_model = bf16_pair
    (prompt,) = prompts(3, 12)
    src = J.ContinuousBatchEngine(jax_model, **ENG)
    rid = src.add_request(prompt, max_new_tokens=8)
    for _ in range(3):
        src.step()
    bundle = src.export_slot(rid)
    assert bundle["layers"][0][0].dtype.str == "<V2"
    jdst = J.ContinuousBatchEngine(jax_model, **ENG)
    jrid = jdst.admit_migrated(bundle)
    want = jdst.run_until_done()[jrid]

    def lands(eng, bundle):
        """The admitted slot's pages and last row against the bundle."""
        slot = next(s for s, r in enumerate(eng._slots) if r is not None)
        n = bundle["bucket"] // eng.page_size
        base = slot * eng._pages_per_slot
        for c, (k, v) in zip(eng._caches, bundle["layers"]):
            for pool, leaf in (("k_pages", k), ("v_pages", v)):
                dense = c[pool][:, base:base + n].movedim(0, 2).reshape(
                    leaf.shape)
                assert np.array_equal(P._host_leaf(dense),
                                      leaf.view(np.uint16))
        assert np.array_equal(eng._last[slot].numpy(), bundle["last"])

    dst = P.ContinuousBatchEngine(port_model, **ENG)
    prid = dst.admit_migrated(bundle)
    lands(dst, bundle)
    got = dst.run_until_done()[prid]
    assert got[:4].tolist() == want[:4].tolist()
    assert len(got) == len(want) == 8 and dst.finish_reason(prid) == "length"
    # the port's bf16 bundle: raw words, the same bits back, the same run
    eng = P.ContinuousBatchEngine(port_model, **ENG)
    rid = eng.add_request(prompt, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    own = eng.export_slot(rid)
    assert own["layers"][0][0].dtype == np.uint16
    back = P.ContinuousBatchEngine(port_model, **ENG)
    rid = back.admit_migrated(own)
    lands(back, own)
    stay = P.ContinuousBatchEngine(port_model, **ENG)
    r = stay.add_request(prompt, max_new_tokens=8)
    assert back.run_until_done()[rid].tolist() == \
        stay.run_until_done()[r].tolist()


# ---- corruption ----------------------------------------------------------

def _flip(b):
    k = b["layers"][0][0].copy()
    k.reshape(-1).view(np.uint8)[5] ^= 0x10
    b["layers"][0] = (k, b["layers"][0][1])


def _skew(b):
    b["version"] = 1


def _no_checksum(b):
    del b["checksum"]


@pytest.mark.parametrize("corrupt, match", [
    (_flip, "checksum mismatch"), (_skew, "version skew"),
    (_no_checksum, "no checksum")])
def test_corrupt_bundles_raise_handoff_corrupt(llama, corrupt, match):
    """A flipped byte, schema skew or a missing checksum: both packages
    raise ``HandoffCorrupt`` at the door, before any slot is taken."""
    for mod, m in zip((J, P), llama):
        src = mod.ContinuousBatchEngine(m, **ENG)
        bundle = src.export_prefill(np.arange(1, 10), max_new_tokens=4)
        corrupt(bundle)
        dst = mod.ContinuousBatchEngine(m, **ENG)
        with pytest.raises(mod.HandoffCorrupt, match=match):
            dst.admit_prefilled(bundle, max_new_tokens=4)
        assert dst.num_active == 0 and not dst._queue


def test_wrong_kind_and_inconsistent_bundles(llama):
    """A prefill bundle where a migration is expected, a non-dict, and a
    resealed migration bundle whose kv_len disagrees with its tokens."""
    for mod, m in zip((J, P), llama):
        eng = mod.ContinuousBatchEngine(m, **ENG)
        pre = eng.export_prefill(np.arange(1, 10), max_new_tokens=4)
        with pytest.raises(mod.HandoffCorrupt, match="kind"):
            eng.admit_migrated(pre)
        with pytest.raises(mod.HandoffCorrupt, match="not a dict"):
            eng.admit_migrated([pre])
        rid = eng.add_request(np.arange(1, 10), max_new_tokens=6)
        eng.step()
        mig = eng.export_slot(rid)
        mig["kv_len"] += 1
        with pytest.raises(mod.HandoffCorrupt, match="inconsistent"):
            eng.admit_migrated(mod.seal_bundle(mig))


# ---- the bundles own their memory -----------------------------------------

def test_cpu_bundles_survive_page_reuse(llama):
    """Bundles taken on the CPU (where ``.numpy()`` would share memory) do
    not change when the slot's pages or the kept prefill buffers are
    reused: a migration, a handoff and a preemption bundle, each checked
    against a copy after other requests overwrote the memory it came
    from."""
    port_model = llama[1]
    p1, p2, p3 = prompts(21, 12, 14, 13)
    eng = P.ContinuousBatchEngine(port_model, max_batch=1, max_len=64,
                                  page_size=8, enable_preemption=True)
    rid = eng.add_request(p1, max_new_tokens=6)
    eng.step()
    mig = eng.export_slot(rid)
    pre = eng.export_prefill(p2, max_new_tokens=4)     # bucket 16 buffers
    kept = copy.deepcopy((mig, pre))
    victim = eng.add_request(p3, max_new_tokens=8, priority=2)  # same pages
    eng.step()
    eng.export_prefill(p3, max_new_tokens=4)           # same buffers
    eng.add_request(p2, max_new_tokens=4, priority=0)  # preempts the victim
    resume = next(r for r in eng._queue if r.rid == victim).resume
    kept_resume = copy.deepcopy(resume)
    eng.step()                                         # the victim's pages
    for got, want in ((mig, kept[0]), (pre, kept[1]),
                      (resume, kept_resume)):
        a, b = _leaves(got), _leaves(want)
        assert a.keys() == b.keys()
        for path in a:
            assert np.array_equal(a[path], b[path]), path
        P.verify_bundle(got)
    assert eng.run_until_done()


# ---- OOM degrade and the poison rule ---------------------------------------

def _oom(mod):
    if mod is J:
        return RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying "
                            "to allocate 1234567 bytes")
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 1.18 MiB")


def _oom_engine(mod, m):
    """``test_supervisor.py``'s engine at 2 slots, not 4 (the same budget
    arithmetic; the decode program of the other cases)."""
    return mod.ContinuousBatchEngine(m, **ENG)


def test_step_oom_sheds_typed_and_shrinks_budget(llama, monkeypatch):
    """An OOM in the decode dispatch sheds the most recently admitted slot
    (``test_supervisor.py:217``)."""
    def scenario(mod, m):
        eng = _oom_engine(mod, m)
        shed = []
        r_old = eng.add_request([1, 2, 3], max_new_tokens=4, logprobs=True)
        r_new = eng.add_request([4, 5, 6], max_new_tokens=4,
                                request_id="victim",
                                on_shed=lambda rid, info: shed.append(info))
        orig = mod._get_select_decode
        state = {"boomed": False}

        def flaky(*a, **kw):
            if not state["boomed"]:
                state["boomed"] = True

                def raise_oom(*aa, **kk):
                    raise _oom(mod)

                return raise_oom
            return orig(*a, **kw)

        monkeypatch.setattr(mod, "_get_select_decode", flaky)
        out = outcome(eng, [r_old, r_new], eng.run_until_done(),
                      shed=[(i["where"], "retry_after" in i) for i in shed])
        monkeypatch.setattr(mod, "_get_select_decode", orig)
        return out

    got = both(llama, scenario)
    assert got["reason"] == ["length", "shed"]
    assert got["shed"] == [("oom", True)]
    assert got["stats"]["max_active_slots"] == 1
    assert got["stats"]["requests_degraded"] == 1


def test_admission_oom_sheds_admitting_request(llama):
    """An OOM in the admission prefill sheds the admitting request, and the
    reduced budget gates later admissions (``test_supervisor.py:269``)."""
    def scenario(mod, m):
        eng = _oom_engine(mod, m)
        r1 = eng.add_request([1, 2, 3], max_new_tokens=3, logprobs=True)
        done = eng.step()
        orig = eng._bucketed_prefill
        state = {"boomed": False}

        def flaky(req):
            if not state["boomed"]:
                state["boomed"] = True
                raise _oom(mod)
            return orig(req)

        shed = []
        eng._bucketed_prefill = flaky
        r2 = eng.add_request([4, 5, 6], max_new_tokens=3,
                             on_shed=lambda rid, info: shed.append(
                                 info["where"]))
        done.update(eng.run_until_done())
        budget = eng.max_active_slots
        r3 = eng.add_request([7, 8, 9], max_new_tokens=2, logprobs=True)
        r4 = eng.add_request([7, 8, 10], max_new_tokens=2, logprobs=True)
        done.update(eng.step())
        active = eng.num_active
        done.update(eng.run_until_done())
        return outcome(eng, [r1, r2, r3, r4], done, shed=shed,
                       budget=budget, active=active)

    got = both(llama, scenario)
    assert got["reason"] == ["length", "shed", "length", "length"]
    assert got["shed"] == ["oom"] and got["budget"] == 1
    assert got["active"] <= 1


def test_oom_budget_floor_is_one(llama):
    """``test_supervisor.py:303``: three OOMs, the budget stays at one."""
    def scenario(mod, m):
        eng = _oom_engine(mod, m)
        orig = eng._bucketed_prefill
        state = {"booms": 3}

        def flaky(req):
            if state["booms"] > 0:
                state["booms"] -= 1
                raise _oom(mod)
            return orig(req)

        eng._bucketed_prefill = flaky
        rids = [eng.add_request([i + 1, i + 2], max_new_tokens=2,
                                logprobs=True) for i in range(4)]
        return outcome(eng, rids, eng.run_until_done())

    got = both(llama, scenario)
    assert got["stats"]["max_active_slots"] == 1
    assert got["reason"] == ["shed"] * 3 + ["length"]


def test_failed_pool_write_poisons_and_forward_oom_degrades(llama,
                                                            monkeypatch):
    """A failure while the pool is written poisons the engine (the call
    raises RuntimeError, so does every later step); an OOM in a
    prefix-cached admission's forward, before any write, sheds the request
    and the engine serves on."""
    port_model = llama[1]
    p1, p2 = (np.concatenate([np.arange(1, 18), t])
              for t in prompts(5, 4, 7))
    eng = P.ContinuousBatchEngine(port_model, **ENG,
                                  enable_prefix_cache=True)
    r1 = eng.add_request(p1, max_new_tokens=4)

    def forward_oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(eng, "_suffix_forward", forward_oom)
    r2 = eng.add_request(p2, max_new_tokens=4)
    assert eng.finish_reason(r2) == "shed" and eng.max_active_slots == 1
    assert not eng._poisoned
    monkeypatch.undo()
    assert r1 in eng.run_until_done()

    calls = {"n": 0}
    real = P._page_tiles

    def tiles_fail(buf, ps):
        calls["n"] += 1
        if calls["n"] > 1:       # the second layer's write
            raise RuntimeError("device error")
        return real(buf, ps)

    monkeypatch.setattr(P, "_page_tiles", tiles_fail)
    with pytest.raises(RuntimeError, match="writing the KV pool"):
        eng.add_request(p1, max_new_tokens=4)
    monkeypatch.undo()
    assert eng._poisoned
    with pytest.raises(RuntimeError, match="rebuild the engine"):
        eng.step()
