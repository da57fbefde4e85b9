"""The port's autotune search (``paddle_tpu_torch/ops/hopper/autotune.py``)
against the JAX package's (``tests/test_autotune.py``'s cases on the
port's module), one scenario through both searches, the ``spec_verify``
cost model and ``_resolve_spec_k`` against the JAX ones, the hooked
kernels' candidate spaces within their kernels' limits and the wrappers'
refusals (stand-in launches), and the engine's ``speculative_k="auto"``
against the JAX engine."""
import json
import os
import time

import numpy as np
import pytest
import torch
from test_torch_pair import (SMALL, build_pair, fake_kernels,  # noqa: F401
                             mix_prompts, posing_as_cuda)

import paddle_tpu  # noqa: F401  (the JAX flag registry)
from paddle_tpu.ops.pallas import autotune as jax_autotune
from paddle_tpu.ops.pallas import decode_tail as jax_tail
from paddle_tpu.serving import ContinuousBatchEngine as JaxEngine
from paddle_tpu.serving import _resolve_spec_k as jax_resolve
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.ops.hopper import (_build, autotune, decode_tail,
                                         fused_norm, mla_decode)
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine
from paddle_tpu_torch.serving import _resolve_spec_k
from paddle_tpu_torch.utils.flags import flag_overrides

H100_SMS = 132
ON = {"FLAGS_use_autotune": True}


@pytest.fixture
def tuned_cache(tmp_path, monkeypatch):
    """A throwaway cache file for both packages; the JAX flag restored."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("PD_AUTOTUNE_CACHE", path)
    prev = jax_autotune.enabled()
    yield path
    jax_set_flags({"FLAGS_use_autotune": prev})


def _runner_factory(timings, calls):
    def runner(cfg):
        def run():
            calls.append(cfg)
            time.sleep(timings[cfg])
            return np.zeros(())
        return run
    return runner


# ---- JAX's cases on the port's module ---------------------------------------

def test_flag_off_by_default_returns_default_and_never_measures(
        tuned_cache):
    calls = []
    assert not autotune.enabled()
    got = autotune.pick("k", "key", (256,), [(128,), (64,)],
                        _runner_factory({}, calls), can_measure=True)
    assert got == (256,) and calls == []
    assert not os.path.exists(tuned_cache)


def test_measures_picks_fastest_and_persists(tuned_cache):
    calls = []
    timings = {(128,): 0.03, (64,): 0.001, (32,): 0.02}
    with flag_overrides(ON):
        got = autotune.pick("k", "rows128 d256", (128,), list(timings),
                            _runner_factory(timings, calls),
                            can_measure=True, log=False)
    assert got == (64,)
    assert set(calls) == set(timings)
    data = json.load(open(tuned_cache))
    assert data["k"][autotune.full_key("rows128 d256")]["choice"] == [64]
    fresh = autotune.AutotuneCache(tuned_cache)
    assert fresh.get("k", autotune.full_key("rows128 d256")) == [64]


def test_cache_hit_skips_measurement(tuned_cache):
    autotune.get_cache().put("k", autotune.full_key("sig"), (32,), 1.0)
    calls = []
    autotune.stages.clear()
    with flag_overrides(ON):
        got = autotune.pick("k", "sig", (128,), [(128,), (32,)],
                            _runner_factory({}, calls), can_measure=True)
    assert got == (32,) and calls == []
    assert dict(autotune.stages) == {"k cache": 1}


def test_no_measure_context_returns_default(tuned_cache):
    autotune.stages.clear()
    with flag_overrides(ON):
        got = autotune.pick("k", "other", (128,), [(64,)],
                            _runner_factory({}, []), can_measure=False)
    assert got == (128,)
    assert dict(autotune.stages) == {"k default": 1}


def test_failing_candidates_lose(tuned_cache):
    def runner(cfg):
        def run():
            if cfg == (512,):
                raise RuntimeError("too much shared memory")
            return np.zeros(())
        return run

    with flag_overrides(ON):
        got = autotune.pick("k", "oom", (128,), [(512,), (64,)], runner,
                            can_measure=True, log=False)
    assert got == (64,)


def test_cost_table_records_all_candidates_and_roundtrips(tuned_cache):
    calls = []
    timings = {(128,): 0.02, (64,): 0.001, (32,): 0.01}
    params = {"rows": 128, "d": 64, "dtype": "float32"}

    def cost_model(cfg):
        return {"bytes": 1000, "flops": 2000, "vmem_bytes": 10,
                "grid": 128 // cfg[0]}

    with flag_overrides(ON):
        got = autotune.search("k", "sig", (128,), list(timings),
                              _runner_factory(timings, calls),
                              can_measure=True, params=params,
                              cost_model=cost_model, log=False)
    assert got == (64,)
    ent = autotune.AutotuneCache(tuned_cache).entry(
        "k", autotune.full_key("sig"))
    assert ent["choice"] == [64] and ent["params"] == params
    assert ent["est"]["bytes"] == 1000 and ent["est"]["flops"] == 2000
    assert set(ent["table"]) == {"128", "64", "32"}
    assert all(r["status"] == "ok" and r["ms"] >= 0
               for r in ent["table"].values())


def test_failures_recorded_and_never_retried(tuned_cache):
    calls = []

    def runner(cfg):
        def run():
            calls.append(cfg)
            raise RuntimeError("refused")
        return run

    with flag_overrides(ON):
        got = autotune.search("k", "oom", (128,), [(512,), (256,)], runner,
                              can_measure=True, log=False)
        assert got == (128,) and len(calls) == 2
        fresh = autotune.AutotuneCache(tuned_cache)
        ent = fresh.entry("k", autotune.full_key("oom"))
        assert ent["table"]["512"]["status"] == "fail"
        assert "refused" in ent["table"]["512"]["error"]
        assert fresh.failures("k", autotune.full_key("oom")) == {
            (512,), (256,)}
        calls.clear()
        got = autotune.search("k", "oom", (128,), [(512,), (256,)], runner,
                              can_measure=True, log=False)
    assert got == (128,) and calls == []


def test_pruning_drops_infeasible_and_ranks_by_waves(tuned_cache):
    """A candidate whose block needs more shared memory than the limit is
    recorded unlaunched; the grid term counts waves of SMs * blocks an SM,
    so 132 blocks of one wave rank with 1 block."""
    calls = []
    timings = {(64,): 0.002, (32,): 0.002, (16,): 0.002}

    def cost_model(cfg):
        (b,) = cfg
        return {"bytes": 1000, "flops": 1000,
                "vmem_bytes": 10 ** 9 if b == 16 else 10,
                "grid": {64: 1, 32: 400}[b] if b != 16 else 1,
                "blocks_per_sm": 1}

    with flag_overrides(ON):
        got = autotune.search("k", "pruned", (128,), [(64,), (32,), (16,)],
                              _runner_factory(timings, calls),
                              can_measure=True, cost_model=cost_model,
                              max_measure=1, log=False)
    assert set(calls) == {(64,)} and got == (64,)
    tab = autotune.AutotuneCache(tuned_cache).entry(
        "k", autotune.full_key("pruned"))["table"]
    assert tab["16"]["status"] == "infeasible"
    assert "vmem" in tab["16"]["reason"]
    one_wave = autotune.roofline_ms(0, 0, "H100", grid=132, blocks_per_sm=1)
    assert one_wave == autotune.roofline_ms(0, 0, "H100", grid=1,
                                            blocks_per_sm=1)
    assert autotune.roofline_ms(0, 0, "H100", grid=133,
                                blocks_per_sm=1) == 2 * one_wave
    assert autotune.roofline_caps("NVIDIA_H100_80GB_HBM3") == (3.35e12,
                                                                989e12)


def test_deferred_flush(tuned_cache):
    cache = autotune.get_cache()
    cache.put("k", "sig", (8,), 1.0)
    assert not os.path.exists(tuned_cache)
    cache.flush()
    assert json.load(open(tuned_cache))["k"]["sig"]["choice"] == [8]
    assert autotune._ATEXIT_REGISTERED
    assert not [f for f in os.listdir(os.path.dirname(tuned_cache))
                if f.endswith(".tmp")]


def test_corrupt_cache_file_starts_empty(tuned_cache):
    with open(tuned_cache, "w") as f:
        f.write("{ not json")
    assert autotune.AutotuneCache(tuned_cache).get("k", "sig") is None


def test_stale_winner_falls_back_to_default(tuned_cache):
    autotune.get_cache().put("k", autotune.full_key("shape"), (48,), 1.0)
    with flag_overrides(ON):
        got = autotune.pick("k", "shape", (128,), [(64,), (32,)],
                            _runner_factory({}, []), can_measure=False)
    assert got == (128,)


def test_default_path_and_device_kind(monkeypatch):
    monkeypatch.delenv("PD_AUTOTUNE_CACHE", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert autotune.cache_path() == os.path.join(root,
                                                 ".pd_autotune_torch.json")
    assert autotune.device_kind() == "cpu"
    assert autotune.full_key("rows8 d4096 bfloat16") == (
        "rows8 d4096 bfloat16 @cpu")


def test_can_measure_only_eager_on_the_card():
    cpu = torch.zeros(2)
    assert not autotune.can_measure(cpu)
    assert not autotune.can_measure()
    with _build.unit_scope():
        assert _build.in_unit()
    assert not _build.in_unit()


def test_measure_takes_its_launches_out_of_the_counts(monkeypatch):
    monkeypatch.setattr(_build, "launches", _build.launches.__class__(
        {"rms_norm": 3}))

    def run():
        _build.launches["rms_norm"] += 1
        return np.zeros(())

    assert autotune._measure(run) >= 0
    assert dict(_build.launches) == {"rms_norm": 3}


# ---- one scenario through both searches -------------------------------------

def test_one_scenario_persists_the_same_entries(tuned_cache, monkeypatch,
                                                tmp_path):
    """Candidates with timings, a failure, an infeasible geometry and a
    pruned one through the JAX ``search`` and the port's, ``_measure``
    patched to the same timings: the same file apart from the time
    stamps and the device key."""
    timings = {(8,): 0.5, (16,): 0.25, (32,): 0.75, (128,): 0.1}
    params = {"rows": 64, "d": 512, "dtype": "bfloat16"}

    def cost_model(cfg):
        (b,) = cfg
        return {"bytes": 4096 * b, "flops": 1000, "grid": 1,
                "vmem_bytes": 5000 if b == 64 else 100}

    def runner(cfg):
        if cfg == (32,):
            raise RuntimeError("geometry refused")
        return lambda: cfg

    cands = [(8,), (16,), (32,), (64,), (128,)]
    files = {}
    for name, mod in (("jax", jax_autotune), ("port", autotune)):
        path = str(tmp_path / f"{name}.json")
        monkeypatch.setenv("PD_AUTOTUNE_CACHE", path)
        monkeypatch.setattr(mod, "_measure",
                            lambda fn, reps=3: timings[fn()])
        if name == "jax":
            jax_set_flags({"FLAGS_use_autotune": True})
            got = mod.search("k", "rows64 d512 bfloat16", (8,), cands,
                             runner, True, params=params,
                             cost_model=cost_model, max_measure=3,
                             vmem_limit=4096, log=False)
        else:
            with flag_overrides(ON):
                got = mod.search("k", "rows64 d512 bfloat16", (8,), cands,
                                 runner, True, params=params,
                                 cost_model=cost_model, max_measure=3,
                                 vmem_limit=4096, log=False)
        assert got == (16,)
        data = json.load(open(path))
        ent = {k.rsplit(" @", 1)[0]: v for k, v in data["k"].items()}
        for v in ent.values():
            v.pop("measured_at")
        files[name] = ent
    assert files["jax"] == files["port"]
    table = files["port"]["rows64 d512 bfloat16"]["table"]
    assert table["64"]["status"] == "infeasible"
    assert table["32"]["status"] == "fail"
    assert "128" not in table          # ranked last of four, pruned


# ---- spec_verify and speculative_k="auto" -----------------------------------

SPEC_PARAMS = {"batch": 8, "hidden": 4096, "layers": 32,
               "intermediate": 14336, "wtot": 6144, "vocab": 128256,
               "dtype": "bfloat16"}


@pytest.mark.parametrize("k", [2, 3, 4, 6, 8])
def test_spec_verify_cost_matches_jax(k):
    assert decode_tail._spec_verify_cost(SPEC_PARAMS, (k,)) == (
        jax_tail._spec_verify_cost(SPEC_PARAMS, (k,)))
    assert autotune.analytical_cost("spec_verify", SPEC_PARAMS, (k,)) == (
        decode_tail._spec_verify_cost(SPEC_PARAMS, (k,)))


@pytest.fixture(scope="module")
def pair():
    jax_model, port_model, _ = build_pair(max_len=128)
    return jax_model, port_model


ENGINE = dict(max_batch=2, max_len=128, page_size=16)
# ms a verify dispatch by k: at acceptance 0.7, k = 3 has the least ms a
# retired token (2: 0.588, 3: 0.548, 4: 0.592)
SPEC_TABLE = {2: 1.0, 3: 1.2, 4: 1.5, 6: 3.0, 8: 5.0}


def _persist_spec_table(port_model, max_batch):
    cfg = port_model.config
    params = {"batch": max_batch, "hidden": cfg.hidden_size,
              "layers": cfg.num_hidden_layers,
              "intermediate": cfg.intermediate_size,
              "wtot": (cfg.num_attention_heads
                       + 2 * cfg.num_key_value_heads) * 128,
              "vocab": cfg.vocab_size, "dtype": str(cfg.dtype)}
    key = autotune.full_key(autotune.signature(params))
    cache = autotune.get_cache()
    for k, ms in SPEC_TABLE.items():
        cache.record_result("spec_verify", key, (k,), ms=ms)
    cache.put("spec_verify", key, (2,), 1.0, params=params)
    cache.flush()


def test_resolve_spec_k_same_as_jax_from_one_table(pair, tuned_cache):
    jax_model, port_model = pair
    jax_set_flags({"FLAGS_use_autotune": False})
    assert _resolve_spec_k(port_model, 2, 128) == jax_resolve(
        jax_model, 2, 128) == 4
    _persist_spec_table(port_model, 2)
    jax_set_flags({"FLAGS_use_autotune": True})
    with flag_overrides(ON):
        got = _resolve_spec_k(port_model, 2, 128)
    assert got == jax_resolve(jax_model, 2, 128) == 3


def _run(engine, prompts, news):
    rids = [engine.add_request(p, max_new_tokens=n) for p, n in
            zip(prompts, news)]
    out = engine.run_until_done()
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("table", [False, True])
def test_engine_auto_matches_jax(pair, tuned_cache, table):
    """``speculative_k="auto"``: with the flag off both engines take the
    default 4; with a persisted table both re-rank it to 3. The f32 tokens
    are the JAX engine's."""
    jax_model, port_model = pair
    want_k = 4
    if table:
        _persist_spec_table(port_model, ENGINE["max_batch"])
        want_k = 3
    jax_set_flags({"FLAGS_use_autotune": table})
    prompts = mix_prompts(8, (7, 19))
    news = (8, 6)
    with flag_overrides({"FLAGS_use_autotune": table}):
        port_eng = PortEngine(port_model, speculative_k="auto", **ENGINE)
    jax_eng = JaxEngine(jax_model, speculative_k="auto", **ENGINE)
    assert port_eng.speculative_k == jax_eng.speculative_k == want_k
    assert _run(port_eng, prompts, news) == _run(jax_eng, prompts, news)


# ---- the hooks: candidate spaces and refusals -------------------------------

@pytest.mark.parametrize("d, es", [(d, 2) for d in (8, 128, 512, 2048,
                                                    4096, 16384, 32768)]
                         + [(d, 4) for d in (8, 128, 512, 2048, 4096,
                                             16384)])
def test_rms_candidates_within_1024_threads(d, es):
    tpr, rule = fused_norm.rms_layout(d, es)
    cands = [c for (c,) in fused_norm.rms_candidates(d, es)]
    assert (rule,) in fused_norm.rms_candidates(d, es)
    assert cands and all(tpr * c <= 1024 for c in cands)
    assert all(c & (c - 1) == 0 for c in cands)
    assert tpr * cands[-1] * 2 > 1024          # every power of two that fits


@pytest.mark.parametrize("rows", [1, 8, 16, 32, 33])
@pytest.mark.parametrize("kernel", ["qkv", "epilogue"])
def test_tail_splits_are_co_resident(rows, kernel):
    """Every split ``split_options`` offers at Llama-3-8B's widths on 132
    SMs is the default or has all its work items resident at once."""
    n_tiles = 48 if kernel == "qkv" else 32
    k = 4096
    opts = decode_tail.split_options(n_tiles, rows, k, H100_SMS)
    default = decode_tail.split_count(n_tiles, rows, k, H100_SMS)
    assert default in opts
    n_rt = -(-rows // decode_tail.row_tile(rows))
    chunks = k // decode_tail.CHUNK
    for s in opts:
        per = -(-chunks // s)
        assert -(-chunks // per) == s and 1 <= s <= decode_tail.MAX_SPLIT
        per_sm = min(decode_tail.BLOCKS_PER_SM, decode_tail.SMEM_PER_SM // (
            decode_tail.block_smem(rows, per) + decode_tail.SMEM_RESERVED))
        assert s == default or n_tiles * s * n_rt <= per_sm * H100_SMS
    if rows == 8:
        assert len(opts) > 1


def _tail_cuda(R=8, hidden=256, H=2, hk=1, d=128):
    dt = torch.bfloat16
    z = lambda *s, t=dt: posing_as_cuda(torch.zeros(*s, dtype=t))  # noqa
    return (z(R, hidden), z(hidden), z(hidden, H * d), z(hidden, hk * d),
            z(hidden, hk * d), z(R, d, t=torch.float32),
            z(R, d, t=torch.float32))


def test_tail_wrappers_take_a_cached_split_and_refuse_others(
        fake_kernels, tuned_cache, monkeypatch):
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    x, wn, wq, wk, wv, cs, sn = _tail_cuda()
    opts = decode_tail.split_options(4, 8, 256, H100_SMS)
    default = decode_tail.split_count(4, 8, 256, H100_SMS)
    other = next(s for s in opts if s != default)
    params = {"batch": 8, "hidden": 256, "wtot": 512, "dtype": "bfloat16"}
    autotune.get_cache().put("fused_qkv_rope", autotune.full_key(
        autotune.signature(params)), (other,), 1.0)
    autotune.stages.clear()
    with flag_overrides(ON):
        decode_tail.fused_qkv_rope(x, wn, wq, wk, wv, cs, sn, 1e-5, 2, 1,
                                   128)
    decode_tail.fused_qkv_rope(x, wn, wq, wk, wv, cs, sn, 1e-5, 2, 1, 128)
    assert [a[17] for _, a in fake_kernels] == [other, default]
    assert dict(autotune.stages) == {"fused_qkv_rope cache": 1}
    bad = max(opts) + 1
    with pytest.raises(ValueError, match="split"):
        decode_tail._launch_qkv(x, wn, wq, wk, wv, cs, sn, 1e-5, 2, 1, 128,
                                1, H100_SMS, bad)
    attn, wo = posing_as_cuda(torch.zeros(8, 256, dtype=torch.bfloat16)), (
        posing_as_cuda(torch.zeros(256, 256, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="split"):
        decode_tail._launch_epilogue(attn, wo, x, wn, 1e-5, 1, H100_SMS, 99)
    assert len(fake_kernels) == 2 and sum(_build.launches.values()) == 2


def test_rms_norm_takes_a_cached_block_and_refuses_too_many_threads(
        fake_kernels, tuned_cache):
    x = posing_as_cuda(torch.zeros(64, 128, dtype=torch.bfloat16))
    w = posing_as_cuda(torch.ones(128, dtype=torch.bfloat16))
    autotune.get_cache().put("rms_norm", autotune.full_key(
        "rows64 d128 bfloat16"), (16,), 1.0)
    with flag_overrides(ON):
        fused_norm.rms_norm(x, w)
        fused_norm.rms_norm(posing_as_cuda(torch.zeros(8, 128,
                                                       dtype=torch.bfloat16)),
                            w)
    assert [a[7] for _, a in fake_kernels] == [16, 4]   # cached, the rule
    with pytest.raises(ValueError, match="1024 threads"):
        fused_norm._launch_rms(x, w, 1e-6, 1, 64, 128, 64)
    assert len(fake_kernels) == 2


def test_mla_grid_candidates_and_refusal(fake_kernels, tuned_cache,
                                        monkeypatch):
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    B, H, r, dr, T = 8, 16, 512, 64, 256
    cands = mla_decode.grid_candidates(B, H, H100_SMS)
    assert cands[0] == B and mla_decode.grid_blocks(B, H, H100_SMS) in cands
    assert max(cands) == mla_decode.MAX_WAVES * H100_SMS
    q = posing_as_cuda(torch.zeros(B, H, r))
    qp = posing_as_cuda(torch.zeros(B, H, dr))
    ckv = posing_as_cuda(torch.zeros(B, T, r, dtype=torch.bfloat16))
    kpe = posing_as_cuda(torch.zeros(B, T, dr, dtype=torch.bfloat16))
    autotune.get_cache().put("mla_decode", autotune.full_key(
        f"B{B}xH{H}xr{r}xT{T} bfloat16"), (cands[1],), 1.0)
    with flag_overrides(ON):
        mla_decode.mla_decode(q, qp, ckv, kpe, 100)
    assert fake_kernels[0][1][16] == cands[1]
    rows = posing_as_cuda(torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="blocks outside"):
        mla_decode._launch(q, qp, ckv, kpe, rows, None, 1, H100_SMS, B - 1)
    assert len(fake_kernels) == 1
