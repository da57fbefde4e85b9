"""The step units' jit layer on the CPU: the port's ``_memoized_step``
against the JAX package's, the graph layer's bookkeeping, and every
memoized unit through an emulated card.

``paddle_tpu_torch/jit/cuda_graph.py`` captures a unit into a CUDA graph
on CUDA tensors. The CPU tests have no card, so :class:`FakeCard` stands
in for the module's one CUDA object (``_CUDA``): a "capture" runs the eager
body once on the graph's inputs and keeps its outputs; a "replay" runs the
body again on the same inputs and copies each fresh output into the kept
one, which is what a replay does to a graph's static outputs. Everything
around it is the real layer: the signature, the state found by identity, the
static inputs and their copies, the outputs rebuilt around them, the
launch bookkeeping, the weak references, the LRU and the weight
fingerprint. So a caller that kept an output across the unit's next call,
or a unit that depended on a Python value the signature misses, gives
other tokens here than its eager run.

Also: the decode tail's barrier state keyed by (device, stream), with a
stand-in stream; the launch counts of ``generate``'s routes at small size
with stand-in kernels (``fake_kernels``), graphed and eager alike.
"""
import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from test_torch_pair import (SMALL, fake_kernels,  # noqa: F401
                             posing_as_cuda)

from paddle_tpu import generation as jax_generation
from paddle_tpu.utils.flags import flag_overrides as jax_flag_overrides
from paddle_tpu_torch import generation
from paddle_tpu_torch.jit import cuda_graph
from paddle_tpu_torch.models import DeepseekV2Config, DeepseekV2ForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import decode_tail as port_tail
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.utils.flags import flag_overrides

S0, NEW = 21, 8


# --------------------------------------------------------------------------
# the emulated card
# --------------------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _Graph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    @torch.inference_mode()
    def replay(self):
        counts = Counter(_build.launches)
        fresh = self.fn()
        _build.launches.clear()
        _build.launches.update(counts)
        for kept, new in zip(cuda_graph.flatten(self.out)[0],
                             cuda_graph.flatten(fresh)[0]):
            if isinstance(kept, torch.Tensor) and kept is not new:
                kept.copy_(new)
        self.replays += 1


class FakeCard:
    """``cuda_graph._CUDA`` for CPU tensors (see the module docstring)."""

    def __init__(self):
        self.graphs = []

    def device_of(self, leaves, what):
        if any(isinstance(x, torch.Tensor) for x in leaves):
            return torch.device("cpu")
        return None

    def side_stream(self, device):
        return _Stream()

    current_stream = side_stream

    def use(self, stream):
        return contextlib.nullcontext()

    def warm(self, model):
        return contextlib.nullcontext()

    def new_graph(self):
        self.graphs.append(_Graph())
        return self.graphs[-1]

    def pool(self, model):
        return None

    def record(self, graph, pool, fn):
        # a capture runs nothing on the card: its draws are given back
        states = [g.get_state() for g in graph.generators]
        graph.fn = fn
        graph.out = fn()
        for g, state in zip(graph.generators, states):
            g.set_state(state)
        return graph.out


@pytest.fixture
def card(monkeypatch):
    fake = FakeCard()
    monkeypatch.setattr(cuda_graph, "_CUDA", fake)
    return fake


@contextlib.contextmanager
def eager_units():
    """Every graphed unit runs its eager body (as chip_smoke's comparison
    runs do)."""
    real = cuda_graph.GraphedStep.__call__
    cuda_graph.GraphedStep.__call__ = lambda unit, *a: unit.eager(*a)
    try:
        yield
    finally:
        cuda_graph.GraphedStep.__call__ = real


def _llama(**kw):
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(**dict(SMALL, **kw)),
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _mla():
    return DeepseekV2ForCausalLM(
        DeepseekV2Config.tiny_mla(num_hidden_layers=2), device="cpu",
        generator=torch.Generator().manual_seed(1))


def _ids(seed=0, B=2, S=S0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 512, (B, S)).astype(np.int32))


def _units(model):
    """Every memoized unit of ``model``, by its getter's attribute."""
    return {attr: list(model.__dict__[attr].values())
            for attr in model.__dict__ if attr.endswith("_steps")}


# --------------------------------------------------------------------------
# memoization against the JAX package
# --------------------------------------------------------------------------

class _JaxModel:
    def functional_state(self):
        return {}


class _PortModel:
    pass


class _Dummy:
    pass


def test_memoized_step_matches_jax_order_eviction_and_flags():
    """The same key sequence through both memoizers with dummy factories:
    the same cache order after every call, the same LRU evictions
    (maxsize 3; a hit moves its key to the back), a hit returning the
    first unit, and the flag fingerprint keying a flag flip apart."""
    jm, pm = _JaxModel(), _PortModel()
    seq = [(1, False), (2, False), (1, False), (3, False), (4, False),
           (2, False), (1, True), (1, False), (5, True), (3, False)]
    made = {"jax": 0, "port": 0}
    for key, fused in seq:
        flags = {"FLAGS_use_fused_decode_tail": fused}
        with jax_flag_overrides(flags):
            def jf():
                made["jax"] += 1
                return _Dummy()
            a = jax_generation._memoized_step(jm, "_steps", key, jf,
                                              maxsize=3)
            again = jax_generation._memoized_step(jm, "_steps", key, jf,
                                                  maxsize=3)
        with flag_overrides(flags):
            def pf():
                made["port"] += 1
                return _Dummy()
            b = generation._memoized_step(pm, "_steps", key, pf, maxsize=3)
            b_again = generation._memoized_step(pm, "_steps", key, pf,
                                                maxsize=3)
        assert a is again and b is b_again
        assert list(jm.__dict__["_steps"]) == list(pm.__dict__["_steps"])
        assert made["jax"] == made["port"]
    assert list(pm.__dict__["_steps"]) == [(1, (False,)), (5, (True,)),
                                           (3, (False,))]
    assert made["port"] == 9    # one hit in ten keys
    with flag_overrides({"FLAGS_use_fused_decode_tail": True}):
        assert generation._trace_flags_key() == (True,)
    with jax_flag_overrides({"FLAGS_use_fused_decode_tail": True}):
        assert jax_generation._trace_flags_key() == (True,)


def test_getters_key_as_jax():
    """Each getter's attribute and key, as the JAX getters build them."""
    model = _llama()
    generation._get_prefill_step(model, 32, True, rope_len=64)
    generation._get_select_decode(model, 32, False, 1, 0, 1)
    generation._get_select_decode_rows(model, 32)
    generation._get_spec_decode(model, 32, 4)
    generation._get_decode_step(model, 32)
    generation._get_beam_step(model, 32)
    off = (False,)
    assert {a: list(model.__dict__[a]) for a in _units(model)} == {
        "_prefill_steps": [((32, True, 64), off)],
        "_select_decode_steps": [((32, False, 1.0, 0, 1.0), off)],
        "_select_decode_rows_steps": [((32,), off)],
        "_spec_decode_steps": [((32, 4), off)],
        "_decode_steps": [(32, off)],
        "_beam_steps": [((32,), off)],
    }


# --------------------------------------------------------------------------
# the graph layer's pieces
# --------------------------------------------------------------------------

def test_replay_counts_arithmetic():
    """A graph's count is what its capture added; the call's counts go
    back to those before the warm-ups; so a call that captured and
    replayed once counts what one eager call counts, and each later replay
    adds the same again."""
    before = Counter(rms_norm=5)
    mark = Counter(rms_norm=5 + 2 * 3, paged_attention=2 * 2)  # warm-ups
    after = mark + Counter(rms_norm=3, paged_attention=2)       # capture
    per_replay = cuda_graph.capture_count(mark, after)
    assert per_replay == Counter(rms_norm=3, paged_attention=2)
    counts = Counter(before)
    for _ in range(4):
        counts.update(per_replay)
    assert counts == Counter(rms_norm=5 + 4 * 3, paged_attention=4 * 2)
    assert cuda_graph.capture_count(Counter(a=1), Counter(a=1)) == Counter()


def test_flatten_round_trip():
    """Leaves in order; the nesting rebuilt in new containers around the
    same leaves; a hashable spec."""
    t = torch.zeros(2)
    tree = (t, None, [{"k": t, "n": 3}, {"k": 1.5}], (True,))
    leaves, spec = cuda_graph.flatten(tree)
    assert len(leaves) == 6 and leaves[0] is t and leaves[2] is t
    assert leaves[1] is None and leaves[3:] == [3, 1.5, True]
    back = cuda_graph.unflatten(spec, leaves)
    assert back[0] is t and back[2][0]["k"] is t and back[2][0]["n"] == 3
    assert back[2][1] == {"k": 1.5} and back[3] == (True,)
    assert back[2] is not tree[2] and back[2][0] is not tree[2][0]
    assert isinstance(back, tuple) and isinstance(back[2], list)
    hash(spec)


def test_dead_state_drops_its_graph():
    """A graph whose state tensor is gone is not alive, and the next
    capture of its unit drops it."""
    kept, gone = torch.zeros(3), torch.zeros(3)
    g = cuda_graph._Graph(None, [], None, [], Counter(), [kept, gone], [])
    assert g.alive()
    del gone
    assert not g.alive()
    live = cuda_graph._Graph(None, [], None, [], Counter(), [kept], [])
    unit = cuda_graph.GraphedStep(None)
    unit._graphs.update(dead=g, live=live)
    unit._drop_dead()
    assert list(unit._graphs) == ["live"]


def test_weights_refresh_decision():
    """A replaced parameter (a new ``Parameter``, a reassigned ``.data``,
    a swapped submodule) drops a unit's graphs; a ``load_state_dict``
    (copies in place) and a call with the same weights keep them."""
    model = _llama()
    unit = generation._get_decode_step(model, 32)

    def captured():
        unit._take_weights()
        unit._graphs["g"] = object()

    captured()
    generation._get_decode_step(model, 32)
    assert "g" in unit._graphs
    model.load_state_dict({k: v.clone() + 1 for k, v in
                           model.state_dict().items()})
    generation._get_decode_step(model, 32)
    assert "g" in unit._graphs
    layer = model.llama.layers[0].mlp.up_proj
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    generation._get_decode_step(model, 32)
    assert not unit._graphs
    captured()
    with torch.no_grad():
        layer.weight.data = layer.weight.data.clone()
    generation._get_decode_step(model, 32)
    assert not unit._graphs
    captured()
    model.llama.layers[1].mlp = type(model.llama.layers[1].mlp)(
        model.config)
    generation._get_decode_step(model, 32)
    assert not unit._graphs


def test_decode_tail_state_keyed_by_device_and_stream(monkeypatch):
    """One zeroed buffer per (device, stream), made once and reused; a
    capture that would make one raises (the warm-up on the capture stream
    makes it first)."""
    stream = {"s": 1}
    monkeypatch.setattr(_build, "stream", lambda device: stream["s"])
    monkeypatch.setattr(port_tail, "_states", {})
    dev = posing_as_cuda(torch.zeros(1)).device
    a = port_tail._state(dev, 3)
    assert port_tail._state(dev, 3) is a
    stream["s"] = 2
    b = port_tail._state(dev, 0)
    assert b is not a and b.data_ptr() != a.data_ptr()
    assert set(port_tail._states) == {(dev, 1), (dev, 2)}
    assert int(a.sum()) == int(b.sum()) == 0
    assert a.numel() == port_tail._BARRIER + port_tail._TILES
    monkeypatch.setattr(_build, "capturing", lambda device: True)
    assert port_tail._state(dev, 0) is b
    stream["s"] = 3
    with pytest.raises(RuntimeError, match="before a CUDA-graph capture"):
        port_tail._state(dev, 0)


# --------------------------------------------------------------------------
# CPU calls: every unit is its eager body
# --------------------------------------------------------------------------

def test_cpu_calls_equal_eager():
    """On CPU tensors every memoized unit's call returns what its eager
    body returns, and captures nothing."""
    model = _llama()
    ids = _ids()
    B, T = ids.shape[0], S0 + NEW
    lengths = torch.full((B,), S0, dtype=torch.int32)
    prefill = generation._get_prefill_step(model, T, False)
    last, caches = prefill(ids, lengths, None)
    last_e, caches_e = prefill.eager(
        ids, lengths, None, generation._cache_buffers(model, B, T, False))
    torch.testing.assert_close(last, last_e, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(3)
    gen_e = torch.Generator().manual_seed(3)
    sel = generation._get_select_decode(model, T, True, 0.8, 5, 0.9)
    got = sel(last, gen, [dict(c) for c in caches])
    want = sel.eager(last, gen_e, [dict(c) for c in caches_e])
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    step = generation._get_decode_step(model, T)
    tok = got[0][:, None]
    torch.testing.assert_close(step(tok, got[3])[0],
                               step.eager(tok, want[3])[0], rtol=0, atol=0)
    for unit in (prefill, sel, step):
        assert unit.captures == unit.replays == 0


# --------------------------------------------------------------------------
# the emulated card: graphed runs against eager ones
# --------------------------------------------------------------------------

ROUTES = {
    "dense": {},
    "paged": {"paged": True, "page_size": 8},
    "ragged": {"attention_mask": "ragged"},
    "chunked": {"prefill_chunk_size": 8},
    "beams": {"num_beams": 3},
    "penalty": {"repetition_penalty": 1.3, "eos_token_id": 7},
    "sampled": {"do_sample": True, "temperature": 0.9, "top_k": 20},
}


def _generate(model, ids, kw, seed=11, new=NEW):
    kw = dict(kw, max_new_tokens=new)
    if kw.get("attention_mask") == "ragged":
        am = np.ones(tuple(ids.shape), np.int32)
        am[1, 13:] = 0
        kw["attention_mask"] = torch.from_numpy(am)
    from paddle_tpu_torch.framework import random as port_random

    port_random.seed(seed)
    return model.generate(ids, **kw).numpy()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_generate_graphed_equals_eager(card, route):
    """Every ``generate`` route, graphed on the emulated card, gives its
    eager run's tokens, twice in a row (the second call replays the
    graphs the first captured, where the state allows); the decode units
    were replayed."""
    model = _llama()
    ids = _ids()
    with eager_units():
        want = _generate(model, ids, ROUTES[route])
    got = _generate(model, ids, ROUTES[route])
    again = _generate(model, ids, ROUTES[route])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    units = [u for us in _units(model).values() for u in us
             if isinstance(u, cuda_graph.GraphedStep)]
    assert sum(u.replays for u in units) >= 2 * (NEW - 1)
    assert all(u.captures <= u.replays for u in units)


def test_dense_decode_replays_one_graph_for_every_position(card):
    """The dense decode captures once per (batch, max_len): ``pos`` rides
    on the device, so 7 forwards at 7 positions replay one graph, and a
    second call with other prompts of the same shape captures nothing."""
    model = _llama()
    _generate(model, _ids(0), {})
    sel = model.__dict__["_select_decode_steps"]
    (unit,) = sel.values()
    prefill, = model.__dict__["_prefill_steps"].values()
    assert (unit.captures, unit.replays) == (1, NEW - 1)
    assert (prefill.captures, prefill.replays) == (1, 1)
    _generate(model, _ids(5), {})
    assert (unit.captures, unit.replays) == (1, 2 * (NEW - 1))
    assert prefill.captures == 1


def test_kept_paged_pools_replay_one_graph(card):
    """Paged decode writes the pools ``generate_paged`` keeps per shape:
    the first call captures over them, every later call of the shape
    replays that graph."""
    model = _llama()
    ids = _ids()
    with eager_units():
        want = _generate(model, ids, ROUTES["paged"])
    for _ in range(3):
        np.testing.assert_array_equal(
            _generate(model, ids, ROUTES["paged"]), want)
    (unit,) = model.__dict__["_select_decode_steps"].values()
    assert unit.captures == 1 and unit.replays == 3 * (NEW - 1)
    assert len(unit._graphs) == 1


def test_prompt_lengths_share_the_decode_graph(card):
    """Two prompt lengths with the same (batch, max_len): the prefill
    writes the one kept buffer set in place, so the second call captures
    its own prefill (another ids shape) and no second decode graph; the
    prefill graphs return the kept buffers as state, so no graph output
    (and no graph pool) holds a cache. Then a cache set of another shape
    evicts the oldest past ``CACHE_SETS``, and its decode graph dies with
    it."""
    model = _llama()
    with eager_units():
        want = [_generate(model, _ids(0, S=S0 - 3), {}, new=NEW + 3),
                _generate(model, _ids(0), {})]
    got = [_generate(model, _ids(0, S=S0 - 3), {}, new=NEW + 3),
           _generate(model, _ids(0), {})]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    (unit,) = model.__dict__["_select_decode_steps"].values()
    (prefill,) = model.__dict__["_prefill_steps"].values()
    assert (unit.captures, unit.replays) == (1, 2 * NEW + 1)
    assert (prefill.captures, prefill.replays) == (2, 2)
    assert list(model.__dict__["_cache_sets"]) == [(2, S0 + NEW)]
    (layers, _), = model.__dict__["_cache_sets"].values()
    kept = {id(t) for c in layers for t in c.values()}
    for g in prefill._graphs.values():
        static = [o for is_state, o in g.outputs if not is_state]
        assert not any(id(o) in kept for o in static)
        state = {id(r()) for r in g.state}
        assert kept <= state
    for b in range(3, 3 + generation.CACHE_SETS):
        _generate(model, _ids(0, B=b), {})
    assert (2, S0 + NEW) not in model.__dict__["_cache_sets"]
    assert len(model.__dict__["_cache_sets"]) == generation.CACHE_SETS
    _generate(model, _ids(0), {})
    assert unit.captures == 2 + generation.CACHE_SETS


@pytest.mark.parametrize("mode", ["paged", "latent", "spec", "rows"])
def test_engine_graphed_equals_eager(card, mode):
    """The engine's decode, rows, verify and prefill-bucket units through
    the emulated card give the eager engine's tokens and logprobs: greedy
    over the paged pool, latent mode (``tiny_mla``), speculative k = 4 on
    repeating prompts, and seeded per-row sampling."""
    model = _mla() if mode == "latent" else _llama()
    rng = np.random.RandomState(2)
    if mode == "spec":
        prompts = [np.tile(rng.randint(0, 512, 4), 5) for _ in range(3)]
    else:
        prompts = [rng.randint(0, 512, n) for n in (5, 16, 23, 9)]

    def run():
        from paddle_tpu_torch.framework import random as port_random

        port_random.seed(4)
        eng = ContinuousBatchEngine(
            model, max_batch=2, max_len=64, page_size=8,
            speculative_k=4 if mode == "spec" else None)
        kw = ({"do_sample": True, "temperature": 0.7, "top_p": 0.9}
              if mode == "rows" else {})
        rids = [eng.add_request(p, max_new_tokens=6, logprobs=True, **kw)
                for p in prompts]
        out = eng.run_until_done()
        return ([out[r].tolist() for r in rids],
                [eng.logprobs(r) for r in rids], eng.stats())

    with eager_units():
        want = run()
    got = run()
    assert got[0] == want[0]
    np.testing.assert_allclose(np.concatenate(got[1]),
                               np.concatenate(want[1]), rtol=0, atol=0)
    assert got[2] == want[2]
    units = [u for us in _units(model).values() for u in us]
    assert sum(u.replays for u in units) > 0
    prefill = model.__dict__["_prefill_steps"].values()
    assert all(u.replays >= 1 for u in prefill)


def test_flag_flip_gets_its_own_unit(card):
    """The engine's decode unit is keyed by the flag fingerprint: turning
    the fused tail on makes (and captures) another unit."""
    model = _llama()
    prompts = [np.arange(5), np.arange(9)]
    for fused in (False, True, False):
        with flag_overrides({"FLAGS_use_fused_decode_tail": fused}):
            eng = ContinuousBatchEngine(model, max_batch=2, max_len=32,
                                        page_size=8)
            for p in prompts:
                eng.add_request(p, max_new_tokens=3)
            eng.run_until_done()
    keys = list(model.__dict__["_select_decode_steps"])
    assert [k[1] for k in keys] == [(False,), (True,)]


@pytest.mark.parametrize("run", ["a", "c", "d"])
def test_launch_counts_hold_graphed(card, fake_kernels, run):
    """``generate``'s routes with stand-in kernels on "CUDA" weights: the
    launch counts of the graphed run equal the eager run's (warm-ups and
    the capture taken back, each replay counted), as phase 16 requires
    them exactly."""
    model = _llama(num_key_value_heads=2)
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = posing_as_cuda(p.detach())
    kw = {"a": {}, "c": {"attention_mask": "ragged"},
          "d": {"prefill_chunk_size": 8}}[run]
    with eager_units():
        _generate(model, _ids(), kw)
    want = Counter(_build.launches)
    _build.launches.clear()
    _generate(model, _ids(), kw)
    assert _build.launches == want
    _build.launches.clear()
    _generate(model, _ids(), kw)
    assert _build.launches == want
    assert want["append_attention"] >= model.config.num_hidden_layers * (
        NEW - 1)


def test_engine_keeps_its_own_last_logits(card):
    """The engine keeps a copy of each step's next logits: a reference
    taken after admission keeps the prefill's values through the next
    steps (the unit's output is the graph's and is overwritten), and the
    engine's logits are never a unit's output."""
    model = _llama()
    eng = ContinuousBatchEngine(model, max_batch=1, max_len=32, page_size=8)
    eng.add_request(np.arange(5), max_new_tokens=4)
    first = eng._last[0]
    snapshot = first.clone()
    eng.step()
    (unit,) = model.__dict__["_select_decode_steps"].values()
    (graph,) = unit._graphs.values()
    outputs = [o for is_state, o in graph.outputs if not is_state]
    eng.step()
    torch.testing.assert_close(first, snapshot, rtol=0, atol=0)
    assert all(eng._last.data_ptr() != o.data_ptr() for o in outputs
               if isinstance(o, torch.Tensor))


def test_prepare_makes_kept_state_outside_the_pool(card, monkeypatch):
    """What a body keeps beyond its call (a rope table of a new length,
    the decode tail's state of the capture stream) is made by
    ``prepare`` before the warm-ups, outside the graph pool they
    allocate from: earlier graphs' replays overwrite the pool's free
    blocks."""
    made = []
    in_pool = [False]

    @contextlib.contextmanager
    def warm(model):
        in_pool[0] = True
        try:
            yield
        finally:
            in_pool[0] = False

    monkeypatch.setattr(card, "warm", warm, raising=False)
    model = _llama()
    real = model.llama._rope

    def rope(n):
        if n not in model.llama._rope_cache:
            made.append((n, in_pool[0]))
        return real(n)

    model.llama._rope = rope
    _generate(model, _ids(), {})
    _generate(model, _ids(), {"prefill_chunk_size": 8})
    assert made and all(not pooled for _, pooled in made)
    assert made[0][0] == S0 + NEW


class _Failing(cuda_graph.GraphedStep):
    """A unit whose body counts one launch a run and runs out of memory at
    the listed runs (1 and 2 are the warm-ups, 3 the capture)."""

    cache_arg = 1

    def __init__(self, model, fail_at):
        super().__init__(model)
        self.runs, self.fail_at = 0, fail_at

    def eager(self, x, caches):
        self.runs += 1
        _build.launches["k"] += 1
        if self.runs in self.fail_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        caches[0].add_(x)
        return x * 2, caches


@pytest.mark.parametrize("fail_at", [{2}, {3}], ids=["warm-up", "capture"])
def test_failed_capture_keeps_no_graph_and_recovers(card, monkeypatch,
                                                    fail_at):
    """An out-of-memory error in a warm-up or in the capture keeps no graph
    (nothing broken can be replayed) and gives back the launches the
    failed runs counted; the next call of the signature captures anew and
    replays correctly."""
    monkeypatch.setattr(_build, "launches", Counter(k=5))
    unit = _Failing(torch.nn.Linear(2, 2), fail_at)
    x, buf = torch.ones(3), torch.zeros(3)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        unit(x, [buf])
    assert _build.launches == Counter(k=5)
    assert not unit._graphs and unit.captures == 0
    out, caches = unit(x, [buf])
    assert unit.captures == 1 and len(unit._graphs) == 1
    assert torch.equal(out, 2 * x) and caches[0] is buf
    assert _build.launches == Counter(k=6)       # one replay's count
