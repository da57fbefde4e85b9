"""Port parity of ``generate``'s strategies against the JAX package, on the
CPU with the plain versions (f32, the same numpy weights in both packages):
``min_new_tokens``, ``repetition_penalty`` and ``no_repeat_ngram_size``
alone and combined, beam search (3 beams, length penalty, early stopping,
eos retirement, ragged prompts, penalties) with identical greedy tokens;
``beam_search_loop`` bit-exact with the JAX function on a scripted numpy
step; the host helpers (n-gram ban, the seen set, the keyword defaults);
and sampling, which is not compared with JAX (another random stream): a
seeded run repeats, stays in range, and ``top_k=1`` or temperature 0 equal
greedy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import build_pair, jax_generate

import paddle_tpu_torch
from paddle_tpu import generation as jax_gen
from paddle_tpu_torch import generation as port_gen

S0, NEW = 21, 8


def _ids(seed=0, B=2, S=S0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _port(model, ids, **kw):
    return model.generate(torch.from_numpy(np.asarray(ids)), **kw).numpy()


@pytest.fixture(scope="module")
def llama():
    jax_model, port_model, _ = build_pair(max_len=S0 + NEW)
    return jax_model, port_model


@pytest.fixture(scope="module")
def greedy(llama):
    """The port's plain greedy tokens of the two prompts."""
    return _port(llama[1], _ids(), max_new_tokens=NEW)


def _eos(greedy):
    """A token row 0 emits at its second step: min_new_tokens has an eos
    to hold back."""
    return int(greedy[0, 1])


MASK = np.array([[1] * 21, [1] * 13 + [0] * 8], np.int32)
# (label, keywords; "eos" stands for the eos token of ``_eos``)
PENALTIES = [
    ("min_new", dict(min_new_tokens=4, eos_token_id="eos")),
    ("repetition", dict(repetition_penalty=1.3)),
    ("repetition below 1", dict(repetition_penalty=0.7)),
    ("ngram 2", dict(no_repeat_ngram_size=2)),
    ("ngram 1", dict(no_repeat_ngram_size=1)),
    ("combined", dict(min_new_tokens=3, eos_token_id="eos",
                      repetition_penalty=1.3, no_repeat_ngram_size=2)),
    ("combined ragged", dict(min_new_tokens=3, eos_token_id="eos",
                             repetition_penalty=1.3, no_repeat_ngram_size=3,
                             attention_mask=MASK)),
]


def _resolve(kw, greedy):
    return {k: (_eos(greedy) if isinstance(v, str) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("label,kw", PENALTIES, ids=[p[0] for p in PENALTIES])
def test_penalties_match_jax(llama, greedy, label, kw):
    jax_model, port_model = llama
    kw = dict(_resolve(kw, greedy), max_new_tokens=NEW)
    ids = _ids()
    want = jax_generate(jax_model, ids, **kw)
    got = _port(port_model, ids, **kw)
    np.testing.assert_array_equal(got, want)
    if "no_repeat_ngram_size" in kw and "attention_mask" not in kw:
        n = kw["no_repeat_ngram_size"]
        for b in range(2):
            seq = list(ids[b]) + list(got[b])
            grams = [tuple(seq[j:j + n]) for j in range(len(seq) - n + 1)]
            assert len(grams) == len(set(grams))


BEAMS = [
    ("3 beams", dict(num_beams=3)),
    ("length penalty 0.5", dict(num_beams=3, length_penalty=0.5)),
    ("eos, early stopping", dict(num_beams=3, eos_token_id="eos",
                                 early_stopping=True)),
    ("eos, length penalty 2", dict(num_beams=3, eos_token_id="eos",
                                   length_penalty=2.0)),
    ("ragged", dict(num_beams=3, attention_mask=MASK)),
    ("penalties", dict(num_beams=3, eos_token_id="eos", min_new_tokens=2,
                       repetition_penalty=1.3, no_repeat_ngram_size=2)),
]


@pytest.mark.parametrize("label,kw", BEAMS, ids=[b[0] for b in BEAMS])
def test_beam_search_matches_jax(llama, greedy, label, kw):
    jax_model, port_model = llama
    kw = dict(_resolve(kw, greedy), max_new_tokens=NEW)
    ids = _ids()
    want = jax_generate(jax_model, ids, **kw)
    got = _port(port_model, ids, **kw)
    np.testing.assert_array_equal(got, want)


def test_one_beam_is_greedy(llama, greedy):
    _, port_model = llama
    np.testing.assert_array_equal(
        _port(port_model, _ids(), max_new_tokens=NEW, num_beams=1), greedy)


def _scripted_step(B, K, V, seed):
    """A deterministic stand-in model: log-probs drawn from the call count,
    the beam origins and the chosen tokens, as numpy."""
    calls = []

    def step(token, row_idx):
        tok = np.asarray(token).reshape(-1)
        calls.append((tok.copy(), np.asarray(row_idx).copy()))
        rng = np.random.RandomState(seed + len(calls))
        x = rng.randn(B * K, V) * 2.0
        x += 0.01 * (tok[:, None] % 7) + 0.001 * np.asarray(row_idx)[:, None]
        x = x - x.max(-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)

    return step, calls


LOOPS = [
    dict(),
    dict(eos_token_id=3),
    dict(eos_token_id=3, early_stopping=True),
    dict(eos_token_id=3, length_penalty=0.3, min_new=3),
    dict(rp=1.4, histories0=[[1, 2, 3, 4, 5], [7, 7, 8]]),
    dict(ngram=2, histories0=[[1, 2, 3, 4, 5], [7, 7, 8]]),
    dict(eos_token_id=0, rp=0.8, ngram=3, min_new=2,
         histories0=[[0, 1, 0, 1, 0], [2]]),
]


@pytest.mark.parametrize("kw", LOOPS, ids=[str(i) for i in range(len(LOOPS))])
def test_beam_search_loop_bit_exact_with_jax(kw):
    B, K, V, N = 2, 3, 16, 9
    logp0 = _scripted_step(B, 1, V, 100)[0](np.zeros((B, 1)), np.zeros(B))
    kw = dict(dict(eos_token_id=None, length_penalty=1.0,
                   early_stopping=False), **kw)
    args = (N, K, kw.pop("eos_token_id"), kw.pop("length_penalty"),
            kw.pop("early_stopping"))
    step_j, calls_j = _scripted_step(B, K, V, 7)
    step_p, calls_p = _scripted_step(B, K, V, 7)
    want = jax_gen.beam_search_loop(logp0, step_j, *args, **kw)
    got = port_gen.beam_search_loop(logp0, step_p, *args, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(calls_p) == len(calls_j)
    for (tp, rp_), (tj, rj) in zip(calls_p, calls_j):
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(rp_, rj)


def test_host_helpers_match_jax():
    hist = [[1, 2, 3, 1, 2], [4, 4, 4], [9]]
    for n in (1, 2, 3):
        np.testing.assert_array_equal(port_gen._ngram_banned(hist, n, 12),
                                      jax_gen._ngram_banned(hist, n, 12))
    ids = _ids(5, B=3, S=10, vocab=12)
    mask = np.ones((3, 14), bool)
    mask[1, 6:10] = False
    for pm in (None, mask):
        want = jax_gen._seen_from_prompt(
            jnp.asarray(ids), 12, None if pm is None else jnp.asarray(pm))
        got = port_gen._seen_from_prompt(
            torch.from_numpy(ids), 12,
            None if pm is None else torch.from_numpy(pm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port_gen.GENERATE_DEFAULTS == jax_gen.GENERATE_DEFAULTS
    port_gen.reject_non_default_kwargs("T5", {"num_beams": 1, "paged": False})
    for bad in ({"num_beams": 4}, {"attention_mask": 1}):
        with pytest.raises(NotImplementedError) as got:
            port_gen.reject_non_default_kwargs("T5", bad)
        with pytest.raises(NotImplementedError) as want:
            jax_gen.reject_non_default_kwargs("T5", bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("route", [{}, {"eos_token_id": 0},
                                   {"paged": True, "page_size": 8}])
def test_seeded_sampling_repeats_and_stays_in_range(llama, greedy, route):
    """The fixed-length loop, the host loop (an eos) and the paged cache:
    the same seed gives the same tokens, another seed other ones; top_k=1
    and temperature 0 give the greedy tokens."""
    _, port_model = llama
    ids = _ids()
    kw = dict(route, max_new_tokens=NEW, do_sample=True, temperature=1.5,
              top_k=50, top_p=0.95)
    runs = []
    for s in (3, 3, 4):
        paddle_tpu_torch.seed(s)
        runs.append(_port(port_model, ids, **kw))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    for r in runs:
        assert r.min() >= 0 and r.max() < 512
    if "eos_token_id" not in route:
        for knob in (dict(top_k=1), dict(temperature=0.0)):
            paddle_tpu_torch.seed(3)
            np.testing.assert_array_equal(
                _port(port_model, ids, **dict(kw, **knob)), greedy)


def test_top_p_sampling():
    """A seed repeats and stays in range; a cut-off of 0 keeps the most
    likely token alone, which both packages then return with its
    probability."""
    from paddle_tpu import to_tensor

    rng = np.random.RandomState(0)
    x = rng.rand(4, 32).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    xt = torch.from_numpy(x)
    ps = torch.full((4,), 0.8)
    s1, i1 = port_gen.top_p_sampling(xt, ps, seed=5)
    s2, i2 = port_gen.top_p_sampling(xt, ps, seed=5)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    assert i1.shape == (4,) and int(i1.min()) >= 0 and int(i1.max()) < 32
    np.testing.assert_allclose(s1.numpy(), x[np.arange(4), i1.numpy()])
    s0, i0 = port_gen.top_p_sampling(xt, torch.zeros(4), seed=1)
    js, ji = jax_gen.top_p_sampling(to_tensor(x), to_tensor(np.zeros(4,
                                                             np.float32)),
                                    seed=1)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ji.numpy()))
    np.testing.assert_array_equal(i0.numpy(), x.argmax(-1))
    np.testing.assert_allclose(s0.numpy(), np.asarray(js.numpy()), rtol=0,
                               atol=1e-7)
