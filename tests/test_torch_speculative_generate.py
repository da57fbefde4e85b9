"""Port parity of the draft-model ``speculative_generate``: f32 tokens and
``(rounds, hits, acceptance)`` equal to the JAX function's on the same
weights, for a random draft (rejections at k = 1 and 4) and for the target
as its own draft (every draft accepted, the m == k catch-up), and equal to
the target's greedy ``generate``; the eos cut; the refusals.

The JAX side runs at ``max_len = P + new + k + 2``, not at the pair's
``max_len``: its rope table for that length is built eagerly first (under
jax 0.9 a table first built inside a jitted step is memoised as a tracer).
"""
import numpy as np
import pytest
import torch
from test_torch_pair import build_pair

from paddle_tpu.speculative import speculative_generate as jax_spec
from paddle_tpu_torch import speculative
from paddle_tpu_torch.generation import generate as port_generate

P, NEW = 9, 14


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX draft, port draft): the draft one
    layer, from another seed."""
    jt, pt, _ = build_pair(max_len=64)
    jd, pd, _ = build_pair(max_len=64, seed=1, num_hidden_layers=1)
    return jt, pt, jd, pd


def _prompt(seed=5):
    return np.random.RandomState(seed).randint(0, 512, size=(1, P)).astype(
        np.int32)


def _jax_run(target, draft, ids, k, **kw):
    max_len = ids.shape[1] + kw.get("max_new_tokens", NEW) + k + 2
    for m in {id(target): target, id(draft): draft}.values():
        m.llama._rope(max_len)
    kw.setdefault("max_new_tokens", NEW)
    out, stats = jax_spec(target, draft, ids, draft_k=k, return_stats=True,
                          **kw)
    return np.asarray(out.numpy()), stats


@pytest.mark.parametrize("case, k", [("random", 1), ("random", 4),
                                     ("self", 3)])
def test_tokens_and_stats_match_jax(models, case, k):
    jt, pt, jd, pd = models
    if case == "self":
        jd, pd = jt, pt
    ids = _prompt()
    got, stats = speculative.speculative_generate(
        pt, pd, torch.from_numpy(ids), max_new_tokens=NEW, draft_k=k,
        return_stats=True)
    want, want_stats = _jax_run(jt, jd, ids, k)
    assert got.dtype == torch.int32 and got.shape == (1, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == want_stats
    solo = port_generate(pt, torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), solo.numpy())
    if case == "self":
        # every proposal lands: each round emits k + 1 tokens
        assert stats["acceptance"] == 1.0
        assert stats["rounds"] == -(-(NEW - 1) // (k + 1))
    else:
        assert stats["hits"] < stats["rounds"] * k


def test_eos_cut_matches_jax(models):
    """An eos inside an accepted run ends the output there, eos kept."""
    jt, pt, _, _ = models
    ids = _prompt(6)
    full = speculative.speculative_generate(pt, pt, ids, max_new_tokens=NEW,
                                            draft_k=3)[0].tolist()
    eos = full[5]
    cut = full.index(eos)
    got = speculative.speculative_generate(pt, pt, ids, max_new_tokens=NEW,
                                           draft_k=3, eos_token_id=eos)
    want, _ = _jax_run(jt, jt, ids, 3, eos_token_id=eos)
    assert got[0].tolist() == full[:cut + 1] == want[0].tolist()


@pytest.mark.parametrize("bad", ["batch", "k", "max_len"])
def test_refusals(models, bad):
    _, pt, _, pd = models
    ids = _prompt()
    kw = dict(max_new_tokens=NEW, draft_k=2)
    if bad == "batch":
        ids, match = np.concatenate([ids, ids]), "batch 1"
    elif bad == "k":
        kw["draft_k"], match = 0, "draft_k must be >= 1"
    else:
        kw["max_new_tokens"], match = 300, "max_position_embeddings"
    with pytest.raises(ValueError, match=match):
        speculative.speculative_generate(pt, pd, ids, **kw)
