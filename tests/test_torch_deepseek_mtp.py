"""Port parity of DeepSeek-V3's multi-token prediction against the JAX
package, on the CPU with the plain versions: the MTP loss and the gradient
of every parameter (``forward(labels=)``, one and two depths, the router aux
term over the MTP blocks too), the logits and the pre-norm stream
(``return_prenorm``), a depth's ``fuse`` and ``block``,
``mtp_speculative_generate``'s tokens and stats (and its equality with the
port's greedy ``generate``), the weight bridge's round trip of
``mtp_layers``, and JAX's three refusals.

The model is ``tiny_v3`` (sigmoid routing, the correction bias, group-limited
selection, routed scaling) with ``q_lora_rank`` 16, two layers and the MTP
depths, its weights drawn with numpy (``test_torch_pair.numpy_state``) and
shared by both packages. For the speculative runs the main model's residual
writes (``o_proj``, the MLPs' and experts' down projections) are scaled by
0.2 and the embedding half of ``eh_proj`` is the identity, so the draft, like
a trained one, often names the main model's next token: both hit and miss
rounds run (the MTP block's own weights keep their draw, so its attention
over its cache decides drafts too). f32; each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import numpy_state

import paddle_tpu
from paddle_tpu.models import deepseek as jax_ds
from paddle_tpu.nn.layer import functional_weights
from paddle_tpu.speculative import mtp_speculative_generate as jax_mtp_generate
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch.models import deepseek as port_ds
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.speculative import mtp_speculative_generate
from paddle_tpu_torch.weights import from_jax_state, to_numpy_state

SEQ = 16                 # training sequence
P, NEW = 9, 12           # speculative prompt and new tokens
MAX_LEN = P + NEW + 3    # mtp_speculative_generate's max_len
RESIDUAL_SCALE = 0.2
RESIDUAL_WRITES = ("o_proj.weight", "down_proj.weight", "experts.w2",
                   "experts.b2")


def _config(pkg, depths, **kw):
    return pkg.DeepseekV2Config.tiny_v3(
        num_nextn_predict_layers=depths, q_lora_rank=16,
        num_hidden_layers=2, router_aux_loss_coef=0.1, **kw)


def _draft_friendly(state):
    """The speculative runs' weights: the main model's residual writes
    scaled by ``RESIDUAL_SCALE``, ``eh_proj``'s embedding half the
    identity."""
    out = {k: (v * RESIDUAL_SCALE if k.startswith("llama.")
               and k.endswith(RESIDUAL_WRITES) else v)
           for k, v in state.items()}
    w = out["mtp_layers.0.eh_proj.weight"].copy()
    h = w.shape[1]
    w[h:] = np.eye(h, dtype=np.float32)
    out["mtp_layers.0.eh_proj.weight"] = w
    return out


def _build(depths, draft=False):
    """(jax_model, port_model, numpy state) holding the same f32 weights;
    the JAX rope tables built eagerly at ``SEQ`` and ``MAX_LEN`` (see
    test_torch_pair.build_pair)."""
    paddle_tpu.seed(0)
    jax_model = jax_ds.DeepseekV2ForCausalLM(_config(jax_ds, depths))
    state = numpy_state(jax_model, 0)
    if draft:
        state = _draft_friendly(state)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    for n in (SEQ, MAX_LEN):
        jax_model.llama._rope(n)
    port_model = from_jax_state(state, _config(port_ds, depths),
                                device="cpu")
    return jax_model, port_model, state


@pytest.fixture(scope="module", params=[1, 2], ids=["D1", "D2"])
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def draft_pair():
    return _build(1, draft=True)


def _batch(seed=0, batch=2, vocab=512):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(batch, SEQ + 1))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    y[0, :2] = -1                                  # ignored positions
    return x, y


def _jax_jit(jax_model, fn):
    """``fn(*arrays)`` of the JAX model, jitted over its functional
    weights; returns numpy."""
    params = dict(jax_model.functional_state())

    @jax.jit
    def run(p, *args):
        with functional_weights(jax_model, p):
            return fn(*args)

    return lambda *args: jax.tree_util.tree_map(
        np.asarray, run(params, *(jnp.asarray(a) for a in args)))


def test_mtp_loss_and_gradients_match_jax(pair):
    """``forward(labels=)`` with one and two MTP depths: the loss (main LM
    loss + 0.3 x the depths' mean loss + 0.1 x the router aux value over the
    main and the MTP blocks' MoE layers) and the gradient of every parameter
    against ``jax.value_and_grad`` of the JAX loss. f32: loss within 1e-6
    relative, each gradient within 1e-5 of its largest entry (sums in
    another order); the correction bias, which only selects, has none in
    either."""
    jax_model, port_model, state = pair
    x, y = _batch(1)
    params = {k: jnp.asarray(v) for k, v in state.items()}

    def loss_of(p, xs, ys):
        with functional_weights(jax_model, p):
            loss, logits = jax_model(wrap(xs), labels=wrap(ys))
        assert logits is None
        return unwrap(loss)

    want_loss, want = jax.jit(jax.value_and_grad(loss_of))(
        params, jnp.asarray(x), jnp.asarray(y))
    port_model.zero_grad(set_to_none=True)
    loss, logits = port_model(torch.from_numpy(x), labels=torch.from_numpy(y))
    assert logits is None
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    grads = dict(port_model.named_parameters())
    assert set(grads) == set(want)
    assert any(k.startswith("mtp_layers.1.") for k in grads) == (
        port_model.config.num_nextn_predict_layers == 2)
    for name, p in grads.items():
        w = np.asarray(want[name])
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        top = np.abs(w).max()
        assert (top > 0) != name.endswith("e_score_correction_bias"), name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * top,
                                   err_msg=name)


def test_prenorm_stream_and_logits_match_jax(pair):
    """``llama(ids, return_prenorm=True)``: the normed and the pre-norm
    hidden and the logits against the JAX trunk's, within 1e-5; the
    cached forward's pre-norm stream over a prefill (the expanded path)
    equals the uncached one within 1e-5."""
    jax_model, port_model, _ = pair
    x, _ = _batch(2)
    normed_j, pre_j, logits_j = _jax_jit(jax_model, lambda ids: tuple(
        unwrap(t) for t in (*jax_model.llama(wrap(ids), return_prenorm=True),
                            jax_model.lm_head_logits(jax_model.llama(
                                wrap(ids))))))(x)
    with torch.no_grad():
        ids = torch.from_numpy(x)
        normed, pre = port_model.llama(ids, return_prenorm=True)
        logits = port_model.lm_head_logits(normed)
        caches = [dict(c, pos=0, prefill=True)
                  for c in (port_model.llama.empty_cache_layer(
                      2, SEQ, torch.float32) for _ in range(2))]
        normed_c, pre_c, _ = port_model.llama.forward_cached(
            ids, caches, rope_len=SEQ, return_prenorm=True)
    for got, want in ((normed, normed_j), (pre, pre_j), (logits, logits_j),
                      (pre_c, pre.numpy()), (normed_c, normed.numpy())):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(pre.numpy(), normed.numpy())


def test_fuse_and_block_match_jax(pair):
    """Each depth's ``fuse`` (the normed pre-norm hidden beside the normed
    next embeddings, through ``eh_proj``) and its ``block`` over the
    shifted window with 0-based rope tables, against the JAX layer's,
    within 1e-5."""
    jax_model, port_model, _ = pair
    rng = np.random.RandomState(3)
    h = rng.randn(2, SEQ - 1, 128).astype(np.float32)
    e = (0.05 * rng.randn(2, SEQ - 1, 128)).astype(np.float32)
    n = SEQ - 1
    for k, (jl, pl) in enumerate(zip(jax_model.mtp_layers,
                                     port_model.mtp_layers)):
        def jax_fn(hs, es, jl=jl):
            cos, sin = jax_model.llama._rope(SEQ)
            x = jl.fuse(wrap(hs), wrap(es))
            return unwrap(x), unwrap(jl.block(x, cos[:n], sin[:n]))

        fused_j, out_j = _jax_jit(jax_model, jax_fn)(h, e)
        cos, sin = port_model.llama._rope(SEQ)
        with torch.no_grad():
            fused = pl.fuse(torch.from_numpy(h), torch.from_numpy(e))
            out = pl.block(fused, cos[:n], sin[:n])
        assert pl.block.is_moe, k     # layer index L + k is past the dense
        np.testing.assert_allclose(fused.numpy(), fused_j, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_mtp_speculative_generate_is_greedy_generate(draft_pair, seed):
    """The port's ``mtp_speculative_generate`` emits exactly its greedy
    ``generate``'s tokens, with hit and miss rounds (two tokens from a
    hit), one 0/1 observation a round in ``serving_spec_accepted_tokens``
    (engine="mtp"), and acceptance = hits / rounds."""
    _, port_model, _ = draft_pair
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 512, size=(1, P)))
    hist = catalog.SERVING_SPEC_ACCEPTED
    before = hist.count(engine="mtp"), hist.sum(engine="mtp")
    out, stats = mtp_speculative_generate(port_model, ids,
                                          max_new_tokens=NEW,
                                          return_stats=True)
    want = port_model.generate(ids, max_new_tokens=NEW)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert out.dtype == ids.dtype and out.shape == (1, NEW)
    assert 0 < stats["hits"] < stats["rounds"]
    assert stats["rounds"] + stats["hits"] >= NEW - 1
    assert stats["acceptance"] == stats["hits"] / stats["rounds"]
    assert (hist.count(engine="mtp") - before[0],
            hist.sum(engine="mtp") - before[1]) == (stats["rounds"],
                                                    stats["hits"])


def test_mtp_speculative_generate_matches_jax(draft_pair):
    """Tokens and stats against the JAX ``mtp_speculative_generate`` (its
    jitted rounds) on one prompt with both hit and miss rounds."""
    jax_model, port_model, _ = draft_pair
    ids = np.random.RandomState(4).randint(0, 512, size=(1, P))
    want, want_stats = jax_mtp_generate(jax_model, ids, max_new_tokens=NEW,
                                        return_stats=True)
    got, stats = mtp_speculative_generate(port_model, torch.from_numpy(ids),
                                          max_new_tokens=NEW,
                                          return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    assert stats == want_stats and 0 < stats["hits"] < stats["rounds"]


def test_weights_round_trip_carries_mtp_layers(pair):
    """``to_numpy_state`` gives back every ``mtp_layers.*`` tensor bit for
    bit, under the JAX names, with no transpose; a bf16 copy round-trips
    by its bits too. ``generate`` ignores the MTP modules: the model
    without them, from the same state, gives the same tokens."""
    jax_model, port_model, state = pair
    out = to_numpy_state(port_model)
    assert set(out) == set(state) == set(jax_model.functional_state())
    mtp = [k for k in state if k.startswith("mtp_layers.")]
    assert mtp and "mtp_layers.0.eh_proj.weight" in mtp
    for k in mtp:
        assert out[k].shape == state[k].shape
        np.testing.assert_array_equal(out[k], state[k], err_msg=k)
    cfg = _config(port_ds, port_model.config.num_nextn_predict_layers)
    bf = to_numpy_state(from_jax_state(state, cfg, device="cpu",
                                       dtype=torch.bfloat16))
    again = to_numpy_state(from_jax_state(bf, cfg, device="cpu",
                                          dtype=torch.bfloat16))
    for k in mtp:
        assert bf[k].dtype == np.uint16
        np.testing.assert_array_equal(again[k], bf[k], err_msg=k)
    plain = from_jax_state({k: v for k, v in state.items() if k not in mtp},
                           _config(port_ds, 0), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 512, (2, 7)))
    torch.testing.assert_close(port_model.generate(ids, max_new_tokens=5),
                               plain.generate(ids, max_new_tokens=5),
                               rtol=0, atol=0)


def _refusal(build, call):
    """(type, message) of what ``call(build())`` raises."""
    with pytest.raises(Exception) as info:
        call(build())
    return type(info.value).__name__, str(info.value)


def test_jax_refusals():
    """JAX's three refusals, in type and message: a fused linear cross
    entropy with MTP depths, a sequence no longer than the depths, and
    ``mtp_speculative_generate`` on a model without them; the latent
    engine's refusal of ``speculative_k`` points to the MTP route."""
    ids3 = np.zeros((1, 3), np.int64)
    ids8 = np.zeros((1, 8), np.int64)
    cases = [
        (dict(num_nextn_predict_layers=1, fuse_linear_cross_entropy=True),
         lambda m, lab: m(lab(ids8), labels=lab(ids8))),
        (dict(num_nextn_predict_layers=3, num_hidden_layers=1),
         lambda m, lab: m(lab(ids3), labels=lab(ids3))),
        (dict(num_hidden_layers=1), None),
    ]
    for kw, call in cases:
        jax_kw = dict(kw)

        def jax_build(kw=jax_kw):
            paddle_tpu.seed(0)
            return jax_ds.DeepseekV2ForCausalLM(
                jax_ds.DeepseekV2Config.tiny_mla(**kw))

        def port_build(kw=kw):
            return port_ds.DeepseekV2ForCausalLM(
                port_ds.DeepseekV2Config.tiny_mla(**kw), device="cpu")

        if call is None:
            want = _refusal(jax_build, lambda m: jax_mtp_generate(
                m, ids3.astype(np.int32), max_new_tokens=2))
            got = _refusal(port_build, lambda m: mtp_speculative_generate(
                m, torch.from_numpy(ids3), max_new_tokens=2))
        else:
            want = _refusal(jax_build, lambda m: call(
                m, lambda a: wrap(jnp.asarray(a))))
            got = _refusal(port_build, lambda m: call(m, torch.from_numpy))
        assert got == want
    with pytest.raises(NotImplementedError,
                       match="use mtp_speculative_generate"):
        ContinuousBatchEngine(port_build(), max_batch=2, max_len=32,
                              speculative_k=2)
