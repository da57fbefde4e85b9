"""Port parity of the training slice (plain versions, CPU) against the JAX
package: the non-cached forward, the chunked fused lm-head + CE loss,
``causal_lm_loss``, AdamW with f32 masters and bf16 moments, and whole
``train_step``s of ``LlamaConfig.tiny()`` from the same numpy weights.
Each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import numpy_state

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from paddle_tpu.ops.fused_loss import fused_linear_cross_entropy as jax_flce
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import causal_lm_loss as port_causal_lm_loss
from paddle_tpu_torch.ops.fused_loss import fused_linear_cross_entropy
from paddle_tpu_torch.weights import from_jax_state


def _np(a):
    return np.asarray(a).astype(np.float32)


def _tiny_pair(seq, **overrides):
    """(jax_model, port_model) of ``LlamaConfig.tiny(**overrides)`` holding
    the same numpy weights; the JAX rope table for ``seq`` is built eagerly
    (see test_torch_pair.build_pair)."""
    paddle_tpu.seed(0)
    jax_model = JaxLM(JaxConfig.tiny(**overrides))
    state = numpy_state(jax_model, seed=1)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(seq)
    port_model = from_jax_state(state, PortConfig.tiny(**overrides),
                                device="cpu")
    return jax_model, port_model


def _batch(seed=0, batch=2, seq=16, vocab=512):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(batch, seq + 1))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    y[0, :3] = -1                                  # ignored positions
    return x, y


@pytest.mark.parametrize("layout", ["hv", "vh"])
def test_fused_linear_cross_entropy_matches_jax(layout):
    """38 tokens in chunks of 16 (two pad rows), some labels ignored; f32:
    loss within 1e-6 relative, gradients within 1e-6 (sums over the chunk
    and the vocab taken in another order)."""
    rng = np.random.RandomState(3)
    n_hidden, vocab = 64, 96
    h = rng.randn(2, 19, n_hidden).astype(np.float32)
    w_shape = (n_hidden, vocab) if layout == "hv" else (vocab, n_hidden)
    w = (0.2 * rng.randn(*w_shape)).astype(np.float32)
    lab = rng.randint(0, vocab, size=(2, 19))
    lab[1, 5:9] = -1
    loss_j, vjp = jax.vjp(
        lambda a, b: jax_flce(a, b, jnp.asarray(lab), layout, 16),
        jnp.asarray(h), jnp.asarray(w))
    dh_j, dw_j = vjp(jnp.float32(1.5))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss_p = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab), layout,
                                        16)
    (loss_p * 1.5).backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), _np(dh_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), _np(dw_j), rtol=0, atol=1e-6)
    # the same loss as the logits path
    logits = th @ tw if layout == "hv" else th @ tw.t()
    np.testing.assert_allclose(
        port_causal_lm_loss(logits, torch.from_numpy(lab)).item(),
        loss_p.item(), rtol=1e-6)


def test_causal_lm_loss_matches_jax():
    """f32 token-mean CE with ignored labels: within 1e-6 relative."""
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(2, 7, 50)).astype(np.float32)
    lab = rng.randint(0, 50, size=(2, 7))
    lab[0, 0] = lab[1, 6] = -1
    want = float(np.asarray(jax_causal_lm_loss(
        paddle_tpu.to_tensor(logits), paddle_tpu.to_tensor(lab)).numpy()))
    got = port_causal_lm_loss(torch.from_numpy(logits),
                              torch.from_numpy(lab)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _bf16_bits(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def _torch_bits(t):
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("cls", ["AdamW", "Adam"])
def test_adam_matches_jax_apply_gradients(cls):
    """Two steps on random arrays: bf16 parameters with f32 masters, bf16
    moments, one f32 parameter; AdamW decays decoupled and one parameter is
    excluded by ``apply_decay_param_fun``, Adam adds the decay to the
    gradient. f32 masters within 1e-6 relative
    (the bias corrections' f32 power may differ in its last bit); the bf16
    parameters and moments, each a rounding of those f32 values, within one
    bf16 ulp."""
    rng = np.random.RandomState(5)
    shapes = {"w": (64, 32), "b": (32,), "f": (16,)}
    dtypes = {"w": "bfloat16", "b": "bfloat16", "f": "float32"}
    params0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (0.1 * rng.randn(*s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
              moment_dtype="bfloat16")
    if cls == "AdamW":
        kw["apply_decay_param_fun"] = lambda name: name != "b"
    opt_j = getattr(jax_opt, cls)(1e-2, **kw)
    jparams = {n: jnp.asarray(a, dtypes[n]) for n, a in params0.items()}
    state = opt_j.init_state(jparams)
    opt_p = getattr(port_opt, cls)(1e-2, **kw)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).to(
        getattr(torch, dtypes[n]))) for n, a in params0.items()}
    for g in grads:
        jparams, state = opt_j.apply_gradients(
            state, jparams, {n: jnp.asarray(a, dtypes[n])
                             for n, a in g.items()})
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        opt_p.apply_gradients(tparams)
    for n in ("w", "b"):
        js, ps = state["param_states"][n], opt_p._state[n]
        np.testing.assert_allclose(ps["master"].numpy(), _np(js["master"]),
                                   rtol=1e-6, atol=0)
        for got, want in ((tparams[n], jparams[n]),
                          (ps["moment1"], js["moment1"]),
                          (ps["moment2"], js["moment2"])):
            diff = np.abs(_torch_bits(got).astype(np.int64)
                          - _bf16_bits(want).astype(np.int64))
            assert diff.max() <= 1, n
    np.testing.assert_allclose(tparams["f"].detach().numpy(),
                               _np(jparams["f"]), rtol=1e-6, atol=0)
    assert "master" not in opt_p._state["f"]


def test_eager_step_names_parameters_by_position():
    """``step()`` is ``apply_gradients`` over the parameter list named
    p0, p1, ...: the same update, bit for bit, and the decay gate sees
    those names."""
    rng = np.random.RandomState(6)
    a = [torch.nn.Parameter(torch.from_numpy(rng.randn(8, 4).astype(
        np.float32)).to(torch.bfloat16)) for _ in range(2)]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    for p, q in zip(a, b):
        p.grad = q.grad = torch.randn(8, 4).to(torch.bfloat16)
    kw = dict(weight_decay=0.1, apply_decay_param_fun=lambda n: n == "p1")
    port_opt.AdamW(1e-2, parameters=a, **kw).step()
    port_opt.AdamW(1e-2, **kw).apply_gradients({"p0": b[0], "p1": b[1]})
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_non_cached_forward_matches_jax():
    """Logits of the non-cached forward on the same weights; f32, within
    atol 1e-4 (as the serving parity tests)."""
    jax_model, port_model = _tiny_pair(16)
    x, _ = _batch(2)
    want = _np(jax_model(paddle_tpu.to_tensor(x)).numpy())
    got = port_model(torch.from_numpy(x))
    assert got.grad_fn is not None          # parameters are trainable
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("variant", ["tied_fused", "untied_logits"])
def test_train_step_matches_jax(variant):
    """Three ``train_step``s of AdamW(3e-4, weight_decay=0.1) on one batch,
    f32. Losses within 1e-5 relative at every step. Gradients agree to
    about 1e-6 relative, and an Adam step moves a weight by about
    lr * g / (|g| + eps): where |g| is near 1e-8 (one or two weights of a
    matrix here), the step follows the rounding noise. So after the last
    step every weight is within 1e-6 except at most 0.1% of each tensor,
    and those are within 2 * 3 * lr, the most three steps can part them."""
    overrides = (dict(tie_word_embeddings=True, fuse_linear_cross_entropy=True)
                 if variant == "tied_fused" else {})
    jax_model, port_model = _tiny_pair(16, **overrides)
    opt_kw = dict(weight_decay=0.1)
    step_j = paddle_tpu.jit.train_step(
        jax_model, lambda m, a, b: m(a, labels=b)[0],
        jax_opt.AdamW(3e-4, parameters=jax_model.parameters(), **opt_kw))
    step_p = port_train_step(
        port_model, lambda m, a, b: m(a, labels=b)[0],
        port_opt.AdamW(3e-4, parameters=port_model.parameters(), **opt_kw))
    x, y = _batch(0)
    for _ in range(3):
        lj = float(step_j(paddle_tpu.to_tensor(x),
                          paddle_tpu.to_tensor(y)).numpy())
        lp = step_p(torch.from_numpy(x), torch.from_numpy(y))
        assert lp.dim() == 0 and not lp.requires_grad
        np.testing.assert_allclose(lp.item(), lj, rtol=1e-5)
    jstate = jax_model.functional_state()
    pstate = dict(port_model.named_parameters())
    assert set(jstate) == set(pstate)
    for name, p in pstate.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        diff = np.abs(p.detach().numpy() - _np(jstate[name]))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 2 * 3 * 3e-4, name


def test_serving_builds_no_graph():
    """Parameters are trainable, yet the serving units run under
    inference mode: nothing they return carries a graph."""
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    _, port_model = _tiny_pair(64)
    assert all(p.requires_grad for p in port_model.parameters())
    eng = ContinuousBatchEngine(port_model, max_batch=2, max_len=64)
    eng.add_request(np.arange(5), max_new_tokens=3)
    assert not eng._last.requires_grad
    eng.run_until_done()
    assert not eng._last.requires_grad
    assert all(not c["k_pages"].requires_grad for c in eng._caches)
    assert all(p.grad is None for p in port_model.parameters())


@pytest.mark.parametrize("option", [dict(recompute=True),
                                    dict(attn_logit_softcapping=50.0),
                                    dict(qk_norm=True)])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="paddle_tpu/models/llama"):
        PortConfig.tiny(**option)
