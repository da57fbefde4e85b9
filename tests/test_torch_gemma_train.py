"""Gemma training at head width 256 and the train step's
``FLAGS_check_nan_inf`` route, against the JAX package on the CPU.

- (a) ``flash_attention_bwd_plain`` (the backward kernels' plain version)
  at (256, 256), causal, local (window 48) and full, against
  ``torch.autograd`` through the plain forward: f32, within 1e-5 (sums in
  another order), as ``test_torch_attention`` holds the other widths.
- (b) The port's flash gradients at [1, 128, 4 | 2, 256], causal and full,
  against ``jax.vjp`` through JAX's ``flash_attention_bshd`` in Pallas
  interpret mode (splash's own dq / dkv kernels): f32, forward within 2e-5
  and gradients within 1e-5.
- (c) Three AdamW ``train_step``s of Gemma and Gemma2 at ``tiny(head_dim=
  256)`` (two layers), sequence 128, f32, from the same numpy weights,
  against JAX's ``paddle.jit.train_step``: the tied head (Gemma through the
  fused loss, Gemma2 through the capped logits), the (1 + w) norms, the
  scaled embedding, GeGLU and Gemma2's capped attention. Losses within
  1e-5 relative at every step; after the last step every weight within
  1e-6 but at most 0.1% of each tensor, and those within 2 x 3 x lr (the
  reason is ``test_torch_train.test_train_step_matches_jax``'s).
- (d) The CUDA routes at 256 with stand-in launches: a Gemma attention
  layer under autograd launches ``flash_attention_256`` and
  ``flash_attention_bwd_256`` once each; the local and full kinds and the
  ring hop at 256 count under their kind's counters.
- (e) ``FLAGS_check_nan_inf``: a weight poisoned with NaN (as
  ``tests/test_extension_checks.py`` poisons one) makes both packages'
  steps raise ``FloatingPointError``; the port's parameters and AdamW
  state are then bit-identical to before the step (no state at all
  before a first step), and the next step on clean weights passes in
  both (one layer: the JAX step under ``checkify`` compiles in half the
  time of two); an Inf in an AdamW moment (finite loss and gradients, an
  Inf written by the update) raises and is put back too. With the flag on
  and off the port's clean steps give the same losses and parameters, bit
  for bit.

The pairs are built once in this module (``gemma_pair``); each JAX train
step is jitted and traced once."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gemma import FAMILIES, _pair
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from paddle_tpu_torch.utils.flags import flag_overrides

SEQ, D, LR, STEPS = 128, 256, 3e-4, 3
# (c): Gemma through the chunked fused loss, Gemma2 through the logits
# (its final softcap refuses the fused loss, as in JAX)
TRAIN = {"gemma": dict(fuse_linear_cross_entropy=True), "gemma2": {}}
POISONED = "llama.layers.0.mlp.up_proj.weight"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def gemma_pair(family, layers=2, seed=5):
    """(jax_model, port_model, numpy state) of ``family`` at ``tiny(head_dim
    =256)`` with its training loss route and ``layers`` layers, f32."""
    jcfg, jlm, pcfg, _ = FAMILIES[family]
    kw = dict(head_dim=D, num_hidden_layers=layers, **TRAIN[family])
    return _pair(jcfg.tiny(**kw), jlm, pcfg.tiny(**kw), seed)


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, 512, size=(1, SEQ + 1))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def _loss(m, x, y):
    return m(x, labels=y)[0]


def _fresh_port(family, layers=2):
    """A port model holding the pair's numpy weights (each test mutates
    its own)."""
    from paddle_tpu_torch.weights import from_jax_state

    _, port_model, state = gemma_pair(family, layers)
    return from_jax_state(state, port_model.config, device="cpu")


def _fresh_jax(family, layers=2):
    jax_model, _, state = gemma_pair(family, layers)
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    return jax_model


# ------------------------------------------------------- (a) the plain bwd --

@pytest.mark.parametrize("kind,s_q,s_kv", [("causal", 128, 128),
                                           ("causal", 96, 160),
                                           ("local", 128, 128),
                                           ("full", 96, 160)])
def test_flash_bwd_plain_at_256_is_the_gradient(kind, s_q, s_kv):
    rng = np.random.RandomState(21)
    q = _t(rng.randn(1, s_q, 4, D).astype(np.float32)).requires_grad_()
    k = _t(rng.randn(1, s_kv, 2, D).astype(np.float32)).requires_grad_()
    v = _t(rng.randn(1, s_kv, 2, D).astype(np.float32)).requires_grad_()
    dout = _t(rng.randn(1, s_q, 4, D).astype(np.float32))
    scale = 1.0 / math.sqrt(D)
    window = 48 if kind == "local" else None
    out = port_flash.flash_attention_plain(q, k, v, causal=kind != "full",
                                           sm_scale=scale, window=window)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = port_flash.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), dout, scale,
        window=window, full=kind == "full")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# --------------------------------------------- (b) against splash's VJP --

@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_at_256_match_splash_interpret(causal):
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(1, SEQ, n, D).astype(np.float32) for n in (4, 2, 2))
    g = rng.randn(1, SEQ, 4, D).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_bshd(
            a, b, c, causal=causal, interpret=True),
        *(jnp.asarray(t) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [_t(t).requires_grad_() for t in (q, k, v)]
    got = port_flash.flash_attention_bshd(*ts, causal=causal)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------- (c) train-step parity --

@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family):
    jax_model, port_model = _fresh_jax(family), _fresh_port(family)
    opt_kw = dict(weight_decay=0.1)
    step_j = paddle_tpu.jit.train_step(
        jax_model, _loss,
        jax_opt.AdamW(LR, parameters=jax_model.parameters(), **opt_kw))
    step_p = port_train_step(
        port_model, _loss,
        port_opt.AdamW(LR, parameters=port_model.parameters(), **opt_kw))
    x, y = _batch(0)
    for _ in range(STEPS):
        lj = float(step_j(paddle_tpu.to_tensor(x),
                          paddle_tpu.to_tensor(y)).numpy())
        lp = step_p(_t(x), _t(y))
        np.testing.assert_allclose(lp.item(), lj, rtol=1e-5)
    jstate = jax_model.functional_state()
    pstate = dict(port_model.named_parameters())
    assert set(jstate) == set(pstate)
    for name, p in pstate.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        diff = np.abs(p.detach().numpy() - np.asarray(jstate[name]))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 2 * STEPS * LR, name


# ------------------------------------------------------ (d) CUDA routes --

def test_gemma_attention_under_autograd_launches_the_256_kernels(
        fake_kernels):
    """A Gemma attention layer's training forward and backward on "CUDA"
    tensors: RoPE on q and k, the causal forward at (256, 256) with its
    lse, and the backward kernels at (256, 256), kind 0."""
    model = GemmaForCausalLM(GemmaConfig.tiny(head_dim=D), device="cpu")
    attn = model.llama.layers[0].self_attn
    cos, sin = model.llama._rope(64)
    x = posing_as_cuda(torch.randn(1, 64, model.config.hidden_size), True)
    attn(x, cos, sin).sum().backward()
    assert dict(_build.launches) == {"fused_rope": 2,
                                     "flash_attention_256": 1,
                                     "flash_attention_bwd_256": 1}
    fwd, bwd = [args for name, args in fake_kernels
                if name in ("pt_append_attention", "pt_flash_attention_bwd")]
    assert fwd[5] is not None and fwd[11:13] == (256, 256) and fwd[16] == 0
    # B, S, T, H, hk, pos, window, q/k width, v width; kind
    assert bwd[10:19] == (1, 64, 64, 4, 2, 0, 0, 256, 256) and bwd[20] == 0


@pytest.mark.parametrize("kind,counters", [
    ("local", ("flash_attention_local", "flash_attention_local_bwd")),
    ("full", ("flash_attention_full", "flash_attention_full_bwd"))])
def test_masks_at_256_count_under_their_kind(kind, counters, fake_kernels):
    q = posing_as_cuda(torch.zeros(1, 64, 4, D), True)
    k, v = (posing_as_cuda(torch.zeros(1, 64, 2, D), True) for _ in range(2))
    out = port_flash.flash_attention_bshd(
        q, k, v, causal=kind == "local",
        window=32 if kind == "local" else None)
    out.sum().backward()
    assert dict(_build.launches) == dict.fromkeys(counters, 1)
    code = {"local": 1, "full": 2}[kind]
    fwd, bwd = fake_kernels[0][1], fake_kernels[1][1]
    assert fwd[11:13] == (256, 256) and fwd[16] == code
    assert bwd[17:19] == (256, 256) and bwd[20] == code
    assert bwd[16] == (32 if kind == "local" else 0)


@pytest.mark.parametrize("kind", ["full", "causal", "local"])
def test_ring_hop_at_256_launches_splash_hop(kind, fake_kernels):
    q = posing_as_cuda(torch.zeros(1, 64, 4, D))
    k = posing_as_cuda(torch.zeros(1, 64, 2, D))
    out, lse = port_flash.hop_bshd(q, k, k, kind, offset=64,
                                   window=96 if kind == "local" else None)
    assert out.shape == (1, 64, 4, D) and lse.shape == (1, 4, 64)
    assert dict(_build.launches) == {"splash_hop": 1}
    assert fake_kernels[0][1][11:13] == (256, 256)


# ---------------------------------------------- (e) FLAGS_check_nan_inf --

def _poison(w):
    with torch.no_grad():
        w[0, 0] = float("nan")


def _state_bits(opt):
    return {name: {k: t.clone() for k, t in st.items()}
            for name, st in opt._state.items()}


@pytest.mark.parametrize("clean_steps", [0, 1])
def test_nan_check_raises_and_commits_nothing(clean_steps):
    """A poisoned step after ``clean_steps`` clean ones raises; every
    parameter and the AdamW state (step count, moments, masters) is
    bit-identical to before it; with the weight cleaned the next step
    passes and matches a run that never saw the poison."""
    x, y = (_t(a) for a in _batch(1))
    runs = []
    for poisoned in (True, False):
        model = _fresh_port("gemma", layers=1)
        opt = port_opt.AdamW(LR, parameters=model.parameters(),
                             weight_decay=0.1)
        with flag_overrides({"check_nan_inf": True}):
            step = port_train_step(model, _loss, opt)
        losses = [step(x, y).item() for _ in range(clean_steps)]
        if poisoned:
            w = dict(model.named_parameters())[POISONED]
            clean = w.detach().clone()
            _poison(w)
            params = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            state, n_step = _state_bits(opt), opt._step
            with pytest.raises(FloatingPointError,
                               match="NaN/Inf.*FLAGS_check_nan_inf"):
                step(x, y)
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), params[n]) or (
                    n == POISONED and torch.equal(
                        torch.nan_to_num(p.detach()),
                        torch.nan_to_num(params[n]))), n
            assert opt._step == n_step
            assert set(opt._state) == set(state)
            for n, st in state.items():
                assert set(opt._state[n]) == set(st), n
                for key, t in st.items():
                    assert torch.equal(opt._state[n][key], t), (n, key)
            with torch.no_grad():
                w.copy_(clean)
        losses.append(step(x, y).item())
        assert np.isfinite(losses[-1])
        runs.append((losses, {n: p.detach().clone()
                              for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


def test_nan_check_sees_what_the_update_writes():
    """An Inf in one AdamW moment: the loss and every gradient stay
    finite, the update writes an Inf parameter, and the step raises with
    every parameter and state tensor put back bit for bit."""
    x, y = (_t(a) for a in _batch(1))
    model = _fresh_port("gemma", layers=1)
    opt = port_opt.AdamW(LR, parameters=model.parameters(), weight_decay=0.1)
    with flag_overrides({"check_nan_inf": True}):
        step = port_train_step(model, _loss, opt)
    step(x, y)
    with torch.no_grad():
        opt._state[POISONED]["moment1"][0, 0] = float("inf")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = _state_bits(opt)
    with pytest.raises(FloatingPointError, match="NaN/Inf"):
        step(x, y)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    for n, st in state.items():
        for key, t in st.items():
            assert torch.equal(opt._state[n][key], t), (n, key)


def test_nan_check_raises_in_jax_too():
    """The JAX ``TrainStep`` under the flag on the same poisoned weight
    raises, and passes on the cleaned one."""
    jax_model = _fresh_jax("gemma", layers=1)
    x, y = (paddle_tpu.to_tensor(a) for a in _batch(1))
    state = jax_model.functional_state()
    clean = state[POISONED]
    paddle_tpu.set_flags({"FLAGS_check_nan_inf": True})
    try:
        step = paddle_tpu.jit.train_step(
            jax_model, _loss,
            jax_opt.AdamW(LR, parameters=jax_model.parameters(),
                          weight_decay=0.1))
    finally:
        paddle_tpu.set_flags({"FLAGS_check_nan_inf": False})
    jax_model.load_functional_state(
        {POISONED: clean.at[0, 0].set(jnp.nan)})
    with pytest.raises(FloatingPointError, match="NaN/Inf"):
        step(x, y)
    jax_model.load_functional_state({POISONED: clean})
    assert np.isfinite(float(step(x, y).numpy()))


def test_flag_off_step_is_unchanged():
    """With the flag off, the step is the one it was: the same losses and
    parameters as with the flag on over three clean steps, bit for bit,
    and no copy kept."""
    x, y = (_t(a) for a in _batch(2))
    runs = []
    for on in (False, True):
        model = _fresh_port("gemma", layers=1)
        with flag_overrides({"check_nan_inf": on}):
            step = port_train_step(
                model, _loss, port_opt.AdamW(LR, parameters=model.parameters(),
                                             weight_decay=0.1))
        assert step._checked is on
        runs.append(([step(x, y).item() for _ in range(STEPS)],
                     [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
