"""Port parity of the DeepSeek / MoE training slice against the JAX package,
on the CPU with the plain versions: the attention at MLA widths (q/k 192,
v 128) and its gradients against splash in interpret mode at the
lane-padded widths the JAX package builds, the gradient of every
parameter of ``tiny_moe`` and ``tiny_mla`` against ``jax.grad`` of the JAX
loss (with a capacity that drops routes and without), a 3-step f32
``train_step`` trajectory with global-norm clipping and a schedule against
the JAX ``TrainStep``, and the CUDA route of the width-192 backward (its
launches stood in for, as in ``test_torch_attention``). Each test states
its tolerance."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import numpy_state

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.models import deepseek as jax_ds
from paddle_tpu.models import llama_moe as jax_moe
from paddle_tpu.nn.layer import functional_weights
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models import deepseek as port_ds
from paddle_tpu_torch.models import llama_moe as port_moe
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from paddle_tpu_torch.weights import from_jax_state

PRESETS = {
    "tiny_moe": (jax_moe.LlamaMoEForCausalLM, jax_moe.LlamaMoEConfig,
                 port_moe.LlamaMoEConfig),
    "tiny_mla": (jax_ds.DeepseekV2ForCausalLM, jax_ds.DeepseekV2Config,
                 port_ds.DeepseekV2Config),
}
SEQ = 16


def _pair(preset, **kw):
    """(jax_model, port_model, numpy state) of the preset holding the same
    f32 weights; the JAX rope table is built eagerly (see
    test_torch_pair.build_pair)."""
    jax_cls, jax_cfg, port_cfg = PRESETS[preset]
    paddle_tpu.seed(0)
    jax_model = jax_cls(getattr(jax_cfg, preset)(**kw))
    state = numpy_state(jax_model, 0)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(SEQ)
    port_model = from_jax_state(state, getattr(port_cfg, preset)(**kw),
                                device="cpu")
    return jax_model, port_model, state


def _batch(seed=0, batch=2, vocab=512):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(batch, SEQ + 1))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    y[0, :2] = -1                                  # ignored positions
    return x, y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_width_flash_grads_match_splash_interpret(dtype):
    """Causal attention at q/k width 192, v width 128, [1, 256, 2], V2-Lite's
    softmax scale: the plain version and its autograd against ``jax.vjp``
    through splash in interpret mode on q and k zero-padded to 256 lanes,
    as ``_mla_sdpa`` builds them (``deepseek.py:131-141``), sliced back.
    The padded lanes' gradients are exactly 0. f32: forward within 2e-5,
    gradients within 1e-5 (sums in another order); bf16: within 2^-6 times
    the largest entry of each (JAX rounds q * scale to bf16 before splash,
    the port scales in f32)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(21)
    q, k = (rng.randn(1, 256, 2, 192).astype(np.float32) for _ in range(2))
    v, g = (rng.randn(1, 256, 2, 128).astype(np.float32) for _ in range(2))
    scale = 0.1147

    def pad(a):
        return jnp.pad(jnp.asarray(a, jdt), [(0, 0)] * 3 + [(0, 64)])

    want, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_bshd(
            a, b, c, causal=True, sm_scale=scale, interpret=True),
        pad(q), pad(k), jnp.asarray(v, jdt))
    dq_p, dk_p, dv_j = vjp(jnp.asarray(g, jdt))
    assert not np.asarray(dq_p[..., 192:]).any()
    assert not np.asarray(dk_p[..., 192:]).any()
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = port_flash.flash_attention_bshd(*ts, causal=True, sm_scale=scale)
    got.backward(torch.from_numpy(g).to(tdt))
    pairs = [(got, want, 2e-5), (ts[0].grad, dq_p[..., :192], 1e-5),
             (ts[1].grad, dk_p[..., :192], 1e-5), (ts[2].grad, dv_j, 1e-5)]
    for a, b, f32_tol in pairs:
        a = a.detach().float().numpy()
        b = np.asarray(b).astype(np.float32)
        tol = f32_tol if dtype == "float32" else 2.0 ** -6 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _jax_grads(jax_model, state, x, y):
    """(loss, {name: gradient}) of the JAX model's training loss, by
    ``jax.value_and_grad`` over its functional weights (what its
    ``TrainStep`` differentiates)."""
    params = {k: jnp.asarray(v) for k, v in state.items()}

    def loss_of(p):
        with functional_weights(jax_model, p):
            return unwrap(jax_model(wrap(jnp.asarray(x)),
                                    labels=wrap(jnp.asarray(y)))[0])

    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
@pytest.mark.parametrize("preset", ["tiny_moe", "tiny_mla"])
def test_every_gradient_matches_jax_grad(preset, capacity_factor,
                                         monkeypatch):
    """The loss (LM loss + 0.1 x the mean router aux value, so the aux
    term's gradient shows) and the gradient of every parameter against
    ``jax.grad`` of the JAX loss, which differentiates the dense one-hot
    dispatch einsums: the port's index dispatch must give the tokens,
    ``gate_weight`` (through the kept weights and the aux value), the
    experts and the shared experts the same gradients. At capacity factor
    0.5 routes drop (checked). f32: loss within 1e-6 relative, each
    gradient within 1e-5 of its largest entry (sums in another order)."""
    kw = dict(moe_capacity_factor=capacity_factor, router_aux_loss_coef=0.1)
    jax_model, port_model, state = _pair(preset, **kw)
    x, y = _batch(1)
    kept = []
    real = port_moe.dispatch_positions

    def spy(topk_idx, num_experts, capacity):
        slot, keep = real(topk_idx, num_experts, capacity)
        kept.append((int(keep.sum()), keep.numel()))
        return slot, keep

    monkeypatch.setattr(port_moe, "dispatch_positions", spy)
    want_loss, want = _jax_grads(jax_model, state, x, y)
    loss, _ = port_model(torch.from_numpy(x), labels=torch.from_numpy(y))
    loss.backward()
    assert len(kept) == 2                           # two MoE layers
    dropped = sum(n - k for k, n in kept)
    assert (dropped > 0) == (capacity_factor < 1)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    grads = {n: p.grad for n, p in port_model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None, name
        top = np.abs(want[name]).max()
        assert top > 0, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * top, err_msg=name)


def _schedule(lr_mod):
    """Two warm-up steps to 1e-3, then a cosine decay."""
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(1e-3, T_max=8),
                               warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


@pytest.mark.parametrize("preset", ["tiny_moe", "tiny_mla"])
def test_clipped_scheduled_trajectory_matches_jax(preset):
    """Three ``train_step``s on one batch of AdamW(weight_decay=0.1,
    beta2=0.95) with ``ClipGradByGlobalNorm(0.5)`` (below the gradients'
    global norm, checked, so every step clips) and a ``LinearWarmup`` into
    a cosine decay, stepped by the caller after each step as in the JAX
    package; f32 against the JAX ``TrainStep``. Losses within 1e-5
    relative at every step. After step 3 every weight is within 1e-6
    except at most 0.1% of each tensor (Adam steps weights whose gradient
    is at the rounding noise by up to lr), and those within 2 x the sum of
    the three rates."""
    jax_model, port_model, _ = _pair(preset)
    sched_j, sched_p = _schedule(jax_opt.lr), _schedule(port_opt.lr)
    kw = dict(beta2=0.95, weight_decay=0.1)
    step_j = paddle_tpu.jit.train_step(
        jax_model, lambda m, a, b: m(a, labels=b)[0],
        jax_opt.AdamW(sched_j, parameters=jax_model.parameters(),
                      grad_clip=jax_opt.ClipGradByGlobalNorm(0.5), **kw))
    step_p = port_train_step(
        port_model, lambda m, a, b: m(a, labels=b)[0],
        port_opt.AdamW(sched_p, parameters=port_model.parameters(),
                       grad_clip=port_opt.ClipGradByGlobalNorm(0.5), **kw))
    x, y = _batch(0)
    rates = []
    for _ in range(3):
        rates.append(sched_p.get_lr())
        assert sched_j.get_lr() == rates[-1]
        lj = float(step_j(paddle_tpu.to_tensor(x),
                          paddle_tpu.to_tensor(y)).numpy())
        lp = step_p(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(lp.item(), lj, rtol=1e-5)
        norm = torch.sqrt(sum(p.grad.square().sum()
                              for p in port_model.parameters()))
        assert norm > 0.5                        # the clip was active
        sched_j.step()
        sched_p.step()
    assert rates == [1e-4, 5.5e-4, 1e-3]
    jstate = jax_model.functional_state()
    for name, p in port_model.named_parameters():
        diff = np.abs(p.detach().numpy() - np.asarray(jstate[name]))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 2 * sum(rates), name


def _posing_as_cuda(shape, grad=True):
    """A zero CPU leaf whose ``device`` reads as CUDA to the wrappers'
    checks, while what they allocate "on its device" still lands on the
    CPU: the whole CUDA route up to the C calls runs without a card."""
    class _Dev(str):
        type = "cuda"

    class _Fake(torch.Tensor):
        @property
        def device(self):
            return _Dev("cpu")

    return torch.zeros(shape).as_subclass(_Fake).requires_grad_(grad)


def _fake_kernels(monkeypatch, calls):
    """Stand-ins for the launches: every C entry point records its
    arguments and returns 0 (success), on no stream; no device check (the
    tensors autograd makes lie on the CPU); fresh counters."""
    def function(stem, name, argtypes):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda device: None)
    monkeypatch.setattr(_build, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_build, "launches", Counter())


def test_mla_width_backward_cuda_route_counts_and_passes_widths(
        monkeypatch):
    """On a CUDA tensor that needs a gradient, causal attention at q/k 192,
    v 128 goes through the autograd Function: the forward launches the
    append kernel with lse under ``flash_attention_mla``, the backward
    launches ``pt_flash_attention_bwd`` with widths (192, 128), no window,
    V2-Lite's scale, counted once as ``flash_attention_mla_bwd``; the
    gradients have the inputs' shapes."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    q, k = (_posing_as_cuda((1, 64, 4, 192)) for _ in range(2))
    v = _posing_as_cuda((1, 64, 4, 128))
    out = port_flash.flash_attention_bshd(q, k, v, causal=True,
                                          sm_scale=0.1147)
    assert out.grad_fn is not None and tuple(out.shape) == (1, 64, 4, 128)
    out.sum().backward()
    assert [name for name, _ in calls] == ["pt_append_attention",
                                           "pt_flash_attention_bwd"]
    fwd, bwd = calls[0][1], calls[1][1]
    assert fwd[5] is not None                      # lse written
    assert fwd[6:15] == (1, 64, 64, 4, 4, 192, 128, 0, 0)
    # B, S, T, H, hk, pos, window, q/k width, v width, then the scale
    assert bwd[10:19] == (1, 64, 64, 4, 4, 0, 0, 192, 128)
    assert abs(bwd[19] - 0.1147) < 1e-7
    assert dict(_build.launches) == {"flash_attention_mla": 1,
                                     "flash_attention_mla_bwd": 1}
    assert [tuple(t.grad.shape) for t in (q, k, v)] == [
        (1, 64, 4, 192), (1, 64, 4, 192), (1, 64, 4, 128)]
    assert port_flash._counters(None, 192) == ("flash_attention_mla",
                                                "flash_attention_mla_bwd")


def test_mla_width_window_raises_on_cuda():
    """A window at q/k width 192 stays unported on CUDA (no model needs
    it), with or without a gradient; the CPU runs the plain version."""
    for grad in (False, True):
        q, k = (_posing_as_cuda((1, 16, 2, 192), grad) for _ in range(2))
        v = _posing_as_cuda((1, 16, 2, 128), False)
        with pytest.raises(NotImplementedError, match="window"):
            port_flash.flash_attention_bshd(q, k, v, causal=True, window=8)
    q = torch.zeros(1, 16, 2, 192)
    out = port_flash.flash_attention_bshd(q, q, torch.zeros(1, 16, 2, 128),
                                          causal=True, window=8)
    assert tuple(out.shape) == (1, 16, 2, 128)
