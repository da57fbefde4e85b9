"""Port parity of the splash FullMask, the ring hop ``splash_hop`` and the
Paddle flash-attention functional API (plain versions, CPU) against the
JAX package: splash in Pallas interpret mode for the kernels' functions,
the JAX functionals on the same arrays for the API, and the CUDA routes
with stand-in launches. f32 unless a test says otherwise; tolerance 2e-5
for sums taken in another order."""
import math
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn import functional as jax_incubate
from paddle_tpu.nn.functional import attention as jax_attn
from paddle_tpu.nn.functional import extra as jax_extra
from paddle_tpu.nn.functional import flash_attention as jax_fa_module
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch.incubate.nn import functional as port_incubate
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.nn.functional import attention as port_attn
from paddle_tpu_torch.nn.functional import flash_attention as port_fa_module
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """numpy of a JAX array or a ``paddle_tpu`` Tensor."""
    return np.asarray(getattr(x, "_array", x))


def _qkv(B, S, T, H, hk, D=128, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32))


# ------------------------------------------------------------- FullMask --

@pytest.mark.parametrize("s_q,s_kv,hk", [
    (256, 256, 2), (128, 384, 8), (384, 128, 2)])
def test_flash_full_mask_matches_splash_interpret(s_q, s_kv, hk):
    """``causal=False`` (splash's FullMask) square, s_kv > s_q and s_kv <
    s_q, GQA 8 / 2 and MHA, against splash in interpret mode."""
    q, k, v = _qkv(1, s_q, s_kv, 8, hk, seed=s_q + hk)
    want = np.asarray(jax_flash.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        interpret=True))
    got = port_flash.flash_attention_bshd(_t(q), _t(k), _t(v),
                                          causal=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype,s_q,s_kv", [
    ("float32", 256, 256), ("float32", 128, 256), ("float32", 256, 128),
    ("bfloat16", 256, 256)])
def test_flash_full_mask_grads_match_splash_interpret(dtype, s_q, s_kv):
    """Forward and (dq, dk, dv) of the FullMask at [1, s_q, 4 | 2, 128]
    against ``jax.grad`` through splash in interpret mode (its dq and dkv
    kernels). f32: forward within 2e-5, gradients within 1e-5; bf16: within
    2^-6 times the largest entry of each (JAX rounds q * scale to bf16
    before splash, the port scales in f32)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _qkv(1, s_q, s_kv, 4, 2, seed=31)
    g = np.random.RandomState(32).randn(*q.shape).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_bshd(
            a, b, c, causal=False, interpret=True),
        *(jnp.asarray(t, jdt) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jdt))
    ts = [_t(t).to(tdt).requires_grad_() for t in (q, k, v)]
    got = port_flash.flash_attention_bshd(*ts, causal=False)
    got.backward(_t(g).to(tdt))
    pairs = [(got, want, ATOL)] + [(t.grad, w, 1e-5)
                                   for t, w in zip(ts, want_grads)]
    for a, b, f32_tol in pairs:
        a = a.detach().float().numpy()
        b = np.asarray(b).astype(np.float32)
        tol = f32_tol if dtype == "float32" else 2.0 ** -6 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("s_q,s_kv,hk", [
    (200, 200, 2), (100, 300, 4), (300, 100, 1)])
def test_flash_full_bwd_plain_is_the_gradient(s_q, s_kv, hk):
    """``flash_attention_bwd_plain(full=True)`` (the full-mask backward
    kernel's plain version, delta from the given out) against autograd
    through the plain full forward, square and both rectangular: f32,
    within 1e-5."""
    rng = np.random.RandomState(41)
    q = _t(rng.randn(1, s_q, 4, 128).astype(np.float32)).requires_grad_()
    k = _t(rng.randn(1, s_kv, hk, 128).astype(np.float32)).requires_grad_()
    v = _t(rng.randn(1, s_kv, hk, 128).astype(np.float32)).requires_grad_()
    dout = _t(rng.randn(1, s_q, 4, 128).astype(np.float32))
    scale = 0.0884
    out = port_flash.flash_attention_plain(q, k, v, causal=False,
                                           sm_scale=scale)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = port_flash.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), dout, scale,
        full=True)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# ----------------------------------------------------------- splash_hop --

HOP_CASES = [("full", 0, None), ("causal", 0, None)] + [
    ("local", off, w) for off in (0, 128, 256) for w in (96, 128, 200)]


@pytest.mark.parametrize("kind,offset,window", HOP_CASES)
def test_splash_hop_matches_jax_interpret(kind, offset, window):
    """``splash_hop`` ([B, H, S, D], q pre-scaled, GQA 4 / 2; out and lse)
    against JAX's in interpret mode, blocks of 256 as a ring hop's, on the
    rows that see a column. A row
    that sees none (a local hop's band past the block) gives out 0 and lse
    -inf in the port, a finite, hugely negative lse (or -inf) in splash;
    no NaN on either side."""
    rng = np.random.RandomState(offset + (window or 0))
    S = T = 256
    q = (rng.randn(1, 4, S, 128) / math.sqrt(128)).astype(np.float32)
    k = rng.randn(1, 2, T, 128).astype(np.float32)
    v = rng.randn(1, 2, T, 128).astype(np.float32)
    w_out, w_lse = (np.asarray(a) for a in jax_flash.splash_hop(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kind, offset=offset,
        window=window, interpret=True))
    g_out, g_lse = (a.numpy() for a in port_flash.splash_hop(
        _t(q), _t(k), _t(v), kind, offset=offset, window=window))
    rows = np.arange(S)[:, None] + offset
    cols = np.arange(T)[None, :]
    if kind == "full":
        seen = np.ones((S, T), bool)
    else:
        seen = cols <= rows
        if kind == "local":
            seen &= cols > rows - window
    live = seen.any(1)
    assert not np.isnan(g_out).any() and not np.isnan(g_lse).any()
    assert not np.isnan(w_lse).any()
    np.testing.assert_allclose(g_out[:, :, live], w_out[:, :, live], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(g_lse[:, :, live], w_lse[:, :, live], rtol=0,
                               atol=ATOL)
    assert (g_out[:, :, ~live] == 0).all()
    assert np.isneginf(g_lse[:, :, ~live]).all()
    assert (w_lse[:, :, ~live] < -1e30).all()
    if kind == "local" and offset == 256 and window == 96:
        # hop 1 of a ring of 256-token blocks: rows 95-255 see no column
        assert list(np.flatnonzero(~live)) == list(range(95, 256))


# ------------------------------------------------------- functional API --

@pytest.fixture
def interpret(monkeypatch):
    """Both packages' kernel gates count the CPU as the device: JAX runs
    splash in interpret mode, the port the kernels' plain versions, each
    where its ``supported`` holds. Returns the shapes of the port's calls
    into ``flash_attention_bshd`` (the kernel route)."""
    supported, bshd = jax_flash.supported, jax_flash.flash_attention_bshd
    monkeypatch.setattr(jax_flash, "supported",
                        lambda q, k, v, dropout=0.0, interpret=False:
                        supported(q, k, v, dropout, interpret=True))
    monkeypatch.setattr(jax_flash, "flash_attention_bshd",
                        lambda *a, **kw: bshd(*a, interpret=True, **kw))
    port_supported, port_bshd = (port_flash.supported,
                                 port_flash.flash_attention_bshd)
    routed = []
    monkeypatch.setattr(port_flash, "supported",
                        lambda q, k, v, dropout=0.0, interpret=False:
                        port_supported(q, k, v, dropout, interpret=True))
    monkeypatch.setattr(port_flash, "flash_attention_bshd",
                        lambda q, *a, **kw: (routed.append(tuple(q.shape)),
                                             port_bshd(q, *a, **kw))[1])
    return routed


@pytest.mark.parametrize("causal,S,hk", [
    (False, 256, 2), (True, 256, 2), (False, 256, 8), (True, 100, 2)])
def test_flash_attention_functional_matches(causal, S, hk, interpret):
    """``flash_attention`` causal and not, GQA and MHA, on the kernel route
    (splash interpret / the port's flash plain version) and, at S = 100,
    on the composite fallback with GQA heads expanded: ``(out, None)``."""
    q, k, v = _qkv(1, S, S, 8, hk, seed=S + hk + causal)
    want, w_sm = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got, g_sm = port_F.flash_attention.flash_attention(
        _t(q), _t(k), _t(v), causal=causal)
    assert w_sm is None and g_sm is None
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    assert interpret == ([(1, S, 8, 128)] if S % 128 == 0 else [])
    # the module is callable, as the JAX one is
    again, _ = port_F.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(again, got)


@pytest.mark.parametrize("causal,scale", [(False, None), (True, 0.05)])
def test_flash_attn_unpadded_matches(causal, scale, interpret):
    """A packed batch of segments 256, 128 (the kernel route) and 100 (the
    composite, as in JAX), custom scale folded into q."""
    lens = [256, 128, 100]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rng = np.random.RandomState(51)
    q, k, v = (rng.randn(int(cu[-1]), 4, 128).astype(np.float32)
               for _ in range(3))
    want = jax_attn.flash_attn_unpadded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu),
        jnp.asarray(cu), max(lens), max(lens), scale=scale, causal=causal)
    got = port_attn.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu), _t(cu),
                                        max(lens), max(lens), scale=scale,
                                        causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    assert interpret == [(1, 256, 4, 128), (1, 128, 4, 128)]


@pytest.mark.parametrize("packed", ["qkvpacked", "varlen"])
def test_flash_attn_packed_forms_match(packed, interpret):
    """``flash_attn_qkvpacked`` [B, S, 3, H, D] and
    ``flash_attn_varlen_qkvpacked`` [total, 3, H, D] (segments 128 and
    100) against the JAX functions."""
    rng = np.random.RandomState(52)
    if packed == "qkvpacked":
        qkv = rng.randn(2, 128, 3, 4, 128).astype(np.float32)
        want = jax_extra.flash_attn_qkvpacked(jnp.asarray(qkv), causal=True)
        got = port_fa_module.flash_attn_qkvpacked(_t(qkv), causal=True)
    else:
        qkv = rng.randn(228, 3, 4, 128).astype(np.float32)
        cu = np.array([0, 128, 228], np.int32)
        want = jax_extra.flash_attn_varlen_qkvpacked(
            jnp.asarray(qkv), jnp.asarray(cu), jnp.asarray(cu), 128, 128,
            causal=True)
        got = port_F.flash_attn_varlen_qkvpacked(_t(qkv), _t(cu), _t(cu),
                                                 128, 128, causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "scale", "bias"])
def test_memory_efficient_attention_matches(case, interpret):
    """Bias-free (the full-mask flash route), with a custom scale folded
    into q, and with an additive bias (the composite)."""
    q, k, v = _qkv(2, 128, 128, 4, 4, seed=53)
    bias = None
    if case == "bias":
        bias = np.random.RandomState(54).randn(2, 4, 128, 128).astype(
            np.float32)
    scale = 0.07 if case != "plain" else None
    want = jax_incubate.memory_efficient_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_bias=None if bias is None else jnp.asarray(bias), scale=scale)
    got = port_incubate.memory_efficient_attention(
        _t(q), _t(k), _t(v), attn_bias=None if bias is None else _t(bias),
        scale=scale)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    assert interpret == ([] if case == "bias" else [(2, 128, 4, 128)])


@pytest.mark.parametrize("mask_kind", ["bool", "additive", "causal"])
def test_scaled_dot_product_attention_matches(mask_kind):
    """SDPA with a bool mask, an additive mask, and ``is_causal`` on a
    rectangular shape (bottom-aligned)."""
    rng = np.random.RandomState(55)
    q = rng.randn(2, 48, 4, 64).astype(np.float32)
    k = rng.randn(2, 80, 4, 64).astype(np.float32)
    v = rng.randn(2, 80, 4, 64).astype(np.float32)
    mask, causal = None, mask_kind == "causal"
    if mask_kind == "bool":
        mask = rng.rand(2, 1, 48, 80) > 0.3
        mask[..., 0] = True
    elif mask_kind == "additive":
        mask = rng.randn(1, 4, 48, 80).astype(np.float32)
    want = jax_attn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=None if mask is None else jnp.asarray(mask),
        is_causal=causal)
    got = port_F.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask),
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


def test_sdpa_softcap_matches():
    """``_sdpa_ref``'s tanh soft cap, causal, against the JAX one."""
    q, k, v = _qkv(1, 64, 64, 2, 2, D=32, seed=56)
    want = jax_attn._sdpa_ref(jnp.asarray(q) * 4, jnp.asarray(k),
                              jnp.asarray(v), causal=True, softcap=5.0)
    got = port_attn._sdpa_ref(_t(q) * 4, _t(k), _t(v), causal=True,
                              softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_reduced_scores_and_triangle_mask_match():
    """``calc_reduced_attention_scores`` from the lse of the scores, and
    ``get_triangle_upper_mask``, against the JAX module's."""
    q, k, _ = _qkv(2, 64, 96, 4, 4, D=32, seed=57)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(32)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    want = jax_fa_module.calc_reduced_attention_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse.astype(np.float32)))
    got = port_fa_module.calc_reduced_attention_scores(
        _t(q), _t(k), _t(lse.astype(np.float32)))
    assert tuple(got.shape) == (2, 4, 1, 96)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    x = np.zeros((2, 4, 8, 8), np.float32)
    np.testing.assert_array_equal(
        port_fa_module.get_triangle_upper_mask(_t(x)).numpy(),
        _np(jax_fa_module.get_triangle_upper_mask(jnp.asarray(x))))


@pytest.mark.parametrize("api", ["sdpa", "flash", "memory_efficient"])
def test_dropout_shape_and_statistics(api):
    """Dropout 0.5 while training: the RNG streams differ from JAX's, so
    only the shape and the statistics are held. With v = 1 every output
    entry is sum_j keep_j p_j / (1 - p): mean 1 over many entries, not all
    equal to 1; with ``training=False`` no dropout (every entry 1)."""
    torch.manual_seed(0)
    q = torch.randn(1, 256, 4, 128)
    k = torch.randn(1, 256, 4, 128) * 0.01       # near-uniform probs
    v = torch.ones(1, 256, 4, 128)

    def call(training):
        if api == "sdpa":
            return port_F.scaled_dot_product_attention(
                q, k, v, dropout_p=0.5, training=training)
        if api == "flash":
            return port_F.flash_attention(q, k, v, dropout=0.5,
                                          training=training)[0]
        return port_incubate.memory_efficient_attention(
            q, k, v, p=0.5, training=training)

    out = call(True)
    assert tuple(out.shape) == (1, 256, 4, 128)
    assert abs(float(out.mean()) - 1.0) < 0.02
    assert float(out.std()) > 0.01
    torch.testing.assert_close(call(False), v, rtol=0, atol=1e-5)


# ------------------------------------------------------------ CUDA routes --

@pytest.mark.parametrize("case,route", [
    ("supported", "kernel"), ("gqa_causal", "kernel"),
    ("short_seq", "plain"), ("width_64", "plain"), ("uneven_gqa", "plain"),
    ("dropout", "plain"), ("width_256", "kernel"), ("width_384", "raises")])
def test_functional_routes_on_cuda(case, route, fake_kernels, monkeypatch):
    """``flash_attention`` on a CUDA tensor: the kernel exactly where the
    JAX ``supported`` holds (sequence and width multiples of 128, whole GQA
    groups, no dropout), Gemma's width 256 included; the plain composite (a
    stand-in here, recording the call) where it does not; a width
    ``supported`` takes but the kernel lacks (384) raises."""
    plain = []
    monkeypatch.setattr(
        port_attn, "_sdpa_ref",
        lambda q, k, v, **kw: (plain.append(kw["dropout"]),
                               torch.zeros(q.shape[:3] + v.shape[3:]))[1])
    S = 100 if case == "short_seq" else 128
    D = {"width_64": 64, "width_256": 256, "width_384": 384}.get(case, 128)
    H, hk = (6, 4) if case == "uneven_gqa" else (8, 2)
    q = posing_as_cuda(torch.randn(1, S, H, D))
    k, v = (posing_as_cuda(torch.randn(1, S, hk, D)) for _ in range(2))
    kw = dict(causal=case == "gqa_causal",
              dropout=0.1 if case == "dropout" else 0.0)
    if route == "raises":
        with pytest.raises(NotImplementedError, match="head widths"):
            port_F.flash_attention(q, k, v, **kw)
        return
    out, _ = port_F.flash_attention(q, k, v, **kw)
    assert tuple(out.shape) == (1, S, H, D)
    want = {"kernel": [("flash_attention_bshd" if kw["causal"]
                        else "flash_attention_full")], "plain": []}[route]
    assert list(_build.launches) == want
    assert plain == ([kw["dropout"]] if route == "plain" else [])
    if route == "kernel":
        assert fake_kernels[0][1][16] == (0 if kw["causal"] else 2)


@pytest.mark.parametrize("kind,offset,window,code", [
    ("full", 0, None, 2), ("causal", 0, None, 0), ("causal", 384, None, 0),
    ("local", 4096, 4096, 1)])
def test_splash_hop_cuda_route(kind, offset, window, code, fake_kernels):
    """``splash_hop`` on a CUDA tensor launches the forward kernel with lse
    at pos = offset under the hop's mask kind, scale 1, counted as
    ``splash_hop``, for every kind and offset; it refuses inputs that need
    a gradient (no backward, as splash's residual output has none)."""
    q = posing_as_cuda(torch.zeros(2, 4, 64, 128))
    k, v = (posing_as_cuda(torch.zeros(2, 2, 64, 128)) for _ in range(2))
    out, lse = port_flash.splash_hop(q, k, v, kind, offset=offset,
                                     window=window)
    assert tuple(out.shape) == (2, 4, 64, 128)
    assert tuple(lse.shape) == (2, 4, 64)
    args = fake_kernels[0][1]
    assert args[6:15] == (2, 64, 64, 4, 2, 128, 128, offset, window or 0)
    assert args[15] == 1.0 and args[16] == code
    assert dict(_build.launches) == {"splash_hop": 1}
    with pytest.raises(RuntimeError, match="no backward"):
        port_flash.splash_hop(posing_as_cuda(torch.zeros(2, 4, 64, 128),
                                              True), k, v, kind,
                              offset=offset, window=window)
