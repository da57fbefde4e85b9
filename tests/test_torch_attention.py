"""Port parity of the attention kernels' modules (plain versions, CPU)
against the JAX package: append attention and splash flash attention in
Pallas interpret mode, causal and sliding-window (the flash gradients
through splash's own backward kernels; the full mask's CUDA route and
refusals, its parity being in ``test_torch_functional_attention``), paged
decode through ``paged_decode_attention`` (its gather reference off the
TPU) and the windowed band gather. f32 unless a test says otherwise; tolerance 2e-5
for sums taken in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import generation as jax_gen
from paddle_tpu.ops.pallas import append_attention as jax_append
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch import generation as port_gen
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from paddle_tpu_torch.ops.hopper import paged_attention as port_paged
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(B, S, T, H, hk, D=128, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32),
            rng.randn(B, T, hk, D).astype(np.float32))


@pytest.mark.parametrize("pos", [0, 50, 100])
@pytest.mark.parametrize("ragged", [False, True])
def test_append_attention_matches_pallas_interpret(pos, ragged):
    B, S, T, H, hk = 2, 16, 256, 8, 2          # g = 4, D = 128
    q, k, v = _qkv(B, S, T, H, hk, seed=pos)
    allowed = None
    if ragged:
        allowed = np.zeros((B, T), bool)
        allowed[0, :pos + S] = True
        allowed[1, :pos + S // 2] = True        # row 1 right-padded
    want = np.asarray(jax_append.append_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
        allowed=None if allowed is None else jnp.asarray(allowed),
        interpret=True))
    got = port_append.append_attention(
        _t(q), _t(k), _t(v), pos,
        allowed=None if allowed is None else _t(allowed)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flash_attention_causal_matches_splash_interpret():
    B, S, H, hk = 1, 256, 8, 2
    q, k, v = _qkv(B, S, S, H, hk, seed=3)
    want = np.asarray(jax_flash.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    got = port_flash.flash_attention_bshd(_t(q), _t(k), _t(v),
                                          causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s_q,s_kv,hk,window", [
    (256, 256, 2, 64), (256, 256, 8, 100), (128, 256, 2, 100)])
def test_flash_attention_local_matches_splash_interpret(s_q, s_kv, hk, window):
    """The sliding-window LocalMask (query i sees kv columns j with
    i + s_kv - s_q - window < j <= i + s_kv - s_q) against splash in
    interpret mode, square and rectangular, grouped and not; f32."""
    q, k, v = _qkv(1, s_q, s_kv, 8, hk, seed=window + s_q)
    want = np.asarray(jax_flash.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, interpret=True))
    got = port_flash.flash_attention_bshd(_t(q), _t(k), _t(v), causal=True,
                                          window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flash_forward_is_append_attention_at_the_bottom_offset():
    """The CUDA route of the causal flash forward is the append kernel at
    pos = s_kv - s_q; their plain versions agree on a rectangular shape."""
    q, k, v = _qkv(1, 16, 48, 4, 1, seed=5)
    a = port_flash.flash_attention_plain(_t(q), _t(k), _t(v), causal=True)
    b = port_append.append_attention_plain(_t(q), _t(k), _t(v), 48 - 16)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)


def _paged_inputs(seed=0, B=3, H=8, hk=2, D=128, ps=16, pps=6):
    rng = np.random.RandomState(seed)
    n_pages = B * pps
    page_indices = rng.permutation(n_pages).astype(np.int32).reshape(B, pps)
    lengths = np.array([1, 37, pps * ps], np.int32)[:B]   # ragged, full row
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(hk, n_pages, ps, D).astype(np.float32)
    vp = rng.randn(hk, n_pages, ps, D).astype(np.float32)
    return q, kp, vp, lengths, page_indices


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_matches_paged_decode(seed):
    q, kp, vp, lengths, page_indices = _paged_inputs(seed)
    want = np.asarray(jax_gen.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(page_indices)))
    got = port_paged.paged_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                     _t(page_indices)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_paged_decode_window_matches():
    q, kp, vp, lengths, page_indices = _paged_inputs(2)
    want = np.asarray(jax_gen.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(page_indices), window=20))
    got = port_gen.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(lengths), _t(page_indices),
        window=20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [20, 37, 50])
def test_paged_window_attention_reads_only_the_band(window, monkeypatch):
    """``_paged_window_attention`` against JAX's at row lengths below, at
    and above the window (1, 37 and a full row of 96); it gathers only the
    ceil(window / ps) + 1 pages of each row's band, from page
    max(len - window, 0) // ps, clamped to the row."""
    q, kp, vp, lengths, page_indices = _paged_inputs(3)
    want = np.asarray(jax_gen._paged_window_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(page_indices), window))
    seen = []
    real = port_gen.gather_pages
    monkeypatch.setattr(port_gen, "gather_pages",
                        lambda pages, idx: (seen.append(idx.clone()),
                                            real(pages, idx))[1])
    got = port_gen.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(lengths), _t(page_indices),
        window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ps, pps = kp.shape[2], page_indices.shape[1]
    wp = -(-window // ps) + 1
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert tuple(seen[0].shape) == (3, wp)
    for b, n in enumerate(lengths):
        first = min(max(int(n) - window, 0) // ps, pps - wp)
        np.testing.assert_array_equal(seen[0][b].numpy(),
                                      page_indices[b, first:first + wp])


@pytest.mark.parametrize("ragged", [False, True])
def test_cached_attention_prefill_matches(ragged):
    """RoPE + dense cache write + attention at pos 0, the engine's prefill
    call: JAX's dense branch vs the port's kernel route (plain on CPU)."""
    rng = np.random.RandomState(7)
    B, S, H, hk, D = 1, 32, 4, 1, 128
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, hk, D).astype(np.float32)
    v = rng.randn(B, S, hk, D).astype(np.float32)
    ang = np.outer(np.arange(64), rng.rand(D // 2)).astype(np.float32)
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    allowed = None
    if ragged:
        allowed = np.zeros((B, S), bool)
        allowed[:, :21] = True
    zeros = np.zeros((B, S, hk, D), np.float32)
    want, wk, _ = jax_gen.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(zeros), jnp.asarray(zeros), 0,
        allowed=None if allowed is None else jnp.asarray(allowed),
        use_flash=True, prefill=True)
    k_buf, v_buf = torch.zeros(B, S, hk, D), torch.zeros(B, S, hk, D)
    got, gk, _ = port_gen.cached_attention(
        _t(q), _t(k), _t(v), _t(cos), _t(sin), k_buf, v_buf, 0,
        allowed=None if allowed is None else _t(allowed), use_flash=True,
        prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0, atol=1e-6)
    assert gk is k_buf            # written in place


@pytest.mark.parametrize("case", ["window", "window_ragged", "row_pos",
                                  "no_flash"])
def test_cached_attention_plain_branch_matches(case):
    """What the kernels do not take (sliding window, per-row positions, or
    the kernels switched off) runs the einsum branch in both packages: a
    4-token append at pos 12 into a 32-slot buffer."""
    rng = np.random.RandomState(11)
    B, S, T, H, hk, D = 2, 4, 32, 4, 2, 128
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, hk, D).astype(np.float32)
    v = rng.randn(B, S, hk, D).astype(np.float32)
    k_buf = rng.randn(B, T, hk, D).astype(np.float32)
    v_buf = rng.randn(B, T, hk, D).astype(np.float32)
    ang = np.outer(np.arange(T), rng.rand(D // 2)).astype(np.float32)
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    pos, window, allowed, row_pos = 12, None, None, None
    if case.startswith("window"):
        window = 6
    if case == "window_ragged":
        allowed = np.ones((B, T), bool)
        allowed[1, 5:12] = False                 # row 1 right-padded
    if case == "row_pos":
        row_pos = np.array([12, 5], np.int32)
    kw = dict(window=window, use_flash=case != "no_flash")
    want, wk, _ = jax_gen.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(k_buf), jnp.asarray(v_buf), pos,
        allowed=None if allowed is None else jnp.asarray(allowed),
        row_pos=None if row_pos is None else jnp.asarray(row_pos), **kw)
    got, gk, _ = port_gen.cached_attention(
        _t(q), _t(k), _t(v), _t(cos), _t(sin), _t(k_buf.copy()),
        _t(v_buf.copy()), pos,
        allowed=None if allowed is None else _t(allowed),
        row_pos=None if row_pos is None else _t(row_pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0, atol=1e-6)


def test_paged_cached_attention_decode_step_matches():
    """Per-row rope at lengths[b], in-place page write, paged attention."""
    rng = np.random.RandomState(9)
    B, H, hk, D, ps, pps = 3, 4, 1, 128, 16, 4
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k = rng.randn(B, 1, hk, D).astype(np.float32)
    v = rng.randn(B, 1, hk, D).astype(np.float32)
    ang = np.outer(np.arange(pps * ps), rng.rand(D // 2)).astype(np.float32)
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    kp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    vp = rng.randn(hk, B * pps, ps, D).astype(np.float32)
    page_indices = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    lengths = np.array([0, 17, 40], np.int32)
    want, wkp, wvp = jax_gen.paged_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos),
        jnp.asarray(sin), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(page_indices), jnp.asarray(lengths), ps)
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    got, gkp, gvp = port_gen.paged_cached_attention(
        _t(q), _t(k), _t(v), _t(cos), _t(sin), tkp, tvp, _t(page_indices),
        _t(lengths), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(gkp.numpy(), np.asarray(wkp), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(gvp.numpy(), np.asarray(wvp))
    assert gkp is tkp and gvp is tvp            # the pool is updated in place


def _as_cuda(t):
    """A CPU tensor that reports a CUDA device, so the wrappers take their
    CUDA branch up to the first check that needs a card."""
    class _Dev:
        type = "cuda"

    class _Fake(torch.Tensor):
        @property
        def device(self):
            return _Dev()

    return t.as_subclass(_Fake)


@pytest.mark.parametrize("kwargs", [dict(causal=False)])
def test_flash_refuses_unported_masks_on_cuda(kwargs, monkeypatch):
    """On a CUDA tensor the full mask at a head width its kernel lacks (384,
    which the JAX ``supported`` takes; q/k 192 with v 128) raises instead of
    running plain code; the checks run before any launch, so a CPU tensor
    posing as CUDA exercises the refusal without a card."""
    for d_qk, d_v in ((384, 384), (192, 128)):
        fq = _as_cuda(torch.zeros(1, 16, 4, d_qk))
        fv = _as_cuda(torch.zeros(1, 16, 4, d_v))
        with pytest.raises(NotImplementedError, match="head widths"):
            port_flash.flash_attention_bshd(fq, fq, fv, **kwargs)


@pytest.mark.parametrize("s_q,s_kv", [(64, 64), (96, 32)])
def test_flash_full_mask_cuda_route_launches_both_kernels(s_q, s_kv,
                                                          fake_kernels):
    """On a CUDA tensor that needs a gradient, ``causal=False`` launches
    the forward kernel with lse under kind 2 (full), s_kv < s_q included,
    and its backward the three-kernel sequence under kind 2, counted as
    ``flash_attention_full`` and ``flash_attention_full_bwd``."""
    q = posing_as_cuda(torch.zeros(1, s_q, 4, 128), True)
    k, v = (posing_as_cuda(torch.zeros(1, s_kv, 2, 128), True)
            for _ in range(2))
    out = port_flash.flash_attention_bshd(q, k, v, causal=False)
    assert out.grad_fn is not None
    out.sum().backward()
    assert [name for name, _ in fake_kernels] == ["pt_append_attention",
                                                  "pt_flash_attention_bwd"]
    fwd, bwd = fake_kernels[0][1], fake_kernels[1][1]
    assert fwd[5] is not None                      # lse written
    # B, S, T, H, hk, q/k width, v width, pos, window, scale, kind
    assert fwd[6:15] == (1, s_q, s_kv, 4, 2, 128, 128, 0, 0)
    assert fwd[16] == 2
    assert bwd[10:19] == (1, s_q, s_kv, 4, 2, 0, 0, 128, 128)
    assert bwd[20] == 2
    assert dict(_build.launches) == {"flash_attention_full": 1,
                                     "flash_attention_full_bwd": 1}
    assert [tuple(t.grad.shape) for t in (q, k, v)] == [
        (1, s_q, 4, 128), (1, s_kv, 2, 128), (1, s_kv, 2, 128)]




@pytest.mark.parametrize("case,want", [
    ("prefill", "flash"), ("prefill_padded", "append"), ("chunk", "append"),
    ("single_token", "append"), ("no_flash", "append"),
    ("row_pos", "append"), ("window", "plain"), ("window_prefill", "flash")])
def test_cached_attention_routes_to_the_kernels(case, want, monkeypatch):
    """Every windowless chunk and the unpadded pos=0 prefill, windowed or
    not, reach a kernel wrapper (which runs the kernel on CUDA); only
    another windowed chunk calls the plain einsum directly."""
    calls = []
    for name, tag in (("flash_attention_bshd", "flash"),
                      ("append_attention", "append"),
                      ("append_attention_plain", "plain")):
        real = getattr(port_gen, name)
        monkeypatch.setattr(
            port_gen, name,
            lambda *a, _real=real, _tag=tag, **kw: (calls.append(_tag),
                                                    _real(*a, **kw))[1])
    B, T, H, hk, D = 1, 16, 4, 1, 128
    S = 1 if case == "single_token" else 8
    pos = 4 if case in ("chunk", "single_token", "row_pos", "window") else 0
    q, k, v = (torch.randn(B, S, n, D) for n in (H, hk, hk))
    cos, sin = torch.ones(T, D), torch.zeros(T, D)
    allowed = torch.ones(B, T, dtype=torch.bool) if case.endswith(
        "padded") else None
    port_gen.cached_attention(
        q, k, v, cos, sin, torch.zeros(B, T, hk, D), torch.zeros(B, T, hk, D),
        pos, allowed=allowed,
        row_pos=torch.tensor([pos], dtype=torch.int32)
        if case == "row_pos" else None,
        use_flash=case != "no_flash", prefill=pos == 0,
        window=3 if case.startswith("window") else None)
    assert calls == [want]


def _check_flash_grads(dtype, window=None):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _qkv(1, 256, 256, 4, 2, seed=12)
    g = np.random.RandomState(13).randn(*q.shape).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_bshd(
            a, b, c, causal=True, interpret=True, window=window),
        *(jnp.asarray(t, jdt) for t in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jdt))
    ts = [_t(t).to(tdt).requires_grad_() for t in (q, k, v)]
    got = port_flash.flash_attention_bshd(*ts, causal=True, window=window)
    got.backward(_t(g).to(tdt))
    pairs = [(got, want, ATOL)] + [(t.grad, w, 1e-5)
                                   for t, w in zip(ts, want_grads)]
    for a, b, f32_tol in pairs:
        a = a.detach().float().numpy()
        b = np.asarray(b).astype(np.float32)
        tol = f32_tol if dtype == "float32" else 2.0 ** -6 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grads_match_splash_interpret(dtype):
    """Forward and (dq, dk, dv) of causal flash attention at [1, 256, 4 | 2,
    128] against ``jax.grad`` through splash in interpret mode (its own dq
    and dkv kernels). f32: forward within 2e-5, gradients within 1e-5
    (sums in another order). bf16: within 2^-6 times the largest entry of
    each (two bf16 ulps there): JAX rounds q * scale to bf16 before splash,
    the port scales in f32."""
    _check_flash_grads(dtype)


@pytest.mark.parametrize("s_q,s_kv,hk,dqk,window", [
    (200, 200, 2, 128, None), (100, 300, 4, 128, 50),
    (130, 300, 4, 192, None)])
def test_flash_bwd_plain_is_the_gradient(s_q, s_kv, hk, dqk, window):
    """``flash_attention_bwd_plain`` (the backward kernel's plain version,
    delta taken from the given out) at 4 query heads, with the f32 out of
    the plain forward, against ``torch.autograd`` through that forward:
    f32, within 1e-5 (sums in another order)."""
    rng = np.random.RandomState(21)
    q = _t(rng.randn(1, s_q, 4, dqk).astype(np.float32)).requires_grad_()
    k = _t(rng.randn(1, s_kv, hk, dqk).astype(np.float32)).requires_grad_()
    v = _t(rng.randn(1, s_kv, hk, 128).astype(np.float32)).requires_grad_()
    dout = _t(rng.randn(1, s_q, 4, 128).astype(np.float32))
    scale = 0.1147
    out = port_flash.flash_attention_plain(q, k, v, causal=True,
                                           sm_scale=scale, window=window)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = port_flash.flash_attention_bwd_plain(q.detach(), k.detach(),
                                               v.detach(), out.detach(), dout,
                                               scale, window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_local_grads_match_splash_interpret(dtype):
    """The same for the sliding-window LocalMask at window 64 (splash's
    custom VJP over the local mask's block info), same tolerances."""
    _check_flash_grads(dtype, window=64)


def test_flash_function_keeps_the_graph(monkeypatch):
    """The CUDA route's autograd Function, with stand-ins for its launches
    that return detached results as a ctypes launch does: the output keeps
    a ``grad_fn``, the backward hands the forward's out and lse to
    ``flash_attention_bwd``, and the gradients are the plain version's."""
    q, k, v = (_t(a).requires_grad_() for a in _qkv(1, 16, 24, 4, 2, seed=14))
    seen = {}

    def fake_launch(q_, k_, v_, pos, allowed, scale, counter, with_lse=False,
                    window=None):
        seen["launch"] = (pos, allowed, counter, with_lse)
        with torch.no_grad():
            out = port_flash.flash_attention_plain(q_, k_, v_, causal=True,
                                                   sm_scale=scale)
        return out, torch.zeros(1, 4, 16)

    def fake_bwd(q_, k_, v_, out, lse, dout, scale, window=None):
        seen["bwd"] = (out.shape, lse.shape)
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        with torch.enable_grad():
            o = port_flash.flash_attention_plain(*leaves, causal=True,
                                                 sm_scale=scale)
        return torch.autograd.grad(o, leaves, dout)

    monkeypatch.setattr(port_flash._append, "launch", fake_launch)
    monkeypatch.setattr(port_flash, "flash_attention_bwd", fake_bwd)
    out = port_flash._FlashCausal.apply(q, k, v, 0.125, None)
    assert out.grad_fn is not None
    assert seen["launch"] == (8, None, "flash_attention_bshd", True)
    out.square().sum().backward()
    assert seen["bwd"] == (q.shape, (1, 4, 16))
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    port_flash.flash_attention_plain(q, k, v, causal=True,
                                     sm_scale=0.125).square().sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, t.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grad", [False, True])
def test_flash_local_mask_cuda_route_passes_the_window(grad, monkeypatch):
    """On a CUDA tensor ``causal=True, window=W`` launches the append
    kernel with ``window`` under the ``flash_attention_local`` counter, and
    with a gradient goes through the autograd Function, whose backward
    hands the window to ``flash_attention_bwd`` (stand-ins for the
    launches, as above)."""
    q, k, v = (_as_cuda(_t(a).requires_grad_(grad))
               for a in _qkv(1, 16, 24, 4, 2, seed=15))
    seen = {}

    def fake_launch(q_, k_, v_, pos, allowed, scale, counter, with_lse=False,
                    window=None):
        seen["launch"] = (pos, allowed, counter, with_lse, window)
        out = torch.zeros(q_.shape)
        return (out, torch.zeros(1, 4, 16)) if with_lse else out

    def fake_bwd(q_, k_, v_, out, lse, dout, scale, window=None):
        seen["bwd"] = window
        return (torch.zeros(q_.shape), torch.zeros(k_.shape),
                torch.zeros(v_.shape))

    monkeypatch.setattr(port_flash._append, "launch", fake_launch)
    monkeypatch.setattr(port_flash, "flash_attention_bwd", fake_bwd)
    out = port_flash.flash_attention_bshd(q, k, v, causal=True, window=5)
    assert seen["launch"] == (8, None, "flash_attention_local", grad, 5)
    assert (out.grad_fn is not None) == grad
    if grad:
        out.sum().backward()
        assert seen["bwd"] == 5
    assert port_flash._counters(5) == ("flash_attention_local",
                                       "flash_attention_local_bwd")


@pytest.mark.parametrize("kernel", ["append", "paged"])
def test_kernels_without_backward_refuse_grad_inputs(kernel):
    """append_attention and paged_attention have no backward: on CUDA they
    raise for an input that needs a gradient instead of cutting the graph."""
    if kernel == "append":
        q = _as_cuda(torch.zeros(1, 4, 4, 128, requires_grad=True))
        kv = _as_cuda(torch.zeros(1, 8, 1, 128))
        call = lambda: port_append.append_attention(q, kv, kv, 0)  # noqa: E731
    else:
        q = _as_cuda(torch.zeros(2, 4, 128, requires_grad=True))
        kv = _as_cuda(torch.zeros(1, 4, 16, 128))
        idx = torch.zeros(2, 2, dtype=torch.int32)
        call = lambda: port_paged.paged_attention(  # noqa: E731
            q, kv, kv, torch.ones(2, dtype=torch.int32), idx)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
