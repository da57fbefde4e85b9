"""Port parity: paddle_tpu_torch.ops.hopper.fused_norm (plain versions, CPU)
against paddle_tpu.ops.pallas.fused_norm, forward and gradients. At
rows % 8 == 0 and d % 128 == 0 (norms) or d % 128 == 0 (RoPE) the JAX
functions run their Pallas kernels in interpret mode; elsewhere their
references. The port follows the kernels' cast order, and its gradients
the JAX custom VJPs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_norm as jax_norm
from paddle_tpu_torch.ops.hopper import fused_norm as port_norm

EPS = 1e-5


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, r, w


def _pair(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(a):
    return np.asarray(a).astype(np.float32)


# [16, 256]: Pallas kernel shape; [3, 7, 128]: 21 rows, the JAX reference
@pytest.mark.parametrize("shape", [(16, 256), (3, 7, 128)])
def test_rms_norm_f32(shape):
    (jx, _, jw), (tx, _, tw) = _pair(_inputs(shape), jnp.float32,
                                     torch.float32)
    want = _np(jax_norm.rms_norm(jx, jw, EPS))
    got = port_norm.rms_norm(tx, tw, EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 256), (3, 7, 128)])
def test_add_rms_norm_f32(shape):
    (jx, jr, jw), (tx, tr, tw) = _pair(_inputs(shape), jnp.float32,
                                       torch.float32)
    want_out, want_h = jax_norm.add_rms_norm(jx, jr, jw, EPS)
    got_out, got_h = port_norm.add_rms_norm(tx, tr, tw, EPS)
    np.testing.assert_allclose(got_out.numpy(), _np(want_out), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_h.numpy(), _np(want_h))


def _ulps_bf16(a, b):
    """Distance in bf16 ulps between two bf16-valued f32 arrays."""
    ia = a.view(np.int32) >> 16
    ib = b.view(np.int32) >> 16
    return np.abs(ia.astype(np.int64) - ib.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_norms_bf16_match_the_pallas_kernel(seed):
    """bf16 at the kernel shape: the same cast points give the same bits,
    except where the f32 mean of squares, summed in another order, moves
    the normalised value across a bf16 rounding boundary — at most one
    ulp there."""
    arrays = _inputs((16, 256), seed)
    (jx, jr, jw), (tx, tr, tw) = _pair(arrays, jnp.bfloat16, torch.bfloat16)
    assert np.array_equal(_np(jx), tx.float().numpy())   # same inputs
    want = _np(jax_norm.rms_norm(jx, jw, EPS))
    got = port_norm.rms_norm(tx, tw, EPS).float().numpy()
    assert _ulps_bf16(got, want).max() <= 1
    want_out, want_h = jax_norm.add_rms_norm(jx, jr, jw, EPS)
    got_out, got_h = port_norm.add_rms_norm(tx, tr, tw, EPS)
    assert _ulps_bf16(got_out.float().numpy(), _np(want_out)).max() <= 1
    # the new residual is the f32 sum rounded once: identical
    np.testing.assert_array_equal(got_h.float().numpy(), _np(want_h))


def test_add_rms_norm_normalises_the_f32_sum():
    """The port follows the Pallas kernel (f32 sum), not the JAX reference
    (sum rounded to bf16 first): the two differ in bf16."""
    x, r, w = _inputs((16, 256), 3)
    tx, tr, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, w))
    got, _ = port_norm.add_rms_norm(tx, tr, tw, EPS)
    kernel_order = port_norm.rms_norm_plain((tx.float() + tr.float()), tw.float(),
                                            EPS).to(torch.bfloat16)
    rounded_first = port_norm.rms_norm_plain(tx + tr, tw, EPS)
    assert _ulps_bf16(got.float().numpy(),
                      kernel_order.float().numpy()).max() <= 1
    assert not torch.equal(got, rounded_first)


def test_rope_ref_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 3, 128).astype(np.float32)
    ang = rng.rand(6, 64).astype(np.float32) * 6.0
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    want = _np(jax_norm.rope_ref(jnp.asarray(x), jnp.asarray(cos),
                                 jnp.asarray(sin)))
    got = port_norm.rope_ref(torch.from_numpy(x), torch.from_numpy(cos),
                             torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # partial width: only the leading 64 lanes rotate
    want_p = _np(jax_norm.rope_ref(jnp.asarray(x), jnp.asarray(cos[:, :64]),
                                   jnp.asarray(sin[:, :64])))
    got_p = port_norm.rope_ref(torch.from_numpy(x),
                               torch.from_numpy(cos[:, :64]),
                               torch.from_numpy(sin[:, :64])).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    """Shape/dtype checks run before any build: a CPU tensor never reaches
    them (plain path), so call the checker directly."""
    x = torch.zeros(4, 12)
    with pytest.raises(ValueError):
        port_norm._check(x, torch.zeros(12))


def _tables(S, half, seed):
    ang = np.outer(np.arange(S),
                   np.random.RandomState(seed).rand(half) * 0.5)
    ang = np.concatenate([ang, ang], -1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _bits_f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rope_and_grad_match_the_pallas_kernel(dtype):
    """fused_rope at [2, 256, 4, 128] against the Pallas kernel in interpret
    mode, and its gradient against the JAX custom VJP. f32: forward within
    1e-6 (XLA fuses the products into multiply-adds; the port rounds each);
    bf16: forward within 2 bf16 ulps for the same reason. The gradient, a
    recompute of rope_ref in both packages, is bit-identical."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 256, 4, 128).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    cos, sin = _tables(256, 64, 7)
    want, vjp = jax.vjp(
        lambda a: jax_norm.fused_rope(a, jnp.asarray(cos), jnp.asarray(sin)),
        jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got = port_norm.fused_rope(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.is_contiguous() and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_bits_f32(got), _np(want), rtol=0,
                                   atol=1e-6)
    else:
        assert _ulps_bf16(_bits_f32(got), _np(want)).max() <= 2
    np.testing.assert_array_equal(_bits_f32(tx.grad), _np(want_dx))


def test_apply_rope_partial_width_matches_jax():
    """A table narrower than the head rotates the leading lanes only; f32
    forward and gradient within 1e-6."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 16, 2, 128).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    cos, sin = _tables(16, 32, 9)                  # rope width 64
    want, vjp = jax.vjp(
        lambda a: jax_norm.apply_rope(a, jnp.asarray(cos), jnp.asarray(sin)),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_norm.apply_rope(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _np(want_dx), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_gradients_match_the_jax_vjps(dtype):
    """Gradients of rms_norm and add_rms_norm (both outputs carrying a
    cotangent) against the JAX custom VJPs at the Pallas kernel shape
    [16, 256]. f32: within 1e-5. bf16: dx and dresidual bit-identical; the
    weight gradient is a bf16 sum over 16 rows that the two packages take
    in another order and precision, so it is held within 2^-5 * max |dw|,
    four bf16 ulps of its largest entry (two seen)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, r, w = _inputs((16, 256), 10)
    rng = np.random.RandomState(11)
    g1, g2 = (rng.randn(16, 256).astype(np.float32) for _ in range(2))

    def check(got, want, is_dw):
        got, want = _bits_f32(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        elif is_dw:
            assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()
        else:
            np.testing.assert_array_equal(got, want)

    _, vjp = jax.vjp(lambda a, b: jax_norm.rms_norm(a, b, EPS),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want = vjp(jnp.asarray(g1, jdt))
    tx, tw = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, w))
    port_norm.rms_norm(tx, tw, EPS).backward(torch.from_numpy(g1).to(tdt))
    check(tx.grad, want[0], False)
    check(tw.grad, want[1], True)

    _, vjp = jax.vjp(lambda a, b, c: jax_norm.add_rms_norm(a, b, c, EPS),
                     *(jnp.asarray(a, jdt) for a in (x, r, w)))
    want = vjp((jnp.asarray(g1, jdt), jnp.asarray(g2, jdt)))
    tx, tr, tw = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, r, w))
    out, h = port_norm.add_rms_norm(tx, tr, tw, EPS)
    torch.autograd.backward((out, h), (torch.from_numpy(g1).to(tdt),
                                       torch.from_numpy(g2).to(tdt)))
    for t, wt, is_dw in ((tx, want[0], False), (tr, want[1], False),
                         (tw, want[2], True)):
        check(t.grad, wt, is_dw)


def test_kernel_outputs_keep_the_graph(monkeypatch):
    """On CUDA the forwards come from ctypes launches, whose outputs carry
    no ``grad_fn``. Stand-ins that return such detached results show that
    the autograd Functions still wire each output into the graph, with the
    gradients of the plain versions (no silent cut)."""
    calls = []

    def detached(fn, tag):
        def run(*a):
            calls.append(tag)
            with torch.no_grad():
                return fn(*(t.detach() if torch.is_tensor(t) else t
                            for t in a))
        return run

    monkeypatch.setattr(port_norm, "_rms_norm_forward",
                        detached(port_norm.rms_norm_plain, "rms"))
    monkeypatch.setattr(port_norm, "_add_rms_norm_forward",
                        detached(port_norm.add_rms_norm_plain, "add"))
    monkeypatch.setattr(port_norm, "_fused_rope_forward",
                        detached(port_norm._rope_ref_full, "rope"))
    x, r, w = (torch.from_numpy(a).requires_grad_()
               for a in _inputs((2, 8, 2, 128), 12))
    cos, sin = (torch.from_numpy(t) for t in _tables(8, 64, 13))
    out, h = port_norm.add_rms_norm(port_norm.rms_norm(x, w, EPS), r, w, EPS)
    y = port_norm.fused_rope(out, cos, sin)
    assert calls == ["rms", "add", "rope"]
    assert y.grad_fn is not None and h.grad_fn is not None
    (y.sum() + h.square().sum()).backward()
    got = [t.grad.clone() for t in (x, r, w)]
    for t in (x, r, w):
        t.grad = None
    out, h = port_norm._add_rms_ref(port_norm.rms_norm_plain(x, w, EPS), r, w,
                                    EPS)
    (port_norm.rope_ref(out, cos, sin).sum() + h.square().sum()).backward()
    for a, t in zip(got, (x, r, w)):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, t.grad, rtol=1e-6, atol=1e-6)
