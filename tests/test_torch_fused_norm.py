"""Port parity: paddle_tpu_torch.ops.hopper.fused_norm (plain versions, CPU)
against paddle_tpu.ops.pallas.fused_norm. At rows % 8 == 0 and
d % 128 == 0 the JAX functions run their Pallas kernels in interpret mode;
elsewhere their references. The port follows the kernels' cast order."""
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
