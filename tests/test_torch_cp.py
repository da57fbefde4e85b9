"""Port parity of context-parallel attention (``paddle_tpu_torch.
distributed.context_parallel``: the ring's ranks in one process) against
the JAX package's ring, Ulysses and MLA ring in a ``shard_map`` over 4 (or
2) virtual CPU devices (the set-up of ``tests/test_context_parallel.py``),
the ring's gradients against ``jax.grad`` of the JAX einsum ring, and the
CUDA route of the kernel hops with stand-in launches. f32; tolerance 2e-5
for sums taken in another order."""
import functools
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.distributed import context_parallel as jax_cp
from paddle_tpu_torch.distributed import context_parallel as port_cp
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash
from test_torch_pair import posing_as_cuda

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(S, H, hk, D=128, B=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, hk, D), np.float32),
            rng.standard_normal((B, S, hk, D), np.float32))


def _jax_sharded(inner, n, **kw):
    """``inner`` (a JAX context-parallel function) in a shard_map over n
    CPU devices, the sequence axis sharded."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sep",))
    spec = P(None, "sep", None, None)
    return jax.jit(shard_map(functools.partial(inner, axis_name="sep", **kw),
                             mesh=mesh, in_specs=(spec, spec, spec),
                             out_specs=spec, check_vma=False))


def _port_ring(q, k, v, n=4, **kw):
    """The port's ring on global numpy arrays: shard, ring, unshard."""
    ring = port_cp.LocalRing(n)
    out = port_cp.ring_attention(
        *(port_cp.shard(x if isinstance(x, torch.Tensor) else _t(x), n)
          for x in (q, k, v)), ring, **kw)
    return port_cp.unshard(out)


@pytest.mark.parametrize("causal,hk,window", [
    (True, 2, None), (False, 2, None), (True, 2, 96), (True, 2, 128),
    (True, 2, 200)])
def test_ring_splash_matches_jax_interpret(causal, hk, window):
    """Degree 4, [1, 512, 4 | 2, 128] (local blocks of 128): the port's
    ring with flash hops (their plain versions) against the JAX ring with
    splash hops in interpret mode; and against the whole-sequence plain
    attention. No NaN."""
    q, k, v = _qkv(512, 4, hk, seed=9 + (window or 0) + causal)
    want = np.asarray(_jax_sharded(
        jax_cp.ring_attention, 4, causal=causal, window=window,
        impl="splash", interpret=True)(q, k, v))
    got = _port_ring(q, k, v, causal=causal, window=window, impl="splash",
                     interpret=True)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    whole = port_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                             causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,window", [
    (True, None), (False, None), (True, 40)])
def test_ring_einsum_matches_jax(causal, window):
    """``impl="einsum"`` (and ``"auto"`` on CPU tensors, which picks it) at
    degree 4 on an untileable shape, [2, 64, 4 | 2, 16], against the JAX
    einsum ring."""
    q, k, v = _qkv(64, 4, 2, D=16, B=2, seed=3)
    want = np.asarray(_jax_sharded(jax_cp.ring_attention, 4, causal=causal,
                                   window=window, impl="einsum")(q, k, v))
    for impl in ("einsum", "auto"):
        got = _port_ring(q, k, v, causal=causal, window=window, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_live_hops_and_ring_errors():
    """``_live_hops`` at the values the JAX tests assert, and the ring's
    argument errors."""
    lh = port_cp._live_hops
    assert lh(8, 128, True, 128) == 2
    assert lh(8, 128, True, 129) == 2
    assert lh(8, 128, True, 130) == 3
    assert lh(8, 128, True, 256) == 3
    assert lh(8, 128, True, None) == 8
    assert lh(4, 128, True, 10_000) == 4
    assert lh(8, 128, True, 1) == 1
    assert lh(4, 4096, True, 4096) == 2
    for n, s, c, w in ((8, 128, True, 130), (4, 4096, True, 4096),
                       (4, 512, False, None)):
        assert lh(n, s, c, w) == jax_cp._live_hops(n, s, c, w)
    q = torch.zeros(4, 1, 16, 2, 16)
    ring = port_cp.LocalRing(4)
    with pytest.raises(ValueError, match="causal"):
        port_cp.ring_attention(q, q, q, ring, causal=False, window=8)
    with pytest.raises(ValueError, match="splash"):
        port_cp.ring_attention(q, q, q, ring, causal=True, impl="splash",
                               interpret=True)
    with pytest.raises(ValueError, match="impl"):
        port_cp.ring_attention(q, q, q, ring, impl="flash")


@pytest.mark.parametrize("impl,causal,window", [
    ("splash", True, None), ("splash", True, 200), ("splash", False, None),
    ("einsum", True, 160)])
def test_ring_grads_match_jax_einsum_ring(impl, causal, window):
    """Gradients of sum(sin(out)^2) through the port's ring (the flash-hop
    ring's autograd Function recomputes through the einsum ring, as the JAX
    custom VJP does) against ``jax.grad`` of the JAX einsum ring in a
    shard_map, degree 4, [1, 512, 4 | 2, 128]; within 1e-5."""
    q, k, v = _qkv(512, 4, 2, seed=11)
    fn = _jax_sharded(jax_cp.ring_attention, 4, causal=causal, window=window,
                      impl="einsum")
    want = jax.jit(jax.grad(lambda *a: (jnp.sin(fn(*a)) ** 2).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = _port_ring(*leaves, causal=causal, window=window, impl=impl,
                     interpret=True)
    (torch.sin(out) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        assert not torch.isnan(t.grad).any()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("n,causal,hk,window", [
    (2, True, 2, None), (4, False, 4, None), (4, True, 2, 24)])
def test_ulysses_matches_jax(n, causal, hk, window):
    """Ulysses at degree 2 and 4 (GQA kv heads repeated to split evenly at
    4 / 2 over 4 ranks), causal, windowed and not, against the JAX
    function; and ``sep_attention(mode="ulysses")``, global in and out."""
    q, k, v = _qkv(64, 4, hk, D=16, B=2, seed=13 + n)
    want = np.asarray(_jax_sharded(jax_cp.ulysses_attention, n,
                                   causal=causal, window=window)(q, k, v))
    ring = port_cp.LocalRing(n)
    got = port_cp.unshard(port_cp.ulysses_attention(
        *(port_cp.shard(_t(x), n) for x in (q, k, v)), ring, causal=causal,
        window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    sep = port_cp.sep_attention(_t(q), _t(k), _t(v), n, causal=causal,
                                mode="ulysses", window=window)
    torch.testing.assert_close(sep, got, rtol=0, atol=0)


def test_sep_attention_ring_is_the_ring():
    """``sep_attention(mode="ring")`` shards the global sequence, runs the
    ring and gathers it back: equal to the sharded ring's result."""
    q, k, v = _qkv(128, 4, 2, D=16, seed=14)
    got = port_cp.sep_attention(_t(q), _t(k), _t(v), 4, causal=True)
    np.testing.assert_array_equal(got.numpy(),
                                  _port_ring(q, k, v, causal=True).numpy())
    with pytest.raises(ValueError, match="mode"):
        port_cp.sep_attention(_t(q), _t(k), _t(v), 4, mode="x")


def _mla_args(S=32, seed=23):
    """tiny_mla widths: 4 heads, qk_nope 32, qk_rope 16, v 32, kv_lora 32."""
    H, dn, dr, dv, r = 4, 32, 16, 32, 32
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, H, dn + dr), np.float32) * 0.3,
            rng.standard_normal((2, S, r), np.float32) * 0.3,
            rng.standard_normal((2, S, dr), np.float32) * 0.3,
            rng.standard_normal((r, H * (dn + dv)), np.float32) * 0.1,
            dn, dv)


def test_mla_ring_matches_jax():
    """The latent ring at tiny_mla widths, degree 4: output and the
    gradients of sum(out^2) with respect to q, c_kv, k_pe and w_kv_b
    against the JAX ring in a shard_map."""
    q, c_kv, k_pe, w, dn, dv = _mla_args()
    mesh = Mesh(np.array(jax.devices()[:4]), ("sep",))
    spec4, spec3 = P(None, "sep", None, None), P(None, "sep", None)
    fn = jax.jit(shard_map(
        functools.partial(jax_cp.mla_ring_attention, axis_name="sep",
                          nope_dim=dn, v_dim=dv),
        mesh=mesh, in_specs=(spec4, spec3, spec3, P(None, None)),
        out_specs=spec4, check_vma=False))
    want = np.asarray(fn(q, c_kv, k_pe, w))
    want_grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                  argnums=(0, 1, 2, 3)))(q, c_kv, k_pe, w)
    ring = port_cp.LocalRing(4)
    leaves = [_t(x).requires_grad_() for x in (q, c_kv, k_pe, w)]
    out = port_cp.mla_ring_attention(
        *(port_cp.shard(x, 4) for x in leaves[:3]), leaves[3], ring,
        nope_dim=dn, v_dim=dv)
    got = port_cp.unshard(out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=ATOL)
    (got ** 2).sum().backward()
    for t, g in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("causal,window,hops", [
    (True, None, 4), (False, None, 4), (True, 128, 2)])
def test_ring_auto_on_cuda_launches_one_hop_kernel_per_live_hop(
        causal, window, hops, monkeypatch):
    """On CUDA tensors ``impl="auto"`` takes the flash hops: one
    ``splash_hop`` launch per live hop, the live ranks folded into the
    batch (hop t: ranks t..3 when causal), at the hop's mask kind and
    offset; ``impl="einsum"`` launches none. The stand-in launch runs the
    hop's plain version, so the result is the whole-sequence attention."""
    calls = []

    def fake_launch(q, k, v, pos, allowed, scale, counter, with_lse=False,
                    window=None, kind=None):
        calls.append((q.shape[0], kind, pos, window))
        _build.launches[counter] += 1
        plain = port_flash.hop_bshd_plain(
            *(x.as_subclass(torch.Tensor) for x in (q, k, v)), kind, pos,
            window, scale)
        return plain if with_lse else plain[0]

    monkeypatch.setattr(port_append, "launch", fake_launch)
    monkeypatch.setattr(_build, "launches", Counter())
    q, k, v = _qkv(512, 4, 2, seed=15)
    ring = port_cp.LocalRing(4)
    shards = [posing_as_cuda(port_cp.shard(_t(x), 4)) for x in (q, k, v)]
    out = port_cp.ring_attention(*shards, ring, causal=causal, window=window)
    assert dict(_build.launches) == {"splash_hop": hops}
    if window is not None:
        want_calls = [(4, "local", 0, 128), (3, "local", 128, 128)]
    elif causal:
        want_calls = [(4, "causal", 0, None)] + [
            (4 - t, "full", 0, None) for t in (1, 2, 3)]
    else:
        want_calls = [(4, "full", 0, None)] * 4
    assert calls == want_calls
    whole = port_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                             causal=causal, window=window)
    np.testing.assert_allclose(
        port_cp.unshard(out.as_subclass(torch.Tensor)).numpy(),
        whole.numpy(), rtol=0, atol=ATOL)
    calls.clear()
    port_cp.ring_attention(*shards, ring, causal=causal, window=window,
                           impl="einsum")
    assert calls == [] and dict(_build.launches) == {"splash_hop": hops}


def test_local_ring_collectives():
    """``ppermute`` moves rank i's block to rank i + 1; ``all_to_all``
    (tiled) sends chunk j of rank i's split axis to rank j, concatenated
    in rank order along the concat axis."""
    ring = port_cp.LocalRing(3)
    x = torch.arange(3 * 2 * 6).reshape(3, 2, 6)
    np.testing.assert_array_equal(ring.ppermute(x)[1], x[0])
    y = ring.all_to_all(x, split_axis=1, concat_axis=0)   # [3, 6, 2]
    assert tuple(y.shape) == (3, 6, 2)
    for j in range(3):
        want = torch.cat([x[i][:, 2 * j:2 * j + 2] for i in range(3)], 0)
        torch.testing.assert_close(y[j], want, rtol=0, atol=0)
    assert math.isclose(float(ring.size), 3.0)
