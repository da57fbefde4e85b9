"""The MLA latent decode at the head counts of DeepSeek-V2 and V3, on the CPU.

The Pallas gate (``paddle_tpu/ops/pallas/mla_decode.py:51-67``) takes any
head count with ``H % 8 == 0``; the port's kernel takes those up to 128, in
head tiles of 16 on its grid's z axis (a last tile of 8 heads has its other
rows masked). Heads are independent, so the tiling moves no number: here
``mla_decode_plain`` is held against the Pallas kernel in interpret mode at
H 24 (a half-full last tile), 32 and 128, r 128, dr 64, T 128, random per-row
positions and an ``allowed`` mask with a dead row, in f32 at the port's
tolerance 1e-4 + 1e-4 |p|; the kernel's own arithmetic (``model_mla`` of
``tests/test_torch_mla_split.py``: hi + lo q and P, the runs, the combine)
at H 128 against both. The CUDA route runs up to its C entry with a stand-in
launch: H 24 and 128 reach it with the grid and scratch of ``grid_blocks``,
H 136 and a head count that is no multiple of 8 are refused before it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import mla_decode as jax_mla
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import mla_decode as port_mla
from test_torch_mla_split import model_mla
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4      # the MLA tolerance, f32 on both sides
R, DR, T = 128, 64, 128
H100_SMS = 132


def _case(H, seed, B=4):
    """Pre-scaled f32 queries (scores of spread 2), unit f32 buffers,
    random per-row positions (one row at T - 1), and an ``allowed`` mask
    with random holes and a dead row."""
    rng = np.random.RandomState(seed)
    qs = 2.0 / np.sqrt(R + DR)
    ql = (rng.randn(B, H, R) * qs).astype(np.float32)
    qp = (rng.randn(B, H, DR) * qs).astype(np.float32)
    ckv = rng.randn(B, T, R).astype(np.float32)
    kpe = rng.randn(B, T, DR).astype(np.float32)
    pos = rng.randint(0, T, size=B).astype(np.int32)
    pos[0] = T - 1
    allowed = rng.rand(B, T) > 0.2
    allowed[1] = False
    return ql, qp, ckv, kpe, pos, allowed


def _jax(ql, qp, ckv, kpe, pos, allowed):
    return np.asarray(jax_mla.mla_decode_attention(
        jnp.asarray(ql), jnp.asarray(qp), jnp.asarray(ckv), jnp.asarray(kpe),
        jnp.asarray(pos), None if allowed is None else jnp.asarray(allowed),
        interpret=True))


def _within(got, ref):
    """max over entries of |got - ref| / (ATOL + RTOL |ref|): <= 1 holds."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


@pytest.mark.parametrize("masked", [False, True], ids=["pos", "allowed"])
@pytest.mark.parametrize("H", [24, 32, 128])
def test_plain_matches_pallas_interpret(H, masked):
    """``mla_decode_plain`` against the Pallas kernel in interpret mode
    within 1e-4 + 1e-4 |p|; with the mask, the dead row exactly 0 in
    both."""
    ql, qp, ckv, kpe, pos, allowed = _case(H, seed=H)
    if not masked:
        allowed = None
    want = _jax(ql, qp, ckv, kpe, pos, allowed)
    got = port_mla.mla_decode(*(torch.from_numpy(a) for a in (
        ql, qp, ckv, kpe, pos)),
        None if allowed is None else torch.from_numpy(allowed)).numpy()
    assert got.shape == (4, H, R)
    assert _within(got, want) <= 1.0
    if masked:
        assert not got[1].any() and not want[1].any()


def test_kernel_arithmetic_at_128_heads():
    """The kernel's arithmetic at H 128 over bf16 buffers, the runs of
    ``grid_blocks``'s 16 blocks of one head tile (and 5 more), against the
    plain version and the Pallas kernel in interpret mode within
    1e-4 + 1e-4 |p|; the dead row exactly 0."""
    ql, qp, ckv, kpe, pos, allowed = _case(128, seed=7)
    ckv_b = torch.from_numpy(ckv).bfloat16()
    kpe_b = torch.from_numpy(kpe).bfloat16()
    al = torch.from_numpy(allowed)
    G = port_mla.grid_blocks(4, 128, H100_SMS)
    assert G == H100_SMS // 8 == 16
    plain = port_mla.mla_decode_plain(torch.from_numpy(ql),
                                      torch.from_numpy(qp), ckv_b, kpe_b,
                                      torch.from_numpy(pos), al)
    want = _jax(ql, qp, ckv_b.float().numpy(), kpe_b.float().numpy(), pos,
                allowed)
    for blocks in (G, G + 5):
        got = model_mla(torch.from_numpy(ql), torch.from_numpy(qp), ckv_b,
                        kpe_b, pos, al, blocks, min_tiles=1)
        assert _within(got, plain) <= 1.0
        assert _within(got, want) <= 1.0
        assert bool((got[1] == 0).all())


def _mla_cuda(B=3, H=16, r=512, dr=64, T=256):
    return (posing_as_cuda(torch.zeros(B, H, r)),
            posing_as_cuda(torch.zeros(B, H, dr)),
            posing_as_cuda(torch.zeros(B, T, r, dtype=torch.bfloat16)),
            posing_as_cuda(torch.zeros(B, T, dr, dtype=torch.bfloat16)))


@pytest.mark.parametrize("H", [24, 128])
def test_cuda_route_takes_24_and_128_heads(H, fake_kernels, monkeypatch):
    """H 24 (a half-full last head tile) and H 128 reach ``pt_mla_decode``
    once each, with the blocks of ``grid_blocks`` (a wave of 132 // 2 and
    132 // 8 blocks a head tile) and the partials [G, H, r] then [G, H]
    twice laid end to end in the scratch; one count a call."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q_lat, q_pe, ckv, kpe = _mla_cuda(H=H)
    out = port_mla.mla_decode(q_lat, q_pe, ckv, kpe, 100)
    assert dict(_build.launches) == {"mla_decode": 1}
    (name, args), = fake_kernels
    G = port_mla.grid_blocks(3, H, H100_SMS)
    assert G == {24: 66, 128: 16}[H]
    assert name == "pt_mla_decode"
    assert args[11:] == (3, H, 256, 512, 64, G, port_mla.MIN_TILES, 1, None)
    assert args[6] - args[8] == G * H * 512 * 4
    assert args[7] - args[6] == args[9] - args[7] == G * H * 4
    assert out.shape == (3, H, 512)


@pytest.mark.parametrize("H", [136, 12, 4])
def test_cuda_route_refuses_heads_the_gate_refuses(H, fake_kernels,
                                                   monkeypatch):
    """More than 128 heads, or a count that is no multiple of 8 (the JAX
    gate's rule), raise before any launch; the CPU route takes any H."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        port_mla.mla_decode(*_mla_cuda(H=H), 5)
    assert not fake_kernels and not _build.launches
    out = port_mla.mla_decode(torch.zeros(2, H, 32), torch.zeros(2, H, 16),
                              torch.ones(2, 8, 32), torch.ones(2, 8, 16), 3)
    assert out.shape == (2, H, 32)
