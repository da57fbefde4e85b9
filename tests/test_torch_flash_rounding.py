"""The rounding plan of the bf16 attention kernels, on the CPU.

``csrc/append_attention.cu`` and ``csrc/flash_attention.cu`` compute their
bf16 bodies on the tensor cores: bf16 operands, f32 sums. The forward's P
enters P v, the backward's P enters dV and its dS enters dK and dQ, each as
bf16 operands. ``model_forward`` and ``model_backward`` repeat that
arithmetic in torch: the forward tile by tile (64 keys a tile) with the
kernel's online softmax in log2 units (m_safe = 0 while a row has seen
nothing), the backward from the forward's out and lse with delta from
the bf16 out. ``terms`` says how P and dS become bf16: 1 rounds each once
(splash's own rounding points), 2 carries hi = bf16(x) and lo = bf16(x -
hi) as two products (what the kernels do). No kernel runs here: the model
says, before any card time, whether that arithmetic holds the tolerances
the kernels are held to. One rounding does not, on rows that see few
columns; two terms do.

Held, for the three masks, grouped-query heads (g = 4) and head widths
(128, 128) and (192, 128):

- against the plain versions ``chip_smoke.py``'s phase 2 holds the
  kernels to (``grouped_attention_plain``, ``flash_attention_bwd_plain``,
  ``hop_bshd_plain``), per element within phase 2's 2e-3 + 2^-7 |p|, lse
  within 1e-3;
- against the JAX ``flash_attention_bshd`` (splash in interpret mode)
  forward and its ``jax.vjp`` gradients in bf16, and ``splash_hop``, within
  2^-6 of each tensor's largest entry, as the port's other bf16 parity
  tests (JAX rounds q * scale to bf16 before splash; the kernels scale the
  f32 scores).

A local ring hop whose band misses the block keeps out 0 and lse -inf on
its dead rows, with no NaN.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.ops.hopper import flash_attention as port_flash

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BN = 64           # keys per tile of the forward kernel
ATOL, RTOL = 2e-3, 2.0 ** -7   # phase 2's attention tolerance
LSE_TOL = 1e-3


def _mask(kind, S, T, offset, window=None):
    """[S, T] bool: query i sees key j (causal and local at ``offset``)."""
    if kind == "full":
        return torch.ones(S, T, dtype=torch.bool)
    rows = torch.arange(S)[:, None] + offset
    cols = torch.arange(T)[None]
    seen = cols <= rows
    if kind == "local":
        seen &= cols > rows - window
    return seen


def _bf16_terms(x, terms):
    """x as ``terms`` bf16 values (in f32) whose sum approximates it."""
    hi = x.bfloat16().float()
    return [hi] if terms == 1 else [hi, (x - hi).bfloat16().float()]


def model_forward(q, k, v, mask, scale, terms=2):
    """The bf16 forward body: (out [B, S, H, Dv] bf16, lse [B, H, S] f32)."""
    B, S, H, D = q.shape
    T, hk, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // hk
    qg, kf, vf = q.reshape(B, S, hk, g, D).float(), k.float(), v.float()
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((B, hk, g, S), -math.inf)
    l = torch.zeros(B, hk, g, S)
    acc = torch.zeros(B, hk, g, S, Dv)
    for t0 in range(0, T, BN):
        s = torch.einsum("bskgd,btkd->bkgst", qg, kf[:, t0:t0 + BN]) * sl2
        s = s.masked_fill(~mask[:, t0:t0 + BN], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(s - m_safe[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for term in _bf16_terms(p, terms):
            acc = acc + torch.einsum("bkgst,btkd->bkgsd", term,
                                     vf[:, t0:t0 + BN])
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    out = (acc * inv[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv)
    lse = torch.where(l > 0, m * LN2 + torch.log(l), -math.inf)
    return out.bfloat16(), lse.reshape(B, H, S)


def model_backward(q, k, v, out, lse, dout, mask, scale, terms=2):
    """The bf16 backward bodies: (dq, dk, dv) in bf16."""
    B, S, H, D = q.shape
    hk, Dv = k.shape[2], v.shape[3]
    g = H // hk
    qg = q.reshape(B, S, hk, g, D).float()
    dog = dout.reshape(B, S, hk, g, Dv).float()
    kf, vf = k.float(), v.float()
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * sl2
    l2 = (lse.reshape(B, hk, g, S) * LOG2E)[..., None]
    p = torch.exp2(s - l2).masked_fill(~mask, 0.0)
    delta = (dog * out.reshape(dog.shape).float()).sum(-1)   # [B, S, hk, g]
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = sum(torch.einsum("bkgst,bskgd->btkd", t, dog)
             for t in _bf16_terms(p, terms))
    dk = sum(torch.einsum("bkgst,bskgd->btkd", t, qg)
             for t in _bf16_terms(ds, terms)) * scale
    dq = sum(torch.einsum("bkgst,btkd->bskgd", t, kf)
             for t in _bf16_terms(ds, terms)) * scale
    return (dq.reshape(q.shape).bfloat16(), dk.bfloat16(), dv.bfloat16())


def _excess(got, want):
    """The largest amount by which |got - want| passes 2e-3 + 2^-7 |want|
    (<= 0: within phase 2's tolerance everywhere)."""
    diff = (got.float() - want.float()).abs()
    return float((diff - ATOL - RTOL * want.float().abs()).max())


def _close(got, want, what):
    excess = _excess(got, want)
    assert excess <= 0, f"{what}: past 2e-3 + 2^-7 |p| by {excess:.3e}"


def _near_jax(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max(),
                               err_msg=what)


def _inputs(S, T, H, hk, dqk, dv, seed):
    rng = np.random.RandomState(seed)
    shapes = ((S, H, dqk), (T, hk, dqk), (T, hk, dv), (S, H, dv))
    return [torch.from_numpy(rng.randn(1, *s).astype(np.float32)).bfloat16()
            for s in shapes]


# (kind, S, T, H, hk, q/k width, v width, window): GQA g = 4 except the
# MLA's own grouping (one q head per KV head) at (192, 128)
CASES = [
    ("full", 256, 256, 8, 2, 128, 128, None),
    ("full", 128, 256, 8, 2, 128, 128, None),
    ("causal", 256, 256, 8, 2, 128, 128, None),
    ("local", 256, 256, 8, 2, 128, 128, 100),
    ("causal", 256, 256, 8, 2, 192, 128, None),
    ("causal", 256, 256, 2, 2, 192, 128, None),
]


@pytest.mark.parametrize("kind,S,T,H,hk,dqk,dv,window", CASES)
def test_rounding_model_holds_phase2_tolerance(kind, S, T, H, hk, dqk, dv,
                                               window):
    """The model's out, lse and gradients against the f32 plain versions
    the kernels are held to on the card."""
    q, k, v, dout = _inputs(S, T, H, hk, dqk, dv, seed=S + T + dqk + H)
    scale = 1.0 / math.sqrt(dqk)
    mask = _mask(kind, S, T, T - S, window)
    out, lse = model_forward(q, k, v, mask, scale)
    _close(out, port_append.grouped_attention_plain(q, k, v, mask[None],
                                                    scale), "out")
    g = H // hk
    sc = torch.einsum("bskgd,btkd->bkgst",
                      q.reshape(1, S, hk, g, dqk).float(), k.float()) * scale
    ref_lse = torch.logsumexp(sc.masked_fill(~mask, -math.inf), -1)
    assert float((lse - ref_lse.reshape(1, H, S)).abs().max()) <= LSE_TOL
    grads = model_backward(q, k, v, out, lse, dout, mask, scale)
    refs = port_flash.flash_attention_bwd_plain(
        q, k, v, out, dout, scale, window=window, full=kind == "full")
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        _close(got, want, name)


@pytest.mark.parametrize("kind,S,T,H,hk,dqk,dv,window", CASES)
def test_rounding_model_matches_splash_interpret(kind, S, T, H, hk, dqk, dv,
                                                 window):
    """The model's out and gradients against the JAX forward and
    ``jax.vjp`` through splash in interpret mode, bf16; width 192 zero-padded
    to 256 lanes for splash, as the JAX DeepSeek path pads it."""
    q, k, v, dout = _inputs(S, T, H, hk, dqk, dv, seed=S + T + dqk + H)
    scale = 1.0 / math.sqrt(dqk)
    mask = _mask(kind, S, T, T - S, window)
    out, lse = model_forward(q, k, v, mask, scale)
    grads = model_backward(q, k, v, out, lse, dout, mask, scale)

    def jnp_bf16(t, pad=0):
        a = jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.pad(a, [(0, 0)] * 3 + [(0, pad)]) if pad else a

    pad = 256 - dqk if dqk % 128 else 0
    want, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_bshd(
            a, b, c, causal=kind != "full", sm_scale=scale, interpret=True,
            window=window),
        jnp_bf16(q, pad), jnp_bf16(k, pad), jnp_bf16(v))
    want_grads = vjp(jnp_bf16(dout))
    _near_jax(out, want, "out")
    for name, got, w in zip(("dq", "dk", "dv"), grads, want_grads):
        _near_jax(got, w[..., :got.shape[-1]], name)


@pytest.mark.parametrize("S,offset,window,first_dead", [
    (128, 128, 96, 95), (256, 256, 96, 95)])
def test_rounding_model_dead_row_hop(S, offset, window, first_dead):
    """A local ring hop (q pre-scaled, scale 1, GQA 4 / 2) whose rows from
    ``first_dead`` on see no column: the model's live rows against
    ``hop_bshd_plain`` (phase 2's tolerance) and JAX's ``splash_hop`` in
    interpret mode; its dead rows out exactly 0 and lse -inf, no NaN."""
    q, k, v, _ = _inputs(S, S, 4, 2, 128, 128, seed=offset + window)
    q = (q.float() / math.sqrt(128)).bfloat16()
    mask = _mask("local", S, S, offset, window)
    out, lse = model_forward(q, k, v, mask, 1.0)
    live = mask.any(1)
    assert list(torch.nonzero(~live).flatten()) == list(range(first_dead, S))
    assert not bool(out.float().isnan().any() or lse.isnan().any())
    assert bool((out[:, ~live] == 0).all())
    assert bool(torch.isneginf(lse[:, :, ~live]).all())
    ref, ref_lse = port_flash.hop_bshd_plain(q, k, v, "local", offset, window)
    _close(out[:, live], ref[:, live], "hop out")
    lse_err = (lse[:, :, live] - ref_lse[:, :, live]).abs().max()
    assert float(lse_err) <= LSE_TOL
    w_out, w_lse = jax_flash.splash_hop(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16).swapaxes(1, 2)
          for t in (q, k, v)),
        "local", offset=offset, window=window, interpret=True)
    _near_jax(out[:, live], np.asarray(w_out.swapaxes(1, 2))[:, live.numpy()],
              "hop out vs splash_hop")
    np.testing.assert_allclose(
        lse[:, :, live].numpy(), np.asarray(w_lse)[:, :, live.numpy()],
        rtol=0, atol=LSE_TOL)


def test_one_rounding_misses_phase2_tolerance():
    """Why the kernels carry P and dS as two bf16 terms: rounded once, as
    splash rounds them, the causal out and every gradient pass phase 2's
    tolerance on the first rows (p near 1 times |v| near 2, and dS's
    cancelling sums); the two-term model of the same inputs holds it
    (``test_rounding_model_holds_phase2_tolerance``)."""
    kind, S, T, H, hk, dqk, dv, window = CASES[2]
    q, k, v, dout = _inputs(S, T, H, hk, dqk, dv, seed=S + T + dqk + H)
    scale = 1.0 / math.sqrt(dqk)
    mask = _mask(kind, S, T, 0)
    out, lse = model_forward(q, k, v, mask, scale, terms=1)
    assert _excess(out, port_append.grouped_attention_plain(
        q, k, v, mask[None], scale)) > 0
    grads = model_backward(q, k, v, out, lse, dout, mask, scale, terms=1)
    refs = port_flash.flash_attention_bwd_plain(q, k, v, out, dout, scale)
    assert all(_excess(g, r) > 0 for g, r in zip(grads, refs))
