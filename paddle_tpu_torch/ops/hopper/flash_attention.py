"""Flash attention dispatch, [B, S, H, D] layout, grouped-query heads.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
``flash_attention_bshd`` (splash attention on the TPU). Where each of
splash's masks runs on CUDA:

- causal (``causal=True``, no window), splash's bottom-aligned CausalMask
  (q row i sees kv columns j <= i + s_kv - s_q): the append-attention
  kernel (csrc/append_attention.cu) at ``pos = s_kv - s_q``, counted as
  ``flash_attention_bshd``; its backward, csrc/flash_attention.cu,
  counted as ``flash_attention_bwd``;
- sliding window (``causal=True, window=W``), splash's
  ``LocalMask(window_size=(W - 1, 0), offset=s_kv - s_q)`` (also
  j > i + s_kv - s_q - W): the same two kernels with ``window``, counted as
  ``flash_attention_local`` and ``flash_attention_local_bwd``;
- full (``causal=False``): not ported, raises ``NotImplementedError``.

Head widths: q/k and v of 128 (the Llama families), and DeepSeek's MLA
at q/k width 192 and v width 128, causal without a window, with its
``sm_scale``: the same forward kernel at its (192, 128) instantiation,
counted as ``flash_attention_mla``, and the backward kernels at theirs,
counted as ``flash_attention_mla_bwd`` (DeepSeek training). JAX zero-pads
those to 256 / 128 lanes for the TPU (``deepseek.py:125-143``); the
function is the same. A window at width 192 raises: no model needs it.

When an input needs a gradient the forward also writes the f32
logsumexp, and the backward runs the dq / dk / dv kernels, as splash's
custom VJP runs its dq and dkv kernels over the same mask. On a CPU tensor
it runs the plain version, differentiated by autograd.

Scale: JAX pre-scales q in q's dtype before splash (``q * scale`` rounds in
bf16); the kernels here scale in f32 inside, as the plain version does.
"""
from __future__ import annotations

import math

import torch

from . import _build
from . import append_attention as _append

_STEM = "flash_attention"


def _causal_mask(s_q, s_kv, window, device):
    """[1, s_q, s_kv] bool, True where bottom-aligned causal (and within the
    window) attention sees the column."""
    rows = torch.arange(s_q, device=device)[:, None] + (s_kv - s_q)
    cols = torch.arange(s_kv, device=device)[None, :]
    mask = cols <= rows
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask[None]


def flash_attention_plain(q, k, v, causal=False, sm_scale=None, window=None):
    """q [B, S, H, D], k [B, S_kv, hk, D], v [B, S_kv, hk, Dv] -> [B, S, H,
    Dv] in q's type; causal bottom-aligned, optionally windowed."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    mask = (_causal_mask(q.shape[1], k.shape[1], window, q.device)
            if causal else None)
    return _append.grouped_attention_plain(q, k, v, mask, scale)


def flash_attention_bwd_plain(q, k, v, out, dout, scale, window=None):
    """The plain version of ``flash_attention_bwd`` on the same inputs:
    (dq, dk, dv) in q's type from f32 products over the whole causal (or
    banded) mask, with ``delta = rowsum(dout * out)`` from the given
    ``out``, as the kernel and splash's backward take it (the forward's
    rounded output, not the exact one)."""
    B, S, H, D = q.shape
    hk = k.shape[2]
    g = H // hk
    qg = q.reshape(B, S, hk, g, D).float()
    kf, vf = k.float(), v.float()
    dog = dout.reshape(B, S, hk, g, -1).float()
    mask = _causal_mask(S, k.shape[1], window, q.device)[:, None, None]
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    del scores
    delta = (dog * out.reshape(dog.shape).float()).sum(-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    ds = probs * (dp - delta.permute(0, 2, 3, 1)[..., None])
    del dp
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", probs, dog)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _counters(window, d_qk=_append.HEAD_DIM):
    """(forward, backward) launch counters of a mask (and head width)."""
    if d_qk != _append.HEAD_DIM:
        return "flash_attention_mla", "flash_attention_mla_bwd"
    if window is None:
        return "flash_attention_bshd", "flash_attention_bwd"
    return "flash_attention_local", "flash_attention_local_bwd"


def flash_attention_bwd(q, k, v, out, lse, dout, scale, window=None):
    """(dq, dk, dv) of the causal attention at pos = s_kv - s_q, or with
    ``window`` of its sliding-window band, from the forward's ``out`` and
    f32 ``lse`` [B, H, S]: three CUDA launches (delta = rowsum(dout * out),
    then dk/dv, then dq), counted once. q/k width and v width (128, 128),
    or (192, 128) without a window."""
    _build.require_cuda(q, k, v, out, lse, dout)
    code = _build.dtype_code(q)
    B, S, H, D = q.shape
    T, hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _build.require((D, Dv) in _append.WIDTHS,
                   f"flash_attention_bwd: the kernel takes (q/k, v) head "
                   f"widths {_append.WIDTHS}, got ({D}, {Dv})")
    _build.require(window is None or D == _append.HEAD_DIM,
                   f"flash_attention_bwd: a window at head width "
                   f"{_append.HEAD_DIM} only")
    _build.require(k.dim() == 4 and v.dim() == 4 and v.shape[:3] == k.shape[:3]
                   and k.shape[0] == B and k.shape[3] == D and H % hk == 0
                   and T >= S,
                   f"flash_attention_bwd: q {tuple(q.shape)}, k "
                   f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    _build.require(all(t.dtype == q.dtype for t in (k, v, out, dout))
                   and out.shape == (B, S, H, Dv) and dout.shape == out.shape,
                   "flash_attention_bwd: q, k, v, out and dout must share one "
                   "dtype, and out/dout be [B, S, H, v width]")
    _build.require(lse.dtype == torch.float32
                   and tuple(lse.shape) == (B, H, S),
                   f"flash_attention_bwd: lse must be f32 [{B}, {H}, {S}]")
    _build.require(window is None or int(window) > 0,
                   "flash_attention_bwd: window must be > 0")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.function(_STEM, "pt_flash_attention_bwd", [_build.VOIDP] * 10 + [
        _build.INT] * 9 + [_build.FLOAT, _build.INT, _build.VOIDP])
    counter = _counters(window, D)[1]
    err = fn(*(_build.ptr(t) for t in (q, k, v, out, dout, lse, delta, dq, dk,
                                       dv)),
             B, S, T, H, hk, T - S, int(window or 0), D, Dv, float(scale), code,
             _build.stream(q.device))
    _build.launches[counter] += 1
    _build.check(err, _STEM, counter)
    return dq, dk, dv


class _FlashCausal(torch.autograd.Function):
    """Causal flash attention on CUDA, with or without a sliding window, at
    either head-width pair: forward with logsumexp, kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        out, lse = _append.launch(q, k, v, k.shape[1] - q.shape[1], None,
                                  scale, _counters(window, q.shape[-1])[0],
                                  with_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.window = scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.scale, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal: bool = False,
                         sm_scale: float | None = None,
                         window: int | None = None):
    """[B, S, H, D] x [B, S_kv, hk, D] attention; hk may divide H."""
    if window is not None and (window <= 0 or not causal):
        raise ValueError("window requires causal=True and window > 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale, window)
    if not causal:
        raise NotImplementedError(
            "flash_attention_bshd on CUDA runs the causal and sliding-window "
            "masks only; the splash kernel's full mask "
            "(paddle_tpu/ops/pallas/flash_attention.py:105-106) is not "
            "ported yet")
    s_q, s_kv = q.shape[1], k.shape[1]
    if s_kv < s_q:
        raise ValueError(f"causal attention needs s_kv >= s_q, got "
                         f"{s_kv} < {s_q}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    d_qk = q.shape[-1]
    if window is not None and (d_qk != _append.HEAD_DIM
                               or v.shape[-1] != _append.HEAD_DIM):
        raise NotImplementedError(
            "flash_attention_bshd on CUDA takes a window at head width "
            f"{_append.HEAD_DIM} only, got q/k {d_qk}, v {v.shape[-1]}")
    if _build.needs_grad(q, k, v):
        return _FlashCausal.apply(q, k, v, scale, window)
    return _append.launch(q, k, v, s_kv - s_q, None, scale,
                          _counters(window, d_qk)[0], window=window)
