"""Flash attention dispatch, [B, S, H, D] layout, grouped-query heads, and
one ring-attention hop.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
``flash_attention_bshd`` (splash attention on the TPU), its gate
``supported`` and ``splash_hop``. Where each of splash's masks runs on
CUDA:

- causal (``causal=True``, no window), splash's bottom-aligned CausalMask
  (q row i sees kv columns j <= i + s_kv - s_q): the append-attention
  kernel (csrc/append_attention.cu) at ``pos = s_kv - s_q``; its backward,
  csrc/flash_attention.cu;
- sliding window (``causal=True, window=W``), splash's
  ``LocalMask(window_size=(W - 1, 0), offset=s_kv - s_q)`` (also
  j > i + s_kv - s_q - W): the same two kernels with ``window``;
- full (``causal=False``), splash's FullMask, any s_q and s_kv: the same
  two kernels under their full mask kind;
- a ring hop (``splash_hop``: the full mask, the CausalMask at an offset,
  or the LocalMask at an offset), forward with lse only: the forward
  kernel.

Head widths (q/k, v) and what runs at each; ``_counters`` names the
launches:

- (128, 128), the Llama families: every mask, forward and backward, and
  the ring hop. Causal ``flash_attention_bshd`` / ``flash_attention_bwd``;
  a window ``flash_attention_local`` / ``flash_attention_local_bwd``; the
  full mask ``flash_attention_full`` / ``flash_attention_full_bwd``; a hop
  ``splash_hop``.
- (256, 256), Gemma's heads, which splash takes as any multiple of 128:
  the same masks and the hop. Causal ``flash_attention_256`` /
  ``flash_attention_bwd_256`` (Gemma's exact prefill and its training
  step); a window and the full mask keep their kind's counters, as does
  the hop.
- (192, 128), DeepSeek's MLA, causal without a window, with its
  ``sm_scale``: ``flash_attention_mla`` / ``flash_attention_mla_bwd``. JAX
  zero-pads those to 256 / 128 lanes for the TPU (``deepseek.py:125-143``);
  the function is the same.
- (64, 64), the entry model's heads, causal: ``flash_attention_bshd`` /
  ``flash_attention_bwd_64``.

Any other width, or a window or the full mask at (192, 128) or (64, 64),
raises on a CUDA tensor before any launch: 384, ... pass ``supported`` but
no kernel is instantiated there, and no model needs them.

When an input needs a gradient the forward also writes the f32
logsumexp, and the backward runs the dq / dk / dv kernels, as splash's
custom VJP runs its dq and dkv kernels over the same mask. On a CPU tensor
it runs the plain version, differentiated by autograd.

Scale: JAX pre-scales q in q's dtype before splash (``q * scale`` rounds in
bf16); the kernels here scale in f32 inside, as the plain version does.
``splash_hop`` keeps JAX's contract (q comes pre-scaled, scale 1).
"""
from __future__ import annotations

import math

import torch

from . import _build
from . import append_attention as _append

_STEM = "flash_attention"
# the masks of one ring hop (``splash_hop``)
HOP_KINDS = ("full", "causal", "local")
# (q/k width, v width) pairs the backward kernels are instantiated at; (64,
# 64) causal only (the entry model's heads)
BWD_WIDTHS = ((128, 128), (192, 128), (64, 64), (256, 256))
# the pairs that take a window, the full mask and the ring hop
MASK_WIDTHS = ((128, 128), (256, 256))
ENTRY_WIDTH = 64


def supported(q, k, v, dropout: float = 0.0, interpret: bool = False) -> bool:
    """The JAX gate of the kernel path (``flash_attention.py:33-49``), with
    "on the TPU" read as "on a CUDA tensor" (or ``interpret``: CPU tensors
    count too, their plain versions standing for Pallas interpret mode, as
    in the CPU parity tests): no dropout, 4-D [B, S, H, D], head width and
    both sequences multiples of 128, a whole number of q heads per KV
    head."""
    if dropout != 0.0 or q.dim() != 4:
        return False
    if not interpret and q.device.type != "cuda":
        return False
    d, s_q, h = q.shape[3], q.shape[1], q.shape[2]
    s_k, h_kv = k.shape[1], k.shape[2]
    return d % 128 == 0 and s_q % 128 == 0 and s_k % 128 == 0 and h % h_kv == 0


def _causal_mask(s_q, s_kv, window, device, offset=None):
    """[1, s_q, s_kv] bool, True where causal attention at ``offset``
    (bottom-aligned, s_kv - s_q, by default), and within the window, sees
    the column."""
    offset = s_kv - s_q if offset is None else offset
    rows = torch.arange(s_q, device=device)[:, None] + offset
    cols = torch.arange(s_kv, device=device)[None, :]
    mask = cols <= rows
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask[None]


def flash_attention_plain(q, k, v, causal=False, sm_scale=None, window=None):
    """q [B, S, H, D], k [B, S_kv, hk, D], v [B, S_kv, hk, Dv] -> [B, S, H,
    Dv] in q's type; causal bottom-aligned, optionally windowed, or full."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    mask = (_causal_mask(q.shape[1], k.shape[1], window, q.device)
            if causal else None)
    return _append.grouped_attention_plain(q, k, v, mask, scale)


def flash_attention_bwd_plain(q, k, v, out, dout, scale, window=None,
                              full=False):
    """The plain version of ``flash_attention_bwd`` on the same inputs:
    (dq, dk, dv) in q's type from f32 products over the whole causal (or
    banded, or ``full``) mask, with ``delta = rowsum(dout * out)`` from the
    given ``out``, as the kernel and splash's backward take it (the
    forward's rounded output, not the exact one)."""
    B, S, H, D = q.shape
    hk = k.shape[2]
    g = H // hk
    qg = q.reshape(B, S, hk, g, D).float()
    kf, vf = k.float(), v.float()
    dog = dout.reshape(B, S, hk, g, -1).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if not full:
        mask = _causal_mask(S, k.shape[1], window, q.device)[:, None, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
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


def _counters(window, d_qk=_append.HEAD_DIM, full=False):
    """(forward, backward) launch counters of a mask (and head width): the
    full mask and a window by their kind at any width, then causal by
    width."""
    if full:
        return "flash_attention_full", "flash_attention_full_bwd"
    if window is not None:
        return "flash_attention_local", "flash_attention_local_bwd"
    if d_qk == _append.MLA_WIDTH:
        return "flash_attention_mla", "flash_attention_mla_bwd"
    if d_qk == ENTRY_WIDTH:
        return "flash_attention_bshd", "flash_attention_bwd_64"
    if d_qk == _append.WIDE:
        return "flash_attention_256", "flash_attention_bwd_256"
    return "flash_attention_bshd", "flash_attention_bwd"


def flash_attention_bwd(q, k, v, out, lse, dout, scale, window=None,
                        full=False):
    """(dq, dk, dv) of the causal attention at pos = s_kv - s_q, or with
    ``window`` of its sliding-window band, or with ``full`` of the full
    mask (any s_q and s_kv), from the forward's ``out`` and f32 ``lse``
    [B, H, S]: three CUDA launches (delta = rowsum(dout * out), then
    dk/dv, then dq), counted once. q/k width and v width (128, 128) or
    (256, 256) under any mask, (192, 128) or (64, 64) causal without a
    window."""
    _build.require_cuda(q, k, v, out, lse, dout)
    code = _build.dtype_code(q)
    B, S, H, D = q.shape
    T, hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _build.require((D, Dv) in BWD_WIDTHS,
                   f"flash_attention_bwd: the kernel takes (q/k, v) head "
                   f"widths {BWD_WIDTHS}, got ({D}, {Dv})")
    _build.require((window is None and not full) or (D, Dv) in MASK_WIDTHS,
                   f"flash_attention_bwd: a window or the full mask at head "
                   f"widths {MASK_WIDTHS} only")
    _build.require(not (full and window is not None),
                   "flash_attention_bwd: the full mask takes no window")
    _build.require(k.dim() == 4 and v.dim() == 4 and v.shape[:3] == k.shape[:3]
                   and k.shape[0] == B and k.shape[3] == D and H % hk == 0
                   and (full or T >= S),
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
    kind = "full" if full else ("causal" if window is None else "local")
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.function(_STEM, "pt_flash_attention_bwd", [_build.VOIDP] * 10 + [
        _build.INT] * 9 + [_build.FLOAT, _build.INT, _build.INT, _build.VOIDP])
    counter = _counters(window, D, full)[1]
    err = fn(*(_build.ptr(t) for t in (q, k, v, out, dout, lse, delta, dq, dk,
                                       dv)),
             B, S, T, H, hk, 0 if full else T - S, int(window or 0), D, Dv,
             float(scale), _append.KINDS[kind], code, _build.stream(q.device))
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


class _FlashFull(torch.autograd.Function):
    """Full-mask flash attention on CUDA: forward with logsumexp, kernel
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _append.launch(q, k, v, 0, None, scale,
                                  "flash_attention_full", with_lse=True,
                                  kind="full")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.scale, full=True)
        return dq, dk, dv, None


def _require_width(what, q, v, widths):
    d_qk, d_v = q.shape[-1], v.shape[-1]
    if (d_qk, d_v) not in widths:
        raise NotImplementedError(
            f"{what} on CUDA takes (q/k, v) head widths {widths}, got "
            f"({d_qk}, {d_v})")


def flash_attention_bshd(q, k, v, causal: bool = False,
                         sm_scale: float | None = None,
                         window: int | None = None):
    """[B, S, H, D] x [B, S_kv, hk, D] attention; hk may divide H."""
    if window is not None and (window <= 0 or not causal):
        raise ValueError("window requires causal=True and window > 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale, window)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not causal:
        _require_width("the full-mask flash_attention_bshd", q, v,
                       MASK_WIDTHS)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _build.needs_grad(q, k, v):
            return _FlashFull.apply(q, k, v, scale)
        return _append.launch(q, k, v, 0, None, scale, "flash_attention_full",
                              kind="full")
    _require_width("flash_attention_bshd", q, v, _append.WIDTHS)
    s_q, s_kv = q.shape[1], k.shape[1]
    if s_kv < s_q:
        raise ValueError(f"causal attention needs s_kv >= s_q, got "
                         f"{s_kv} < {s_q}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    d_qk = q.shape[-1]
    if window is not None and (d_qk, v.shape[-1]) not in MASK_WIDTHS:
        raise NotImplementedError(
            "flash_attention_bshd on CUDA takes a window at (q/k, v) head "
            f"widths {MASK_WIDTHS} only, got ({d_qk}, {v.shape[-1]})")
    if _build.needs_grad(q, k, v):
        _require_width("flash_attention_bshd under autograd", q, v,
                       BWD_WIDTHS)
        return _FlashCausal.apply(q, k, v, scale, window)
    return _append.launch(q, k, v, s_kv - s_q, None, scale,
                          _counters(window, d_qk)[0], window=window)


def _check_hop(kind, window):
    if kind not in HOP_KINDS:
        raise ValueError(f"unknown hop mask kind {kind!r}")
    if kind == "local" and (window is None or window <= 0):
        raise ValueError("a local hop needs window > 0")


def hop_bshd_plain(q, k, v, kind, offset=0, window=None, scale=1.0):
    """The plain version of ``hop_bshd``: f32 scores, the hop's mask, f32
    logsumexp; a row that sees no column gives out 0 and lse -inf."""
    _check_hop(kind, window)
    B, S, H, D = q.shape
    hk = k.shape[2]
    qg = q.reshape(B, S, hk, H // hk, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if kind != "full":
        mask = _causal_mask(S, k.shape[1], window if kind == "local" else None,
                            q.device, offset=offset)
        scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                     # [B, hk, g, S]
    finite = torch.where(torch.isneginf(lse), 0.0, lse)
    probs = torch.exp(scores - finite[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return (out.reshape(B, S, H, v.shape[-1]).to(q.dtype),
            lse.reshape(B, H, S))


def hop_bshd(q, k, v, kind, offset=0, window=None, scale=1.0):
    """One ring hop in the port's [B, S, H, D] layout: q [B, S, H, D] against
    k [B, T, hk, D], v [B, T, hk, Dv] under ``kind`` ("full"; "causal" at
    ``offset`` >= 0: row i sees column j <= i + offset; "local" at
    ``offset`` with ``window``: also j > i + offset - window), scores times
    ``scale``. Returns (out [B, S, H, Dv] in q's dtype, lse [B, H, S] f32).
    A row that sees no column (a local hop's dead row) gives out 0 and lse
    -inf (splash writes a finite, hugely negative lse and another out,
    which the combine weighs by exp(lse - m) = 0 all the same). On CUDA it
    launches the forward kernel, counted as ``splash_hop``; it has no
    backward there (splash's residual output has none)."""
    _check_hop(kind, window)
    if q.device.type == "cpu":
        return hop_bshd_plain(q, k, v, kind, offset, window, scale)
    _build.require_no_grad("splash_hop", q, k, v)
    _require_width("splash_hop", q, v, MASK_WIDTHS)
    return _append.launch(
        q.contiguous(), k.contiguous(), v.contiguous(), offset, None, scale,
        "splash_hop", with_lse=True,
        window=window if kind == "local" else None, kind=kind)


def splash_hop_plain(q, k, v, kind, offset=0, window=None):
    """The plain version of ``splash_hop``, in its layout."""
    out, lse = hop_bshd_plain(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), kind, offset, window)
    return out.transpose(1, 2), lse


def splash_hop(q, k, v, kind, offset=0, window=None):
    """JAX's ``splash_hop`` contract: one flash hop on [B, H, S, D] (q
    pre-scaled), k / v [B, hk, T, D], grouped-query heads; returns (out
    [B, H, S, D] in q's dtype, logsumexp [B, H, S] f32); dead rows as in
    ``hop_bshd``. The kernel reads [B, S, H, D], so this layout is
    transposed at the boundary: on CUDA a copy of q, k and v in, and out
    comes back as a transposed view of the kernel's. The port's own ring
    calls ``hop_bshd`` and never leaves [B, S, H, D]."""
    out, lse = hop_bshd(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), kind, offset, window)
    return out.transpose(1, 2), lse
