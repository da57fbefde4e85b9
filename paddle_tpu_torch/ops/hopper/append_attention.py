"""Append attention: a chunk of S queries at offset ``pos`` against a dense
KV buffer, grouped-query heads in-kernel (CUDA kernel in
csrc/append_attention.cu).

Counterpart of ``paddle_tpu/ops/pallas/append_attention.py``, with its
signature and layouts: q [B, S, H, D] (already roped), k_buf/v_buf
[B, T, hk, D] (chunk already written at ``pos``), ``allowed`` an optional
[B, T] column mask. Query s sees columns t <= pos + s that are allowed.
The kernel also runs the causal, sliding-window and full-mask forward of
``flash_attention.flash_attention_bshd`` and its ring hop ``splash_hop``
(``launch`` with ``window`` or ``kind``).

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises. The kernel takes float32 / bfloat16 and head widths
(q/k, v) of (128, 128), (256, 256) for Gemma (counted as
``append_attention_256``), or (192, 128) for DeepSeek's MLA prefill and
(64, 64) for the entry model (``entry.py``) through the flash forward.
"""
from __future__ import annotations

import math

import torch

from . import _build

_STEM = "append_attention"
HEAD_DIM = 128
# (q/k width, v width) pairs the kernel is instantiated at
WIDTHS = ((128, 128), (192, 128), (64, 64), (256, 256))
MLA_WIDTH = 192
# Gemma's heads: the (256, 256) instance, counted apart
WIDE = 256
# the splash masks the kernel takes, by their code in the C interface
KINDS = {"causal": 0, "local": 1, "full": 2}


def plain_width(d_qk: int, d_v: int) -> bool:
    """Whether attention at head widths (``d_qk``, ``d_v``) takes the plain
    route JAX takes there: the kernel has no instance at the pair
    (``WIDTHS``) and JAX's gates refuse the width too (``d_qk % 128 != 0``,
    ``ops/pallas/flash_attention.py:43``, ``append_attention.py:56``), as
    Phi-3's heads of 96. Decided on the host from the shape, before any
    launch, on every device; not a fallback: a width with an instance
    launches the kernel or raises, (64, 64) included, where JAX runs its
    einsum and the port keeps its kernel."""
    return (d_qk, d_v) not in WIDTHS and d_qk % 128 != 0


def grouped_attention_plain(q, k, v, mask, scale, softcap=None):
    """f32 ``softmax(q k^T * scale) v`` with grouped-query heads: q
    [B, S, H, D], k [B, T, hk, D], v [B, T, hk, Dv], ``mask`` None or
    [B or 1, S, T] bool (True = visible). Returns [B, S, H, Dv]. The plain
    attention every kernel here is held to. ``softcap``: Gemma2's tanh
    cap on the scaled scores, ``softcap * tanh(s / softcap)``, before the
    mask (HF's order, ``generation.py:135-137``); no kernel takes it."""
    B, S, H, D = q.shape
    hk = k.shape[2]
    qg = q.reshape(B, S, hk, H // hk, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def chunk_positions(pos, S, device):
    """[S] int64 positions pos .. pos + S - 1 of a chunk: ``pos`` an int or
    a one-element int tensor on ``device`` (the device ``pos`` of the dense
    caches)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(()).long() + torch.arange(S, device=device)
    return torch.arange(int(pos), int(pos) + S, device=device)


def append_attention_plain(q, k_buf, v_buf, pos, allowed=None, window=None,
                           softcap=None):
    """The einsum branch of ``generation.cached_attention``: f32 scores
    over the whole buffer (tanh-capped with ``softcap``, before the masks)
    with the causal, column and sliding window masks, f32 softmax. A window
    with a column mask counts true positions (right-padded rows); the
    kernel takes a window only without one, where it counts buffer slots,
    and only on the flash route, and no softcap.
    ``pos``: an int or a one-element int32 tensor on q's device."""
    S, T = q.shape[1], k_buf.shape[1]
    t_idx = torch.arange(T, device=q.device)
    qpos = chunk_positions(pos, S, q.device)
    mask = (t_idx[None, :] <= qpos[:, None])[None]              # [1, S, T]
    if window is not None and allowed is None:
        mask = mask & (t_idx[None, :] > qpos[:, None] - window)
    if allowed is not None:
        mask = mask & allowed.bool()[:, None, :]
        if window is not None:
            # right-padded rows: the window counts true positions, i.e.
            # allowed columns before the query's slot
            colpos = torch.cumsum(allowed.int(), dim=1) - 1      # [B, T]
            curpos = colpos.index_select(1, qpos)                # [B, S]
            mask = mask & (colpos[:, None, :] > curpos[:, :, None] - window)
    return grouped_attention_plain(q, k_buf, v_buf, mask,
                                   1.0 / math.sqrt(q.shape[-1]), softcap)


def launch(q, k_buf, v_buf, pos, allowed, scale, counter, with_lse=False,
           window=None, kind=None):
    """Run the CUDA kernel; ``counter`` names the wrapper whose launch this
    is (append attention, the flash forward's masks and the ring hop share
    the kernel). ``kind``: "causal" (query s sees columns t <= pos + s),
    "local" (also t > pos + s - window) or "full" (every column; ``pos``
    is not read); by default "local" with a window, else "causal".
    ``pos``: an int, or a one-element int32 tensor on q's device that the
    kernel reads at entry (``pos_dev``; a CUDA graph of the call then
    serves every position). Returns out, or (out, lse [B, H, S] f32) with
    ``with_lse``."""
    kind = kind or ("causal" if window is None else "local")
    pos_dev = None
    if isinstance(pos, torch.Tensor):
        _build.require(pos.dtype == torch.int32 and pos.numel() == 1,
                       f"{counter}: a device pos is one int32")
        pos_dev, pos = pos, 0
    tensors = [q, k_buf, v_buf] + [t for t in (allowed, pos_dev)
                                   if t is not None]
    _build.require_cuda(*tensors)
    code = _build.dtype_code(q)
    B, S, H, D = q.shape
    _build.require(k_buf.dim() == 4 and v_buf.dim() == 4
                   and v_buf.shape[:3] == k_buf.shape[:3],
                   f"{counter}: k must be [B, T, hk, D] and v [B, T, hk, Dv]")
    T, hk, Dv = k_buf.shape[1], k_buf.shape[2], v_buf.shape[3]
    _build.require(k_buf.shape[0] == B and k_buf.shape[3] == D,
                   f"{counter}: q {tuple(q.shape)} and k {tuple(k_buf.shape)} "
                   "disagree")
    _build.require((D, Dv) in WIDTHS, f"{counter}: the kernel takes (q/k, v) "
                                      f"head widths {WIDTHS}, got ({D}, {Dv})")
    _build.require(H % hk == 0, f"{counter}: {H} heads over {hk} KV heads")
    _build.require(k_buf.dtype == q.dtype and v_buf.dtype == q.dtype,
                   f"{counter}: q, k and v must share one dtype")
    _build.require(kind in KINDS and (kind == "local") == (window is not None),
                   f"{counter}: kind {kind!r} with window {window}: a window "
                   "comes with the local mask and only there")
    _build.require(0 <= int(pos), f"{counter}: pos must be >= 0")
    _build.require(window is None or (int(window) > 0 and allowed is None),
                   f"{counter}: a window must be > 0 and comes without a "
                   "column mask")
    a_ptr = None
    if allowed is not None:
        _build.require(tuple(allowed.shape) == (B, T),
                       f"{counter}: allowed must be [B, T] = ({B}, {T})")
        allowed = allowed.contiguous()
        if allowed.dtype != torch.uint8:
            allowed = allowed.to(torch.uint8)
        a_ptr = _build.ptr(allowed)
    out = q.new_empty(B, S, H, Dv)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() > 0:
        fn = _build.function(_STEM, "pt_append_attention", [_build.VOIDP] * 6 + [
            _build.INT] * 9 + [_build.FLOAT, _build.INT, _build.INT,
                               _build.VOIDP, _build.VOIDP])
        err = fn(_build.ptr(q), _build.ptr(k_buf), _build.ptr(v_buf), a_ptr,
                 _build.ptr(out), None if lse is None else _build.ptr(lse),
                 B, S, T, H, hk, D, Dv, int(pos), int(window or 0),
                 float(scale), KINDS[kind], code,
                 None if pos_dev is None else _build.ptr(pos_dev),
                 _build.stream(q.device))
        _build.launches[counter] += 1
        _build.check(err, _STEM, counter)
    return (out, lse) if with_lse else out


def append_attention(q, k_buf, v_buf, pos, allowed=None):
    """q [B,S,H,D] against k_buf/v_buf [B,T,hk,D] at offset ``pos`` (an int,
    or a one-element int32 tensor on q's device, as the Pallas kernel takes
    it by scalar prefetch) with an optional [B,T] column mask. Returns
    [B,S,H,D] in q's dtype. On CUDA it has no backward and refuses inputs
    that need a gradient. Counted as ``append_attention``, or
    ``append_attention_256`` at Gemma's head width."""
    if q.device.type == "cpu":
        return append_attention_plain(q, k_buf, v_buf, pos, allowed)
    _build.require_no_grad("append_attention", q, k_buf, v_buf)
    d = q.shape[-1]
    return launch(q, k_buf, v_buf, pos, allowed, 1.0 / math.sqrt(d),
                  "append_attention_256" if d == WIDE else "append_attention")
