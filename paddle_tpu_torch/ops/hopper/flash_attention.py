"""Flash attention dispatch, [B, S, H, D] layout, grouped-query heads.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
``flash_attention_bshd`` (splash attention on the TPU). On CUDA its causal,
no-window forward launches the append-attention kernel
(csrc/append_attention.cu) at ``pos = s_kv - s_q``: that is exactly
splash's bottom-aligned causal mask (q row i sees kv columns
j <= i + s_kv - s_q). The splash kernel's other masks (sliding window,
full) and its backward are not ported yet: on CUDA they raise
``NotImplementedError`` rather than run plain code.

On a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import math

import torch

from . import append_attention as _append


def flash_attention_plain(q, k, v, causal=False, sm_scale=None, window=None):
    s_q, s_kv = q.shape[1], k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        rows = torch.arange(s_q, device=q.device)[:, None] + (s_kv - s_q)
        cols = torch.arange(s_kv, device=q.device)[None, :]
        mask = cols <= rows
        if window is not None:
            mask = mask & (cols > rows - window)
        mask = mask[None]
    return _append.grouped_attention_plain(q, k, v, mask, scale)


def flash_attention_bshd(q, k, v, causal: bool = False,
                         sm_scale: float | None = None,
                         window: int | None = None):
    """[B, S, H, D] x [B, S_kv, hk, D] attention; hk may divide H."""
    if window is not None and (window <= 0 or not causal):
        raise ValueError("window requires causal=True and window > 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale, window)
    if not causal or window is not None:
        raise NotImplementedError(
            "flash_attention_bshd on CUDA runs the causal, no-window forward "
            "only; the splash kernel's full and sliding-window masks "
            "(paddle_tpu/ops/pallas/flash_attention.py) are not ported yet")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention_bshd on CUDA has no backward yet (the splash "
            "backward is not ported); call it on tensors that need no grad")
    s_q, s_kv = q.shape[1], k.shape[1]
    if s_kv < s_q:
        raise ValueError(f"causal attention needs s_kv >= s_q, got "
                         f"{s_kv} < {s_q}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _append.launch(q, k, v, s_kv - s_q, None, scale,
                          "flash_attention_bshd")
