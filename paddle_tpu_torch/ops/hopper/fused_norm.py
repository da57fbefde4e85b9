"""RMSNorm and residual-add + RMSNorm (CUDA kernels in csrc/fused_norm.cu),
and the plain rotary helpers the cached path uses.

Counterpart of ``paddle_tpu/ops/pallas/fused_norm.py``. The plain versions
put their casts where the Pallas kernels put them (which is what the TPU
runs): the normalised value is computed in f32, rounded to the input type,
then multiplied by the weight; ``add_rms_norm`` normalises the f32 sum
``x + residual`` and returns that sum, rounded, as the new residual.

On a CPU tensor each function runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

_STEM = "fused_norm"


def _normalize(h32, weight, eps, dtype):
    rms = torch.rsqrt(h32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (h32 * rms).to(dtype) * weight


def rms_norm_plain(x, weight, eps=1e-6):
    return _normalize(x.float(), weight, eps, x.dtype)


def add_rms_norm_plain(x, residual, weight, eps=1e-6):
    h = x.float() + residual.float()
    return _normalize(h, weight, eps, x.dtype), h.to(x.dtype)


def _check(x, weight, *others):
    _build.require_cuda(x, weight, *others)
    code = _build.dtype_code(x)
    d = x.shape[-1]
    _build.require(all(t.dtype == x.dtype for t in (weight, *others)),
                   "fused_norm: all inputs must share one dtype")
    _build.require(tuple(weight.shape) == (d,),
                   f"fused_norm: weight shape {tuple(weight.shape)} != ({d},)")
    _build.require(all(t.shape == x.shape for t in others),
                   "fused_norm: x and residual shapes differ")
    _build.require(d % 8 == 0, f"fused_norm: last dim {d} must be a multiple "
                               "of 8 (16-byte vector loads)")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (x, weight, *others)),
                   "fused_norm: inputs must be 16-byte aligned")
    return code, x.numel() // d, d


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis; weight [hidden]."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    code, rows, d = _check(x, weight)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _build.function(_STEM, "pt_rms_norm", [
        _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.INT, _build.INT,
        _build.FLOAT, _build.INT, _build.VOIDP])
    err = fn(_build.ptr(x), _build.ptr(weight), _build.ptr(out), rows, d,
             float(eps), code, _build.stream(x.device))
    _build.launches["rms_norm"] += 1
    _build.check(err, _STEM, "rms_norm")
    return out


def add_rms_norm(x, residual, weight, eps=1e-6):
    """(rmsnorm(x + residual) * weight, x + residual) in one pass."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, residual, weight, eps)
    code, rows, d = _check(x, weight, residual)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    if rows == 0:
        return out, h
    fn = _build.function(_STEM, "pt_add_rms_norm", [
        _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.VOIDP,
        _build.INT, _build.INT, _build.FLOAT, _build.INT, _build.VOIDP])
    err = fn(_build.ptr(x), _build.ptr(residual), _build.ptr(weight),
             _build.ptr(out), _build.ptr(h), rows, d, float(eps), code,
             _build.stream(x.device))
    _build.launches["add_rms_norm"] += 1
    _build.check(err, _STEM, "add_rms_norm")
    return out, h


# ---------------- rotary (plain: the cached path ropes outside any kernel) ---

def partial_rope(full_fn, x, cos, sin, *args):
    """Tables narrower than the head rotate only the leading slice through
    ``full_fn``; the tail passes through. A partial width must be even and
    smaller than the head."""
    r = cos.shape[-1]
    if r == x.shape[-1]:
        return full_fn(x, cos, sin, *args)
    if r > x.shape[-1] or r % 2 or r < 2:
        raise ValueError(
            f"rope table width {r} is not a valid partial width for "
            f"head_dim {x.shape[-1]} (must be even and smaller)")
    return torch.cat([full_fn(x[..., :r], cos, sin, *args), x[..., r:]],
                     dim=-1)


def rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)


def _rope_ref_full(x, cos, sin):
    c = cos.reshape(1, cos.shape[-2], 1, cos.shape[-1])
    s = sin.reshape(1, sin.shape[-2], 1, sin.shape[-1])
    return (x.float() * c + rotate_half(x).float() * s).to(x.dtype)


def rope_ref(x, cos, sin):
    """Rotate-half RoPE on [B, S, H, D]; cos/sin [S, D] f32 (full width or
    an even partial width)."""
    return partial_rope(_rope_ref_full, x, cos, sin)
