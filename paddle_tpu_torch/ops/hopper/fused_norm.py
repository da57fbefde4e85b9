"""RMSNorm, residual-add + RMSNorm and rotate-half RoPE (CUDA kernels in
csrc/fused_norm.cu), each differentiable.

Counterpart of ``paddle_tpu/ops/pallas/fused_norm.py``. The plain versions
put their casts where the Pallas kernels put them (which is what the TPU
runs): the normalised value is computed in f32, rounded to the input type,
then multiplied by the weight; ``add_rms_norm`` normalises the f32 sum
``x + residual`` and returns that sum, rounded, as the new residual; RoPE
computes ``x * cos + rotate_half(x) * sin`` in f32 and rounds once.

Gradients follow the JAX custom VJPs, which recompute the *reference*
formulation through autodiff (``_rms_bwd``, ``_add_rms_bwd``,
``_rope_bwd``): the backward passes here are PyTorch ops, as the JAX
package's are XLA ops. ``add_rms_norm``'s reference differentiates
``x + residual`` rounded to the input type, while its forward normalises
the f32 sum; both are kept as the JAX package has them.

On a CPU tensor each forward runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, autotune

_STEM = "fused_norm"


def _normalize(h32, weight, eps, dtype):
    rms = torch.rsqrt(h32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (h32 * rms).to(dtype) * weight


def rms_norm_plain(x, weight, eps=1e-6):
    return _normalize(x.float(), weight, eps, x.dtype)


def add_rms_norm_plain(x, residual, weight, eps=1e-6):
    h = x.float() + residual.float()
    return _normalize(h, weight, eps, x.dtype), h.to(x.dtype)


def _add_rms_ref(x, residual, weight, eps):
    """``_add_rms_ref``: the sum rounded to the input type first (what the
    JAX VJP differentiates)."""
    h = x + residual
    return rms_norm_plain(h, weight, eps), h


def _recompute_grad(fn, inputs, needs, grads):
    """VJP of ``fn`` at ``inputs`` by recomputing it under autograd, for the
    inputs whose ``needs`` flag is set (None for the others)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(outs, wanted, grads)) if wanted else iter(())
    return [next(got) if n else None for n in needs]


_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 16-byte vectors of a row the rms_norm kernel holds in registers (1024
# threads of 4): d up to 32768 in bf16, 16384 in f32
MAX_ROW_VECTORS = 4096
# the one-pass kernel's vectors a thread, threads a block at small d, and
# threads a block at most
RMS_VPT, RMS_ROW_THREADS, MAX_THREADS = 4, 128, 1024
_RMS_ARGTYPES = [_build.VOIDP] * 3 + [_build.INT] * 2 + [
    _build.FLOAT, _build.INT, _build.INT, _build.VOIDP]
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def rms_layout(d: int, elem_size: int):
    """(threads a row, rows a block by the kernel's rule) of the one-pass
    ``rms_norm``: whole warps a row, 4 16-byte vectors a thread; 128
    threads a block at small d, one row a block from 128 threads a row."""
    n_vec = d * elem_size // 16
    tpr = 32 * -(-n_vec // (32 * RMS_VPT))
    return tpr, (1 if tpr >= RMS_ROW_THREADS else RMS_ROW_THREADS // tpr)


def rms_candidates(d: int, elem_size: int):
    """The autotune space of ``rms_norm``'s rows a block: the powers of two
    that keep a block within 1024 threads."""
    tpr, _ = rms_layout(d, elem_size)
    return [(1 << i,) for i in range(11) if tpr << i <= MAX_THREADS]


def _norm_cost(params: dict, choice: tuple) -> dict:
    """The JAX ``_norm_cost`` of ``rms_norm`` (x read and out written, the
    weight row once; a few operations an element) with the card's grid: a
    block of ``rpb`` rows, as many resident on an SM as its 2048 threads
    (at most 32 blocks) allow; the block's shared memory is its 32 partial
    sums."""
    rows, d = int(params["rows"]), int(params["d"])
    it = _ITEMSIZE[params["dtype"]]
    (rpb,) = choice
    threads = rms_layout(d, it)[0] * rpb
    return {"bytes": 2 * rows * d * it + d * it,
            "flops": 4 * rows * d,
            "vmem_bytes": 32 * 4,
            "grid": -(-rows // max(rpb, 1)),
            "blocks_per_sm": max(1, min(32, 2048 // threads))}


autotune.register_cost_model("rms_norm", _norm_cost)
_ADD_RMS_ARGTYPES = [_build.VOIDP] * 5 + [_build.INT] * 2 + [
    _build.FLOAT, _build.INT, _build.VOIDP]


def _check(x, weight, residual=None):
    """(dtype code, rows, d) of inputs a norm kernel takes; raises on any
    other. Each tensor's dtype, shape and address is read once."""
    if residual is None:
        _build.require_cuda(x, weight)
    else:
        _build.require_cuda(x, weight, residual)
    dtype = x.dtype
    code = _CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if weight.dtype != dtype or (residual is not None
                                 and residual.dtype != dtype):
        raise ValueError("fused_norm: all inputs must share one dtype")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"fused_norm: weight shape {tuple(weight.shape)} != "
                         f"({d},)")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("fused_norm: x and residual shapes differ")
    if d % 8:
        raise ValueError(f"fused_norm: last dim {d} must be a multiple of 8 "
                         "(16-byte vector loads)")
    if (x.data_ptr() | weight.data_ptr()
            | (0 if residual is None else residual.data_ptr())) & 15:
        raise ValueError("fused_norm: inputs must be 16-byte aligned")
    return code, x.numel() // d, d


def _rms_norm_forward(x, weight, eps):
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    code, rows, d = _check(x, weight)
    if d * x.element_size() > 16 * MAX_ROW_VECTORS:
        raise ValueError(f"rms_norm: the kernel takes rows of at most "
                         f"{MAX_ROW_VECTORS} 16-byte vectors, got d={d} in "
                         f"{x.dtype}")
    if rows == 0:
        return torch.empty_like(x)
    rpb = (_rows_per_block(x, weight, eps, code, rows, d)
           if autotune.enabled() else 0)
    return _launch_rms(x, weight, eps, code, rows, d, rpb)


def _rows_per_block(x, weight, eps, code, rows, d):
    """``rms_norm``'s rows a block from the autotune search (the JAX
    ``_tuned_block_rows``): the kernel's rule unless the cost table knows,
    or an eager call on the card can measure, a faster one."""
    es = x.element_size()
    dt = "bfloat16" if code else "float32"

    def runner(cfg):
        return lambda: _launch_rms(x, weight, eps, code, rows, d, cfg[0])

    (rpb,) = autotune.tuned(
        "rms_norm", f"rows{rows} d{d} {dt}", (rms_layout(d, es)[1],),
        rms_candidates(d, es), runner, (x, weight),
        params={"rows": rows, "d": d, "dtype": dt})
    return rpb


def _launch_rms(x, weight, eps, code, rows, d, rpb):
    """One launch of the kernel at ``rpb`` rows a block (0: its rule),
    refused before the launch when a block would pass 1024 threads."""
    tpr = rms_layout(d, x.element_size())[0]
    _build.require(rpb == 0 or 0 < rpb and tpr * rpb <= MAX_THREADS,
                   f"rms_norm: {rpb} rows a block of {tpr} threads passes "
                   f"{MAX_THREADS} threads")
    out = torch.empty_like(x)
    err = _build.function(_STEM, "pt_rms_norm", _RMS_ARGTYPES)(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, float(eps),
        code, rpb, _build.stream(x.device))
    _build.launches["rms_norm"] += 1
    if err:
        _build.check(err, _STEM, "rms_norm")
    return out


def _add_rms_norm_forward(x, residual, weight, eps):
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, residual, weight, eps)
    code, rows, d = _check(x, weight, residual)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    if rows == 0:
        return out, h
    err = _build.function(_STEM, "pt_add_rms_norm", _ADD_RMS_ARGTYPES)(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(), out.data_ptr(),
        h.data_ptr(), rows, d, float(eps), code, _build.stream(x.device))
    _build.launches["add_rms_norm"] += 1
    if err:
        _build.check(err, _STEM, "add_rms_norm")
    return out, h


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _recompute_grad(
            lambda a, w: rms_norm_plain(a, w, ctx.eps), (x, weight),
            ctx.needs_input_grad[:2], (g,))
        return dx, dw, None


class _AddRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        return _add_rms_norm_forward(x, residual, weight, eps)

    @staticmethod
    def backward(ctx, g_out, g_h):
        dx, dr, dw = _recompute_grad(
            lambda a, r, w: _add_rms_ref(a, r, w, ctx.eps), ctx.saved_tensors,
            ctx.needs_input_grad[:3], (g_out, g_h))
        return dx, dr, dw, None


# Each wrapper enters its autograd Function only when a graph is recorded:
# serving runs under inference mode, and its launches skip the Function's
# per-call host cost.

def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis; weight [hidden]."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x, weight, eps)
    return _rms_norm_forward(x, weight, eps)


def add_rms_norm(x, residual, weight, eps=1e-6):
    """(rmsnorm(x + residual) * weight, x + residual) in one pass."""
    if _build.needs_grad(x, residual, weight):
        return _AddRmsNorm.apply(x, residual, weight, eps)
    return _add_rms_norm_forward(x, residual, weight, eps)


# ---------------- rotary -----------------------------------------------------

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


def _fused_rope_forward(x, cos, sin):
    if x.device.type == "cpu":
        return _rope_ref_full(x, cos, sin)
    x = x.contiguous()          # a partial width hands in a strided slice
    _build.require_cuda(x, cos, sin)
    code = _build.dtype_code(x)
    _build.require(x.dim() == 4, f"fused_rope: x must be [B, S, H, D], got "
                                 f"{tuple(x.shape)}")
    B, S, H, D = x.shape
    _build.require(D % 2 == 0, f"fused_rope: head width {D} must be even")
    _build.require(cos.dtype == torch.float32 and sin.dtype == torch.float32
                   and tuple(cos.shape) == (S, D)
                   and tuple(sin.shape) == (S, D),
                   f"fused_rope: cos/sin must be f32 [{S}, {D}]")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (x, cos, sin)),
                   "fused_rope: inputs must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _build.function(_STEM, "pt_fused_rope", [
        _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.INT64,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.VOIDP])
    err = fn(_build.ptr(x), _build.ptr(cos), _build.ptr(sin), _build.ptr(out),
             B * S * H, S, H, D, code, _build.stream(x.device))
    _build.launches["fused_rope"] += 1
    _build.check(err, _STEM, "fused_rope")
    return out


class _FusedRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(x, cos, sin)
        return _fused_rope_forward(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        return tuple(_recompute_grad(rope_ref, ctx.saved_tensors,
                                     ctx.needs_input_grad, (g,)))


def fused_rope(x, cos, sin):
    """Rotate-half RoPE on x [B, S, H, D] against f32 cos/sin [S, D] (the
    full head width)."""
    if _build.needs_grad(x, cos, sin):
        return _FusedRope.apply(x, cos, sin)
    return _fused_rope_forward(x, cos, sin)


def apply_rope(x, cos, sin):
    """Width-aware rotary over the fused kernel (see ``partial_rope``)."""
    return partial_rope(fused_rope, x, cos, sin)
