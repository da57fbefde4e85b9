"""The fused decode tail (CUDA kernels in csrc/decode_tail.cu).

Counterpart of ``paddle_tpu/ops/pallas/decode_tail.py``: two kernels that
collapse the non-attention work of a decode layer into two launches.

- :func:`fused_qkv_rope` — ``rms_norm(x)`` → ``x·Wq``, ``x·Wk``,
  ``x·Wv`` (f32 sums) → rotate-half RoPE of q and k at each row's
  position.
- :func:`fused_epilogue` — ``attn·Wo`` (f32 sums) → cast → + residual in
  f32 → RMSNorm of the f32 sum; returns (normed, new residual), the
  contract of ``add_rms_norm``.

Rows are independent: B rows for a decode step, B·S flattened rows for a
speculative-verify chunk. The plain versions put every cast where the
Pallas bodies put it (``decode_tail.py:197-224``, ``:311-316``), so the
fused step matches the discrete one up to the order of the f32 sums.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Neither kernel has a backward (the Pallas
kernels have none): on CUDA they refuse inputs that need a gradient.

The JAX package searches the contraction block with its autotuner
(``_block_k``); the card kernels use one fixed geometry (32 output columns
by up to 32 rows per block, the contraction in chunks of 256, see the
source), so nothing is searched here.
"""
from __future__ import annotations

import torch

from . import _build

_STEM = "decode_tail"
_MIN_BLOCK = 128
# the card kernels' own limit (replacing the JAX VMEM budget): the epilogue
# keeps one arrival counter per 32-row tile in a fixed buffer of
# _TILES counters per device
_ROW_TILE = 32
_TILES = 256
MAX_ROWS = _ROW_TILE * _TILES

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def enabled() -> bool:
    from ...utils.flags import flag

    return bool(flag("FLAGS_use_fused_decode_tail"))


# ---------------------------------------------------------------------------
# cost models: the bytes and operations a call needs (bounds in chip_smoke)
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return _ITEMSIZE[str(dtype).replace("torch.", "")]


def _qkv_cost(params: dict) -> dict:
    """``_qkv_cost`` without the VMEM term and the block choice: the weights
    read once, x read, q|k|v written."""
    b, hidden = int(params["batch"]), int(params["hidden"])
    wtot = int(params["wtot"])          # (H + 2*hk) * head_dim
    it = _itemsize(params["dtype"])
    return {"bytes": hidden * wtot * it + b * hidden * it + b * wtot * it,
            "flops": 2 * b * hidden * wtot}


def _epilogue_cost(params: dict) -> dict:
    """``_epilogue_cost`` likewise: Wo and attn read, residual read, normed
    and the new residual written."""
    b, width = int(params["batch"]), int(params["width"])
    hidden = int(params["hidden"])
    it = _itemsize(params["dtype"])
    return {"bytes": (width * hidden * it + b * width * it
                      + 3 * b * hidden * it),
            "flops": 2 * b * width * hidden}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _rope_rotate(flat, cos, sin, n_heads, d):
    """Rotate-half RoPE on [R, n_heads*d] with per-row f32 cos / sin
    [R, d]: f32 products and sum, one cast at the end."""
    r = flat.shape[0]
    x = flat.reshape(r, n_heads, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    out = x.float() * cos[:, None, :] + rot.float() * sin[:, None, :]
    return out.to(flat.dtype).reshape(r, n_heads * d)


def fused_qkv_rope_plain(x, w_norm, wq, wk, wv, cos_row, sin_row, eps,
                         n_heads, n_kv, d):
    x32 = x.float()
    rms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    normed = ((x32 * rms).to(x.dtype) * w_norm).float()
    q, k, v = (torch.matmul(normed, w.float()).to(x.dtype)
               for w in (wq, wk, wv))
    cos, sin = cos_row.float(), sin_row.float()
    return (_rope_rotate(q, cos, sin, n_heads, d),
            _rope_rotate(k, cos, sin, n_kv, d), v)


def fused_epilogue_plain(attn, wo, residual, w_norm, eps):
    od = torch.matmul(attn.float(), wo.float()).to(attn.dtype)
    h = od.float() + residual.to(attn.dtype).float()
    rms = torch.rsqrt(h.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (h * rms).to(attn.dtype) * w_norm, h.to(attn.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def fused_qkv_rope(x, w_norm, wq, wk, wv, cos_row, sin_row, eps,
                   n_heads: int, n_kv: int, d: int):
    """x [R, hidden] → (q [R, H*d], k [R, hk*d], v [R, hk*d]), q and k
    roped at each row's position (``cos_row`` / ``sin_row`` [R, d] f32,
    gathered by the caller)."""
    if x.device.type == "cpu":
        return fused_qkv_rope_plain(x, w_norm, wq, wk, wv, cos_row, sin_row,
                                    eps, n_heads, n_kv, d)
    cos_row, sin_row = cos_row.contiguous(), sin_row.contiguous()
    _build.require_no_grad("fused_qkv_rope", x, w_norm, wq, wk, wv)
    _build.require_cuda(x, w_norm, wq, wk, wv, cos_row, sin_row)
    code = _build.dtype_code(x)
    R, hidden = x.shape
    _build.require(all(t.dtype == x.dtype for t in (w_norm, wq, wk, wv)),
                   "fused_qkv_rope: x and the weights must share one dtype")
    _build.require(tuple(w_norm.shape) == (hidden,)
                   and tuple(wq.shape) == (hidden, n_heads * d)
                   and tuple(wk.shape) == (hidden, n_kv * d)
                   and tuple(wv.shape) == (hidden, n_kv * d),
                   "fused_qkv_rope: weight shapes disagree with x and heads")
    _build.require(cos_row.dtype == torch.float32
                   and sin_row.dtype == torch.float32
                   and tuple(cos_row.shape) == (R, d)
                   and tuple(sin_row.shape) == (R, d),
                   f"fused_qkv_rope: cos/sin must be f32 [{R}, {d}]")
    _build.require(supported(R, hidden, n_heads, n_kv, d, d,
                             x.element_size()),
                   "fused_qkv_rope: shape outside the kernel's limits")
    _build.require(_aligned(x, w_norm, wq, wk, wv),
                   "fused_qkv_rope: inputs must be 16-byte aligned")
    q = x.new_empty(R, n_heads * d)
    k = x.new_empty(R, n_kv * d)
    v = x.new_empty(R, n_kv * d)
    if R == 0:
        return q, k, v
    P, I, F = _build.VOIDP, _build.INT, _build.FLOAT
    fn = _build.function(_STEM, "pt_fused_qkv_rope",
                         [P] * 10 + [I] * 5 + [F, I, P])
    err = fn(*(_build.ptr(t) for t in (x, w_norm, wq, wk, wv, cos_row,
                                       sin_row, q, k, v)),
             R, hidden, n_heads, n_kv, d, float(eps), code,
             _build.stream(x.device))
    _build.launches["fused_qkv_rope"] += 1
    _build.check(err, _STEM, "fused_qkv_rope")
    return q, k, v


_counters: dict = {}


def _arrival_counters(device) -> torch.Tensor:
    """The epilogue's per-row-tile arrival counters on ``device``: zeroed
    once, and left at zero by every launch (one stream per device)."""
    c = _counters.get(device)
    if c is None:
        c = _counters[device] = torch.zeros(_TILES, dtype=torch.int32,
                                            device=device)
    return c


def fused_epilogue(attn, wo, residual, w_norm, eps):
    """attn [R, H*d] (attention output before o_proj), wo [H*d, hidden],
    residual [R, hidden] → (normed, new residual), both [R, hidden]:
    ``add_rms_norm(attn @ wo, residual, w_norm)`` in one launch."""
    if attn.device.type == "cpu":
        return fused_epilogue_plain(attn, wo, residual, w_norm, eps)
    _build.require_no_grad("fused_epilogue", attn, wo, residual, w_norm)
    _build.require_cuda(attn, wo, residual, w_norm)
    code = _build.dtype_code(attn)
    R, width = attn.shape
    hidden = wo.shape[1]
    _build.require(all(t.dtype == attn.dtype for t in (wo, residual, w_norm)),
                   "fused_epilogue: attn, wo, residual and the norm weight "
                   "must share one dtype")
    _build.require(tuple(wo.shape) == (width, hidden)
                   and tuple(residual.shape) == (R, hidden)
                   and tuple(w_norm.shape) == (hidden,),
                   "fused_epilogue: shapes disagree")
    _build.require(width % _MIN_BLOCK == 0 and hidden % _MIN_BLOCK == 0
                   and R <= MAX_ROWS,
                   "fused_epilogue: shape outside the kernel's limits")
    _build.require(_aligned(attn, wo, residual, w_norm),
                   "fused_epilogue: inputs must be 16-byte aligned")
    normed = torch.empty_like(residual)
    new_res = torch.empty_like(residual)
    if R == 0:
        return normed, new_res
    hbuf = torch.empty(R, hidden, dtype=torch.float32, device=attn.device)
    partial = torch.empty(R, hidden // 32, dtype=torch.float32,
                          device=attn.device)
    counter = _arrival_counters(attn.device)
    P, I, F = _build.VOIDP, _build.INT, _build.FLOAT
    fn = _build.function(_STEM, "pt_fused_epilogue",
                         [P] * 9 + [I] * 3 + [F, I, P])
    err = fn(*(_build.ptr(t) for t in (attn, wo, residual, w_norm, normed,
                                       new_res, hbuf, partial, counter)),
             R, width, hidden, float(eps), code, _build.stream(attn.device))
    _build.launches["fused_epilogue"] += 1
    _build.check(err, _STEM, "fused_epilogue")
    return normed, new_res


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------

def supported(b: int, hidden: int, n_heads: int, n_kv: int, d: int,
              rope_width: int, itemsize: int) -> bool:
    """Shape gate of the fused tail (``decode_tail.supported``): the
    structural conditions of the JAX gate, then the card kernels' own limit
    (at most ``MAX_ROWS`` rows) in place of its VMEM budget, which is what
    ``itemsize`` fed; the card limit does not depend on it. The caller
    checks the model-level assumptions (no bias, float32 or bfloat16
    throughout)."""
    if d % 128 != 0 or hidden % _MIN_BLOCK != 0:
        return False
    if rope_width != d:
        return False  # partial-rotary families keep the discrete path
    if (n_heads * d) % _MIN_BLOCK != 0:
        return False
    return b <= MAX_ROWS
