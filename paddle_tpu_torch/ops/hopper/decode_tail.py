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
(``_block_k``); the card kernels take a fixed geometry instead (bf16: 128
output columns by up to 32 rows a block, the contraction in chunks of 64
rows split over blocks, see the source; f32: 32 columns a block over the
whole contraction), and the wrapper picks the split from shapes alone
(:func:`split_count`), so nothing is searched here.
"""
from __future__ import annotations

import functools

import torch

from . import _build

_STEM = "decode_tail"
_MIN_BLOCK = 128
# the card kernels' own limit (replacing the JAX VMEM budget): 256 tiles of
# 32 rows
_ROW_TILE = 32
_TILES = 256
MAX_ROWS = _ROW_TILE * _TILES
# the bf16 bodies' geometry (csrc/decode_tail.cu): output columns of a
# work item, contraction rows of a ring stage, the ring's stages, slices
# at most; shared memory an SM holds and what a block reserves of it
TILE, CHUNK, STAGES, MAX_SPLIT = 128, 32, 6, 16
SEG = 128                       # x columns of one partial sum of squares
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
BLOCKS_PER_SM = 3               # more would gain nothing and cost registers
# the f32 epilogue's per-row partial sums: one per 32 columns
_F32_COLS = 32
_P, _I, _F = _build.VOIDP, _build.INT, _build.FLOAT
_QKV_ARGTYPES = [_P] * 12 + [_I] * 6 + [_F, _I, _P]
_EPILOGUE_ARGTYPES = [_P] * 8 + [_I] * 4 + [_F, _I, _P]

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

def row_tile(rows: int) -> int:
    """Rows a block of the bf16 bodies takes: one, two or four n tiles of 8."""
    return 8 if rows <= 8 else (16 if rows <= 16 else 32)


def block_smem(rows: int, slice_chunks: int) -> int:
    """Shared memory of a bf16 block: the ring of ``STAGES`` stages of 32
    rows by 128 (+ 8) columns, and the item's slice of activation rows,
    row tile by slice (+ 8), in bf16; plus a little static memory."""
    ring = STAGES * CHUNK * (TILE + 8) * 2
    return (ring + row_tile(rows) * (slice_chunks * CHUNK + 8) * 2
            + slice_chunks * CHUNK * 2 + 256)


@functools.lru_cache(maxsize=256)
def split_count(n_tiles: int, rows: int, k: int, n_sm: int) -> int:
    """Slices of the ``k``-row contraction for ``n_tiles`` column tiles of
    128 at ``rows`` rows: the most (up to ``MAX_SPLIT``) whose work items,
    one a block, all fit on the card at once, as the blocks' shared memory
    allows; each slice whole chunks of 32 rows, none empty. Where no split
    fits in one wave (many row tiles) the most that fits in shared memory
    at all: the blocks then walk several items. Shapes only."""
    n_rt = -(-rows // row_tile(rows))
    chunks = k // CHUNK
    fallback = 0
    for want in range(min(MAX_SPLIT, chunks), 0, -1):
        per = -(-chunks // want)
        split = -(-chunks // per)
        per_sm = min(BLOCKS_PER_SM,
                     SMEM_PER_SM // (block_smem(rows, per) + SMEM_RESERVED))
        if per_sm and not fallback:
            fallback = split
        if n_tiles * split * n_rt <= per_sm * n_sm:
            return split
    return fallback or 1


def _partial_floats(rows: int, n_tiles: int, split: int) -> int:
    rt = row_tile(rows)
    return -(-rows // rt) * rt * n_tiles * split * TILE


def qkv_scratch(rows, hidden, n_heads, n_kv, d, n_sm, code):
    """(split, f32 scratch floats) of a ``fused_qkv_rope`` call: the bf16
    body's per-slice partials [row tiles * RT, tiles, split, 128], then the
    rows' sums of squares by 128-column segment [R, hidden / 128]; the f32
    body takes none."""
    if not code:
        return 1, 0
    n_tiles = (n_heads + 2 * n_kv) * d // TILE
    split = split_count(n_tiles, rows, hidden, n_sm)
    return split, _partial_floats(rows, n_tiles, split) + rows * (hidden // SEG)


def epilogue_scratch(rows, width, hidden, n_sm, code):
    """(split, f32 scratch floats, arrival counters) of a ``fused_epilogue``
    call. bf16: the partials, then h [R, hidden] and the tiles' sums of
    squares [R, hidden / 128], no counter; f32: h and the blocks' sums of
    squares [R, hidden / 32], one counter a 32-row tile."""
    if not code:
        return (1, rows * hidden + rows * (hidden // _F32_COLS),
                -(-rows // _ROW_TILE))
    n_tiles = hidden // TILE
    split = split_count(n_tiles, rows, width, n_sm)
    return (split, _partial_floats(rows, n_tiles, split) + rows * hidden
            + rows * n_tiles, 0)


_states: dict = {}
# the qkv kernel's grid barrier (count, generation) comes first
_BARRIER = 2


def _state(device, n_counters: int) -> torch.Tensor:
    """The kernels' persistent int32 state on ``device``: the qkv kernel's
    grid barrier, then at least ``n_counters`` arrival counters of the f32
    epilogue. Zeroed when made; every launch leaves its part as the next
    launch needs it (one stream per device)."""
    c = _states.get(device)
    if c is None or c.numel() < _BARRIER + n_counters:
        c = _states[device] = torch.zeros(_BARRIER + max(n_counters, _TILES),
                                          dtype=torch.int32, device=device)
    return c


def _check(what, code_of, specs):
    """The dtype code of ``code_of`` (float32 / bfloat16), after each
    (tensor, shape, dtype) of ``specs`` is checked once: one CUDA device,
    contiguous, its shape and dtype, 16-byte aligned."""
    code = _build.dtype_code(code_of)
    dev = code_of.device
    if dev.type != "cuda":
        _build.require_cuda(code_of)
    for t, shape, dtype in specs:
        if t.device != dev or not t.is_contiguous():
            _build.require_cuda(*(s[0] for s in specs))
        if t.dtype != dtype:
            raise ValueError(f"{what}: an input of {t.dtype} where {dtype} "
                             "is expected (one dtype; cos/sin float32)")
        if t.shape != shape:
            raise ValueError(f"{what}: shapes disagree: {tuple(t.shape)} "
                             f"where {tuple(shape)} is expected")
        if t.data_ptr() & 15:
            raise ValueError(f"{what}: inputs must be 16-byte aligned")
    return code


def fused_qkv_rope(x, w_norm, wq, wk, wv, cos_row, sin_row, eps,
                   n_heads: int, n_kv: int, d: int):
    """x [R, hidden] → (q [R, H*d], k [R, hk*d], v [R, hk*d]), q and k
    roped at each row's position (``cos_row`` / ``sin_row`` [R, d] f32,
    gathered by the caller)."""
    if x.device.type == "cpu":
        return fused_qkv_rope_plain(x, w_norm, wq, wk, wv, cos_row, sin_row,
                                    eps, n_heads, n_kv, d)
    _build.require_no_grad("fused_qkv_rope", x, w_norm, wq, wk, wv)
    cos_row, sin_row = cos_row.contiguous(), sin_row.contiguous()
    R, hidden = x.shape
    wq_n, kv_n = n_heads * d, n_kv * d
    dt, f32 = x.dtype, torch.float32
    code = _check("fused_qkv_rope", x, (
        (x, (R, hidden), dt), (w_norm, (hidden,), dt),
        (wq, (hidden, wq_n), dt), (wk, (hidden, kv_n), dt),
        (wv, (hidden, kv_n), dt), (cos_row, (R, d), f32),
        (sin_row, (R, d), f32)))
    _build.require(supported(R, hidden, n_heads, n_kv, d, d,
                             x.element_size()),
                   "fused_qkv_rope: shape outside the kernel's limits")
    q = x.new_empty(R, wq_n)
    k = x.new_empty(R, kv_n)
    v = x.new_empty(R, kv_n)
    if R == 0:
        return q, k, v
    split, n_scratch = qkv_scratch(R, hidden, n_heads, n_kv, d,
                                   _build.sm_count(x.device), code)
    scratch = (torch.empty(n_scratch, dtype=f32, device=x.device)
               if n_scratch else None)
    err = _build.function(_STEM, "pt_fused_qkv_rope", _QKV_ARGTYPES)(
        x.data_ptr(), w_norm.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _state(x.device, 0).data_ptr(), R, hidden, n_heads, n_kv, d, split,
        float(eps), code, _build.stream(x.device))
    _build.launches["fused_qkv_rope"] += 1
    if err:
        _build.check(err, _STEM, "fused_qkv_rope")
    return q, k, v


def fused_epilogue(attn, wo, residual, w_norm, eps):
    """attn [R, H*d] (attention output before o_proj), wo [H*d, hidden],
    residual [R, hidden] → (normed, new residual), both [R, hidden]:
    ``add_rms_norm(attn @ wo, residual, w_norm)`` in one launch."""
    if attn.device.type == "cpu":
        return fused_epilogue_plain(attn, wo, residual, w_norm, eps)
    _build.require_no_grad("fused_epilogue", attn, wo, residual, w_norm)
    R, width = attn.shape
    hidden = wo.shape[1]
    dt = attn.dtype
    code = _check("fused_epilogue", attn, (
        (attn, (R, width), dt), (wo, (width, hidden), dt),
        (residual, (R, hidden), dt), (w_norm, (hidden,), dt)))
    _build.require(width % _MIN_BLOCK == 0 and hidden % _MIN_BLOCK == 0
                   and R <= MAX_ROWS,
                   "fused_epilogue: shape outside the kernel's limits")
    normed = torch.empty_like(residual)
    new_res = torch.empty_like(residual)
    if R == 0:
        return normed, new_res
    split, n_scratch, n_count = epilogue_scratch(
        R, width, hidden, _build.sm_count(attn.device), code)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=attn.device)
    counter = _state(attn.device, n_count)[_BARRIER:] if n_count else None
    err = _build.function(_STEM, "pt_fused_epilogue", _EPILOGUE_ARGTYPES)(
        attn.data_ptr(), wo.data_ptr(), residual.data_ptr(), w_norm.data_ptr(),
        normed.data_ptr(), new_res.data_ptr(), scratch.data_ptr(),
        None if counter is None else counter.data_ptr(), R, width, hidden,
        split, float(eps), code, _build.stream(attn.device))
    _build.launches["fused_epilogue"] += 1
    if err:
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
