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
(``_block_k``). The bf16 card kernels (128 output columns by up to 32 rows
a block, the contraction in chunks of 32 rows split over blocks, see the
source) take the number of slices of the contraction, ``split``, where
JAX takes its block: by default :func:`split_count`'s, from shapes alone;
with ``FLAGS_use_autotune`` the search (``autotune.py``) over
:func:`split_options`, the splits whose work items are all resident on
the card at once (the qkv kernel waits on a grid-wide barrier). A wrapper
refuses any other split before a launch. The f32 bodies (32 columns a
block over the whole contraction) take none.
"""
from __future__ import annotations

import functools

import torch

from . import _build, autotune

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


def _spec_verify_cost(params: dict, choice: tuple) -> dict:
    """The JAX ``_spec_verify_cost`` (``decode_tail.py:111-137``): one
    speculative verify dispatch at chunk width k reads the weights once,
    whatever k, while operations and activations grow with batch * k."""
    (k,) = choice
    b = int(params["batch"])
    hidden = int(params["hidden"])
    layers = int(params["layers"])
    inter = int(params["intermediate"])
    wtot = int(params["wtot"])          # (H + 2*hk) * head_dim per layer
    vocab = int(params["vocab"])
    it = _itemsize(params["dtype"])
    # weights: qkv + o_proj + 3 MLP mats per layer + the lm head
    w_elems = layers * (hidden * wtot + hidden * hidden
                        + 3 * hidden * inter) + hidden * vocab
    act_elems = b * k * (layers * (4 * hidden + 2 * inter) + vocab)
    return {"bytes": (w_elems + act_elems) * it,
            "flops": 2 * b * k * w_elems,
            "vmem_bytes": 0,
            "grid": 0}


def _tail_geometry(cost, rows, k, n_tiles, split):
    """A tail kernel's cost at ``split`` slices of its ``k``-row
    contraction: ``cost``'s bytes plus the f32 partials written and read
    back (``_partial_floats``), a block's shared memory, its work items as
    the grid and the blocks an SM holds at that memory."""
    per = -(-(k // CHUNK) // split)
    smem = block_smem(rows, per)
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return {"bytes": cost["bytes"] + 2 * 4 * _partial_floats(rows, n_tiles,
                                                             split),
            "flops": cost["flops"], "vmem_bytes": smem,
            "grid": n_tiles * split * -(-rows // row_tile(rows)),
            "blocks_per_sm": max(per_sm, 1)}


def _qkv_tune_cost(params: dict, choice: tuple) -> dict:
    """``fused_qkv_rope``'s autotune cost at split ``choice``."""
    b, hidden = int(params["batch"]), int(params["hidden"])
    return _tail_geometry(_qkv_cost(params), b, hidden,
                          int(params["wtot"]) // TILE, choice[0])


def _epilogue_tune_cost(params: dict, choice: tuple) -> dict:
    """``fused_epilogue``'s autotune cost at split ``choice``."""
    b, width = int(params["batch"]), int(params["width"])
    return _tail_geometry(_epilogue_cost(params), b, width,
                          int(params["hidden"]) // TILE, choice[0])


autotune.register_cost_model("fused_qkv_rope", _qkv_tune_cost)
autotune.register_cost_model("fused_epilogue", _epilogue_tune_cost)
autotune.register_cost_model("spec_verify", _spec_verify_cost)


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


@functools.lru_cache(maxsize=256)
def split_options(n_tiles: int, rows: int, k: int, n_sm: int) -> tuple:
    """The splits a bf16 tail kernel takes at this shape, ascending:
    ``split_count``'s, and every other split into whole, non-empty chunks
    of 32 rows whose work items, one a block, are all resident on the card
    at once as the blocks' shared memory allows (a grid barrier over
    blocks that are not resident would never open). The autotune space,
    and what the wrappers take."""
    n_rt = -(-rows // row_tile(rows))
    chunks = k // CHUNK
    out = {split_count(n_tiles, rows, k, n_sm)}
    for want in range(1, min(MAX_SPLIT, chunks) + 1):
        per = -(-chunks // want)
        split = -(-chunks // per)
        per_sm = min(BLOCKS_PER_SM,
                     SMEM_PER_SM // (block_smem(rows, per) + SMEM_RESERVED))
        if per_sm and n_tiles * split * n_rt <= per_sm * n_sm:
            out.add(split)
    return tuple(sorted(out))


def _partial_floats(rows: int, n_tiles: int, split: int) -> int:
    rt = row_tile(rows)
    return -(-rows // rt) * rt * n_tiles * split * TILE


def _pick_split(n_tiles, rows, k, n_sm, split):
    """``split`` when given, after checking it is one of ``split_options``;
    else ``split_count``'s."""
    if split is None:
        return split_count(n_tiles, rows, k, n_sm)
    _build.require(split in split_options(n_tiles, rows, k, n_sm),
                   f"decode tail: split {split} is not one the kernel takes "
                   f"at {rows} rows, {n_tiles} column tiles and a "
                   f"contraction of {k} on {n_sm} SMs "
                   f"({split_options(n_tiles, rows, k, n_sm)})")
    return split


def qkv_scratch(rows, hidden, n_heads, n_kv, d, n_sm, code, split=None):
    """(split, f32 scratch floats) of a ``fused_qkv_rope`` call: the bf16
    body's per-slice partials [row tiles * RT, tiles, split, 128], then the
    rows' sums of squares by 128-column segment [R, hidden / 128]; the f32
    body takes none. ``split``: a searched one (checked), or None for
    ``split_count``'s."""
    if not code:
        return 1, 0
    n_tiles = (n_heads + 2 * n_kv) * d // TILE
    split = _pick_split(n_tiles, rows, hidden, n_sm, split)
    return split, _partial_floats(rows, n_tiles, split) + rows * (hidden // SEG)


def epilogue_scratch(rows, width, hidden, n_sm, code, split=None):
    """(split, f32 scratch floats, arrival counters) of a ``fused_epilogue``
    call. bf16: the partials, then h [R, hidden] and the tiles' sums of
    squares [R, hidden / 128], no counter; f32: h and the blocks' sums of
    squares [R, hidden / 32], one counter a 32-row tile. ``split`` as in
    ``qkv_scratch``."""
    if not code:
        return (1, rows * hidden + rows * (hidden // _F32_COLS),
                -(-rows // _ROW_TILE))
    n_tiles = hidden // TILE
    split = _pick_split(n_tiles, rows, width, n_sm, split)
    return (split, _partial_floats(rows, n_tiles, split) + rows * hidden
            + rows * n_tiles, 0)


def _tuned_split(kernel, params, n_tiles, rows, k, n_sm, runner, operands):
    """A bf16 tail kernel's split: ``split_count``'s with the flag off, else
    the autotune search over ``split_options`` (the JAX ``_block_k``)."""
    if not autotune.enabled():
        return None
    (split,) = autotune.tuned(
        kernel, autotune.signature(params),
        (split_count(n_tiles, rows, k, n_sm),),
        [(c,) for c in split_options(n_tiles, rows, k, n_sm)], runner,
        operands, params=params)
    return split


_states: dict = {}
# the qkv kernel's grid barrier (count, generation) comes first
_BARRIER = 2


def _state(device, n_counters: int) -> torch.Tensor:
    """The kernels' persistent int32 state for ``device``'s current stream
    (read as ``_build.stream`` reads it): the qkv kernel's grid barrier,
    then at least ``n_counters`` arrival counters of the f32 epilogue.
    Zeroed when made; every launch leaves its part as the next launch needs
    it. Two streams never share a buffer, so a CUDA graph captured on a
    side stream owns its own; within one stream launches run in order. A
    buffer is made before a capture, by the warm-up runs on the capture
    stream (``jit/cuda_graph.py``): one first made inside a capture would
    come from the graph's pool, and the capture would record its zero-fill.
    One replay of such a graph at a time."""
    key = (device, _build.stream(device))
    c = _states.get(key)
    if c is None or c.numel() < _BARRIER + n_counters:
        if _build.capturing(device):
            raise RuntimeError(
                "decode tail: its barrier state for this stream must exist "
                "before a CUDA-graph capture (run the unit eagerly on the "
                "capture stream first)")
        c = _states[key] = torch.zeros(_BARRIER + max(n_counters, _TILES),
                                       dtype=torch.int32, device=device)
    return c


def prepare_stream(device) -> None:
    """Make the persistent state of ``device``'s current stream now (a
    graph's warm-up must not be where it is first made). The CPU has
    none."""
    if device.type == "cuda":
        _state(device, 0)


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
    if R == 0:
        return x.new_empty(R, wq_n), x.new_empty(R, kv_n), x.new_empty(R, kv_n)
    args = (x, w_norm, wq, wk, wv, cos_row, sin_row, eps, n_heads, n_kv, d,
            code)
    n_sm = _build.sm_count(x.device)
    split = None
    if code:
        split = _tuned_split(
            "fused_qkv_rope", {"batch": R, "hidden": hidden,
                               "wtot": wq_n + 2 * kv_n, "dtype": "bfloat16"},
            (wq_n + 2 * kv_n) // TILE, R, hidden, n_sm,
            lambda cfg: lambda: _launch_qkv(*args, n_sm, cfg[0]), (x, wq))
    return _launch_qkv(*args, n_sm, split)


def _launch_qkv(x, w_norm, wq, wk, wv, cos_row, sin_row, eps, n_heads, n_kv,
                d, code, n_sm, split):
    """One ``fused_qkv_rope`` launch at ``split`` (None: ``split_count``'s),
    on inputs the wrapper has checked."""
    R, hidden = x.shape
    q = x.new_empty(R, n_heads * d)
    k = x.new_empty(R, n_kv * d)
    v = x.new_empty(R, n_kv * d)
    split, n_scratch = qkv_scratch(R, hidden, n_heads, n_kv, d, n_sm, code,
                                   split)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=x.device)
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
    if R == 0:
        return torch.empty_like(residual), torch.empty_like(residual)
    args = (attn, wo, residual, w_norm, eps, code)
    n_sm = _build.sm_count(attn.device)
    split = None
    if code:
        split = _tuned_split(
            "fused_epilogue", {"batch": R, "width": width, "hidden": hidden,
                               "dtype": "bfloat16"},
            hidden // TILE, R, width, n_sm,
            lambda cfg: lambda: _launch_epilogue(*args, n_sm, cfg[0]),
            (attn, wo))
    return _launch_epilogue(*args, n_sm, split)


def _launch_epilogue(attn, wo, residual, w_norm, eps, code, n_sm, split):
    """One ``fused_epilogue`` launch at ``split`` (None: ``split_count``'s),
    on inputs the wrapper has checked."""
    R, width = attn.shape
    hidden = wo.shape[1]
    normed = torch.empty_like(residual)
    new_res = torch.empty_like(residual)
    split, n_scratch, n_count = epilogue_scratch(R, width, hidden, n_sm, code,
                                                 split)
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
