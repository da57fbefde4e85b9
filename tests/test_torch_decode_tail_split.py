"""The split decode-tail kernels' arithmetic and host path, on the CPU.

``csrc/decode_tail.cu``'s bf16 bodies cut each call into work items: a
tile of 128 output columns (``fused_qkv_rope``: 64 RoPE pairs, columns
[h d + 64 p, +64) and [h d + d/2 + 64 p, +64)), a slice of whole 32-row
chunks of the contraction and a tile of 8, 16 or 32 rows. Each item's
product runs on the tensor cores with bf16 operands and f32 sums; after a
grid-wide sync the slices' f32 partials are added in slice order, cast and
finished. ``fused_qkv_rope`` scales its rows from sums of squares taken by
128-column segments (each row's segments added in a fixed order) before
it normalises; ``fused_epilogue`` publishes each column tile's sum of
squares of a row and normalises with their sum over tiles, in tile order.

``model_qkv`` and ``model_epilogue`` repeat that arithmetic in torch,
held against the plain versions and the JAX Pallas kernels in interpret
mode: f32 within 1e-5 of the largest entry, bf16 within one bf16 ulp of
it (phase 2's tolerance), at hidden 256 and 384, 1-4 query heads, R 1, 8
and 33 (two row tiles). In bf16 the JAX kernel in interpret mode is a
reference at 8 rows only: at 1 and 33 rows its products on the CPU differ
from the exact f32 sums the plain version takes by up to two bf16 ulps of
the largest entry (``test_jax_bf16_reference_rows``), so there the model
is held against the plain version alone. Then the tile, split and scratch
layout at the smoke's shapes on 132 SMs, and both CUDA routes with
stand-in launches (the ``fake_kernels`` fixture): arguments, one scratch
allocation, one count a call, every refusal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_tail as jax_tail
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import decode_tail as port_tail
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

D, EPS = 128, 1e-6
TILE, HALF, CHUNK, SEG = 128, 64, 32, 128
H100_SMS = 132


def slices(k, split):
    """[(k0, k1)] of each slice of a k-row contraction: ceil(chunks /
    split) whole 32-row chunks a slice, as the kernels cut it."""
    chunks = k // CHUNK
    per = -(-chunks // split)
    return [(s * per * CHUNK, min(chunks, (s + 1) * per) * CHUNK)
            for s in range(split)]


def sliced_product(a, w, cols, split):
    """The f32 sum over slices, in slice order, of a[:, slice] @ w[slice,
    cols]: each item's product with f32 sums of exact products, then the
    slices added in order."""
    out = torch.zeros(a.shape[0], len(cols))
    for k0, k1 in slices(a.shape[1], split):
        out = out + a[:, k0:k1].float() @ w[k0:k1][:, cols].float()
    return out


def model_qkv(x, wn, wq, wk, wv, cos, sin, eps, n_heads, n_kv, d, split):
    """``fused_qkv_rope``'s bf16 body: row scales from the 128-column
    segments' sums of squares (segment q, q + 4, ... added by one thread,
    then the four sums pairwise), the normed row round(round(x * scale) *
    w_norm), the sliced products by 64-pair tile, the cast, RoPE of each
    pair in f32 (each product and the sum rounded) and the cast."""
    R, hidden = x.shape
    xf = x.float()
    seg = (xf.reshape(R, hidden // SEG, SEG) ** 2).sum(-1)
    quarter = [seg[:, q::4].sum(-1) if q < seg.shape[1] else torch.zeros(R)
               for q in range(4)]
    ss = (quarter[0] + quarter[1]) + (quarter[2] + quarter[3])
    scale = torch.rsqrt(ss / hidden + eps)[:, None]
    normed = ((xf * scale).to(x.dtype) * wn).to(x.dtype)
    outs = []
    for w, n, rope in ((wq, n_heads, True), (wk, n_kv, True),
                       (wv, n_kv, False)):
        out = torch.empty(R, n * d, dtype=x.dtype)
        for head in range(n):
            for p in range(d // TILE):
                lo = [head * d + HALF * p + i for i in range(HALF)]
                hi = [head * d + d // 2 + HALF * p + i for i in range(HALF)]
                v = sliced_product(normed, w, lo + hi, split).to(x.dtype)
                x1, x2 = v[:, :HALF].float(), v[:, HALF:].float()
                ih = [HALF * p + i for i in range(HALF)]
                jh = [d // 2 + i for i in ih]
                if rope:
                    o1 = x1 * cos[:, ih] + (-x2) * sin[:, ih]
                    o2 = x2 * cos[:, jh] + x1 * sin[:, jh]
                else:
                    o1, o2 = x1, x2
                out[:, lo] = o1.to(x.dtype)
                out[:, hi] = o2.to(x.dtype)
        outs.append(out)
    return tuple(outs)


def model_epilogue(attn, wo, res, wn, eps, split):
    """``fused_epilogue``'s bf16 body: the sliced product by 128-column
    tile, cast, + residual in f32; the new residual is the cast sum; each
    tile's sum of squares of a row, added over tiles in order; the norm of
    the f32 sum."""
    R, hidden = res.shape
    n_tiles = hidden // TILE
    h = torch.empty(R, hidden)
    tile_ss = torch.empty(R, n_tiles)
    for t in range(n_tiles):
        cols = list(range(t * TILE, (t + 1) * TILE))
        v = sliced_product(attn, wo, cols, split).to(attn.dtype).float()
        h[:, cols] = v + res[:, cols].float()
        tile_ss[:, t] = (h[:, cols] ** 2).sum(-1)
    ss = torch.zeros(R)
    for t in range(n_tiles):
        ss = ss + tile_ss[:, t]
    scale = torch.rsqrt(ss / hidden + eps)[:, None]
    return (h * scale).to(attn.dtype) * wn, h.to(attn.dtype)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(
        want, torch.Tensor) else want.float().numpy()
    top = float(np.abs(want).max())
    tol = (1e-5 * top if dtype == "float32"
           else 2.0 ** (np.floor(np.log2(top)) - 7))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _pair(arr, dtype):
    t = torch.from_numpy(np.asarray(arr, np.float32))
    j = jnp.asarray(arr, jnp.float32)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


# (hidden, query heads, KV heads): 8 and 12 chunks of the contraction
SHAPES = [(256, 2, 1), (384, 4, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 33])
@pytest.mark.parametrize("hidden,n_heads,n_kv", SHAPES)
def test_qkv_model_matches_plain_and_pallas(hidden, n_heads, n_kv, rows,
                                            dtype):
    """The qkv body's arithmetic at the split the wrapper picks and at 3
    slices (uneven at 8 chunks: 3, 3, 2), against the plain version and the
    Pallas kernel in interpret mode."""
    rng = np.random.RandomState(hidden + rows)
    arrs = [rng.randn(rows, hidden), 1 + 0.1 * rng.randn(hidden),
            0.05 * rng.randn(hidden, n_heads * D),
            0.05 * rng.randn(hidden, n_kv * D),
            0.05 * rng.randn(hidden, n_kv * D)]
    pairs = [_pair(a, dtype) for a in arrs]
    cos, sin = _rope_tables(64, D, 10000.0)
    pos = rng.randint(0, 64, size=rows)
    c, s = cos[pos], sin[pos]
    args = [p for p, _ in pairs] + [c, s, EPS, n_heads, n_kv, D]
    plain = port_tail.fused_qkv_rope_plain(*args)
    want = jax_tail.fused_qkv_rope(*(j for _, j in pairs),
                                   jnp.asarray(c.numpy()),
                                   jnp.asarray(s.numpy()), EPS, n_heads,
                                   n_kv, D, interpret=True)
    picked = port_tail.qkv_scratch(rows, hidden, n_heads, n_kv, D,
                                   H100_SMS, 1)[0]
    for split in sorted({picked, 3}):
        got = model_qkv(*args, split)
        for g, p, w in zip(got, plain, want):
            assert g.dtype == pairs[0][0].dtype
            _close(g, p, dtype)
            if dtype == "float32" or rows == 8:
                _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 33])
@pytest.mark.parametrize("hidden,n_heads,n_kv", SHAPES)
def test_epilogue_model_matches_plain_and_pallas(hidden, n_heads, n_kv,
                                                 rows, dtype):
    """The epilogue body's arithmetic at the wrapper's split and at 5
    slices (uneven at 8 and 12 chunks), against the plain version and the
    Pallas kernel in interpret mode."""
    del n_kv
    rng = np.random.RandomState(10 * hidden + rows)
    arrs = [rng.randn(rows, n_heads * D),
            0.05 * rng.randn(n_heads * D, hidden), rng.randn(rows, hidden),
            1 + 0.1 * rng.randn(hidden)]
    pairs = [_pair(a, dtype) for a in arrs]
    args = [p for p, _ in pairs] + [EPS]
    plain = port_tail.fused_epilogue_plain(*args)
    want = jax_tail.fused_epilogue(*(j for _, j in pairs), EPS,
                                   interpret=True)
    picked = port_tail.epilogue_scratch(rows, n_heads * D, hidden, H100_SMS,
                                        1)[0]
    for split in sorted({picked, 5}):
        got = model_epilogue(*args, split)
        for g, p, w in zip(got, plain, want):
            _close(g, p, dtype)
            if dtype == "float32" or rows == 8:
                _close(g, w, dtype)


def test_jax_bf16_reference_rows():
    """Why bf16 is held against JAX at 8 rows: there the Pallas kernel in
    interpret mode gives the plain version's bits; at 1 row its k differs
    from the plain version's exact f32 sums by two bf16 ulps of the
    largest entry."""
    dist = {}
    for rows in (1, 8):
        rng = np.random.RandomState(256 + rows)
        arrs = [rng.randn(rows, 256), 1 + 0.1 * rng.randn(256),
                0.05 * rng.randn(256, 2 * D), 0.05 * rng.randn(256, D),
                0.05 * rng.randn(256, D)]
        pairs = [_pair(a, "bfloat16") for a in arrs]
        cos, sin = _rope_tables(64, D, 10000.0)
        pos = rng.randint(0, 64, size=rows)
        c, s = cos[pos], sin[pos]
        plain = port_tail.fused_qkv_rope_plain(
            *(p for p, _ in pairs), c, s, EPS, 2, 1, D)
        want = jax_tail.fused_qkv_rope(*(j for _, j in pairs),
                                       jnp.asarray(c.numpy()),
                                       jnp.asarray(s.numpy()), EPS, 2, 1, D,
                                       interpret=True)
        k = plain[1].float().numpy()
        top = float(np.abs(k).max())
        dist[rows] = float(np.abs(k - np.asarray(
            jnp.asarray(want[1], jnp.float32))).max()) / 2.0 ** (
                np.floor(np.log2(top)) - 7)
    assert dist == {1: 2.0, 8: 0.0}


def test_slices_cover_the_contraction_with_none_empty():
    """Every split the wrapper can pick cuts the contraction into whole
    chunks, in order, the last slice no longer than the others and none
    empty."""
    for k in (256, 384, 1408, 4096, 4224):
        for want in range(1, port_tail.MAX_SPLIT + 1):
            chunks = k // CHUNK
            per = -(-chunks // min(want, chunks))
            split = -(-chunks // per)
            cut = slices(k, split)
            assert cut[0][0] == 0 and cut[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
            assert all(k1 > k0 for k0, k1 in cut)
            assert all(k1 - k0 <= cut[0][1] for k0, k1 in cut)


# ------------------------------------------------------------- layout --

@pytest.mark.parametrize("rows,qkv_split,epi_split", [
    (8, 8, 12),     # a decode step at 8 slots: 384 and 384 items
    (32, 5, 12),    # a verify chunk of 8 slots x k = 4: 240 and 384 items
    (1, 8, 12),
    (16, 8, 12),
])
def test_split_and_scratch_at_the_smoke_shapes(rows, qkv_split, epi_split):
    """Llama-3-8B widths (hidden 4096, 32 | 8 heads of 128) on 132 SMs: the
    splits the wrapper picks, every item resident at once (one block an
    item, as many an SM as shared memory holds, at most 3), and one f32
    scratch of partials (+ the rows' segment sums, or h and the tiles' sums
    of squares)."""
    hidden, H, hk = 4096, 32, 8
    split, n = port_tail.qkv_scratch(rows, hidden, H, hk, D, H100_SMS, 1)
    rt = port_tail.row_tile(rows)
    assert split == qkv_split
    assert n == rt * 48 * split * TILE + rows * hidden // SEG
    chunks = hidden // CHUNK
    per = -(-chunks // split)
    per_sm = min(3, port_tail.SMEM_PER_SM // (
        port_tail.block_smem(rows, per) + port_tail.SMEM_RESERVED))
    assert 48 * split <= per_sm * H100_SMS
    split, n, counters = port_tail.epilogue_scratch(rows, H * D, hidden,
                                                    H100_SMS, 1)
    assert split == epi_split and counters == 0
    assert n == rt * 32 * split * TILE + rows * hidden + rows * 32
    per = -(-chunks // split)
    per_sm = min(3, port_tail.SMEM_PER_SM // (
        port_tail.block_smem(rows, per) + port_tail.SMEM_RESERVED))
    assert 32 * split <= per_sm * H100_SMS


def test_row_tiles_and_many_rows():
    """8, 16 or 32 rows a tile; past one wave (33 rows: two row tiles of 32)
    the split still fits shared memory, and the blocks walk the items."""
    assert [port_tail.row_tile(r) for r in (1, 8, 9, 16, 17, 32, 33)] == [
        8, 8, 16, 16, 32, 32, 32]
    split = port_tail.qkv_scratch(33, 4096, 32, 8, D, H100_SMS, 1)[0]
    per = -(-128 // split)
    assert port_tail.block_smem(33, per) + port_tail.SMEM_RESERVED <= (
        port_tail.SMEM_PER_SM)
    assert port_tail.qkv_scratch(33, 4096, 32, 8, D, H100_SMS, 0) == (1, 0)
    # f32: h and a sum of squares per 32 columns, a counter per 32 rows
    assert port_tail.epilogue_scratch(33, 4096, 4096, H100_SMS, 0) == (
        1, 33 * 4096 + 33 * 128, 2)


# ---------------------------------------------------------- CUDA routes --

def _qkv_inputs(R=3, hidden=256, H=2, hk=1, dtype=torch.bfloat16):
    t = [posing_as_cuda(torch.zeros(*shape, dtype=dtype)) for shape in (
        (R, hidden), (hidden,), (hidden, H * D), (hidden, hk * D),
        (hidden, hk * D))]
    cs = [posing_as_cuda(torch.zeros(R, D)) for _ in range(2)]
    return t + cs


def _epilogue_inputs(R=3, hidden=256, H=2, dtype=torch.bfloat16):
    return [posing_as_cuda(torch.zeros(*shape, dtype=dtype)) for shape in (
        (R, H * D), (H * D, hidden), (R, hidden), (hidden,))]


@pytest.fixture
def scratch_sizes(monkeypatch):
    """The element counts of the f32 buffers the wrappers allocate."""
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        if kw.get("dtype") == torch.float32:
            sizes.append(math.prod(shape))
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    port_tail._states.clear()
    return sizes


def test_qkv_cuda_route_arguments_scratch_and_one_count(fake_kernels,
                                                        scratch_sizes):
    """``pt_fused_qkv_rope`` gets the 10 tensors, one f32 scratch of the
    size ``qkv_scratch`` gives, the grid barrier's two words, the shapes,
    the split, eps, the dtype code and the stream; one count a call."""
    args = _qkv_inputs()
    q, k, v = port_tail.fused_qkv_rope(*args[:5], args[5], args[6], EPS, 2,
                                       1, D)
    port_tail.fused_qkv_rope(*args[:5], args[5], args[6], EPS, 2, 1, D)
    assert dict(_build.launches) == {"fused_qkv_rope": 2}
    name, a = fake_kernels[0]
    assert name == "pt_fused_qkv_rope" and len(fake_kernels) == 2
    assert len(a) == len(port_tail._QKV_ARGTYPES)
    split, n = port_tail.qkv_scratch(3, 256, 2, 1, D, H100_SMS, 1)
    assert scratch_sizes == [n, n]
    assert a[12:] == (3, 256, 2, 1, D, split, EPS, 1, None)
    assert a[:7] == tuple(t.data_ptr() for t in args)
    assert a[7:10] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    state = port_tail._states[(args[0].device, None)]
    assert a[11] == state.data_ptr() and int(state.sum()) == 0
    assert (q.shape, k.shape, v.shape) == ((3, 256), (3, 128), (3, 128))


def test_epilogue_cuda_route_arguments_scratch_and_one_count(fake_kernels,
                                                             scratch_sizes):
    """``pt_fused_epilogue`` gets the 6 tensors, one f32 scratch (the
    partials, h and the tiles' sums of squares), no counter in bf16, the
    shapes, the split, eps, the dtype code and the stream; one count."""
    args = _epilogue_inputs()
    normed, new_res = port_tail.fused_epilogue(*args, EPS)
    assert dict(_build.launches) == {"fused_epilogue": 1}
    name, a = fake_kernels[0]
    assert name == "pt_fused_epilogue"
    assert len(a) == len(port_tail._EPILOGUE_ARGTYPES)
    split, n, _ = port_tail.epilogue_scratch(3, 2 * D, 256, H100_SMS, 1)
    assert scratch_sizes == [n]
    assert a[7] is None
    assert a[8:] == (3, 2 * D, 256, split, EPS, 1, None)
    assert a[:6] == (*(t.data_ptr() for t in args), normed.data_ptr(),
                     new_res.data_ptr())


def test_f32_routes_take_no_split_and_the_counters(fake_kernels,
                                                   scratch_sizes):
    """f32 keeps the CUDA-core bodies: qkv takes no scratch; the epilogue
    takes h and its blocks' sums of squares and the arrival counters after
    the grid barrier's two words."""
    args = _qkv_inputs(dtype=torch.float32)
    port_tail.fused_qkv_rope(*args, EPS, 2, 1, D)
    a = fake_kernels[0][1]
    assert a[10] is None and a[17] == 1 and a[19] == 0
    eargs = _epilogue_inputs(dtype=torch.float32)
    port_tail.fused_epilogue(*eargs, EPS)
    a = fake_kernels[1][1]
    state = port_tail._states[(eargs[0].device, None)]
    assert a[7] == state.data_ptr() + 4 * port_tail._BARRIER
    assert a[11] == 1 and a[13] == 0
    assert scratch_sizes == [3 * 256 + 3 * 256 // 32]


@pytest.mark.parametrize("bad", ["half", "mix", "shape", "cos_dtype",
                                 "cos_shape", "head_dim", "align", "rows",
                                 "grad"])
def test_qkv_cuda_route_refusals_unchanged(bad, fake_kernels, scratch_sizes):
    """float32 / bfloat16 only, one dtype, weight shapes that match x and
    the heads, f32 cos / sin [R, d], head width a multiple of 128,
    16-byte aligned inputs, at most ``MAX_ROWS`` rows, no input that needs
    a gradient; nothing launches."""
    args = _qkv_inputs()
    heads, err = (2, 1, D), ValueError
    if bad == "half":
        args = _qkv_inputs(dtype=torch.float16)[:5] + args[5:]
        err = TypeError
    elif bad == "mix":
        args[2] = posing_as_cuda(args[2].float())
    elif bad == "shape":
        args[3] = posing_as_cuda(torch.zeros(256, 2 * D,
                                             dtype=torch.bfloat16))
    elif bad == "cos_dtype":
        args[5] = posing_as_cuda(torch.zeros(3, D, dtype=torch.bfloat16))
    elif bad == "cos_shape":
        args[6] = posing_as_cuda(torch.zeros(4, D))
    elif bad == "head_dim":
        args = _qkv_inputs(H=4)
        args[5] = posing_as_cuda(torch.zeros(3, 64))
        args[6] = posing_as_cuda(torch.zeros(3, 64))
        heads = (8, 2, 64)
    elif bad == "align":
        args[0] = posing_as_cuda(torch.zeros(3 * 256 + 1, dtype=torch.bfloat16)[
            1:].reshape(3, 256))
    elif bad == "rows":
        args = _qkv_inputs(R=port_tail.MAX_ROWS + 1)
    else:
        args[0] = posing_as_cuda(torch.zeros(3, 256), grad=True)
        err = RuntimeError
    with pytest.raises(err):
        port_tail.fused_qkv_rope(*args, EPS, *heads)
    assert not fake_kernels and not _build.launches


@pytest.mark.parametrize("bad", ["half", "mix", "shape", "width", "align",
                                 "rows", "grad"])
def test_epilogue_cuda_route_refusals_unchanged(bad, fake_kernels,
                                                scratch_sizes):
    """One dtype of float32 / bfloat16, matching shapes, width and hidden
    multiples of 128, 16-byte aligned inputs, at most ``MAX_ROWS`` rows, no
    input that needs a gradient; nothing launches."""
    args, err = _epilogue_inputs(), ValueError
    if bad == "half":
        args = _epilogue_inputs(dtype=torch.float16)
        err = TypeError
    elif bad == "mix":
        args[2] = posing_as_cuda(args[2].float())
    elif bad == "shape":
        args[3] = posing_as_cuda(torch.zeros(128, dtype=torch.bfloat16))
    elif bad == "width":
        args = [posing_as_cuda(torch.zeros(*s, dtype=torch.bfloat16))
                for s in ((3, 192), (192, 256), (3, 256), (256,))]
    elif bad == "align":
        args[2] = posing_as_cuda(torch.zeros(3 * 256 + 1, dtype=torch.bfloat16)[
            1:].reshape(3, 256))
    elif bad == "rows":
        args = _epilogue_inputs(R=port_tail.MAX_ROWS + 1)
    else:
        args[0] = posing_as_cuda(torch.zeros(3, 2 * D), grad=True)
        args = [args[0]] + [posing_as_cuda(a.float()) for a in args[1:]]
        err = RuntimeError
    with pytest.raises(err):
        port_tail.fused_epilogue(*args, EPS)
    assert not fake_kernels and not _build.launches
