"""The split paged decode attention and the one-pass RMSNorm, on the CPU.

``csrc/paged_attention.cuh`` cuts each row's visible prefix into
``split_count`` runs of whole pages, one block per (run, row, KV head).
Its bf16 body (a warp a block) walks the run in chunks of 16 tokens with
an f32 online softmax (m, l, acc), P entering P V as two bf16 terms
(hi + lo); its f32 body walks it in tiles of 32 tokens. A second launch
merges the runs with weights exp(m_s - M). ``model_paged``
repeats that arithmetic in torch, held against ``paged_attention_plain``
and the JAX ``paged_decode_attention`` (its gather reference off the TPU)
at edge lengths, empty runs and 1-16 query heads per KV head: f32 within
1e-5, bf16 within phase 2's 2e-3 + 2^-7 |p|.

``csrc/fused_norm.cu``'s ``rms_norm`` gives each row a group of threads
that holds it in registers, several rows a block at small d;
``model_rms_rows`` repeats its block mapping and sums, held against
``rms_norm_plain`` and the JAX ``rms_norm`` within phase 2's norm tolerance
1e-6 + 2^-6 |p|.

No kernel runs here: the CUDA routes run up to their C entry points with
stand-in launches (the ``fake_kernels`` fixture), which show the
arguments, the scratch and one launch count a call.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import generation as jax_gen
from paddle_tpu.ops.pallas import fused_norm as jax_norm
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import fused_norm as port_norm
from paddle_tpu_torch.ops.hopper import paged_attention as port_paged
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

BF16_CHUNK, F32_TILE = 16, 32   # tokens a step of the bf16 and f32 bodies
ATOL, RTOL = 2e-3, 2.0 ** -7    # phase 2's attention tolerance
NORM_ATOL, NORM_RTOL = 1e-6, 2.0 ** -6
H100_SMS = 132


def split_runs(length, ps, pps, n_split):
    """[(t_begin, t_end)] of each split of a row, as the kernel cuts them:
    ``n_split`` runs of ceil(pages / n_split) whole pages of the visible
    prefix [0, min(length, pps * ps)); a run past the last page is empty
    (t_end <= t_begin)."""
    vis = max(0, min(length, pps * ps))
    n_pg = -(-vis // ps)
    run = -(-n_pg // n_split)
    runs = []
    for s in range(n_split):
        p0 = min(n_pg, s * run)
        p1 = min(n_pg, p0 + run)
        runs.append((p0 * ps, min(vis, p1 * ps)))
    return runs


def _merge(states):
    """(m, l, acc) of several softmax states over disjoint tokens, with
    weights exp(m_s - M) over the states that saw a token: the combine
    launch."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - M))
        L = L + w * l
        acc = acc + w[..., None] * a
    return M, L, acc


def model_paged(q, k_pages, v_pages, lengths, page_indices, n_split,
                step=None):
    """The split kernel's arithmetic. ``step``, the tokens the body takes
    at a time, defaults to the kernel's for q's dtype. Each run: f32 scores
    scaled by 1/sqrt(D), an online softmax (m, l) and an f32 accumulator,
    P as hi + lo bf16 terms in the bf16 body; the runs merge; 0 for a row
    that saw nothing; one rounding to q's dtype."""
    bf16 = q.dtype == torch.bfloat16
    step = step or (BF16_CHUNK if bf16 else F32_TILE)
    B, H, D = q.shape
    hk, _, ps, _ = k_pages.shape
    g = H // hk
    pps = page_indices.shape[1]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty(B, H, D, dtype=q.dtype)
    for b in range(B):
        rows = page_indices[b].long()
        k = k_pages[:, rows].reshape(hk, pps * ps, D).float()
        v = v_pages[:, rows].reshape(hk, pps * ps, D).float()
        qg = q[b].float().reshape(hk, g, D)
        runs = []
        for t0, t1 in split_runs(int(lengths[b]), ps, pps, n_split):
            m = torch.full((hk, g), -math.inf)
            l = torch.zeros(hk, g)
            acc = torch.zeros(hk, g, D)
            for a in range(t0, t1, step):
                e = min(a + step, t1)
                s = torch.einsum("kgd,ktd->kgt", qg, k[:, a:e]) * scale
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                if bf16:
                    hi = p.bfloat16().float()
                    p = hi + (p - hi).bfloat16().float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgt,ktd->kgd", p, v[:, a:e])
                m = m_new
            runs.append((m, l, acc))
        _, L, acc = _merge(runs)
        o = torch.where(L[..., None] > 0,
                        acc / torch.where(L > 0, L, 1.0)[..., None], 0.0)
        out[b] = o.reshape(H, D).to(q.dtype)
    return out


def _paged(lengths, H=8, hk=2, D=128, ps=16, pps=6, seed=0):
    rng = np.random.RandomState(seed)
    B = len(lengths)
    n_pages = B * pps
    page_indices = rng.permutation(n_pages).astype(np.int32).reshape(B, pps)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(hk, n_pages, ps, D).astype(np.float32)
    vp = rng.randn(hk, n_pages, ps, D).astype(np.float32)
    return q, kp, vp, np.asarray(lengths, np.int32), page_indices


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# 1, ps - 1, ps, ps + 1, a full row (pps * ps = 96) and past it (clamped)
EDGE_LENGTHS = [1, 15, 16, 17, 96, 103]


@pytest.mark.parametrize("step", [BF16_CHUNK, F32_TILE])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_split", [1, 3, 6])
def test_model_matches_plain_and_jax_f32(g, n_split, step):
    """The split arithmetic in f32, at either body's step, against the
    plain version and the JAX gather reference, at every edge length, 1-16
    query heads per KV head and 1, 3 and 6 runs a row (6: empty runs in
    the short rows)."""
    q, kp, vp, lengths, idx = _paged(EDGE_LENGTHS, H=2 * g, hk=2, seed=g)
    got = model_paged(_t(q), _t(kp), _t(vp), _t(lengths), _t(idx), n_split,
                      step)
    plain = port_paged.paged_attention_plain(_t(q), _t(kp), _t(vp),
                                             _t(lengths), _t(idx))
    want = np.asarray(jax_gen.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(idx)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_more_splits_than_pages_leave_empty_runs_and_dead_row_is_zero():
    """Six runs over rows of one page and of none: five or six runs are
    empty, their partials drop out of the combine, and the row of length 0
    comes out exactly 0 (the plain version and JAX give NaN there)."""
    q, kp, vp, lengths, idx = _paged([1, 16, 0, 5], seed=3)
    assert split_runs(16, 16, 6, 6)[1:] == [(16, 16)] * 5
    assert split_runs(0, 16, 6, 6) == [(0, 0)] * 6
    got = model_paged(_t(q), _t(kp), _t(vp), _t(lengths), _t(idx), 6)
    assert bool((got[2] == 0).all()) and bool(torch.isfinite(got).all())
    plain = port_paged.paged_attention_plain(_t(q), _t(kp), _t(vp),
                                             _t(lengths), _t(idx))
    live = [0, 1, 3]
    np.testing.assert_allclose(got[live].numpy(), plain[live].numpy(),
                               rtol=0, atol=1e-5)
    assert bool(torch.isnan(plain[2]).all())


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_model_bf16_within_phase2_tolerance(ps):
    """bf16 pages and queries, the page sizes of phase 2: the bf16 body's
    arithmetic (P as hi + lo, one rounding at the end) within phase 2's
    tolerance of the plain version."""
    lengths = [1, ps - 1, ps, ps + 1, 6 * ps, 6 * ps + 3]
    q, kp, vp, lengths, idx = _paged(lengths, H=8, hk=2, ps=ps, seed=ps)
    args = [_t(a) for a in (q, kp, vp)]
    args = [a.to(torch.bfloat16) for a in args] + [_t(lengths), _t(idx)]
    got = model_paged(*args, 4).float()
    ref = port_paged.paged_attention_plain(*args).float()
    assert bool(((got - ref).abs() <= ATOL + RTOL * ref.abs()).all())


@pytest.mark.parametrize("length,ps,pps,n_split", [
    (1, 16, 6, 6), (15, 16, 6, 2), (96, 16, 6, 4), (103, 16, 6, 5),
    (5594, 16, 128, 5), (2047, 8, 256, 33), (0, 32, 64, 5)])
def test_runs_are_whole_pages_covering_the_visible_prefix(length, ps, pps,
                                                          n_split):
    runs = split_runs(length, ps, pps, n_split)
    vis = max(0, min(length, pps * ps))
    assert len(runs) == n_split
    full = [(t0, t1) for t0, t1 in runs if t1 > t0]
    assert runs[:len(full)] == full      # the empty runs come last
    ends = [0] + [t1 for _, t1 in full]
    assert [t0 for t0, _ in full] == ends[:-1] and ends[-1] == vis
    for t0, t1 in full:
        assert t0 % ps == 0 and (t1 == vis or t1 % ps == 0)


@pytest.mark.parametrize("B,hk,pps,want,want_f32", [
    (8, 8, 128, 17, 5),       # phase 2's main shape and the decode profile's
    (1, 8, 128, 128, 33),     # B 1 at 2048 tokens: a page a block
    (32, 8, 128, 5, 2),       # B 32
    (8, 32, 128, 5, 2),       # G 1
    (8, 16, 128, 9, 3),       # G 2
    (8, 4, 128, 33, 9),       # G 8
    (8, 2, 128, 66, 17),      # G 16
    (8, 8, 256, 17, 5),       # page size 8
    (8, 8, 64, 17, 5),        # page size 32
    (7, 8, 128, 19, 5),       # the edge lengths
    (4, 8, 768, 33, 9),       # Mistral-7B's 4 slots at max_len 12288
    (1, 8, 2, 2, 2),          # never more runs than pages
    (1, 8, 0, 1, 1),          # an empty page table still launches one run
])
def test_split_count_at_the_smoke_shapes(B, hk, pps, want, want_f32):
    """About 8 one-warp blocks an SM of the H100 for the bf16 body, 2 of
    its 8-warp blocks for the f32 body, over B * hk (row, KV head) pairs,
    capped by the pages per row; from shapes alone."""
    for per_sm, w in ((port_paged.WARPS_PER_SM, want),
                      (port_paged.F32_BLOCKS_PER_SM, want_f32)):
        n = port_paged.split_count(B, hk, pps, H100_SMS, per_sm)
        assert n == w
        assert n * B * hk >= min(per_sm * H100_SMS, max(pps, 1) * B * hk)


def _paged_cuda(B=3, H=8, hk=2, ps=16, pps=6, dtype=torch.bfloat16):
    q = posing_as_cuda(torch.zeros(B, H, 128, dtype=dtype))
    kv = posing_as_cuda(torch.zeros(hk, B * pps, ps, 128, dtype=dtype))
    lengths = posing_as_cuda(torch.tensor([1, 40, 96][:B],
                                          dtype=torch.int32))
    idx = posing_as_cuda(torch.zeros(B, pps, dtype=torch.int32))
    return q, kv, lengths, idx


def test_paged_cuda_route_arguments_scratch_and_one_count(fake_kernels,
                                                          monkeypatch):
    """On CUDA tensors the wrapper calls ``pt_paged_attention`` once per
    call with the shapes, the split count of ``split_count`` and three
    partial buffers laid end to end in one f32 scratch ([B, H, n] m and l,
    then [B, H, n, D] acc), and counts one ``paged_attention`` launch."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q, kv, lengths, idx = _paged_cuda()
    out = port_paged.paged_attention(q, kv, kv, lengths, idx)
    port_paged.paged_attention(q, kv, kv, lengths, idx)
    assert dict(_build.launches) == {"paged_attention": 2}
    name, args = fake_kernels[0]
    assert name == "pt_paged_attention" and len(fake_kernels) == 2
    n = port_paged.split_count(3, 2, 6, H100_SMS)
    assert n == 6
    assert args[9:] == (3, 8, 2, 18, 16, 6, n, 1.0 / math.sqrt(128), 1,
                        None)
    # acc [3, 8, n, 128] first (16-byte aligned), then m and l [3, 8, n]
    assert args[5] - args[7] == 3 * 8 * n * 128 * 4
    assert args[6] - args[5] == 3 * 8 * n * 4
    assert args[0] == q.data_ptr() and args[8] == out.data_ptr()
    assert args[3] == lengths.data_ptr() and args[4] == idx.data_ptr()
    assert out.shape == q.shape and out.dtype == q.dtype


def test_paged_cuda_route_f32_dtype_code(fake_kernels, monkeypatch):
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q, kv, lengths, idx = _paged_cuda(dtype=torch.float32)
    port_paged.paged_attention(q, kv, kv, lengths, idx)
    args = fake_kernels[0][1]
    assert args[17] == 0
    assert args[15] == port_paged.split_count(3, 2, 6, H100_SMS,
                                              port_paged.F32_BLOCKS_PER_SM)


@pytest.mark.parametrize("bad", ["head_dim", "groups", "groups_ragged",
                                 "lengths_dtype", "index_shape", "dtype_mix",
                                 "grad", "pages"])
def test_paged_cuda_route_refusals_unchanged(bad, fake_kernels, monkeypatch):
    """The wrapper's refusals: head widths 64, 96, 128 and 256 (80 is
    refused), whole groups of 1-16 query
    heads a KV head (17 over 1 is refused, and so are 7 heads over 2),
    int32 lengths [B], int32 page indices [B, pages], one dtype, no input
    that needs a gradient (as before), and at most ``MAX_PAGES`` pages a
    row (the split kernel holds a row's page table in shared memory); no
    launch is counted."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q, kv, lengths, idx = _paged_cuda()
    err = ValueError
    if bad == "head_dim":
        q = posing_as_cuda(torch.zeros(3, 8, 80, dtype=torch.bfloat16))
        kv = posing_as_cuda(torch.zeros(2, 18, 16, 80, dtype=torch.bfloat16))
    elif bad == "groups":        # G 17: past the 16 rows of an mma tile
        q = posing_as_cuda(torch.zeros(3, 34, 128, dtype=torch.bfloat16))
    elif bad == "groups_ragged":  # H % hk != 0
        q = posing_as_cuda(torch.zeros(3, 7, 128, dtype=torch.bfloat16))
    elif bad == "lengths_dtype":
        lengths = posing_as_cuda(torch.ones(3, dtype=torch.int64))
    elif bad == "index_shape":
        idx = posing_as_cuda(torch.zeros(2, 6, dtype=torch.int32))
    elif bad == "dtype_mix":
        kv = posing_as_cuda(kv.float())
    elif bad == "pages":       # more page indices a row than it holds
        idx = posing_as_cuda(torch.zeros(3, port_paged.MAX_PAGES + 1,
                                         dtype=torch.int32))
    else:
        q = posing_as_cuda(torch.zeros(3, 8, 128), grad=True)
        kv = posing_as_cuda(kv.float())
        err = RuntimeError
    with pytest.raises(err):
        port_paged.paged_attention(q, kv, kv, lengths, idx)
    assert not fake_kernels and not _build.launches


# ---------------------------------------------------------------- rms_norm --

def rms_layout(d, elem_size):
    """(threads per row, rows per block, threads per block) of the one-pass
    kernel: 4 16-byte vectors a thread, whole warps a row, 128 threads a
    block at small d."""
    n_vec = d * elem_size // 16
    tpr = 32 * -(-n_vec // (32 * 4))
    rpb = 1 if tpr >= 128 else 128 // tpr
    return tpr, rpb, tpr * rpb


def model_rms_rows(x, weight, eps):
    """The kernel's arithmetic: thread r of a row's group sums the squares
    of its vectors r, r + tpr, r + 2 tpr, r + 3 tpr in f32, then the group's
    sums are added; then the normalised value in f32, rounded to the
    storage type, times the weight in the storage type."""
    rows, d = x.shape
    n = 16 // x.element_size()
    tpr, _, _ = rms_layout(d, x.element_size())
    xf = x.float().reshape(rows, d // n, n)
    slots = torch.zeros(rows, tpr * 4, n)
    slots[:, :d // n] = xf
    per_thread = (slots.reshape(rows, 4, tpr, n) ** 2).sum(dim=(1, 3))
    inv = torch.rsqrt(per_thread.sum(1, keepdim=True) / d + eps)
    return (x.float() * inv).to(x.dtype) * weight


@pytest.mark.parametrize("d,elem,want", [
    (512, 2, (32, 4, 128)), (2048, 2, (64, 2, 128)),
    (4096, 2, (128, 1, 128)), (512, 4, (32, 4, 128)),
    (2048, 4, (128, 1, 128)), (4096, 4, (256, 1, 256)),
    (8, 2, (32, 4, 128)), (32768, 2, (1024, 1, 1024))])
def test_rms_block_layout(d, elem, want):
    """A warp a row at DeepSeek's latent width 512 (4 rows a block), a few
    warps at 2048 and 4096; the widest row the kernel takes fills 1024
    threads."""
    assert rms_layout(d, elem) == want


@pytest.mark.parametrize("d", [512, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 8, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_model_matches_plain_and_jax(d, rows, dtype):
    rng = np.random.RandomState(d + rows)
    x = rng.randn(rows, d).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx, tw = _t(x).to(tdt), _t(w).to(tdt)
    got = model_rms_rows(tx, tw, 1e-5).float()
    ref = port_norm.rms_norm_plain(tx, tw, 1e-5).float()
    want = torch.from_numpy(np.asarray(jax_norm.rms_norm(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w, getattr(
            jnp, dtype)), 1e-5)).astype(np.float32))
    for r in (ref, want):
        assert bool(((got - r).abs() <= NORM_ATOL + NORM_RTOL * r.abs()).all())


def _norm_cuda(rows=8, d=512, dtype=torch.bfloat16):
    x = posing_as_cuda(torch.zeros(rows, d, dtype=dtype))
    w = posing_as_cuda(torch.ones(d, dtype=dtype))
    return x, w


def test_rms_norm_cuda_route_arguments_and_one_count(fake_kernels):
    """``pt_rms_norm`` gets raw pointers, rows, d, eps, the dtype code, the
    rows a block (0, the kernel's rule, with the autotune flag off) and the
    stream; one ``rms_norm`` count a call; ``add_rms_norm`` likewise."""
    x, w = _norm_cuda(rows=6, d=4096)
    out = port_norm.rms_norm(x, w, 1e-5)
    assert fake_kernels == [("pt_rms_norm", (
        x.data_ptr(), w.data_ptr(), out.data_ptr(), 6, 4096,
        1e-5, 1, 0, None))]
    r = posing_as_cuda(torch.zeros(6, 4096, dtype=torch.bfloat16))
    o, h = port_norm.add_rms_norm(x, r, w, 1e-5)
    name, args = fake_kernels[1]
    assert name == "pt_add_rms_norm" and args[5:7] == (6, 4096)
    assert args[3] == o.data_ptr() and args[4] == h.data_ptr()
    assert dict(_build.launches) == {"rms_norm": 1, "add_rms_norm": 1}


def test_rms_norm_cuda_route_f32_and_leading_axes(fake_kernels):
    x = posing_as_cuda(torch.zeros(2, 3, 512))
    w = posing_as_cuda(torch.ones(512))
    port_norm.rms_norm(x, w)
    name, args = fake_kernels[0]
    assert args[3:5] == (6, 512) and args[6] == 0


@pytest.mark.parametrize("bad", ["dtype", "mix", "weight", "d", "align",
                                 "wide"])
def test_rms_norm_cuda_route_refusals(bad, fake_kernels):
    """Every refusal stands: float32 / bfloat16 only, one dtype, a weight
    of [d], d a multiple of 8, 16-byte aligned inputs; and rows no wider
    than the kernel holds in registers. Nothing launches."""
    x, w = _norm_cuda()
    err = ValueError
    if bad == "dtype":
        x, w = (posing_as_cuda(t.half()) for t in (x, w))
        err = TypeError
    elif bad == "mix":
        w = posing_as_cuda(w.float())
    elif bad == "weight":
        w = posing_as_cuda(torch.ones(2, 256, dtype=torch.bfloat16))
    elif bad == "d":
        x, w = _norm_cuda(d=12)
    elif bad == "align":
        x = posing_as_cuda(torch.zeros(8 * 512 + 1, dtype=torch.bfloat16)[
            1:].reshape(8, 512))
    else:
        x, w = _norm_cuda(d=32768 + 8)
    with pytest.raises(err):
        port_norm.rms_norm(x, w)
    assert not fake_kernels and not _build.launches


@pytest.mark.parametrize("g", [3, 5, 6, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_route_at_odd_groups_matches_jax_ref(g, dtype):
    """Groups that are not powers of two (ERNIE-4.5-21B-A3B has 20 query
    heads over 4 KV heads, a group of 5): the wrapper's CPU route against
    the JAX ``_paged_attention_ref``, f32 within 1e-5, bf16 inputs (both
    sides from the same bf16 values, f32 sums) within phase 2's 2e-3 +
    2^-7 |p|; the split kernel's arithmetic model at 3 runs a row within
    the same tolerances."""
    q, kp, vp, lengths, idx = _paged(EDGE_LENGTHS, H=2 * g, hk=2, seed=30 + g)
    args = [_t(a).to(dtype) for a in (q, kp, vp)] + [_t(lengths), _t(idx)]
    got = port_paged.paged_attention(*args)
    jargs = [jnp.asarray(a.float().numpy()) for a in args[:3]]
    if dtype == torch.bfloat16:
        jargs = [a.astype(jnp.bfloat16) for a in jargs]
    want = np.asarray(jax_gen._paged_attention_ref(
        *jargs, jnp.asarray(lengths), jnp.asarray(idx))).astype(np.float32)
    model = model_paged(*args, 3).float().numpy()
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (ATOL, RTOL)
    for out in (got.float().numpy(), model):
        np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("g", [3, 5, 6, 7, 16])
def test_paged_cuda_route_admits_every_group(g, fake_kernels, monkeypatch):
    """On CUDA tensors every whole group of 1-16 query heads a KV head
    reaches the kernel: one ``pt_paged_attention`` call with H = g * hk,
    the split count planned from B * hk, one launch counted."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q, kv, lengths, idx = _paged_cuda(H=2 * g)
    out = port_paged.paged_attention(q, kv, kv, lengths, idx)
    assert dict(_build.launches) == {"paged_attention": 1}
    (name, args), = fake_kernels
    assert name == "pt_paged_attention"
    assert (args[9], args[10], args[11]) == (3, 2 * g, 2)
    assert args[15] == port_paged.split_count(3, 2, 6, H100_SMS)
    assert out.shape == (3, 2 * g, 128)
