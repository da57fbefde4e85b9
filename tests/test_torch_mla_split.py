"""The MLA latent-decode kernel's split plan and arithmetic, on the CPU.

``csrc/mla_decode.cu`` cuts the rows' visible prefixes (``pos[b] + 1``
columns, read on the card) into runs of whole 32-column tiles, at least
``MIN_TILES`` a run and balanced over a grid of about one block an SM
(``plan_runs`` below); block k takes run k, and blocks past the last run exit
and write nothing. Its bf16 body computes, tile by tile, the scores of 16
heads on the tensor cores with q entering as two bf16 terms (hi + lo)
against the exact bf16 latent, an f32 online softmax, and P C with P as
hi + lo; a second launch merges the partials of a row's runs with weights
exp(m_s - M). ``model_mla`` repeats that arithmetic in torch, held against
``mla_decode_plain`` and the JAX ``mla_decode_attention`` (the Pallas
kernel in interpret mode) within the port's f32 tolerance 1e-4 + 1e-4 |p|,
at pos 0, lengths at a tile boundary and one either side, T - 1, an
interior hole in ``allowed``, a dead row (exactly 0), 8 and 16 heads, B 1
and 8. At phase 2's scales, one bf16 rounding of q or of P misses that
tolerance, which is why each enters as hi + lo.

No kernel runs here: the CUDA route runs up to its C entry point with a
stand-in launch (the ``fake_kernels`` fixture), which shows the arguments,
the scratch and one launch count a call.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import mla_decode as jax_mla
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import mla_decode as port_mla
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4      # phase 2's MLA tolerance, f32 on both sides
BN = port_mla.BN
H100_SMS = 132


def plan_tiles(lengths, G, min_tiles=None):
    """Tiles of a run, as the kernel's ``plan_tiles`` picks them from the
    rows' visible lengths: the fewest, at least ``min_tiles`` and the tiles
    over the ``G`` blocks, that give no more than ``G`` runs; if
    ceil(tiles / G) gives too many, the tiles over the blocks left beside
    one spare run a nonempty row; a row a run if no block is left."""
    min_tiles = port_mla.MIN_TILES if min_tiles is None else min_tiles
    tiles = [-(-max(0, n) // BN) for n in lengths]
    total, rows = sum(tiles), sum(1 for n in tiles if n)
    per = max(min_tiles, -(-total // G))
    if sum(-(-n // per) for n in tiles) > G:
        per = (max(per + 1, -(-total // (G - rows))) if G > rows
               else max(tiles))
    return per


def plan_runs(lengths, G, min_tiles=None):
    """[(row, t_begin, t_end)] of the kernel's runs, slot by slot: every
    row's visible prefix [0, length) cut into runs of ``plan_tiles`` whole
    tiles of ``BN`` columns, rows in order. Block k takes run k; the blocks
    past the list exit and write no slot."""
    per = plan_tiles(lengths, G, min_tiles)
    runs = []
    for b, n in enumerate(lengths):
        n = max(0, n)
        runs += [(b, t, min(n, t + per * BN)) for t in range(0, n, per * BN)]
    assert len(runs) <= G
    return runs


def _terms(x, split):
    """x as the kernel feeds it to a bf16 product: hi + lo (two bf16 terms,
    16 bits of mantissa), one bf16 rounding, or exact f32."""
    if split == "f32":
        return x
    hi = x.bfloat16().float()
    if split == "bf16":
        return hi
    return hi + (x - hi).bfloat16().float()


def model_mla(q_lat, q_pe, ckv, kpe, pos, allowed, G, min_tiles=None,
              q_split="hilo", p_split="hilo", partials=None):
    """The kernel's arithmetic: each run of the plan over ``G`` blocks walks
    its tiles with an f32 online softmax (a head that has seen nothing keeps
    m = -inf and adds nothing), q and P entering their products as
    ``q_split`` / ``p_split`` terms, and writes slot k; the combine reads
    the slots of each row's runs. ``partials``, if given, is a dict that
    receives the (m, l, acc) slots [G, ...] as the kernel leaves them, NaN
    where no block wrote."""
    B, H, r = q_lat.shape
    T = ckv.shape[1]
    c = ckv.float()
    k = kpe.float()
    ql, qp = _terms(q_lat.float(), q_split), _terms(q_pe.float(), q_split)
    pm = torch.full((G, H), math.nan)
    pl = torch.full((G, H), math.nan)
    pa = torch.full((G, H, r), math.nan)
    lengths = [max(0, min(T, int(p) + 1)) for p in pos]
    runs = plan_runs(lengths, G, min_tiles)
    for slot, (b, t0, t1) in enumerate(runs):
        m = torch.full((H,), -math.inf)
        l = torch.zeros(H)
        acc = torch.zeros(H, r)
        for a in range(t0, t1, BN):
            e = min(a + BN, t1)
            sc = ql[b] @ c[b, a:e].T + qp[b] @ k[b, a:e].T
            if allowed is not None:
                sc = sc.masked_fill(~allowed[b, a:e].bool()[None], -math.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(sc - m_use[:, None])
            alpha = torch.exp(m - m_use)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + _terms(p, p_split) @ c[b, a:e]
            m = m_new
        pm[slot], pl[slot], pa[slot] = m, l, acc
    out = torch.zeros(B, H, r)
    for b in range(B):
        slots = [i for i, run in enumerate(runs) if run[0] == b]
        if not slots:
            continue
        m = pm[slots]
        M = m.amax(0)
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
        L = (w * pl[slots]).sum(0)
        ctx = torch.zeros(H, r)
        for i, s in enumerate(slots):     # a zero weight reads nothing
            ctx = ctx + torch.where(w[i, :, None] > 0,
                                    w[i, :, None] * pa[s], 0.0)
        inv = torch.where(L > 0, 1.0 / torch.where(L > 0, L, 1.0), 0.0)
        out[b] = ctx * inv[:, None]
    if partials is not None:
        partials.update(m=pm, l=pl, acc=pa, runs=runs)
    return out


def _inputs(B, H, r, dr, T, seed, q_scale=None):
    """f32 pre-scaled queries, bf16 unit-normal buffers (the serving path's
    types); q_scale defaults to phase 2's 2 / sqrt(r + dr): scores of
    spread 2."""
    rng = np.random.RandomState(seed)
    qs = 2.0 / math.sqrt(r + dr) if q_scale is None else q_scale
    ql = (rng.randn(B, H, r) * qs).astype(np.float32)
    qp = (rng.randn(B, H, dr) * qs).astype(np.float32)
    ckv = torch.from_numpy(rng.randn(B, T, r).astype(np.float32)).bfloat16()
    kpe = torch.from_numpy(rng.randn(B, T, dr).astype(np.float32)).bfloat16()
    return torch.from_numpy(ql), torch.from_numpy(qp), ckv, kpe


def _within(got, ref):
    """max over entries of |got - ref| / (ATOL + RTOL |ref|): <= 1 holds."""
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


T_SMALL = 512
# pos 0; lengths 31 / 32 / 33 and 127 / 128 / 129 (tile boundaries, one
# either side); T - 1
EDGE_POS = [0, 30, 31, 32, 126, 127, 128, T_SMALL - 1]


def _case(name, B, H):
    """pos and allowed of a named case at T_SMALL: ``edges`` every edge
    position (B 8), ``full`` T - 1 (B 1), ``hole`` an interior hole and a
    dead row."""
    if name == "edges":
        pos = np.asarray(EDGE_POS[:B], np.int32)
        return pos, None
    if name == "full":
        return np.full(B, T_SMALL - 1, np.int32), None
    pos = np.asarray(([300, 0, 129, T_SMALL - 1] * 2)[:B], np.int32)
    allowed = np.ones((B, T_SMALL), bool)
    allowed[0, 40:200] = False          # an interior hole
    if B > 1:
        allowed[1] = False              # a dead row
    return pos, allowed


@pytest.mark.parametrize("extra", [0, 5, 124])
@pytest.mark.parametrize("H", [8, 16])
@pytest.mark.parametrize("B,name", [(8, "edges"), (1, "full"), (8, "hole"),
                                    (1, "hole")])
def test_model_matches_plain_and_jax(B, name, H, extra):
    """The kernel's arithmetic (hi + lo q and P, f32 softmax, the combine of
    each row's runs) over B + ``extra`` blocks (one run a row; a few rows
    split; 132 blocks at B 8, tiles of one or two tiles a run) against the
    plain version and the Pallas kernel in interpret mode, at r 128, dr 64,
    T 512, within 1e-4 + 1e-4 |p|; a dead row exactly 0 in all three."""
    pos, allowed = _case(name, B, H)
    ql, qp, ckv, kpe = _inputs(B, H, 128, 64, T_SMALL, seed=B * H + extra)
    al = None if allowed is None else torch.from_numpy(allowed)
    got = model_mla(ql, qp, ckv, kpe, pos, al, B + extra, min_tiles=1)
    plain = port_mla.mla_decode_plain(ql, qp, ckv, kpe,
                                      torch.from_numpy(pos), al)
    want = torch.from_numpy(np.array(jax_mla.mla_decode_attention(
        jnp.asarray(ql.numpy()), jnp.asarray(qp.numpy()),
        jnp.asarray(ckv.float().numpy()), jnp.asarray(kpe.float().numpy()),
        jnp.asarray(pos), None if allowed is None else jnp.asarray(allowed),
        interpret=True)))
    assert _within(got, plain) <= 1.0
    assert _within(got, want) <= 1.0
    if name == "hole" and B > 1:
        for o in (got, plain, want):
            assert bool((o[1] == 0).all())
    assert bool(torch.isfinite(got).all())


@pytest.fixture(scope="module")
def phase2_full_rows():
    """Phase 2's widths and scales (H 16, r 512, dr 64, q of spread
    2 / sqrt(576), unit bf16 latents), B 2 full rows of T 4096, and the f64
    reference."""
    B, H, r, dr, T = 2, 16, 512, 64, 4096
    ql, qp, ckv, kpe = _inputs(B, H, r, dr, T, seed=2)
    pos = np.full(B, T - 1, np.int32)
    ref = port_mla.mla_decode_plain(ql.double(), qp.double(), ckv.double(),
                                    kpe.double(), torch.from_numpy(pos))
    G = port_mla.grid_blocks(B, H, H100_SMS)
    return (ql, qp, ckv, kpe, pos, G), ref.float()


@pytest.mark.parametrize("q_split,p_split,holds", [
    ("hilo", "hilo", True), ("bf16", "hilo", False), ("hilo", "bf16", False)])
def test_one_bf16_rounding_of_q_or_p_misses_the_tolerance(
        phase2_full_rows, q_split, p_split, holds):
    """At phase 2's scales over full 4096-column rows: hi + lo for both q
    and P keeps the kernel's arithmetic within a tenth of the tolerance of
    the f64 result (about 1/27 here); one bf16 rounding of q misses it
    (about 20 times over), and one of P too (about 1.9 times)."""
    args, ref = phase2_full_rows
    got = model_mla(*args[:5], None, args[5], q_split=q_split,
                    p_split=p_split)
    ratio = _within(got, ref)
    if holds:
        assert ratio <= 0.1
    else:
        assert ratio > 1.0


@pytest.mark.parametrize("lengths,G,min_tiles", [
    ([0], 132, 2), ([1], 132, 2), ([31, 32, 33], 132, 2),
    ([127, 128, 129], 132, 4), ([1041] * 8, 132, 2), ([4096] * 8, 132, 2),
    ([1, 4096, 1001, 2048, 3072, 18, 4001, 2501], 132, 2),
    ([4096], 132, 1), ([4096] * 200, 200, 2), ([0, 5, 0, 700], 4, 2),
    ([1000, 3, 2000], 3, 1), ([5000, 100], 7, 3)])
def test_runs_cover_each_visible_prefix_in_whole_tiles(lengths, G,
                                                       min_tiles):
    """The runs cover each row's [0, length) in order, without overlap or
    gap, rows in order, in runs of the plan's whole tiles (only a row's
    last may end short, at its length), at least ``min_tiles`` tiles unless
    a row is shorter, and never more runs than blocks."""
    runs = plan_runs(lengths, G, min_tiles)
    per = plan_tiles(lengths, G, min_tiles)
    assert len(runs) <= G and per >= min_tiles
    assert [b for b, _, _ in runs] == sorted(b for b, _, _ in runs)
    for b, n in enumerate(lengths):
        mine = [(t0, t1) for row, t0, t1 in runs if row == b]
        ends = [0] + [t1 for _, t1 in mine]
        assert [t0 for t0, _ in mine] == ends[:-1] and ends[-1] == max(0, n)
        for t0, t1 in mine:
            assert t1 > t0 and t0 % (per * BN) == 0
            assert t1 == n or t1 - t0 == per * BN


def test_empty_slots_are_never_read():
    """Slots past the last run stay as the scratch was (NaN here), a dead
    row has no run, and the result is finite and right: the combine reads
    only the slots of each row's runs."""
    B, H = 3, 16
    ql, qp, ckv, kpe = _inputs(B, H, 128, 64, T_SMALL, seed=9)
    pos = np.asarray([0, T_SMALL - 1, -1], np.int32)
    parts = {}
    got = model_mla(ql, qp, ckv, kpe, pos, None, 16, min_tiles=4,
                    partials=parts)
    assert [run[0] for run in parts["runs"]] == [0, 1, 1, 1, 1]
    n = len(parts["runs"])
    assert bool(torch.isnan(parts["acc"][n:]).all())
    assert not bool(torch.isnan(parts["acc"][:n]).any())
    assert bool(torch.isfinite(got).all()) and bool((got[2] == 0).all())
    plain = port_mla.mla_decode_plain(ql, qp, ckv, kpe,
                                      torch.from_numpy(pos))
    assert _within(got[:2], plain[:2]) <= 1.0


# the ragged rows of phase 2 and the serving lengths of phase 10's profile
RAGGED_POS = [0, 4095, 1000, 2047, 3071, 17, 4000, 2500]
SERVING_POS = list(range(1040, 1048))


@pytest.mark.parametrize("B,H,pos,want_G,want_per,want_runs", [
    (8, 16, RAGGED_POS, 132, 5, 110),
    (8, 16, SERVING_POS, 132, 3, 88),
    (1, 16, [4095], 132, 2, 64),
    (1, 8, [127], 132, 2, 2),
    (8, 16, [4095] * 8, 132, 8, 128),
    (200, 16, [4095] * 200, 200, 128, 200),
    (4, 32, [4095] * 4, 66, 8, 64),
])
def test_plan_at_the_smoke_shapes(B, H, pos, want_G, want_per, want_runs):
    """The grid from shapes alone (one bf16 block an SM of the H100 for each
    16-head tile, never fewer than the rows) and the plan the rows' lengths
    give: at phase 2's ragged rows runs of 5 tiles on 110 of the 132
    blocks (4 tiles would make 134 runs), at the serving lengths 3 tiles on
    88."""
    G = port_mla.grid_blocks(B, H, H100_SMS)
    lengths = [p + 1 for p in pos]
    assert G == want_G
    assert plan_tiles(lengths, G) == want_per
    assert len(plan_runs(lengths, G)) == want_runs


def _mla_cuda(B=3, H=16, r=512, dr=64, T=256, dtype=torch.bfloat16):
    q_lat = posing_as_cuda(torch.zeros(B, H, r))
    q_pe = posing_as_cuda(torch.zeros(B, H, dr))
    ckv = posing_as_cuda(torch.zeros(B, T, r, dtype=dtype))
    kpe = posing_as_cuda(torch.zeros(B, T, dr, dtype=dtype))
    return q_lat, q_pe, ckv, kpe


def test_mla_cuda_route_arguments_scratch_and_one_count(fake_kernels,
                                                        monkeypatch):
    """On CUDA tensors the wrapper calls ``pt_mla_decode`` once a call with
    the shapes, the blocks of ``grid_blocks``, ``MIN_TILES``, the dtype
    code and the partial buffers laid end to end in one scratch ([G, H, r]
    acc, then [G, H] m and l, then the rows' spans [B, 2]), and counts one
    ``mla_decode`` launch a call; per-row pos goes as int32 [B]."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q_lat, q_pe, ckv, kpe = _mla_cuda()
    pos = posing_as_cuda(torch.tensor([0, 100, 255], dtype=torch.int32))
    allowed = posing_as_cuda(torch.ones(3, 256, dtype=torch.bool))
    out = port_mla.mla_decode(q_lat, q_pe, ckv, kpe, pos, allowed)
    port_mla.mla_decode(q_lat, q_pe, ckv, kpe, 7)
    assert dict(_build.launches) == {"mla_decode": 2}
    assert len(fake_kernels) == 2
    name, args = fake_kernels[0]
    n = port_mla.grid_blocks(3, 16, H100_SMS)
    assert name == "pt_mla_decode" and n == 132
    assert args[11:] == (3, 16, 256, 512, 64, n, port_mla.MIN_TILES, 1, None)
    assert args[0] == q_lat.data_ptr() and args[2] == ckv.data_ptr()
    assert args[3] == kpe.data_ptr() and args[10] == out.data_ptr()
    assert args[5] is not None and fake_kernels[1][1][5] is None
    # acc [n, 16, 512] first, then m and l [n, 16], then spans [3, 2]
    assert args[6] - args[8] == n * 16 * 512 * 4
    assert args[7] - args[6] == args[9] - args[7] == n * 16 * 4
    assert out.shape == (3, 16, 512) and out.dtype == torch.float32


def test_mla_cuda_route_f32_dtype_code_and_h8(fake_kernels, monkeypatch):
    """f32 buffers go with dtype code 0; 8 heads (the JAX gate's smallest)
    take the same grid of one head tile."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q_lat, q_pe, ckv, kpe = _mla_cuda(H=8, dtype=torch.float32)
    port_mla.mla_decode(q_lat, q_pe, ckv, kpe, 3)
    args = fake_kernels[0][1]
    assert args[12] == 8 and args[18] == 0
    assert args[16] == port_mla.grid_blocks(3, 8, H100_SMS) == 132


@pytest.mark.parametrize("bad", ["heads", "latent", "rope", "q_dtype",
                                 "dtype_mix", "shape", "allowed", "grad",
                                 "bf16_width"])
def test_mla_cuda_route_refusals(bad, fake_kernels, monkeypatch):
    """The wrapper's refusals: at most 128 heads, latent width 512 and rope
    width 128, f32 queries, one buffer dtype, shapes that agree, allowed of
    [B, T], no input that needs a gradient; and bf16 widths that are
    multiples of 8 (16-byte copies of each row). Nothing launches."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    q_lat, q_pe, ckv, kpe = _mla_cuda()
    allowed = None
    err = ValueError
    if bad == "heads":
        q_lat, q_pe, ckv, kpe = _mla_cuda(H=136)
    elif bad == "latent":
        q_lat, q_pe, ckv, kpe = _mla_cuda(r=640)
    elif bad == "rope":
        q_lat, q_pe, ckv, kpe = _mla_cuda(dr=192)
    elif bad == "q_dtype":
        q_lat = posing_as_cuda(torch.zeros(3, 16, 512, dtype=torch.bfloat16))
    elif bad == "dtype_mix":
        kpe = posing_as_cuda(kpe.float())
    elif bad == "shape":
        ckv = posing_as_cuda(torch.zeros(3, 255, 512, dtype=torch.bfloat16))
    elif bad == "allowed":
        allowed = posing_as_cuda(torch.ones(3, 128, dtype=torch.bool))
    elif bad == "bf16_width":
        q_lat, q_pe, ckv, kpe = _mla_cuda(r=500, dr=60)
    else:
        q_lat = posing_as_cuda(torch.zeros(3, 16, 512), grad=True)
        err = RuntimeError
    with pytest.raises(err):
        port_mla.mla_decode(q_lat, q_pe, ckv, kpe, 5, allowed)
    assert not fake_kernels and not _build.launches
