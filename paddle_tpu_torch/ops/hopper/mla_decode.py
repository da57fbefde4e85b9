"""MLA latent decode attention: one absorbed query per batch row against the
compressed latent cache (CUDA kernel in csrc/mla_decode.cu).

Counterpart of ``paddle_tpu/ops/pallas/mla_decode.py``
``mla_decode_attention``, with its signature and layouts: q_lat [B, H, r]
(q_nope absorbed through W_uk) and q_pe [B, H, dr] (roped), both f32 and
pre-scaled; ckv_buf [B, T, r] and kpe_buf [B, T, dr] (the current token
already written at ``pos``); ``pos`` an int or [B] per-row limits; an
optional [B, T] column mask ``allowed``. Row b sees columns t <= pos[b]
that are allowed. Returns the latent-space context [B, H, r] in f32; a row
that sees no column returns 0, as the Pallas kernel does.

The Pallas gate ``supported()`` (``mla_decode.py:51-67``) takes any head
count with ``H % 8 == 0`` and caps the buffer at 10 MB of VMEM residency
(T <= 8192 at DeepSeek-V2 widths): that cap is the TPU's, whose kernel
holds a row's whole buffer in VMEM. The CUDA kernel streams the buffer from
device memory in tiles, so it takes any T; it takes the gate's head counts
up to 128 (DeepSeek-V2 and V3), as head tiles of 16 on its grid's z axis
(a last tile of 8 heads, as at H 8 or 24, has its other rows masked and
writes nothing for them), a latent width up to 512 and a rope width up to
128, buffers of float32 or bfloat16 (bf16: both widths multiples of 8 and
the buffers 16-byte aligned, as its tensor-map copies need).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (a split pass and a combine pass, counted as one
``mla_decode`` launch) or raises. The host sizes the split grid from
shapes alone (``grid_blocks``), or with ``FLAGS_use_autotune`` by the
search (``autotune.pick``, kernel ``"mla_decode"`` as in the JAX package,
whose search times its T block) over ``grid_candidates``: from B blocks
to a few waves of 16-head tiles an SM. At 128 heads a wave is 132 // 8 =
16 blocks a head tile: 128 blocks on 132 SMs, one block an SM at most, no
fuller wave (a redesign that splits more finely is queued). The kernel
cuts the rows' visible prefixes into runs of whole tiles, balanced over its
blocks, from the lengths on the card (``plan_tiles`` in
csrc/mla_decode.cu), so nothing waits for ``pos``.
"""
from __future__ import annotations

import torch

from . import _build, autotune

_STEM = "mla_decode"
BN = 32            # columns per tile (csrc/mla_decode.cu)
HEAD_TILE = 16     # heads of a block: the m of its tensor-core products
MIN_TILES = 2      # tiles a run takes at least: 64 columns, 74 KB of bf16
                   # cache read for a 32 KB f32 partial
MAX_HEADS, MAX_R, MAX_DR = 128, 512, 128
HEAD_STEP = 8      # the head counts the JAX gate takes: multiples of 8
_ARGTYPES = [_build.VOIDP] * 11 + [_build.INT] * 8 + [_build.VOIDP]


def _row_pos(pos, B, device):
    """``pos`` (an int or [B]) as an int32 [B] tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(
            B).contiguous()
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def mla_decode_plain(q_lat, q_pe, ckv_buf, kpe_buf, pos, allowed=None):
    """Masked f32 softmax over the buffer with the kernel's dead-row rule
    (a row with no visible column gives 0)."""
    B, H, r = q_lat.shape
    T = ckv_buf.shape[1]
    scores = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv_buf.float())
              + torch.einsum("bhd,btd->bht", q_pe.float(), kpe_buf.float()))
    lim = _row_pos(pos, B, q_lat.device).long()
    vis = torch.arange(T, device=q_lat.device)[None, :] <= lim[:, None]
    if allowed is not None:
        vis = vis & allowed.bool()
    scores = scores.masked_fill(~vis[:, None, :], float("-inf"))
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)                      # exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bht,btr->bhr", p, ckv_buf.float())
    return torch.where(l > 0, ctx / torch.where(l > 0, l, 1.0), 0.0)


def grid_blocks(B, H, n_sm):
    """Blocks of the split launch, from shapes alone: one bf16 block an SM
    for each 16-head tile, never fewer than the rows. The kernel cuts the
    rows' visible prefixes into at most that many runs and the blocks past
    the last run exit."""
    return max(B, n_sm // -(-H // HEAD_TILE), 1)


#: the split launch's blocks at most, in waves of one block an SM for each
#: 16-head tile (the partials grow with the blocks)
MAX_WAVES = 4


def grid_candidates(B, H, n_sm):
    """The autotune space of the split launch's blocks, ascending: B (one
    run a row), half a wave, and one to ``MAX_WAVES`` waves of 16-head
    tiles an SM, never fewer than B; ``grid_blocks``'s is among them."""
    wave = n_sm // -(-H // HEAD_TILE)
    return sorted({max(B, c, 1) for c in
                   (B, wave // 2, *(w * wave for w in range(1,
                                                             MAX_WAVES + 1)))})


def mla_decode(q_lat, q_pe, ckv_buf, kpe_buf, pos, allowed=None):
    """The latent context [B, H, r] f32 (see the module docstring). On CUDA
    it has no backward and refuses inputs that need a gradient."""
    if q_lat.device.type == "cpu":
        return mla_decode_plain(q_lat, q_pe, ckv_buf, kpe_buf, pos, allowed)
    _build.require_no_grad("mla_decode", q_lat, q_pe, ckv_buf, kpe_buf)
    B, H, r = q_lat.shape
    T, dr = ckv_buf.shape[1], q_pe.shape[-1]
    _build.require(q_lat.dtype == torch.float32
                   and q_pe.dtype == torch.float32,
                   "mla_decode: q_lat and q_pe must be float32")
    _build.require(ckv_buf.dim() == 3 and tuple(ckv_buf.shape) == (B, T, r)
                   and kpe_buf.dim() == 3 and kpe_buf.shape[:2] == (B, T)
                   and kpe_buf.shape[2] == dr and q_pe.shape[:2] == (B, H),
                   f"mla_decode: q_lat {tuple(q_lat.shape)}, q_pe "
                   f"{tuple(q_pe.shape)}, ckv {tuple(ckv_buf.shape)} and kpe "
                   f"{tuple(kpe_buf.shape)} disagree")
    _build.require(kpe_buf.dtype == ckv_buf.dtype,
                   "mla_decode: ckv_buf and kpe_buf must share one dtype")
    _build.require(H % HEAD_STEP == 0 and H <= MAX_HEADS and r <= MAX_R
                   and dr <= MAX_DR,
                   f"mla_decode: the kernel takes head counts that are "
                   f"multiples of {HEAD_STEP} up to {MAX_HEADS}, latent width "
                   f"up to {MAX_R} and rope width up to {MAX_DR}; got H={H} "
                   f"r={r} dr={dr}")
    code = _build.dtype_code(ckv_buf)
    if code == 1:
        _build.require(r % 8 == 0 and dr % 8 == 0
                       and ckv_buf.data_ptr() % 16 == 0
                       and kpe_buf.data_ptr() % 16 == 0,
                       f"mla_decode: bf16 buffers need widths that are "
                       f"multiples of 8 and 16-byte aligned rows; got r={r} "
                       f"dr={dr}")
    # the kernel reads the queries two values at a time
    q_lat, q_pe = (q if q.is_contiguous() and q.data_ptr() % 8 == 0
                   else q.clone(memory_format=torch.contiguous_format)
                   for q in (q_lat, q_pe))
    rows = _row_pos(pos, B, q_lat.device)
    tensors = [q_lat, q_pe, ckv_buf, kpe_buf, rows]
    a_ptr = None
    if allowed is not None:
        _build.require(tuple(allowed.shape) == (B, T),
                       f"mla_decode: allowed must be [B, T] = ({B}, {T})")
        allowed = allowed.to(torch.uint8).contiguous()
        tensors.append(allowed)
        a_ptr = allowed.data_ptr()
    _build.require_cuda(*tensors)
    if B * H * r == 0 or T == 0:
        return torch.zeros(B, H, r, dtype=torch.float32, device=q_lat.device)
    n_sm = _build.sm_count(q_lat.device)
    args = (q_lat, q_pe, ckv_buf, kpe_buf, rows, a_ptr, code, n_sm)
    G = grid_blocks(B, H, n_sm)
    if autotune.enabled():
        (G,) = autotune.pick(
            "mla_decode", f"B{B}xH{H}xr{r}xT{T} {_DTYPES[code]}", (G,),
            [(g,) for g in grid_candidates(B, H, n_sm)],
            lambda cfg: lambda: _launch(*args, cfg[0]),
            autotune.can_measure(q_lat, ckv_buf, rows))
    return _launch(*args, G)


_DTYPES = ("float32", "bfloat16")


def _launch(q_lat, q_pe, ckv_buf, kpe_buf, rows, a_ptr, code, n_sm, G):
    """One launch over ``G`` blocks, on inputs the wrapper has checked;
    ``G`` outside ``[B, MAX_WAVES`` waves] is refused before it."""
    B, H, r = q_lat.shape
    T, dr = ckv_buf.shape[1], q_pe.shape[-1]
    _build.require(B <= G <= max(grid_candidates(B, H, n_sm)),
                   f"mla_decode: {G} blocks outside [{B}, "
                   f"{max(grid_candidates(B, H, n_sm))}]")
    out = torch.empty(B, H, r, dtype=torch.float32, device=q_lat.device)
    # one scratch: a slot a block, acc [G, H, r] then m and l [G, H] (f32),
    # then each row's first slot and count [B, 2] (int32)
    part = torch.empty(G * H * (r + 2) + 2 * B, dtype=torch.float32,
                       device=q_lat.device)
    acc = part.data_ptr()
    m = acc + G * H * r * 4
    fn = _build.function(_STEM, "pt_mla_decode", _ARGTYPES)
    err = fn(q_lat.data_ptr(), q_pe.data_ptr(), ckv_buf.data_ptr(),
             kpe_buf.data_ptr(), rows.data_ptr(), a_ptr, m, m + G * H * 4,
             acc, m + 2 * G * H * 4, out.data_ptr(), B, H, T, r, dr, G,
             MIN_TILES, code, _build.stream(q_lat.device))
    _build.launches["mla_decode"] += 1
    _build.check(err, _STEM, "mla_decode")
    return out
