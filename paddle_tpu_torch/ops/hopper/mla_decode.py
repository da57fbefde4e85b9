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

The Pallas gate ``supported()`` (``mla_decode.py:51-67``) caps the buffer
at 10 MB of VMEM residency (T <= 8192 at DeepSeek-V2 widths): that cap is
the TPU's, whose kernel holds a row's whole buffer in VMEM. The CUDA kernel
streams the buffer from device memory in tiles, so it takes any T; it
takes up to 16 heads, a latent width up to 512 and a rope width up to 128,
buffers of float32 or bfloat16.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (a split pass and a combine pass, counted as one
``mla_decode`` launch) or raises.
"""
from __future__ import annotations

import torch

from . import _build

_STEM = "mla_decode"
BN = 32            # columns per tile (csrc/mla_decode.cu)
MAX_HEADS, MAX_R, MAX_DR, MAX_SPLIT = 16, 512, 128, 256


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


def split_plan(B, T, device):
    """Splits per row: about two blocks per SM over the B rows, no more
    than the buffer has tiles. The kernel cuts each row's visible prefix,
    not the buffer, into that many chunks of whole tiles."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return min(MAX_SPLIT, -(-T // BN), max(1, -(-2 * n_sm // B)))


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
    _build.require(H <= MAX_HEADS and r <= MAX_R and dr <= MAX_DR,
                   f"mla_decode: the kernel takes up to {MAX_HEADS} heads, "
                   f"latent width {MAX_R} and rope width {MAX_DR}; got H={H} "
                   f"r={r} dr={dr}")
    code = _build.dtype_code(ckv_buf)
    q_lat, q_pe = q_lat.contiguous(), q_pe.contiguous()
    rows = _row_pos(pos, B, q_lat.device)
    tensors = [q_lat, q_pe, ckv_buf, kpe_buf, rows]
    a_ptr = None
    if allowed is not None:
        _build.require(tuple(allowed.shape) == (B, T),
                       f"mla_decode: allowed must be [B, T] = ({B}, {T})")
        allowed = allowed.to(torch.uint8).contiguous()
        tensors.append(allowed)
        a_ptr = _build.ptr(allowed)
    _build.require_cuda(*tensors)
    out = torch.empty(B, H, r, dtype=torch.float32, device=q_lat.device)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    n_split = split_plan(B, T, q_lat.device)
    part_m = torch.empty(B, n_split, H, dtype=torch.float32,
                         device=q_lat.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B, n_split, H, r, dtype=torch.float32,
                           device=q_lat.device)
    fn = _build.function(_STEM, "pt_mla_decode", [_build.VOIDP] * 10 + [
        _build.INT] * 7 + [_build.VOIDP])
    err = fn(_build.ptr(q_lat), _build.ptr(q_pe), _build.ptr(ckv_buf),
             _build.ptr(kpe_buf), _build.ptr(rows), a_ptr, _build.ptr(part_m),
             _build.ptr(part_l), _build.ptr(part_acc), _build.ptr(out), B, H,
             T, r, dr, n_split, code,
             _build.stream(q_lat.device))
    _build.launches["mla_decode"] += 1
    _build.check(err, _STEM, "mla_decode")
    return out
