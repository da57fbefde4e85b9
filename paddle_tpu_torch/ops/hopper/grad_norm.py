"""Global gradient norm and clip scale (CUDA kernels in csrc/grad_norm.cu).

Replaces no TPU kernel: the JAX package computes
``ClipGradByGlobalNorm.functional_clip`` (``paddle_tpu/optimizer/clip.py:
57-68``) as XLA code inside its train step. ``grad_norm(grads, clip_norm)``
returns one f32 tensor [2]: the global norm ``sqrt(sum of every
gradient's squares in f32)`` and the clip scale ``min(clip_norm / (norm +
1e-6), 1)``, both on the gradients' device. The optimizer hands the scale's
address to the fused update (``adam_update``), so the host never waits for
the norm and no clipped copy of the gradients is made.

The plain version is the port's clip as it was (each gradient's
``sq_norm``, added in the gradients' order). The kernel sums in another
order (per-block f32 partials, then a second pass in a fixed order, no
float atomics), so its norm differs from the plain one in the last bits,
and two calls on the same gradients give the same bits.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the two passes, counted as one ``grad_norm``, or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .adam_update import upload

_STEM = "grad_norm"
CHUNK = 65536     # elements a block of pass 1 sums (csrc/grad_norm.cu)
EPS = 1e-6        # added to the norm before the division (clip.py:66)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [_build.VOIDP, _build.INT, _build.INT64, _build.VOIDP,
             _build.FLOAT, _build.FLOAT, _build.VOIDP, _build.VOIDP]


def sq_norm(g):
    """Sum of squares of one gradient in f32."""
    return torch.sum(torch.square(g.float()))


def grad_norm_plain(grads, clip_norm):
    """(norm, scale) as an f32 tensor [2]."""
    total = torch.sqrt(sum(sq_norm(g) for g in grads))
    scale = torch.clamp(clip_norm / (total + EPS), max=1.0)
    return torch.stack([total, scale])


def build_table(grads):
    """(int64 CPU table [tensors, 4], blocks). Row i: the gradient's
    address, its element count, then ``first_block << 2 | vec << 1 |
    bf16``, and a 0."""
    rows, first = [], 0
    for g in grads:
        code = _CODES.get(g.dtype)
        if code is None:
            raise TypeError(f"grad_norm takes float32 or bfloat16 gradients, "
                            f"got {g.dtype}")
        n = g.numel()
        vec = g.data_ptr() % 16 == 0
        rows.append([g.data_ptr(), n, first << 2 | int(vec) << 1 | code, 0])
        first += -(-n // CHUNK)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 4), first


def grad_norm(grads, clip_norm):
    """(norm, scale) of the gradients ``grads`` (a list) as an f32 tensor
    [2] on their device."""
    grads = list(grads)
    if not grads:
        raise ValueError("grad_norm needs at least one gradient")
    device = grads[0].device
    if device.type == "cpu":
        return grad_norm_plain(grads, clip_norm)
    _build.require_cuda(*grads)
    grads = [g for g in grads if g.numel()]
    table, blocks = build_table(grads)
    table = upload(table, device)
    partials = torch.empty(blocks, dtype=torch.float32, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    err = _build.function(_STEM, "pt_grad_norm", _ARGTYPES)(
        table.data_ptr(), len(grads), blocks, partials.data_ptr(),
        float(clip_norm), EPS, out.data_ptr(), _build.stream(device))
    _build.launches["grad_norm"] += 1
    _build.check(err, _STEM, "grad_norm")
    return out
