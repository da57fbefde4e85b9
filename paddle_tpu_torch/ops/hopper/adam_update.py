"""Multi-tensor Adam / AdamW update (CUDA kernel in csrc/adam_update.cu).

Replaces no TPU kernel. The JAX package's ``TrainStep``
(``paddle_tpu/jit/__init__.py:218-303``) runs ``Adam.update``
(``paddle_tpu/optimizer/optimizer.py:245-261``) inside one donated XLA
computation, where XLA fuses each parameter's update chain into one loop
over its elements. Eager PyTorch runs the same chain as about 17
elementwise kernels a tensor; this kernel is the hand-written counterpart
of XLA's fusion: one pass over a whole group of tensors.

``adam_update(items, hp, scale, tables)`` updates in place, for each item
``(param, grad, state, decay)``: the parameter, its f32 ``master`` where
the state has one, the moments ``moment1`` / ``moment2`` and, with
``amsgrad``, ``moment2_max``. ``scale`` (a 0-d f32 tensor or None) is the
global-norm clip's factor: each gradient is first clipped as
``ClipGradByGlobalNorm.functional_clip`` clips it, ``(g.float() *
scale).to(g.dtype)``.

The plain version is the port's per-parameter update as it was before this
kernel (``Optimizer.apply_gradients`` and ``Adam.update``), its casts and
rounding order kept: the moments are read as f32 and stored once,
``m = m*b1 + g*(1-b1)``, ``v = v*b2 + (g*(1-b2))*g``, ``w -= ((m/bc1)*lr) /
(sqrt(v/bc2) + eps)`` with the bias corrections from the host's
``np.float32`` power; AdamW scales the f32 value by ``1 - lr*wd`` (formed in
Python) first, Adam adds ``w*wd`` to the gradient. One change: the square
root is the correctly rounded one (``sqrt_rn``). PyTorch's f32 square root
on the CPU goes through MKL's vector math, within one ulp but not
correctly rounded (about 0.6% of random inputs land one ulp off), so its
bits depend on the host's code path and no kernel can reproduce them. The
kernel computes the same operations in the same order with IEEE division
and square root and no fused multiply-add, on each Python scalar rounded
to f32 as PyTorch rounds it, so it equals the plain version on the CPU bit
for bit.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches one kernel per group of tensors sharing (parameter dtype, master
or not, moment dtype, amsgrad, L2 or decoupled decay), or raises. The
group's table (pointers, element counts, decay and vector flags) is built
on the host and kept on the card while its addresses hold (``Tables``).
Each launch counts one ``adam_update``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build

_STEM = "adam_update"
CHUNK = 65536     # elements a block updates (csrc/adam_update.cu)
ROW = 8           # int64 words a tensor's table row holds
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([_build.VOIDP, _build.INT, _build.INT64] + [_build.INT] * 5
             + [_build.FLOAT] * 9 + [_build.VOIDP, _build.VOIDP])


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    """One step's settings: the rate, betas, epsilon, the decay (L2 added
    to the gradient, or ``decoupled``), amsgrad and the step count (from
    1)."""
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    decoupled: bool
    amsgrad: bool
    step: int


def bias_corrections(beta1, beta2, step):
    """(1 - beta1^step, 1 - beta2^step), the power taken in f32 on the
    host."""
    stepf = np.float32(step)
    return (float(np.float32(1) - np.float32(beta1) ** stepf),
            float(np.float32(1) - np.float32(beta2) ** stepf))


def sqrt_rn(x):
    """The correctly rounded f32 square root of f32 ``x`` (IEEE, the
    kernel's ``__fsqrt_rn``): taken in f64 and rounded once, which is
    exact for f32 inputs (53 >= 2 * 24 + 2 bits)."""
    return x.double().sqrt_().float()


@torch.no_grad()
def adam_update_plain(items, hp: AdamHyper, scale=None):
    """The per-parameter eager update, in place."""
    b1, b2 = hp.beta1, hp.beta2
    bc1, bc2 = bias_corrections(b1, b2, hp.step)
    for p, g, state, decay in items:
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        w = p.detach()
        master = state.get("master")
        w32 = master if master is not None else w
        if w32.dtype != torch.float32:     # low precision, no master
            w32 = w32.float()
        g32 = g.float()
        if decay:
            if hp.decoupled:
                w32.mul_(1.0 - hp.lr * hp.weight_decay)
            else:
                g32 = g32 + w32 * hp.weight_decay
        m_store, v_store = state["moment1"], state["moment2"]
        # m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g * g (f32, in
        # the JAX rounding order)
        m = m_store.float().mul_(b1).add_(g32 * (1 - b1))
        v = v_store.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        v_hat = v
        if hp.amsgrad:
            v_max = state["moment2_max"]
            v_hat = torch.maximum(v_max.float(), v)
            v_max.copy_(v_hat)
        denom = sqrt_rn(v_hat / bc2).add_(hp.eps)
        w32.sub_((m / bc1).mul_(hp.lr).div_(denom))
        if m is not m_store:
            m_store.copy_(m)
            v_store.copy_(v)
        if w32 is not w:
            w.copy_(w32)


def group_key(p, g, state, hp: AdamHyper) -> tuple:
    """(parameter dtype code, has a master, moment dtype code, amsgrad, L2
    decay): the kernel instance that updates this tensor. Raises on what
    the kernel does not take."""
    code = _CODES.get(p.dtype)
    m_code = _CODES.get(state["moment1"].dtype)
    if code is None or m_code is None:
        raise TypeError(f"adam_update takes float32 or bfloat16 parameters "
                        f"and moments, got {p.dtype} and "
                        f"{state['moment1'].dtype}")
    master = state.get("master")
    if g.dtype != p.dtype or g.shape != p.shape:
        raise ValueError(f"adam_update: gradient {g.dtype} {tuple(g.shape)} "
                         f"does not match its parameter {p.dtype} "
                         f"{tuple(p.shape)}")
    moments = [state["moment1"], state["moment2"]]
    if hp.amsgrad:
        moments.append(state["moment2_max"])
    if any(t.dtype != state["moment1"].dtype or t.shape != p.shape
           for t in moments):
        raise ValueError("adam_update: moments must share one dtype and "
                         "their parameter's shape")
    if master is not None and (master.dtype != torch.float32
                               or master.shape != p.shape or code == 0):
        raise ValueError("adam_update: a master is the f32 copy of a "
                         "bfloat16 parameter")
    return (code, master is not None, m_code, bool(hp.amsgrad),
            not hp.decoupled)


def group_items(items, hp: AdamHyper) -> dict:
    """{group_key: [item, ...]} in the items' order."""
    groups: dict = {}
    for item in items:
        p, g, state, _ = item
        groups.setdefault(group_key(p, g, state, hp), []).append(item)
    return groups


def _pointers(item):
    p, g, state, _ = item
    master, vmax = state.get("master"), state.get("moment2_max")
    return (p.data_ptr(), g.data_ptr(),
            0 if master is None else master.data_ptr(),
            state["moment1"].data_ptr(), state["moment2"].data_ptr(),
            0 if vmax is None else vmax.data_ptr())


def signature(group) -> tuple:
    """What a group's table depends on: every address, element count and
    decay flag."""
    return tuple(_pointers(item) + (item[0].numel(), bool(item[3]))
                 for item in group)


def build_table(group):
    """(int64 CPU table [tensors, ROW], blocks). Row i: the parameter,
    gradient, master (0: none), moment1, moment2 and moment2_max (0: none)
    addresses, the element count, then ``first_block << 2 | vec << 1 |
    decay``: the tensor's first block of CHUNK elements, whether every
    address is 16-byte aligned (the kernel's vector loads), and whether it
    decays."""
    rows, first = [], 0
    for item in group:
        ptrs = _pointers(item)
        n = item[0].numel()
        vec = all(a % 16 == 0 for a in ptrs)
        rows.append(list(ptrs) + [n, first << 2 | int(vec) << 1
                                  | int(bool(item[3]))])
        first += -(-n // CHUNK)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, ROW), first


def upload(table, device):
    """The table on ``device``, copied from pinned memory without a host
    wait (the pinned block is not reused before its copy has run)."""
    if device.type == "cuda" and torch.cuda.is_available():
        table = table.pin_memory()
    return table.to(device, non_blocking=True)


class Tables:
    """Each group's table on the card, rebuilt only when the group's
    addresses, sizes or decay flags change (a gradient reallocated by the
    next backward, a state loaded anew)."""

    def __init__(self):
        self._cache: dict = {}
        self.builds = 0

    def get(self, key, group, device):
        """(device table, tensors, blocks) of ``group``."""
        sig = signature(group)
        hit = self._cache.get(key)
        if hit is None or hit[0] != sig:
            table, blocks = build_table(group)
            hit = (sig, upload(table, device), len(group), blocks)
            self._cache[key] = hit
            self.builds += 1
        return hit[1:]


def _scalars(hp: AdamHyper):
    """The nine f32 scalars the kernel takes, each the Python value that
    the plain version hands PyTorch (which rounds it to f32): b1, 1 - b1,
    b2, 1 - b2, eps, lr, bc1, bc2, then the decay factor (``1 - lr*wd``
    decoupled, ``wd`` as L2)."""
    bc1, bc2 = bias_corrections(hp.beta1, hp.beta2, hp.step)
    wdf = (1.0 - hp.lr * hp.weight_decay if hp.decoupled
           else hp.weight_decay)
    return (hp.beta1, 1 - hp.beta1, hp.beta2, 1 - hp.beta2, hp.eps, hp.lr,
            bc1, bc2, wdf)


def adam_update(items, hp: AdamHyper, scale: Optional[torch.Tensor],
                tables: Tables):
    """One Adam / AdamW step over ``items`` [(param, grad, state, decay)],
    in place; ``scale`` the clip factor (0-d f32) or None; ``tables`` the
    caller's kept device tables."""
    if not items:
        return
    device = items[0][0].device
    if device.type == "cpu":
        adam_update_plain(items, hp, scale)
        return
    groups = group_items(items, hp)
    for key, group in groups.items():
        for p, g, state, _ in group:
            _build.require_cuda(p, g, *state.values())
    if scale is not None:
        _build.require_cuda(scale)
        _build.require(scale.dtype == torch.float32 and scale.numel() == 1,
                       "adam_update: the clip scale is one f32 value")
    fn = _build.function(_STEM, "pt_adam_update", _ARGTYPES)
    scalars = _scalars(hp)
    for key, group in groups.items():
        table, n, blocks = tables.get(key, group, device)
        code, master, m_code, ams, l2 = key
        err = fn(table.data_ptr(), n, blocks, code, int(master), m_code,
                 int(ams), int(l2), *scalars,
                 None if scale is None else scale.data_ptr(),
                 _build.stream(device))
        _build.launches["adam_update"] += 1
        _build.check(err, _STEM, "adam_update")
