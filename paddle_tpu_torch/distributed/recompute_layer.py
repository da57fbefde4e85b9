"""Recompute (activation checkpointing) — counterpart of
``paddle_tpu/distributed/recompute_layer.py``: ``recompute``,
``RecomputeLayer`` and ``apply_recompute``.

Built on ``torch.utils.checkpoint`` in its non-reentrant form, whatever
``use_reentrant`` the caller passes: the JAX package's ``jax.checkpoint``
is the non-reentrant kind (gradients reach parameters the function closes
over; a value a module stores during the forward, such as the MoE layers'
aux loss, is the first forward's), and the backward replays the forward
once. Policies, as JAX's ``jax.checkpoint_policies``:

- ``None`` / ``"full"`` / ``"nothing_saveable"``: save nothing, recompute
  everything;
- ``"dots_saveable"``: keep every matrix product's output
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``) and recompute
  the rest;
- ``"dots_with_no_batch_dims_saveable"``: keep the products without a
  batch dimension (``mm``, ``addmm``, ``mv``, ``dot``).

The hand-written kernels are ``torch.autograd.Function``s outside
PyTorch's dispatcher: under every policy they run again in the backward.

``RecomputeLayer`` registers the layer it wraps as ``inner``, so parameter
names carry ``.inner.`` as the JAX package's do
(``llama.layers.0.inner.self_attn.q_proj.weight``). Off the grad path
(serving, ``generate``, ``torch.inference_mode()``) it calls the inner
layer directly.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

POLICIES = ("full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable")
_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
_NO_BATCH_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.mv.default,
                  _aten.dot.default}


def saved_ops(policy):
    """The ops whose outputs ``policy`` keeps (empty: recompute all)."""
    if policy is None or policy in ("full", "nothing_saveable"):
        return frozenset()
    if policy == "dots_saveable":
        return frozenset(_DOTS)
    if policy == "dots_with_no_batch_dims_saveable":
        return frozenset(_NO_BATCH_DOTS)
    raise ValueError(f"unknown recompute policy {policy!r} (one of "
                     f"{', '.join(POLICIES)})")


def _context_fn(policy):
    """``checkpoint``'s ``context_fn`` for ``policy``, or None (the
    default: nothing saved)."""
    keep = saved_ops(policy)
    if not keep:
        return None

    def decide(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in keep
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             decide)


def recompute(function, *args, use_reentrant=True, policy=None, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (``paddle.distributed.fleet.utils.recompute``).
    ``use_reentrant`` is accepted and not read: the checkpoint is always
    the non-reentrant one (see the module docstring)."""
    context_fn = _context_fn(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return _ckpt.checkpoint(function, *args, use_reentrant=False, **extra,
                            **kwargs)


class RecomputeLayer(nn.Module):
    """Wrap a sublayer so its forward is recomputed in the backward."""

    def __init__(self, inner: nn.Module, policy=None):
        super().__init__()
        saved_ops(policy)               # refuse an unknown policy now
        self.inner = inner
        self._policy = policy

    def forward(self, *args, **kwargs):
        if not torch.is_grad_enabled():
            return self.inner(*args, **kwargs)
        return recompute(self.inner, *args, policy=self._policy, **kwargs)


def apply_recompute(model: nn.Module, configs):
    """Wrap the children of ``model`` named in ``configs.checkpoints``, or
    every direct child with parameters when it names none, in
    ``RecomputeLayer(child, policy=configs.policy)``
    (``strategy.recompute_configs``)."""
    targets = set(getattr(configs, "checkpoints", None) or [])
    policy = getattr(configs, "policy", None)
    for name, sub in list(model.named_children()):
        if (not targets or name in targets) and any(
                True for _ in sub.parameters()):
            setattr(model, name, RecomputeLayer(sub, policy=policy))
    return model
