"""The training step — counterpart of ``paddle_tpu/jit`` ``TrainStep`` /
``train_step``.

The JAX package compiles forward, backward and the optimizer update into
one donated XLA computation. The port runs the same three eagerly, the
update as one multi-tensor kernel (Adam / AdamW) over parameters,
masters and moments updated in place, which is the port's donation (a
CUDA graph of the training step is later work). The serving and
``generate`` step units are CUDA graphs: ``jit/cuda_graph.py``."""
from __future__ import annotations

import torch


class _Kept:
    """What one step's update may change, kept to put back: the values of
    the parameters it updates and of the optimizer's state tensors, the
    optimizer's per-parameter state dicts and its step count."""

    def __init__(self, params, optimizer):
        self.step = optimizer._step
        self.state = {name: (st, dict(st))
                      for name, st in optimizer._state.items()}
        tensors = [p for p in params.values() if p.grad is not None]
        tensors += [t for name, (st, _) in self.state.items()
                    if name in params for t in st.values()]
        self.values = [(t, t.detach().clone()) for t in tensors]

    @torch.no_grad()
    def restore(self, optimizer):
        for t, v in self.values:
            t.copy_(v)
        optimizer._state = {}
        for name, (st, entries) in self.state.items():
            st.clear()
            st.update(entries)
            optimizer._state[name] = st
        optimizer._step = self.step


@torch.no_grad()
def _all_finite(loss, tensors) -> bool:
    """Whether the loss and every element of ``tensors`` are finite: each
    tensor's largest magnitude (a multi-tensor reduction that carries a NaN
    or an Inf through) and the loss checked on the device, then one host
    sync."""
    peaks = [t.float() for t in (torch._foreach_norm(tensors, float("inf"))
                                 if tensors else [])]
    return bool(torch.isfinite(torch.stack(peaks + [loss.float()])).all())


class TrainStep:
    """One training step per call: zero the gradients,
    ``loss = loss_fn(model, *batch)``, backward, one optimizer update over
    the model's trainable parameters by their state-dict names. The rate is
    the optimizer's ``get_lr()``, read by ``apply_gradients`` on each call.
    Returns the loss as a detached 0-d tensor. As in the JAX package
    (``jit/__init__.py:279,301-302``), a
    learning-rate scheduler is read on every call and never stepped here:
    stepping it is the caller's choice.

    ``FLAGS_check_nan_inf``, read once here at construction as JAX reads
    it (``jit/__init__.py:246-261``): a step whose loss, any gradient, or
    any parameter or optimizer state the update wrote holds a NaN or an
    Inf raises ``FloatingPointError`` and commits nothing. The update runs
    in place, so the step keeps a copy of what it updates (the parameters
    with a gradient and their optimizer state, as JAX's checked step keeps
    its undonated inputs) and puts it back, bit for bit, before it raises;
    the next step runs from the state before the failed one. The check
    costs one host sync a step and that copy's memory. It differs from
    JAX's ``checkify`` float checks in what it sees: those flag a NaN (or
    a division by zero) that any operation of the compiled step produces,
    an intermediate that never reaches the loss included, and let an Inf
    that never becomes a NaN pass; the port checks what reaches the loss,
    the gradients and the update, NaN and Inf alike. With the flag off the
    step is as it was: no copy, no check, no sync."""

    def __init__(self, model, loss_fn, optimizer, donate=True):
        from ..utils.flags import flag

        self._model = model
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        # the update is in place whatever ``donate`` says (kept for the
        # JAX signature)
        self._donate = donate
        self._checked = bool(flag("FLAGS_check_nan_inf"))

    def __call__(self, *batch):
        params = {name: p for name, p in self._model.named_parameters()
                  if p.requires_grad}
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss = self._loss_fn(self._model, *batch)
            loss.backward()
        loss = loss.detach()
        if not self._checked:
            self._optimizer.apply_gradients(params)
            return loss
        kept = _Kept(params, self._optimizer)
        self._optimizer.apply_gradients(params)
        updated = [p for p in params.values() if p.grad is not None]
        written = [t for name, p in params.items() if p.grad is not None
                   for t in self._optimizer._state.get(name, {}).values()]
        if not _all_finite(loss, [p.grad for p in updated] + updated
                           + written):
            kept.restore(self._optimizer)
            raise FloatingPointError(
                "NaN/Inf in the train step (FLAGS_check_nan_inf): the loss, "
                "a gradient, or a parameter or optimizer state the update "
                "wrote is not finite; nothing was committed")
        return loss


def train_step(model, loss_fn, optimizer, donate=True) -> TrainStep:
    return TrainStep(model, loss_fn, optimizer, donate)
