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


class TrainStep:
    """One training step per call: zero the gradients,
    ``loss = loss_fn(model, *batch)``, backward, one optimizer update over
    the model's trainable parameters by their state-dict names. The rate is
    the optimizer's ``get_lr()``, read by ``apply_gradients`` on each call.
    Returns the loss as a detached 0-d tensor. As in the JAX package
    (``jit/__init__.py:279,301-302``), a
    learning-rate scheduler is read on every call and never stepped here:
    stepping it is the caller's choice."""

    def __init__(self, model, loss_fn, optimizer, donate=True):
        self._model = model
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        # the update is in place whatever ``donate`` says (kept for the
        # JAX signature)
        self._donate = donate

    def __call__(self, *batch):
        params = {name: p for name, p in self._model.named_parameters()
                  if p.requires_grad}
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss = self._loss_fn(self._model, *batch)
            loss.backward()
        self._optimizer.apply_gradients(params)
        return loss.detach()


def train_step(model, loss_fn, optimizer, donate=True) -> TrainStep:
    return TrainStep(model, loss_fn, optimizer, donate)
