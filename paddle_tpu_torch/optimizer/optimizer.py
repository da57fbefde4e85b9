"""Optimizer base, Adam and AdamW — counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``, ``Adam``, ``AdamW``).

One update rule, two routes, as in the JAX package: ``apply_gradients``
takes ``{name: parameter}`` (the train step passes the model's state-dict
names, so ``apply_decay_param_fun`` sees them) and ``step()`` runs it over
the optimizer's own parameter list with positional names ``p0, p1, ...``.

Each step follows ``Optimizer.apply_gradients`` and ``Adam.update``:
low-precision parameters keep an f32 master copy (``multi_precision``);
AdamW decays the f32 value by ``(1 - lr * weight_decay)`` before the
update; the moments are stored in ``moment_dtype`` (f32 by default) and
updated in f32; the bias corrections use the f32 step count; the new value
is ``w - lr * m_hat / (sqrt(v_hat) + eps)``, written back cast to the
parameter's dtype. Where JAX returns new arrays, the port updates the
parameters, masters and moments in place.

``learning_rate`` is a number or an ``lr.LRScheduler``; every update reads
``get_lr()`` and none steps the scheduler (the caller does, as in the JAX
package). ``grad_clip`` (``clip.py``) clips the gradients before the
update (``optimizer.py:87-88``). ``state_dict`` / ``set_state_dict`` carry
the step count, the moments, the f32 masters and the scheduler's state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .lr import LRScheduler

_LOW_PRECISION = (torch.float16, torch.bfloat16)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state: Dict[str, dict] = {}
        self._step = 0

    # ---- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr.get_lr())
        return self._lr

    def set_lr(self, value) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler; "
                               "call scheduler.step()")
        self._lr = float(value)

    # ---- the update rule (subclasses) ------------------------------------
    def init_param_state(self, p) -> dict:
        return {}

    def update(self, w32, g32, state, lr, step) -> None:
        """Update the f32 value ``w32`` in place from the f32 gradient."""
        raise NotImplementedError

    def _decoupled_wd(self) -> bool:
        return False

    def _should_decay(self, name: str) -> bool:
        return True

    # ---- the two routes ----------------------------------------------------
    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor]) -> None:
        """One step over ``{name: parameter}`` from each parameter's
        ``.grad`` (clipped first with ``grad_clip``) at ``get_lr()``; a
        parameter without a gradient is left as it is."""
        self._step += 1
        lr, wd = self.get_lr(), self._weight_decay
        grads = {name: p.grad for name, p in params.items()
                 if p.grad is not None}
        if self._grad_clip is not None:
            grads = self._grad_clip.functional_clip(grads)
        for name, g in grads.items():
            p = params[name]
            state = self._state.get(name)
            if state is None:
                state = self.init_param_state(p)
                if self._multi_precision and p.dtype in _LOW_PRECISION:
                    state["master"] = p.detach().float()
                self._state[name] = state
            elif any(t.device != p.device for t in state.values()):
                # state loaded by set_state_dict onto another device
                state = self._state[name] = {k: t.to(p.device)
                                             for k, t in state.items()}
            master = state.get("master")
            w32 = master if master is not None else p.data
            if w32.dtype != torch.float32:     # low precision, no master
                w32 = w32.float()
            g32 = g.float()
            if wd and self._should_decay(name):
                if self._decoupled_wd():
                    w32.mul_(1.0 - lr * wd)
                else:
                    g32 = g32 + w32 * wd
            self.update(w32, g32, state, lr, self._step)
            if w32 is not p.data:
                p.data.copy_(w32)

    def step(self) -> None:
        """``apply_gradients`` over the optimizer's parameter list."""
        if self._parameter_list is None:
            raise RuntimeError("this optimizer was created without a "
                               "parameter list")
        self.apply_gradients({f"p{i}": p for i, p in
                              enumerate(self._parameter_list)
                              if p.requires_grad})

    # ---- state dict ----------------------------------------------------------
    def state_dict(self) -> dict:
        """{"step", "state": {name: {moment1, moment2[, master]}}[,
        "LR_Scheduler"]}: the live tensors, as ``torch.optim`` returns
        them (``framework_io.save`` copies them to the host)."""
        sd = {"step": self._step,
              "state": {name: dict(st) for name, st in self._state.items()}}
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict``'s contents; tensors on another device
        move to their parameter's at the next update."""
        self._step = int(sd.get("step", 0))
        self._state = {name: dict(st)
                       for name, st in sd.get("state", {}).items()}
        if "LR_Scheduler" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["LR_Scheduler"])


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        # "bfloat16" stores m and v at 2 bytes per parameter; the update
        # still computes in f32
        self._moment_dtype = (torch.float32 if moment_dtype is None
                              else _DTYPES[str(moment_dtype)])

    def init_param_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        m_store, v_store = state["moment1"], state["moment2"]
        # m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g * g (f32, in
        # the JAX rounding order)
        m = m_store.float().mul_(b1).add_(g32 * (1 - b1))
        v = v_store.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        stepf = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** stepf)
        bc2 = float(np.float32(1) - np.float32(b2) ** stepf)
        denom = (v / bc2).sqrt_().add_(self._eps)
        w32.sub_((m / bc1).mul_(lr).div_(denom))
        if m is not m_store:
            m_store.copy_(m)
            v_store.copy_(v)


class AdamW(Adam):
    """Adam with decoupled weight decay; ``apply_decay_param_fun(name)``
    picks the parameters that decay (all by default)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable] = None,
                 grad_clip=None, multi_precision=True, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _should_decay(self, name):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(name))
        return True
