"""The optimizers — counterpart of ``paddle_tpu/optimizer/optimizer.py``:
``Optimizer`` and fourteen update rules (``SGD``, ``Momentum``, ``Adam``,
``AdamW``, ``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``,
``Lion``, ``Ftrl``, ``ASGD``, ``RAdam``, ``NAdam``, ``Rprop``). ``LBFGS``
is not ported.

One update rule, two routes, as in the JAX package: ``apply_gradients``
takes ``{name: parameter}`` (the train step passes the model's state-dict
names, so ``apply_decay_param_fun`` sees them) and ``step()`` runs it over
the optimizer's own parameter list with positional names ``p0, p1, ...``;
``minimize(loss)`` is backward, ``step()``, ``clear_grad()``.

Each step follows ``Optimizer.apply_gradients``: low-precision parameters
keep an f32 master copy (``multi_precision``); the rule computes in f32
from the f32 gradient (clipped first by ``grad_clip``); decay is added to
the gradient as L2 (``w * wd``), or scales the f32 value by ``1 - lr * wd``
first for the decoupled rules (AdamW, Lion); the result is written back
cast to the parameter's dtype. Where JAX returns new arrays, the port
updates the parameters, masters and state in place.

Adam and AdamW run their whole update as one multi-tensor pass
(``ops/hopper/adam_update.py``): the plain per-parameter version on CPU
tensors, the hand-written kernel on CUDA ones (one launch per group of
tensors of one kind), with a global-norm clip's scale read on the card.
The other rules are elementwise PyTorch, eager on either device, as they
are XLA elementwise code in the JAX package (no Pallas kernel).

``learning_rate`` is a number or an ``lr.LRScheduler``; every update reads
``get_lr()`` and none steps the scheduler (the caller does, as in the JAX
package). ``state_dict`` / ``set_state_dict`` carry the step count, each
parameter's state (the rule's tensors and the f32 master) and the
scheduler's state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.hopper.adam_update import AdamHyper, Tables, adam_update
from .clip import ClipGradByGlobalNorm
from .lr import LRScheduler

_LOW_PRECISION = (torch.float16, torch.bfloat16)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _f32(x) -> np.float32:
    return np.float32(x)


def _power(base, step) -> float:
    """``base ** step`` in f32 (the JAX rules raise a Python number to the
    f32 step count)."""
    return float(np.float32(base) ** np.float32(step))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._name = name
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

    def update(self, w32, g32, state, lr, step):
        """The rule on the f32 value ``w32`` and f32 gradient ``g32``:
        returns the new f32 value and updates ``state``."""
        raise NotImplementedError

    def _decoupled_wd(self) -> bool:
        return False

    def _should_decay(self, name: str) -> bool:
        return True

    # ---- the two routes ----------------------------------------------------
    def _param_state(self, name, p) -> dict:
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
        return state

    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor]) -> None:
        """One step over ``{name: parameter}`` from each parameter's
        ``.grad`` (clipped first with ``grad_clip``) at ``get_lr()``; a
        parameter without a gradient is left as it is."""
        self._step += 1
        entries = [(name, p, p.grad, self._param_state(name, p))
                   for name, p in params.items() if p.grad is not None]
        self._apply(entries, self.get_lr())

    def _apply(self, entries, lr) -> None:
        """The eager per-parameter route of ``update`` (``entries``:
        [(name, parameter, gradient, state)])."""
        grads = {name: g for name, _, g, _ in entries}
        if self._grad_clip is not None:
            grads = self._grad_clip.functional_clip(grads)
        wd = self._weight_decay
        for name, p, _, state in entries:
            w = p.detach()
            master = state.get("master")
            w32 = (master if master is not None else w).float()
            g32 = grads[name].float()
            if wd and self._should_decay(name):
                if self._decoupled_wd():
                    w32 = w32 * (1.0 - lr * wd)
                else:
                    g32 = g32 + w32 * wd
            self._cur_param_name = name
            new = self.update(w32, g32, state, lr, self._step)
            if master is not None:
                master.copy_(new)
            w.copy_(new)

    def step(self) -> None:
        """``apply_gradients`` over the optimizer's parameter list."""
        if self._parameter_list is None:
            raise RuntimeError("this optimizer was created without a "
                               "parameter list")
        self.apply_gradients({f"p{i}": p for i, p in
                              enumerate(self._parameter_list)
                              if p.requires_grad})

    def clear_grad(self, set_to_zero=True) -> None:
        """Drop the gradients of the parameter list (``set_to_zero`` is
        accepted and, as in the JAX package, not read)."""
        if self._parameter_list is not None:
            for p in self._parameter_list:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None) -> None:
        """``loss.backward()``, ``step()``, ``clear_grad()``."""
        loss.backward()
        self.step()
        self.clear_grad()

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


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def update(self, w32, g32, state, lr, step):
        return w32 - lr * g32


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_param_state(self, p):
        return {"velocity": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        v = self._momentum * state["velocity"] + g32
        state["velocity"] = v
        if self._nesterov:
            return w32 - lr * (g32 + self._momentum * v)
        return w32 - lr * v


class Adam(Optimizer):
    """Adam; ``amsgrad`` keeps ``moment2_max`` and divides by its bias-
    corrected value. ``lazy_mode`` and ``name`` are kept and not read, as
    in the JAX package. ``moment_dtype="bfloat16"`` stores the moments at
    2 bytes a parameter; the update still computes in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 amsgrad=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._amsgrad = amsgrad
        self._moment_dtype = (torch.float32 if moment_dtype is None
                              else _DTYPES[str(moment_dtype)])
        # the fused update's tables on the card, kept while their
        # addresses hold
        self._tables = Tables()

    def init_param_state(self, p):
        state = {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                        device=p.device),
                 "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                        device=p.device)}
        if self._amsgrad:
            state["moment2_max"] = torch.zeros(
                p.shape, dtype=self._moment_dtype, device=p.device)
        return state

    def _apply(self, entries, lr):
        """One ``adam_update`` over every parameter with a gradient; a
        global-norm clip passes its scale (on the gradients' device), any
        other clip its clipped gradients."""
        grads = {name: g for name, _, g, _ in entries}
        scale = None
        if isinstance(self._grad_clip, ClipGradByGlobalNorm):
            if grads:
                scale = self._grad_clip.norm_and_scale(grads)[1]
        elif self._grad_clip is not None:
            grads = self._grad_clip.functional_clip(grads)
        wd = self._weight_decay
        items = [(p, grads[name], state, bool(wd) and self._should_decay(name))
                 for name, p, _, state in entries]
        hp = AdamHyper(lr=lr, beta1=self._beta1, beta2=self._beta2,
                       eps=self._eps, weight_decay=wd,
                       decoupled=self._decoupled_wd(), amsgrad=self._amsgrad,
                       step=self._step)
        adam_update(items, hp, scale, self._tables)


class AdamW(Adam):
    """Adam with decoupled weight decay; ``apply_decay_param_fun(name)``
    picks the parameters that decay (all by default). ``lr_ratio`` is kept
    and not read, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None,
                 apply_decay_param_fun: Optional[Callable] = None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 amsgrad=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad, moment_dtype, name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self):
        return True

    def _should_decay(self, name):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(name))
        return True


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_param_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        b1 = self._beta1
        m = b1 * state["moment"] + (1 - b1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], g32.abs())
        state["moment"], state["inf_norm"] = m, u
        rate = float(_f32(lr) / (_f32(1) - _f32(_power(b1, step))))
        return w32 - rate * m / (u + self._eps)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_param_state(self, p):
        return {"moment": torch.full(p.shape, float(self._init_acc),
                                     dtype=torch.float32, device=p.device)}

    def update(self, w32, g32, state, lr, step):
        acc = state["moment"] + g32 * g32
        state["moment"] = acc
        return w32 - lr * g32 / (acc.sqrt() + self._eps)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._eps, self._rho = epsilon, rho

    def init_param_state(self, p):
        return {"avg_squared_grad": _zeros(p), "avg_squared_update": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        rho, eps = self._rho, self._eps
        asu = state["avg_squared_update"]
        g2 = rho * state["avg_squared_grad"] + (1 - rho) * g32 * g32
        delta = (asu + eps).sqrt() / (g2 + eps).sqrt() * g32
        state["avg_squared_grad"] = g2
        state["avg_squared_update"] = rho * asu + (1 - rho) * delta * delta
        return w32 - lr * delta


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_param_state(self, p):
        state = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            state["mean_grad"] = _zeros(p)
        return state

    def update(self, w32, g32, state, lr, step):
        rho, eps = self._rho, self._eps
        ms = rho * state["mean_square"] + (1 - rho) * g32 * g32
        state["mean_square"] = ms
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            state["mean_grad"] = mg
            denom = (ms - mg * mg + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        mom = self._momentum * state["momentum"] + lr * g32 / denom
        state["momentum"] = mom
        return w32 - mom


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, 0.0, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _should_decay(self, name):
        if self._exclude_fn is not None:
            return not bool(self._exclude_fn(name))
        return True

    def init_param_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32 * g32
        state["moment1"], state["moment2"] = m, v
        m_hat = m / float(_f32(1) - _f32(_power(b1, step)))
        v_hat = v / float(_f32(1) - _f32(_power(b2, step)))
        wd = (self._lamb_wd
              if self._should_decay(getattr(self, "_cur_param_name", ""))
              else 0.0)
        r = m_hat / (v_hat.sqrt() + self._eps) + wd * w32
        w_norm = torch.linalg.vector_norm(w32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), device=w32.device))
        return w32 - lr * trust * r


class Lion(Optimizer):
    def __init__(self, learning_rate=1e-4, beta1=0.9, beta2=0.99,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2 = beta1, beta2

    def _decoupled_wd(self):
        return True

    def init_param_state(self, p):
        return {"moment": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        direction = torch.sign(b1 * state["moment"] + (1 - b1) * g32)
        state["moment"] = b2 * state["moment"] + (1 - b2) * g32
        return w32 - lr * direction


class Ftrl(Optimizer):
    """FTRL-proximal, the JAX rule (``optimizer.py:416-452``): n (squared
    gradients) and z (the linearised loss); ``n ** -lr_power`` (the square
    root at the default -0.5)."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def init_param_state(self, p):
        return {"squared": _zeros(p), "linear": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        n, z = state["squared"], state["linear"]
        n_new = n + g32 * g32
        pow_old = n ** -self._lr_power
        pow_new = n_new ** -self._lr_power
        sigma = (pow_new - pow_old) / lr
        z_new = z + g32 - sigma * w32
        denom = 2.0 * self._l2 + pow_new / lr
        state["squared"], state["linear"] = n_new, z_new
        shrunk = -(z_new - torch.sign(z_new) * self._l1) / denom
        return torch.where(z_new.abs() > self._l1, shrunk,
                           torch.zeros((), device=w32.device))


class ASGD(Optimizer):
    """SGD over the running sum of the last ``batch_num`` gradients
    (``d <- d - y_oldest + g``, ``w <- w - lr * d / n``)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if batch_num <= 0:
            raise ValueError("batch_num must be positive")
        self._batch_num = batch_num

    def init_param_state(self, p):
        return {"d": _zeros(p),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device)}

    def update(self, w32, g32, state, lr, step):
        idx = (step - 1) % self._batch_num
        d = state["d"] - state["ys"][idx] + g32
        state["d"] = d
        state["ys"][idx] = g32
        n = float(min(step, self._batch_num))
        return w32 - lr * d / n


class RAdam(Optimizer):
    """Rectified Adam: the rectified step where ``rho_t > 4``, else the
    bias-corrected momentum alone."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_param_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        t = _f32(step)
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32 * g32
        state["moment1"], state["moment2"] = m, v
        b2t = _f32(_power(b2, step))
        m_hat = m / float(_f32(1) - _f32(_power(b1, step)))
        # the scalars in f32 as the JAX rule takes them (Python numbers
        # against the f32 step count)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = _f32(rho_inf) - _f32(2.0) * t * b2t / (_f32(1) - b2t)
        if not rho_t > 4.0:
            return w32 - lr * m_hat
        ratio = ((rho_t - _f32(4)) * (rho_t - _f32(2)) * _f32(rho_inf)
                 / max(_f32((rho_inf - 4) * (rho_inf - 2)) * rho_t,
                       _f32(1e-12)))
        r = np.sqrt(max(ratio, _f32(0)))
        v_hat = (v / float(_f32(1) - b2t)).sqrt() + self._eps
        return w32 - float(_f32(lr) * r) * m_hat / v_hat


class NAdam(Optimizer):
    """Nesterov Adam with momentum decay ``psi`` (``mu_product`` a 0-d
    state)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def init_param_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=p.device)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        t = _f32(step)
        mu_t = float(_f32(b1) * (_f32(1) - _f32(0.5) * _f32(
            _power(0.96, t * _f32(self._psi)))))
        mu_next = float(_f32(b1) * (_f32(1) - _f32(0.5) * _f32(
            _power(0.96, (t + _f32(1)) * _f32(self._psi)))))
        mu_prod = state["mu_product"] * mu_t
        m = b1 * state["moment1"] + (1 - b1) * g32
        v = b2 * state["moment2"] + (1 - b2) * g32 * g32
        state.update(moment1=m, moment2=v, mu_product=mu_prod)
        m_hat = (mu_next * m / (1 - mu_prod * mu_next)
                 + (1 - mu_t) * g32 / (1 - mu_prod))
        v_hat = v / float(_f32(1) - _f32(_power(b2, step)))
        return w32 - lr * m_hat / (v_hat.sqrt() + self._eps)


class Rprop(Optimizer):
    """Resilient backprop: per-weight step sizes ``lr_t`` grown by
    ``etas[1]`` while the gradient keeps its sign and shrunk by ``etas[0]``
    when it flips (then the step is skipped and the stored gradient
    zeroed), within ``learning_rate_range``."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def init_param_state(self, p):
        return {"prev_grad": _zeros(p),
                "lr_t": torch.full(p.shape, float(self.get_lr()),
                                   dtype=torch.float32, device=p.device)}

    def update(self, w32, g32, state, lr, step):
        sign = torch.sign(g32 * state["prev_grad"])
        one = torch.ones((), device=w32.device)
        factor = torch.where(sign > 0, self._eta_pos * one,
                             torch.where(sign < 0, self._eta_neg * one, one))
        lr_t = torch.clamp(state["lr_t"] * factor, self._lr_min, self._lr_max)
        eff_grad = torch.where(sign < 0, torch.zeros((), device=w32.device),
                               g32)
        state["prev_grad"], state["lr_t"] = eff_grad, lr_t
        return w32 - lr_t * torch.sign(eff_grad)
