"""Learning-rate schedules — the port's own copy of
``paddle_tpu/optimizer/lr.py`` (pure Python, the same 18 schedules with
Paddle's semantics).

``scheduler.get_lr()`` returns the current value and ``scheduler.step()``
advances it (per epoch or per step, the caller's choice); ``lr_at(step)``
is the value at a step as a pure function; ``state_dict`` /
``set_state_dict`` carry ``last_epoch`` and ``last_lr``. An optimizer
given a scheduler as its ``learning_rate`` reads ``get_lr()`` on every
update and never steps it.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.verbose = verbose
        self.step()

    def get_lr(self):
        return self.last_lr

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        self.last_lr = self.lr_at(self.last_epoch)
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def lr_at(self, step) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        self.last_lr = sd["last_lr"]

    set_dict = set_state_dict

    def __call__(self):
        return self.get_lr()


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = max(step, 1)
        return self.base_lr * (self.d_model**-0.5) * min(step**-0.5, step * self.warmup_steps**-1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries, self.values = boundaries, values
        super().__init__(values[0], last_epoch, verbose)

    def lr_at(self, step):
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * math.exp(-self.gamma * step)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr / (1 + self.gamma * step)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr, self.power, self.cycle = decay_steps, end_lr, power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.peak = learning_rate if not isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps, self.start_lr, self.end_lr = warmup_steps, start_lr, end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def lr_at(self, step):
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * step / self.warmup_steps
        if self.lr_sched is not None:
            return self.lr_sched.lr_at(step - self.warmup_steps)
        return self.peak


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma**step


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        n = sum(1 for m in self.milestones if step >= m)
        return self.base_lr * self.gamma**n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** (step // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.lr_lambda(step)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cum = 1.0
        self._cum_step = 0
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        cum = 1.0
        for s in range(1, step + 1):
            cum *= self.lr_lambda(s)
        return self.base_lr * cum


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0
        self.verbose = verbose

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics) if not hasattr(metrics, "item") else float(metrics.item())
        if self.best is None:
            self.best = current
            return
        better = (current < self.best - self._thresh()) if self.mode == "min" else (
            current > self.best + self._thresh())
        if better:
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def _thresh(self):
        return self.threshold if self.threshold_mode == "abs" else abs(self.best) * self.threshold

    def lr_at(self, step):
        return self.last_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * step / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        t, ti = step, self.T_0
        while t >= ti:
            t -= ti
            ti *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / ti)) / 2


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def lr_at(self, step):
        step = min(step, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._interp(self.initial_lr, self.max_lr, step / max(up_steps, 1))
        return self._interp(self.max_lr, self.end_lr, (step - up_steps) / max(self.total_steps - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        cycle_len = self.up + self.down
        cycle = step // cycle_len
        pos = step - cycle * cycle_len
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = (self.max_lr - self.base_lr_) * pct
        if self.scale_fn is not None:
            x = cycle + 1 if self.scale_mode == "cycle" else step
            return self.base_lr_ + amp * self.scale_fn(x)
        if self.mode == "triangular2":
            return self.base_lr_ + amp / (2**cycle)
        if self.mode == "exp_range":
            return self.base_lr_ + amp * self.exp_gamma**step
        return self.base_lr_ + amp


class CosineAnnealingWithWarmupDecay(LRScheduler):
    """The fleet Llama-recipe scheduler (reference incubate usage): linear
    warmup then cosine to min_lr over decay_steps."""

    def __init__(self, max_lr, min_lr, warmup_step, decay_step, last_epoch=-1, verbose=False):
        self.max_lr, self.min_lr = max_lr, min_lr
        self.warmup_step, self.decay_step = warmup_step, decay_step
        super().__init__(max_lr, last_epoch, verbose)

    def lr_at(self, step):
        if step < self.warmup_step:
            return self.max_lr * step / max(self.warmup_step, 1)
        if step >= self.decay_step:
            return self.min_lr
        frac = (step - self.warmup_step) / max(self.decay_step - self.warmup_step, 1)
        return self.min_lr + (self.max_lr - self.min_lr) * 0.5 * (1 + math.cos(math.pi * frac))


class LinearLR(LRScheduler):
    """optimizer.lr.LinearLR (python/paddle/optimizer/lr.py LinearLR):
    linearly interpolate the LR factor from start_factor to end_factor over
    total_steps."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        t = min(max(step, 0), self.total_steps)
        factor = (self.start_factor
                  + (self.end_factor - self.start_factor)
                  * t / self.total_steps)
        return self.base_lr * factor
