"""The port's update rules beyond Adam / AdamW (``SGD``, ``Momentum``,
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``, ``Lion``,
``Ftrl``, ``ASGD``, ``RAdam``, ``NAdam``, ``Rprop``) against the JAX
``apply_gradients`` on the CPU, from the same numpy parameters and
gradients: f32 parameters, and bf16 parameters with f32 masters. Then the
eager API's ``clear_grad`` / ``clear_gradients`` / ``minimize``.

Tolerance: f32 values (parameters, masters, every state tensor) within
1e-6 relative of JAX's, plus 1e-7 of the tensor's largest magnitude;
bf16 parameters, each a rounding of those f32 values, within one bf16
ulp. The absolute term is for entries that come out of a cancellation:
XLA's f32 square root on the CPU is within one ulp but not correctly
rounded (it differs from PyTorch's in the last bit for about 13% of random
inputs), and where a rule subtracts nearly equal terms (centered RMSProp's
``ms - mg^2``, Ftrl's ``z + g - sigma * w``, Lamb's ``w - lr * trust *
r``) that ulp is large against the small result, not against the
tensor's scale. The rules' scalar factors (bias corrections, NAdam's
momentum schedule, RAdam's rectification) are f32 on both sides, the
powers taken by numpy and XLA, which may differ in the last bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_opt
from paddle_tpu_torch import optimizer as port_opt

# name -> (class, learning rate, keywords shared by both packages, steps)
RULES = {
    "SGD": ("SGD", 0.1, dict(weight_decay=0.01), 2),
    "Momentum": ("Momentum", 0.1, dict(momentum=0.9, weight_decay=0.01), 2),
    "Momentum_nesterov": ("Momentum", 0.1,
                          dict(momentum=0.9, use_nesterov=True), 2),
    "Adamax": ("Adamax", 0.01, dict(beta2=0.99, weight_decay=0.01), 2),
    "Adagrad": ("Adagrad", 0.1, dict(initial_accumulator_value=0.1,
                                     weight_decay=0.01), 2),
    "Adadelta": ("Adadelta", 1.0, dict(rho=0.9, epsilon=1e-6), 2),
    "RMSProp": ("RMSProp", 0.01, dict(rho=0.9), 2),
    "RMSProp_centered": ("RMSProp", 0.01, dict(rho=0.9, momentum=0.5,
                                               centered=True), 2),
    "Lamb": ("Lamb", 0.01, dict(lamb_weight_decay=0.05,
                                exclude_from_weight_decay_fn=lambda n:
                                n == "b"), 2),
    "Lion": ("Lion", 1e-3, dict(weight_decay=0.1), 2),
    "Ftrl": ("Ftrl", 0.1, dict(l1=0.01, l2=0.01), 2),
    "ASGD": ("ASGD", 0.1, dict(batch_num=2, weight_decay=0.01), 3),
    # beta2 0.99: steps 1-4 take the unrectified step, 5-6 the rectified
    "RAdam": ("RAdam", 0.01, dict(beta2=0.99), 6),
    "NAdam": ("NAdam", 0.01, dict(weight_decay=0.01), 2),
    "Rprop": ("Rprop", 0.01, dict(learning_rate_range=(1e-4, 0.5),
                                  etas=(0.5, 1.2)), 3),
}
SHAPES = {"w": (32, 16), "b": (16,)}


def _case(dtype, steps, seed=11):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (0.1 * rng.randn(*s)).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-7 * float(np.abs(want).max()),
                               err_msg=what)


def _bf16_bits(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def _torch_bf16_bits(t):
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


def test_every_rule_is_covered():
    """The 13 rules beyond Adam / AdamW, and LBFGS the only JAX optimizer
    the port leaves out."""
    classes = {spec[0] for spec in RULES.values()}
    assert len(classes) == 13
    jax_names = {n for n, c in vars(jax_opt).items() if isinstance(c, type)
                 and issubclass(c, jax_opt.Optimizer)}
    port_names = {n for n, c in vars(port_opt).items()
                  if isinstance(c, type)
                  and issubclass(c, port_opt.Optimizer)}
    assert port_names == classes | {"Adam", "AdamW", "Optimizer"}
    assert jax_names - port_names == {"LBFGS"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax_apply_gradients(rule, dtype):
    cls, lr, kw, steps = RULES[rule]
    params0, grads = _case(dtype, steps)
    opt_j = getattr(jax_opt, cls)(lr, **kw)
    opt_p = getattr(port_opt, cls)(lr, **kw)
    jparams = {n: jnp.asarray(a, dtype) for n, a in params0.items()}
    state = opt_j.init_state(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).to(
        getattr(torch, dtype))) for n, a in params0.items()}
    for g in grads:
        jparams, state = opt_j.apply_gradients(
            state, jparams, {n: jnp.asarray(a, dtype) for n, a in g.items()})
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        opt_p.apply_gradients(tparams)
    assert opt_p._step == steps
    for n, p in tparams.items():
        js, ps = state["param_states"][n], opt_p._state[n]
        assert set(ps) == set(js), n
        for key, want in js.items():
            _close(ps[key].numpy(), _np(want), f"{rule} {n} {key}")
        if dtype == "float32":
            _close(p.detach().numpy(), _np(jparams[n]), f"{rule} {n}")
        else:
            assert "master" in ps
            diff = np.abs(_torch_bf16_bits(p).astype(np.int64)
                          - _bf16_bits(jparams[n]).astype(np.int64))
            assert diff.max() <= 1, f"{rule} {n}"


def test_multi_precision_off_updates_bf16_directly():
    """``multi_precision=False`` keeps no master: the bf16 value is read as
    f32, updated, and rounded back, as in JAX (within one bf16 ulp)."""
    params0, grads = _case("bfloat16", 2)
    opt_j = jax_opt.Momentum(0.1, momentum=0.9, multi_precision=False)
    opt_p = port_opt.Momentum(0.1, momentum=0.9, multi_precision=False)
    jparams = {n: jnp.asarray(a, jnp.bfloat16) for n, a in params0.items()}
    state = opt_j.init_state(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).bfloat16())
               for n, a in params0.items()}
    for g in grads:
        jparams, state = opt_j.apply_gradients(
            state, jparams, {n: jnp.asarray(a, jnp.bfloat16)
                             for n, a in g.items()})
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n]).bfloat16()
        opt_p.apply_gradients(tparams)
    for n, p in tparams.items():
        assert "master" not in opt_p._state[n]
        diff = np.abs(_torch_bf16_bits(p).astype(np.int64)
                      - _bf16_bits(jparams[n]).astype(np.int64))
        assert diff.max() <= 1, n


def test_state_dict_round_trip_of_a_rule():
    """A rule's state (NAdam's 0-d ``mu_product`` included) survives
    ``state_dict`` / ``set_state_dict``: the next step equals the
    uninterrupted one bit for bit."""
    params0, grads = _case("float32", 3)
    a = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for n, v in params0.items()}
    b = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for n, v in params0.items()}
    opt_a, opt_b = port_opt.NAdam(0.01), port_opt.NAdam(0.01)
    for i, g in enumerate(grads):
        for params in (a, b):
            for n, p in params.items():
                p.grad = torch.from_numpy(g[n])
        opt_a.apply_gradients(a)
        if i == 1:
            fresh = port_opt.NAdam(0.01)
            fresh.set_state_dict(opt_b.state_dict())
            opt_b = fresh
        opt_b.apply_gradients(b)
    for n in params0:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("alias", ["clear_grad", "clear_gradients"])
def test_clear_grad_drops_the_gradients(alias):
    """As the JAX package: every parameter of the list loses its gradient
    (``set_to_zero`` is accepted and not read)."""
    ps = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    for p in ps:
        p.grad = torch.ones(3)
    opt = port_opt.SGD(0.1, parameters=ps)
    getattr(opt, alias)(set_to_zero=True)
    assert all(p.grad is None for p in ps)
    port_opt.SGD(0.1).clear_grad()        # no parameter list: nothing


def test_minimize_is_backward_step_clear():
    """``minimize(loss)``: the gradient of ``sum(w^2)`` is 2w, SGD at 0.1
    leaves 0.8 w (f32, exact here), and no gradient is left."""
    w0 = np.array([1.0, -2.0, 0.5], np.float32)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = port_opt.SGD(0.1, parameters=[w])
    assert opt.minimize((w * w).sum()) is None
    np.testing.assert_array_equal(w.detach().numpy(),
                                  w0 - np.float32(0.1) * (2 * w0))
    assert w.grad is None and opt._step == 1
