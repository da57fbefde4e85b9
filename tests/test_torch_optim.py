"""Port parity of the optimizer pieces of the training slice against the
JAX package, on the CPU: every learning-rate schedule of ``lr.py`` (its
``get_lr`` sequence over 20 steps and its ``state_dict`` round trip), the
three gradient-clipping classes, the optimizer's scheduler and
``state_dict``, and ``save`` / ``load`` (a bf16 model and optimizer state
bit for bit, and a file the JAX package wrote). Each test states its
tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu_torch import framework_io
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models import DeepseekV2Config, DeepseekV2ForCausalLM

# name -> (positional, keyword) arguments shared by both packages; a
# schedule argument is built in each package by name
SCHEDULES = {
    "NoamDecay": ((64, 5), dict(learning_rate=2.0)),
    "PiecewiseDecay": (([3, 7, 12], [0.1, 0.05, 0.02, 0.01]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.2), {}),
    "PolynomialDecay": ((0.5, 8), dict(end_lr=0.01, power=2.0)),
    "PolynomialDecay_cycle": ((0.5, 6), dict(end_lr=0.01, cycle=True)),
    "LinearWarmup": ((0.3, 4, 0.0, 0.3), {}),
    "LinearWarmup_sched": (("CosineAnnealingDecay", 4, 0.01, 0.5), {}),
    "ExponentialDecay": ((0.5, 0.9), {}),
    "MultiStepDecay": ((0.5, [2, 5, 9]), dict(gamma=0.5)),
    "StepDecay": ((0.5, 3), dict(gamma=0.7)),
    "LambdaDecay": ((0.5, lambda e: 0.95 ** e), {}),
    "MultiplicativeDecay": ((0.5, lambda e: 0.9), {}),
    "ReduceOnPlateau": ((0.5,), dict(factor=0.5, patience=1, cooldown=1)),
    "CosineAnnealingDecay": ((0.5, 10), dict(eta_min=0.01)),
    "CosineAnnealingWarmRestarts": ((0.5, 3), dict(T_mult=2, eta_min=0.01)),
    "OneCycleLR": ((0.5, 15), dict(three_phase=False)),
    "CyclicLR": ((0.01, 0.5, 3), dict(step_size_down=4,
                                      mode="triangular2")),
    "CosineAnnealingWithWarmupDecay": ((0.5, 0.05, 3, 15), {}),
    "LinearLR": ((0.5, 8), dict(start_factor=0.25)),
}
# ReduceOnPlateau reads a metric per step: it falls, then stalls
METRICS = [5.0, 4.0, 3.5, 3.5, 3.6, 3.6, 3.7, 3.0, 3.0, 3.1, 3.2, 3.3, 2.0,
           2.0, 2.1, 2.2, 2.3, 2.4, 2.5, 2.6]


def _schedule(lr_mod, key):
    cls = getattr(lr_mod, key.split("_")[0])
    args, kwargs = SCHEDULES[key]
    if key == "LinearWarmup_sched":
        args = (lr_mod.CosineAnnealingDecay(0.5, 6),) + args[1:]
    return cls(*args, **kwargs)


def _advance(sched, key, step):
    if key == "ReduceOnPlateau":
        sched.step(METRICS[step])
    else:
        sched.step()


def test_every_schedule_is_covered():
    """The 18 schedules of ``lr.py``, the same in both packages."""
    names = {k.split("_")[0] for k in SCHEDULES}
    port = {n for n, c in vars(port_opt.lr).items()
            if isinstance(c, type) and issubclass(c, port_opt.LRScheduler)
            and c is not port_opt.LRScheduler}
    jax_names = {n for n, c in vars(jax_opt.lr).items()
                 if isinstance(c, type)
                 and issubclass(c, jax_opt.lr.LRScheduler)
                 and c is not jax_opt.lr.LRScheduler}
    assert names == port == jax_names and len(names) == 18


@pytest.mark.parametrize("key", sorted(SCHEDULES))
def test_schedule_matches_jax(key):
    """``get_lr`` and ``lr_at`` over 20 steps equal the JAX schedule's
    exactly (the same Python arithmetic); ``state_dict`` equals the JAX
    one, and a fresh schedule given it by ``set_state_dict`` continues the
    same sequence."""
    jax_s, port_s = _schedule(jax_opt.lr, key), _schedule(port_opt.lr, key)
    got, want = [], []
    for step in range(20):
        got.append(port_s.get_lr())
        want.append(jax_s.get_lr())
        assert port_s.lr_at(step) == jax_s.lr_at(step)
        _advance(port_s, key, step)
        _advance(jax_s, key, step)
    assert got == want
    assert len(set(got)) > 1 or key == "ReduceOnPlateau"
    sd = port_s.state_dict()
    assert sd == jax_s.state_dict()
    fresh = _schedule(port_opt.lr, key)
    fresh.set_state_dict(sd)
    for step in range(3):
        assert fresh.get_lr() == port_s.get_lr()
        if key != "ReduceOnPlateau":
            fresh.step()
            port_s.step()


def _grads(dtype, seed=3):
    rng = np.random.RandomState(seed)
    shapes = {"w": (32, 16), "b": (16,), "e": (8, 4)}
    return {n: (rng.randn(*s) * (3.0 if n == "w" else 0.2)).astype(
        np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clip_matches_jax(clip, dtype):
    """``functional_clip`` of each class against the JAX one (norms in f32,
    the global norm with its 1e-6): f32 within 1e-6 of the largest entry
    (the norm summed in another order); bf16 within one bf16 ulp of each
    entry (one rounding of f32 values that agree to that). The clip bites:
    "w" is scaled or cut. The list API keeps a None gradient None."""
    make = {"value": lambda m: m.ClipGradByValue(0.5),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0)}[clip]
    grads = _grads(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = make(jax_opt).functional_clip(
        {n: jnp.asarray(g, jdt) for n, g in grads.items()})
    got = make(port_opt).functional_clip(
        {n: torch.from_numpy(g).to(tdt) for n, g in grads.items()})
    for n, g in got.items():
        assert g.dtype == tdt
        if dtype == "float32":
            w = np.asarray(want[n])
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
        else:
            ulps = np.abs(g.view(torch.int16).numpy().astype(np.int64)
                          - np.asarray(want[n]).view(np.int16))
            assert ulps.max() <= 1, n
    assert np.abs(got["w"].float().numpy() - grads["w"]).max() > 0.1
    p = torch.zeros(2)
    out = make(port_opt)([(p, None), (p, torch.from_numpy(grads["b"]))])
    assert out[0] == (p, None) and out[1][0] is p
    torch.testing.assert_close(
        out[1][1], make(port_opt).functional_clip(
            {0: torch.from_numpy(grads["b"])})[0])


def test_optimizer_scheduler_and_clip_wiring():
    """A scheduler as ``learning_rate``: ``get_lr`` follows it, ``set_lr``
    refuses, the optimizer never steps it; ``grad_clip`` runs before the
    update and leaves ``.grad`` as it was; a plain rate can be set."""
    sched = port_opt.lr.StepDecay(0.1, 1, gamma=0.5)
    p = torch.nn.Parameter(torch.ones(4))
    opt = port_opt.Adam(sched, parameters=[p],
                        grad_clip=port_opt.ClipGradByValue(0.01))
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.2)
    p.grad = torch.full((4,), 5.0)
    opt.step()
    assert sched.last_epoch == 0 and torch.equal(p.grad, torch.full((4,),
                                                                    5.0))
    # Adam's first step moves each weight by lr * m_hat / (sqrt(v_hat) +
    # eps), about lr whatever the clipped gradient's size
    torch.testing.assert_close(p.detach(), torch.full((4,), 0.9))
    sched.step()
    assert opt.get_lr() == 0.05
    plain = port_opt.AdamW(0.1, parameters=[p])
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3


def _bf16_model(seed):
    cfg = DeepseekV2Config.tiny_mla(num_hidden_layers=2, dtype="bfloat16")
    return DeepseekV2ForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))


def _trainer(model):
    opt = port_opt.AdamW(port_opt.lr.LinearWarmup(1e-3, 2, 1e-4, 1e-3),
                         parameters=model.parameters(), weight_decay=0.1,
                         moment_dtype="bfloat16",
                         grad_clip=port_opt.ClipGradByGlobalNorm(1.0))
    return opt, port_train_step(model, lambda m, a, b: m(a, labels=b)[0],
                                opt)


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """A bf16 ``tiny_mla`` after two steps (bf16 parameters and moments, f32
    masters, a scheduler at step 2): ``save`` then ``load`` gives every
    tensor back bit for bit with its dtype, and a model and optimizer
    restored from the file take a third step bit-identical to the
    original's."""
    ids = np.random.RandomState(0).randint(0, 512, size=(2, 17))
    x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    model = _bf16_model(0)
    opt, step = _trainer(model)
    for _ in range(2):
        step(x, y)
        opt._lr.step()
    framework_io.save({"model": model.state_dict(),
                       "opt": opt.state_dict(), "note": ["bf16", 2]},
                      str(tmp_path / "ckpt" / "step2.pdparams"))
    back = framework_io.load(str(tmp_path / "ckpt" / "step2.pdparams"))
    assert back["note"] == ["bf16", 2]
    assert back["opt"]["step"] == 2
    assert back["opt"]["LR_Scheduler"] == opt._lr.state_dict()
    for name, t in model.state_dict().items():
        assert back["model"][name].dtype == t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(back["model"][name]), _bits(t))
    for name, st in opt.state_dict()["state"].items():
        assert set(back["opt"]["state"][name]) == {"moment1", "moment2",
                                                   "master"}
        for key, t in st.items():
            got = back["opt"]["state"][name][key]
            assert got.dtype == t.dtype
            np.testing.assert_array_equal(_bits(got), _bits(t))
    restored = _bf16_model(1)
    restored.load_state_dict(back["model"])
    opt2, step2 = _trainer(restored)
    opt2.set_state_dict(back["opt"])
    assert opt2.get_lr() == opt.get_lr()
    l1, l2 = step(x, y), step2(x, y)
    assert l1.item() == l2.item()
    for (name, a), b in zip(model.state_dict().items(),
                            restored.state_dict().values()):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def test_load_reads_a_file_the_jax_package_wrote(tmp_path):
    """``paddle_tpu.save`` of nested containers (a bf16 and an f32 tensor,
    a Parameter, ints, strings): the port's ``load`` maps the JAX payload
    class onto its own and returns the values bit for bit (bf16 as bf16),
    a Parameter as ``nn.Parameter``; ``return_numpy`` gives arrays (bf16
    widened to f32, exactly)."""
    rng = np.random.RandomState(5)
    a32 = rng.randn(3, 4).astype(np.float32)
    b16 = np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16))
    param = paddle_tpu.create_parameter([2, 3], "float32")
    path = str(tmp_path / "jax.pdparams")
    paddle_tpu.save({"f32": paddle_tpu.to_tensor(a32),
                     "bf16": paddle_tpu.to_tensor(b16),
                     "nested": [{"p": param}, ("x", 7)]}, path)
    got = framework_io.load(path)
    assert got["f32"].dtype == torch.float32
    np.testing.assert_array_equal(got["f32"].numpy(), a32)
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].view(torch.int16).numpy(),
                                  b16.view(np.int16))
    p = got["nested"][0]["p"]
    assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    np.testing.assert_array_equal(p.detach().numpy(), param.numpy())
    assert got["nested"][1] == ("x", 7)
    arrs = framework_io.load(path, return_numpy=True)
    assert arrs["bf16"].dtype == np.float32
    np.testing.assert_array_equal(arrs["bf16"], b16.astype(np.float32))
