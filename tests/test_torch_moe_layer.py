"""The rest of the MoE layer against the JAX package, on the CPU: the
counting primitives, the three gates given the same random draws,
``MoELayer`` forward and gradients (grouped and list experts, recompute),
``GroupedMLP.forward_ragged``, ``global_scatter`` / ``global_gather`` and
``weights.load_jax_state``.

Weights are drawn with numpy from a seed and loaded into both packages.
The JAX gates draw with threefry, the port's with Philox, so the gates are
held equal given the same draws: the uniforms ``jax.random.uniform`` gives
the JAX gate go to the port's ``_route`` as ``noise=`` / ``r=``. f32
throughout: outputs within 1e-5 (sums in another order), gradients within
1e-5 of each tensor's largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import moe as jax_moe
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.distributed import moe as port_moe
from paddle_tpu_torch.weights import load_jax_state, to_numpy_state

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, E, HID = 16, 4, 24


def _np_state(layer, seed):
    """Seeded numpy weights for every parameter of a JAX layer (biases and
    gate weights non-zero, so every term is exercised)."""
    rng = np.random.RandomState(seed)
    return {k: (0.3 * rng.randn(*v.shape)).astype(np.float32)
            for k, v in layer.functional_state().items()}


def _load_jax(layer, state):
    layer.load_functional_state({k: jnp.asarray(v) for k, v in state.items()})


# ------------------------------------------------------------- counting --

def test_counting_primitives_match_jax():
    rng = np.random.RandomState(0)
    idx = rng.randint(-1, 5, size=(9, 2)).astype(np.int32)
    idx[0, 0] = 7                    # outside [0, n): counted nowhere
    for cap in (0, 1, 2, 3):
        want = np.asarray(jax_moe.prune_gate_by_capacity(jnp.asarray(idx),
                                                         5, cap))
        got = port_moe.prune_gate_by_capacity(torch.from_numpy(idx), 5, cap)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    counts = port_moe.expert_count(torch.from_numpy(idx), 5)
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jax_moe.expert_count(jnp.asarray(idx), 5)))
    np.testing.assert_array_equal(
        port_moe.limit_by_capacity(counts, 2).numpy(),
        np.asarray(jax_moe.limit_by_capacity(jnp.asarray(counts.numpy()), 2)))
    logits = rng.randn(9, 5).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    top = np.argsort(-probs, 1)[:, :2].astype(np.int32)
    top[2, 0] = -1                   # a dropped first route
    want = float(jax_moe.load_balance_loss(jnp.asarray(probs),
                                           jnp.asarray(top)))
    got = float(port_moe.load_balance_loss(torch.from_numpy(probs),
                                           torch.from_numpy(top)))
    assert abs(got - want) <= 1e-6


# ----------------------------------------------------------------- gates --

def _gate_pair(kind, seed, **kw):
    paddle_tpu.seed(seed)
    cls = {"naive": (jax_moe.NaiveGate, port_moe.NaiveGate),
           "switch": (jax_moe.SwitchGate, port_moe.SwitchGate),
           "gshard": (jax_moe.GShardGate, port_moe.GShardGate)}[kind]
    jg = cls[0](D_MODEL, E, **kw)
    state = _np_state(jg, seed)
    _load_jax(jg, state)
    pg = load_jax_state(cls[1](D_MODEL, E, device="cpu", **kw), state)
    return jg, pg, state


@pytest.mark.parametrize("kind,training,kw", [
    ("naive", True, {}),
    ("naive", False, dict(capacity_factor=None)),
    ("naive", False, dict(capacity_factor=0.5, topk=1)),
    ("switch", True, dict(switch_eps=0.1, capacity=(0.5, 2.4))),
    ("switch", False, dict(switch_eps=0.1, capacity=(0.5, 0.5))),
    ("gshard", True, dict(capacity=(0.5, 2.4))),
    ("gshard", False, dict(capacity=(1.2, 0.8))),
], ids=["naive-train", "naive-nodrop", "naive-top1-cf0.5", "switch-train",
        "switch-eval", "gshard-train", "gshard-eval"])
def test_gate_route_matches_jax_given_the_draws(kind, training, kw):
    """(combine, dispatch, aux) of ``_route`` equal the JAX gate's, given
    the same uniforms: the Switch jitter U(1 - eps, 1 + eps) over [S, E],
    GShard's random routing U(0, 1) over [S] (about half the second routes
    turn into the -1 sentinel); at factors below 1 routes drop. The
    dispatch is detached."""
    jg, pg, state = _gate_pair(kind, 3, **kw)
    S = 24
    x = np.random.RandomState(4).randn(S, D_MODEL).astype(np.float32)
    key = jax.random.PRNGKey(5)
    draw = {}
    if kind == "switch" and training:
        draw["noise"] = torch.from_numpy(np.array(jax.random.uniform(
            key, (S, E), minval=1.0 - jg.switch_eps,
            maxval=1.0 + jg.switch_eps)))
    if kind == "gshard" and training:
        draw["r"] = torch.from_numpy(np.array(jax.random.uniform(key,
                                                                 (S,))))
    want = jg._route(jnp.asarray(x), jnp.asarray(state["gate_weight"]),
                     jnp.asarray(state["gate_bias"]),
                     key if draw else None, training)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pg._route(xt, pg.gate_weight, pg.gate_bias, training, **draw)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2].detach()), float(want[2]),
                               **TOL)
    assert not got[1].requires_grad and got[0].requires_grad
    kept = int(got[1].sum())
    routes = S * pg.top_k
    if kind == "gshard" and training:
        assert kept < routes - S // 4      # random routing dropped routes
    if min(kw.get("capacity", (1, 1))[0 if training else 1],
           kw.get("capacity_factor", None) or 2.0) < 1:
        assert kept < routes               # capacity dropped routes


def test_gates_draw_from_their_generator():
    """Training-mode draws come from the gate's ``torch.Generator``: two
    GShard gates with equally seeded generators route alike, and the draw
    changes the routing (second routes drop; eval keeps more); the gates'
    top-k checks raise."""
    x = torch.from_numpy(np.random.RandomState(6).randn(32, D_MODEL)
                         .astype(np.float32))
    outs = []
    for _ in range(2):
        g = port_moe.GShardGate(D_MODEL, E, device="cpu",
                                generator=torch.Generator().manual_seed(9))
        g.train()
        outs.append(g.dispatch(x))
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    g.eval()
    assert int(g.dispatch(x)[1].sum()) > int(outs[0][1].sum())
    assert isinstance(g.get_loss(), torch.Tensor) and g.get_loss() is None
    with pytest.raises(ValueError):
        port_moe.SwitchGate(D_MODEL, E, topk=2)
    with pytest.raises(ValueError):
        port_moe.GShardGate(D_MODEL, E, topk=1)


# ---------------------------------------------------------------- layer --

class _JaxExpert(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(D_MODEL, HID)
        self.fc2 = jnn.Linear(HID, D_MODEL)

    def forward(self, x):
        return self.fc2(JF.gelu(self.fc1(x)))


class _PortExpert(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = port_nn.Linear(D_MODEL, HID, bias=True)
        self.fc2 = port_nn.Linear(HID, D_MODEL, bias=True)

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.fc1(x)))


def _layer_pair(experts, gate, seed=11, recompute=0):
    paddle_tpu.seed(seed)
    if experts == "list":
        jl = jax_moe.MoELayer(D_MODEL, [_JaxExpert() for _ in range(E)],
                              gate=dict(gate))
        pl = port_moe.MoELayer(D_MODEL, [_PortExpert() for _ in range(E)],
                               gate=dict(gate))
    else:
        jl = jax_moe.MoELayer(D_MODEL, jax_moe.GroupedMLP(
            E, D_MODEL, HID, activation=experts), gate=dict(gate),
            recompute_interval=recompute)
        pl = port_moe.MoELayer(D_MODEL, port_moe.GroupedMLP(
            E, D_MODEL, HID, activation=experts, device="cpu"),
            gate=dict(gate), recompute_interval=recompute)
    state = _np_state(jl, seed)
    _load_jax(jl, state)
    load_jax_state(pl, state)
    return jl, pl, state


CASES = [   # (experts, gate, recompute_interval, training)
    ("gelu", {"type": "naive"}, 0, True),
    ("swiglu", {"type": "gshard", "random_routing": False,
                "capacity": (0.8, 0.6)}, 0, False),
    ("gelu", {"type": "switch", "switch_eps": 0.0,
              "capacity": (0.6, 1.5)}, 0, True),
    ("list", {"type": "naive", "capacity_factor": 0.75}, 0, False),
    ("list", {"type": "gshard", "random_routing": False}, 0, True),
    ("swiglu", {"type": "naive", "topk": 3}, 1, True),
]
IDS = ["naive-gelu-train", "gshard-swiglu-eval", "switch-gelu-train",
       "naive-list-eval", "gshard-list-train", "naive-swiglu-recompute"]


@pytest.mark.parametrize("experts,gate,recompute,training", CASES, ids=IDS)
def test_moe_layer_forward_and_gradients_match_jax(experts, gate, recompute,
                                                   training):
    """``MoELayer`` on [2, 12, M] tokens: output, and the gradients of
    sum(out^2) + the gate's aux loss w.r.t. the input, the gate and every
    expert parameter, against ``jax.grad`` of the JAX layer (training mode
    with no random draw: the Switch jitter 0, GShard routing fixed). The
    factors below 1 drop routes on both sides."""
    jl, pl, state = _layer_pair(experts, gate, recompute=recompute)
    jl.train() if training else jl.eval()
    pl.train(training)
    x = np.random.RandomState(12).randn(2, 12, D_MODEL).astype(np.float32)

    def jax_loss(st, xs):
        jl.load_functional_state(st)
        out = unwrap(jl(wrap(xs)))
        aux = jl.gate.get_loss()
        return jnp.sum(out ** 2) + unwrap(aux), out

    st = {k: jnp.asarray(v) for k, v in state.items()}
    (_, want), (g_st, g_x) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(st, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pl(xt)
    loss = out.pow(2).sum() + pl.gate.get_loss()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    grads = {"x": (xt.grad, g_x)}
    grads.update({n: (p.grad, g_st[n]) for n, p in pl.named_parameters()})
    for name, (got, ref) in grads.items():
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    assert float(pl.gate.gate_weight.grad.abs().sum()) > 0


def test_moe_layer_refusals_and_ep():
    """No mesh: a ``moe_group`` raises naming ROADMAP.md item 12; the
    default EP axes are (); ``fused_moe`` raises as in the JAX package."""
    from paddle_tpu_torch.incubate.nn.functional import fused_moe

    g = port_moe.GroupedMLP(E, D_MODEL, HID, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        port_moe.MoELayer(D_MODEL, g, moe_group=("dp",))
    layer = port_moe.MoELayer(D_MODEL, g)
    assert layer._ep_axes == () == port_moe.default_ep_axes(E)
    assert port_moe.shard_grouped_experts(g, ()) == ()
    assert isinstance(layer.gate, port_moe.NaiveGate) and layer.gate.top_k == 2
    with pytest.raises(NotImplementedError, match="MoELayer"):
        fused_moe(*([None] * 6))


def test_grouped_mlp_init_matches_jax_law():
    """XavierUniform with each expert's fans: every entry inside
    sqrt(6 / (fan_in + fan_out)), biases 0, the same limits as JAX's."""
    paddle_tpu.seed(1)
    jg = jax_moe.GroupedMLP(E, 64, 32, activation="swiglu")
    pg = port_moe.GroupedMLP(E, 64, 32, activation="swiglu", device="cpu",
                             generator=torch.Generator().manual_seed(1))
    for name in ("w1", "w2"):
        lim = np.sqrt(6.0 / (64 + 32))
        j = np.asarray(jg.functional_state()[name])
        p = getattr(pg, name).detach().numpy()
        assert j.shape == p.shape
        assert np.abs(p).max() <= lim and np.abs(p).max() > 0.9 * lim
        assert np.abs(j).max() <= lim
    assert not bool(pg.b1.detach().any()) and not bool(pg.b2.detach().any())


# --------------------------------------------------------------- ragged --

@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_forward_ragged_matches_jax_and_the_expert_batch(activation):
    """Tokens sorted by expert with group sizes [3, 0, 5, 2]: equal to the
    JAX ``ragged_dot`` path and to ``forward_expert_batch`` on the same
    rows laid out [E, C, M] (zero rows past each group); a size sum other
    than T raises as in JAX."""
    paddle_tpu.seed(2)
    jg = jax_moe.GroupedMLP(E, D_MODEL, HID, activation=activation)
    state = _np_state(jg, 2)
    _load_jax(jg, state)
    pg = load_jax_state(port_moe.GroupedMLP(E, D_MODEL, HID,
                                            activation=activation,
                                            device="cpu"), state)
    sizes = [3, 0, 5, 2]
    x = np.random.RandomState(3).randn(sum(sizes), D_MODEL).astype(
        np.float32)
    want = np.asarray(unwrap(jg.forward_ragged(wrap(jnp.asarray(x)),
                                               jnp.asarray(sizes))))
    got = pg.forward_ragged(torch.from_numpy(x), torch.tensor(sizes))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    xe = torch.zeros(E, max(sizes), D_MODEL)
    off = 0
    for e, n in enumerate(sizes):
        xe[e, :n] = torch.from_numpy(x[off:off + n])
        off += n
    batch = pg.forward_expert_batch(xe)
    rows = torch.cat([batch[e, :n] for e, n in enumerate(sizes)])
    np.testing.assert_allclose(got.detach().numpy(), rows.detach().numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="group_sizes sums to 9 but x has "
                                         "10 tokens"):
        pg.forward_ragged(torch.from_numpy(x), torch.tensor([3, 0, 4, 2]))


# --------------------------------------------------- scatter and gather --

def test_global_scatter_gather_match_jax():
    """Two ranks of two experts with uneven counts: the scattered buffers
    (expert-major, then source rank, zero-padded to the largest receive
    count) equal JAX's, and gather restores each rank's buffer."""
    world, n_expert, M = 2, 2, 4
    rng = np.random.RandomState(0)
    lc = np.array([[2, 0, 2, 1], [1, 1, 0, 2]], np.int64)
    gc = np.zeros_like(lc)
    for dst in range(world):
        for src in range(world):
            for e in range(n_expert):
                gc[dst, src * n_expert + e] = lc[src, dst * n_expert + e]
    x = np.zeros((world, int(lc.sum(1).max()), M), np.float32)
    for r in range(world):
        x[r, :int(lc[r].sum())] = rng.randn(int(lc[r].sum()), M)
    want = np.asarray(unwrap(jax_moe.global_scatter(
        paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(lc),
        paddle_tpu.to_tensor(gc))))
    got = port_moe.global_scatter(torch.from_numpy(x), torch.from_numpy(lc),
                                  torch.from_numpy(gc))
    np.testing.assert_array_equal(got.numpy(), want)
    back_want = np.asarray(unwrap(jax_moe.global_gather(
        paddle_tpu.to_tensor(want), paddle_tpu.to_tensor(lc),
        paddle_tpu.to_tensor(gc))))
    back = port_moe.global_gather(got, torch.from_numpy(lc),
                                  torch.from_numpy(gc))
    np.testing.assert_array_equal(back.numpy(), back_want)
    np.testing.assert_array_equal(back.numpy(), x)


# --------------------------------------------------------------- bridge --

def test_load_jax_state_by_parameter_name():
    """Any module by its parameter names, each parameter keeping its
    dtype (bf16 from its uint16 bits, bit-exact back); a missing or extra
    name raises."""
    g = port_moe.NaiveGate(D_MODEL, E, device="cpu", dtype=torch.bfloat16)
    w = np.random.RandomState(1).randn(D_MODEL, E).astype(np.float32)
    bits = torch.from_numpy(w).bfloat16().view(torch.int16).numpy().view(
        np.uint16)
    state = {"gate_weight": bits, "gate_bias": np.zeros(E, np.uint16)}
    load_jax_state(g, state)
    assert g.gate_weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy_state(g)["gate_weight"], bits)
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(g, {"gate_weight": bits})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state(g, dict(state, extra=bits))
