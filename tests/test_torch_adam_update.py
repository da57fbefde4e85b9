"""The fused Adam / AdamW update (``ops/hopper/adam_update.py``) and the
global-norm kernel's wrapper (``ops/hopper/grad_norm.py``) on the CPU:

- the optimizer's multi-tensor route, on CPU tensors, bit for bit against
  a frozen copy of the per-parameter update it replaced (bf16 and f32
  parameters, with and without f32 masters, f32 and bf16 moments, a decay
  mask, L2 and decoupled decay, with and without a global-norm clip),
  whose one change is the correctly rounded square root; against the
  copy with PyTorch's own f32 square root, the moments bit for bit and
  the values within one ulp;
- the grouping, the table and its reuse, as pure functions;
- the CUDA routes with stand-in launches (tensors posing as CUDA, the
  plain versions refusing them): one launch per group, the scalars as f32,
  the clip scale's address, one ``grad_norm`` count a call;
- ``amsgrad`` Adam and AdamW against the JAX ``apply_gradients``.

Each test states its tolerance."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

from paddle_tpu import optimizer as jax_opt
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.ops.hopper import _build, adam_update, grad_norm


# ---------------------------------------------------------------------------
# the per-parameter update as it was, kept verbatim as the reference
# ---------------------------------------------------------------------------

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _frozen_sq_norm(g):
    return torch.sum(torch.square(g.float()))


def _frozen_global_clip(grads, clip_norm):
    total = torch.sqrt(sum(_frozen_sq_norm(g) for g in grads.values()))
    scale = torch.clamp(clip_norm / (total + 1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


class _FrozenAdam:
    """``Optimizer.apply_gradients`` and ``Adam.update`` of the port before
    the multi-tensor update (AdamW: ``decoupled`` with a decay gate). One
    line is parametrised: the square root, ``torch.sqrt`` as it was
    (``.sqrt_()``) or the correctly rounded ``sqrt_rn`` the plain version
    now takes (PyTorch's f32 square root on the CPU is MKL's, within one
    ulp but not correctly rounded, which no kernel can reproduce)."""

    def __init__(self, lr, beta1, beta2, eps, weight_decay, decoupled,
                 should_decay, clip_norm, multi_precision, moment_dtype,
                 sqrt=adam_update.sqrt_rn):
        self._sqrt = sqrt
        self._lr, self._beta1, self._beta2, self._eps = lr, beta1, beta2, eps
        self._weight_decay = weight_decay
        self._decoupled = decoupled
        self._should = should_decay
        self._clip_norm = clip_norm
        self._multi_precision = multi_precision
        self._moment_dtype = moment_dtype
        self._state = {}
        self._step = 0

    def init_param_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def update(self, w32, g32, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        m_store, v_store = state["moment1"], state["moment2"]
        m = m_store.float().mul_(b1).add_(g32 * (1 - b1))
        v = v_store.float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        stepf = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** stepf)
        bc2 = float(np.float32(1) - np.float32(b2) ** stepf)
        denom = self._sqrt(v / bc2).add_(self._eps)
        w32.sub_((m / bc1).mul_(lr).div_(denom))
        if m is not m_store:
            m_store.copy_(m)
            v_store.copy_(v)

    @torch.no_grad()
    def apply_gradients(self, params):
        self._step += 1
        lr, wd = self._lr, self._weight_decay
        grads = {name: p.grad for name, p in params.items()
                 if p.grad is not None}
        if self._clip_norm is not None:
            grads = _frozen_global_clip(grads, self._clip_norm)
        for name, g in grads.items():
            p = params[name]
            state = self._state.get(name)
            if state is None:
                state = self.init_param_state(p)
                if self._multi_precision and p.dtype in _LOW_PRECISION:
                    state["master"] = p.detach().float()
                self._state[name] = state
            master = state.get("master")
            w32 = master if master is not None else p.data
            if w32.dtype != torch.float32:
                w32 = w32.float()
            g32 = g.float()
            if wd and self._should(name):
                if self._decoupled:
                    w32.mul_(1.0 - lr * wd)
                else:
                    g32 = g32 + w32 * wd
            self.update(w32, g32, state, lr, self._step)
            if w32 is not p.data:
                p.data.copy_(w32)


SHAPES = {"w": (64, 33), "b": (37,), "e": (9, 16), "s": ()}


def _params(dtype, seed=5):
    rng = np.random.RandomState(seed)
    return {n: torch.nn.Parameter(torch.from_numpy(np.asarray(
        rng.randn(*s), dtype=np.float32)).to(dtype))
        for n, s in SHAPES.items()}


def _grad_sets(dtype, steps=2, seed=6, scale=0.1):
    rng = np.random.RandomState(seed)
    return [{n: torch.from_numpy(np.asarray(
        scale * rng.randn(*s), dtype=np.float32)).to(dtype)
        for n, s in SHAPES.items()} for _ in range(steps)]


def _bits(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["f32", "bf16_master", "bf16_no_master"])
def test_cpu_route_equals_the_frozen_update(kind, moments, decoupled, clip):
    """Two steps at rate 1e-2, betas 0.9 / 0.95, weight decay 0.1 with
    parameter ``b`` excluded; the clip at norm 0.05 scales every gradient
    (their norm is about 4.8). Parameters, masters and moments equal the
    frozen update's bit for bit."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    multi = kind != "bf16_no_master"
    mdt = getattr(torch, moments)
    clip_obj = None if clip is None else port_opt.ClipGradByGlobalNorm(clip)
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
              grad_clip=clip_obj, multi_precision=multi,
              moment_dtype=moments)
    if decoupled:
        opt = port_opt.AdamW(1e-2, apply_decay_param_fun=lambda n: n != "b",
                             **kw)
    else:
        opt = port_opt.Adam(1e-2, **kw)
        opt._should_decay = lambda n: n != "b"
    ref = _FrozenAdam(1e-2, 0.9, 0.95, 1e-8, 0.1, decoupled,
                      lambda n: n != "b", clip, multi, mdt)
    got, want = _params(dtype), _params(dtype)
    for grads in _grad_sets(dtype):
        for n in SHAPES:
            got[n].grad = grads[n].clone()
            want[n].grad = grads[n].clone()
        opt.apply_gradients(got)
        ref.apply_gradients(want)
    for n in SHAPES:
        np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]), n)
        st, rs = opt._state[n], ref._state[n]
        assert set(st) == set(rs), n
        for key in rs:
            assert st[key].dtype == rs[key].dtype, (n, key)
            np.testing.assert_array_equal(_bits(st[key]), _bits(rs[key]),
                                          f"{n} {key}")


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` equals numpy's f32 square root (correctly rounded) bit
    for bit over 2^20 values across 120 binades, where ``torch.sqrt`` on
    f32 is off by one ulp for some."""
    rng = np.random.RandomState(3)
    x = (rng.uniform(0, 1, 1 << 20) * 2.0 ** rng.randint(-60, 60, 1 << 20)
         ).astype(np.float32)
    got = adam_update.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    off = torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32) \
        - got.view(np.int32)
    assert np.abs(off).max() <= 1


def test_only_the_square_root_changed():
    """Against the frozen update with ``torch.sqrt`` (the bits before this
    kernel), bf16 parameters with f32 masters and bf16 moments, two steps:
    the moments bit for bit, the masters within one f32 ulp, the bf16
    parameters within one bf16 ulp."""
    opt = port_opt.AdamW(1e-2, beta2=0.95, weight_decay=0.1,
                         moment_dtype="bfloat16")
    ref = _FrozenAdam(1e-2, 0.9, 0.95, 1e-8, 0.1, True, lambda n: True,
                      None, True, torch.bfloat16, sqrt=torch.sqrt)
    got, want = _params(torch.bfloat16), _params(torch.bfloat16)
    for grads in _grad_sets(torch.bfloat16):
        for n in SHAPES:
            got[n].grad = grads[n].clone()
            want[n].grad = grads[n].clone()
        opt.apply_gradients(got)
        ref.apply_gradients(want)
    for n in SHAPES:
        st, rs = opt._state[n], ref._state[n]
        for key in ("moment1", "moment2"):
            np.testing.assert_array_equal(_bits(st[key]), _bits(rs[key]))
        for a, b in ((st["master"], rs["master"]), (got[n], want[n])):
            diff = _bits(a).astype(np.int64) - _bits(b).astype(np.int64)
            assert np.abs(diff).max() <= 1, n


def test_the_clip_scale_is_the_frozen_clips():
    """``ClipGradByGlobalNorm`` through ``grad_norm``: the norm and scale,
    and the clipped gradients, equal the frozen clip's bit for bit (bf16
    and f32 gradients)."""
    for dtype in (torch.bfloat16, torch.float32):
        grads = _grad_sets(dtype, steps=1)[0]
        clip = port_opt.ClipGradByGlobalNorm(0.05)
        want = _frozen_global_clip(grads, 0.05)
        got = clip.functional_clip(grads)
        for n in grads:
            np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]))
        total = torch.sqrt(sum(_frozen_sq_norm(g) for g in grads.values()))
        ns = clip.norm_and_scale(grads)
        assert torch.equal(ns[0], total)
        assert torch.equal(ns[1], torch.clamp(0.05 / (total + 1e-6),
                                              max=1.0))
        assert float(ns[1]) < 1.0


# ---------------------------------------------------------------------------
# grouping and tables, as pure functions
# ---------------------------------------------------------------------------

def _item(shape, dtype=torch.bfloat16, master=True, mdt=torch.bfloat16,
          ams=False, decay=True, offset=0):
    """(param, grad, state, decay) of fresh CPU tensors; ``offset`` starts
    the parameter ``offset`` elements into its storage (unaligned)."""
    n = int(np.prod(shape)) if shape else 1
    p = torch.zeros(n + offset, dtype=dtype)[offset:].reshape(shape)
    state = {"moment1": torch.zeros(shape, dtype=mdt),
             "moment2": torch.zeros(shape, dtype=mdt)}
    if master:
        state["master"] = torch.zeros(shape)
    if ams:
        state["moment2_max"] = torch.zeros(shape, dtype=mdt)
    return (p, torch.zeros(shape, dtype=dtype), state, decay)


def _hp(**kw):
    base = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                decoupled=True, amsgrad=False, step=1)
    base.update(kw)
    return adam_update.AdamHyper(**base)


def test_groups_by_kind_in_item_order():
    """One group per (parameter dtype, master, moment dtype, amsgrad, L2):
    the 8B recipe's parameter set (bf16, f32 masters, bf16 moments) is one
    group; items keep their order inside a group."""
    a, b = _item((4, 8)), _item((8,))
    c = _item((3,), dtype=torch.float32, master=False)
    d = _item((5,), master=False)
    groups = adam_update.group_items([a, c, b, d], _hp())
    assert list(groups) == [(1, True, 1, False, False),
                            (0, False, 1, False, False),
                            (1, False, 1, False, False)]
    assert [x[0].shape for x in groups[(1, True, 1, False, False)]] == [
        (4, 8), (8,)]
    ams = _item((2,), ams=True, mdt=torch.float32)
    assert list(adam_update.group_items([ams], _hp(amsgrad=True,
                                                    decoupled=False))) == [
        (1, True, 0, True, True)]


@pytest.mark.parametrize("bad", ["float16", "grad_dtype", "moment_mix",
                                 "f32_master", "grad_shape"])
def test_group_key_refuses_what_the_kernel_does_not_take(bad):
    p, g, state, decay = _item((4,))
    err = ValueError
    if bad == "float16":
        p, g = p.half(), g.half()
        err = TypeError
    elif bad == "grad_dtype":
        g = g.float()
    elif bad == "moment_mix":
        state["moment2"] = state["moment2"].float()
    elif bad == "f32_master":
        p, g = p.float(), g.float()
    else:
        g = torch.zeros(5, dtype=p.dtype)
    with pytest.raises(err):
        adam_update.group_key(p, g, state, _hp())


def test_table_rows_blocks_and_flags():
    """Each row: the six addresses (0 for no master / no moment2_max), the
    element count and ``first_block << 2 | vec << 1 | decay``; blocks of
    CHUNK elements, a tensor's first block after the previous tensor's
    last; vec 0 where an address is not 16-byte aligned."""
    chunk = adam_update.CHUNK
    items = [_item((chunk + 1,)), _item((7,), decay=False),
             _item((2 * chunk,), offset=1), _item((), ams=True)]
    table, blocks = adam_update.build_table(items)
    assert table.shape == (4, adam_update.ROW) and table.dtype == torch.int64
    assert blocks == 2 + 1 + 2 + 1
    firsts = [0, 2, 3, 5]
    for row, item, first in zip(table.tolist(), items, firsts):
        p, g, state, decay = item
        assert row[:6] == [p.data_ptr(), g.data_ptr(),
                           state["master"].data_ptr(),
                           state["moment1"].data_ptr(),
                           state["moment2"].data_ptr(),
                           state["moment2_max"].data_ptr()
                           if "moment2_max" in state else 0]
        assert row[6] == p.numel()
        aligned = all(a % 16 == 0 for a in row[:6])
        assert row[7] == first << 2 | int(aligned) << 1 | int(decay)
    assert table[2, 7] >> 1 & 1 == 0          # the offset parameter
    no_master = adam_update.build_table([_item((3,), master=False)])[0]
    assert no_master[0, 2] == 0 and no_master[0, 5] == 0


def test_tables_reused_while_addresses_hold():
    """A group's table is built once and kept while every address, size and
    decay flag holds; a new gradient tensor (the next backward) or another
    decay flag rebuilds it."""
    tables = adam_update.Tables()
    key = (1, True, 1, False, False)
    items = [_item((4, 8)), _item((8,))]
    t1 = tables.get(key, items, torch.device("cpu"))
    t2 = tables.get(key, items, torch.device("cpu"))
    assert tables.builds == 1 and t1[0] is t2[0] and t1[1:] == (2, 2)
    p, _, state, decay = items[1]
    items[1] = (p, torch.zeros(8, dtype=torch.bfloat16), state, decay)
    tables.get(key, items, torch.device("cpu"))
    assert tables.builds == 2
    items[1] = (p, items[1][1], state, False)
    tables.get(key, items, torch.device("cpu"))
    assert tables.builds == 3


# ---------------------------------------------------------------------------
# the CUDA routes, with stand-in launches
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_refuses_cuda(monkeypatch):
    """The plain versions raise on a tensor posing as CUDA."""
    for mod, name in ((adam_update, "adam_update_plain"),
                      (grad_norm, "grad_norm_plain")):
        real = getattr(mod, name)

        def guard(first, *a, _real=real, _name=name, **k):
            tensors = first if isinstance(first, list) else [first]
            for t in tensors:
                t = t[0] if isinstance(t, tuple) else t
                if t.device.type == "cuda":
                    raise AssertionError(f"{_name} ran on a CUDA tensor")
            return _real(first, *a, **k)

        monkeypatch.setattr(mod, name, guard)


def _cuda_items():
    items = []
    for item in (_item((4, 8)), _item((40,), decay=False),
                 _item((3,), dtype=torch.float32, master=False,
                       mdt=torch.float32)):
        p, g, state, decay = item
        items.append((posing_as_cuda(p), posing_as_cuda(g),
                      {k: posing_as_cuda(t) for k, t in state.items()},
                      decay))
    return items


def test_cuda_route_launches_once_per_group(fake_kernels,  # noqa: F811
                                            plain_refuses_cuda):
    """Two groups (bf16 + master + bf16 moments; f32): two launches of
    ``pt_adam_update``, each with its table, tensor and block counts, the
    kind's codes and the nine scalars; the clip scale's address; two
    ``adam_update`` counts. A second step with the same tensors reuses both
    tables."""
    items = _cuda_items()
    scale = posing_as_cuda(torch.full((2,), 0.5))[1]
    hp = _hp(lr=3e-4, weight_decay=0.1, step=3)
    tables = adam_update.Tables()
    adam_update.adam_update(items, hp, scale, tables)
    assert dict(_build.launches) == {"adam_update": 2}
    assert [c[0] for c in fake_kernels] == ["pt_adam_update"] * 2
    bc1, bc2 = adam_update.bias_corrections(0.9, 0.95, 3)
    want_scalars = (0.9, 1 - 0.9, 0.95, 1 - 0.95, 1e-8, 3e-4, bc1, bc2,
                    1.0 - 3e-4 * 0.1)
    for (_, args), codes, n, blocks in zip(
            fake_kernels, [(1, 1, 1, 0, 0), (0, 0, 0, 0, 0)], [2, 1],
            [2, 1]):
        assert args[1:3] == (n, blocks)
        assert args[3:8] == codes
        assert args[8:17] == want_scalars
        assert args[17] == scale.data_ptr() and args[18] is None
    adam_update.adam_update(items, hp, scale, tables)
    assert tables.builds == 2 and _build.launches["adam_update"] == 4
    # L2 decay takes wd itself as the factor; no clip passes a null
    fake_kernels.clear()
    adam_update.adam_update(items[2:], _hp(decoupled=False), None, tables)
    args = fake_kernels[0][1]
    assert args[7] == 1 and args[16] == 0.1 and args[17] is None


def test_cuda_route_refuses_a_bad_scale(fake_kernels,  # noqa: F811
                                        plain_refuses_cuda):
    items = _cuda_items()
    with pytest.raises(ValueError, match="clip scale"):
        adam_update.adam_update(items, _hp(), posing_as_cuda(torch.ones(2)),
                                adam_update.Tables())
    assert not fake_kernels


def test_grad_norm_cuda_route(fake_kernels, plain_refuses_cuda):  # noqa: F811
    """One ``pt_grad_norm`` call (both passes) per call: the table, tensor
    and block counts, a partials buffer of one f32 a block, the clip norm
    and 1e-6, an f32 [2] output; one ``grad_norm`` count. An empty
    gradient is left out of the table."""
    chunk = grad_norm.CHUNK
    grads = [posing_as_cuda(torch.zeros(chunk + 3, dtype=torch.bfloat16)),
             posing_as_cuda(torch.zeros(0, dtype=torch.bfloat16)),
             posing_as_cuda(torch.zeros(5))]
    out = grad_norm.grad_norm(grads, 1.0)
    assert dict(_build.launches) == {"grad_norm": 1}
    name, args = fake_kernels[0]
    assert name == "pt_grad_norm"
    assert args[1:3] == (2, 3)
    assert args[4:6] == (1.0, 1e-6)
    assert args[6] == out.data_ptr() and out.shape == (2,)
    assert out.dtype == torch.float32
    table = grad_norm.build_table([grads[0], grads[2]])[0]
    assert table[:, 2].tolist() == [0 << 2 | 1 << 1 | 1, 2 << 2 | 1 << 1 | 0]


def test_optimizer_takes_the_fused_route_on_cuda(fake_kernels,  # noqa: F811
                                                 plain_refuses_cuda):
    """AdamW with a global-norm clip over parameters posing as CUDA: one
    ``grad_norm`` and one ``adam_update`` launch a step for a bf16 set with
    masters and bf16 moments, the scale passed by address (no clipped
    copies)."""
    params = {n: torch.nn.Parameter(posing_as_cuda(torch.zeros(
        s, dtype=torch.bfloat16))) for n, s in (("w", (4, 8)), ("b", (8,)))}
    opt = port_opt.AdamW(1e-3, grad_clip=port_opt.ClipGradByGlobalNorm(1.0),
                         moment_dtype="bfloat16")
    for _ in range(2):
        for p in params.values():
            p.grad = posing_as_cuda(torch.zeros(p.shape, dtype=p.dtype))
        opt.apply_gradients(params)
    assert _build.launches == Counter(adam_update=2, grad_norm=2)
    names = [c[0] for c in fake_kernels]
    assert names == ["pt_grad_norm", "pt_adam_update"] * 2
    assert fake_kernels[1][1][17] == fake_kernels[0][1][6] + 4


# ---------------------------------------------------------------------------
# amsgrad against the JAX package
# ---------------------------------------------------------------------------

def _bf16_bits(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def _torch_bf16_bits(t):
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("cls", ["AdamW", "Adam"])
def test_amsgrad_matches_jax_apply_gradients(cls):
    """Three steps of amsgrad (the gradients shrink after the first, so
    ``moment2_max`` holds the first step's ``v``): bf16 parameters with f32
    masters and bf16 moments, one f32 parameter; the tolerances of
    ``test_torch_train.test_adam_matches_jax_apply_gradients``: f32 masters
    within 1e-6 relative, bf16 parameters and moments within one bf16
    ulp."""
    rng = np.random.RandomState(7)
    shapes = {"w": (64, 32), "b": (32,), "f": (16,)}
    dtypes = {"w": "bfloat16", "b": "bfloat16", "f": "float32"}
    params0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (g * rng.randn(*s)).astype(np.float32)
              for n, s in shapes.items()} for g in (0.3, 0.05, 0.1)]
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
              moment_dtype="bfloat16", amsgrad=True)
    if cls == "AdamW":
        kw["apply_decay_param_fun"] = lambda name: name != "b"
    opt_j = getattr(jax_opt, cls)(1e-2, **kw)
    jparams = {n: jnp.asarray(a, dtypes[n]) for n, a in params0.items()}
    state = opt_j.init_state(jparams)
    extra = dict(lazy_mode=False, name="opt")   # kept, not read
    if cls == "AdamW":
        extra["lr_ratio"] = None
    opt_p = getattr(port_opt, cls)(1e-2, **extra, **kw)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).to(
        getattr(torch, dtypes[n]))) for n, a in params0.items()}
    for g in grads:
        jparams, state = opt_j.apply_gradients(
            state, jparams, {n: jnp.asarray(a, dtypes[n])
                             for n, a in g.items()})
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        opt_p.apply_gradients(tparams)
    for n in ("w", "b"):
        js, ps = state["param_states"][n], opt_p._state[n]
        assert set(ps) == set(js)
        np.testing.assert_allclose(ps["master"].numpy(),
                                   np.asarray(js["master"]), rtol=1e-6,
                                   atol=0)
        for got, want in ((tparams[n], jparams[n]),
                          (ps["moment1"], js["moment1"]),
                          (ps["moment2"], js["moment2"]),
                          (ps["moment2_max"], js["moment2_max"])):
            diff = np.abs(_torch_bf16_bits(got).astype(np.int64)
                          - _bf16_bits(want).astype(np.int64))
            assert diff.max() <= 1, n
    np.testing.assert_allclose(tparams["f"].detach().numpy(),
                               np.asarray(jparams["f"]), rtol=1e-6, atol=0)
    # moment2_max kept the larger first v
    v_max = opt_p._state["w"]["moment2_max"].float()
    assert torch.all(v_max >= opt_p._state["w"]["moment2"].float())
    assert torch.any(v_max > opt_p._state["w"]["moment2"].float())
