"""CUDA graphs of the step units: the port's counterpart of ``jax.jit``'s
compiled-executable cache.

The JAX package keeps one jitted step unit per key
(``paddle_tpu/generation.py`` ``_memoized_step``); XLA compiles it once
per input signature and runs the executable on every call. Here a step
unit derives from :class:`GraphedStep` and puts its body in
:meth:`GraphedStep.eager`.

- Called with CPU tensors, a unit runs its eager body, as every kernel
  wrapper runs its plain version there.
- Called with CUDA tensors, the first call per signature runs the body
  twice on a side stream and then captures it into a
  ``torch.cuda.CUDAGraph``. The two runs build the kernels at first use,
  set their launch attributes, initialise cuBLAS and make the decode
  tail's barrier state for that stream. Every call, the first included,
  replays the graph. The signature is the nesting of the arguments, each
  tensor's shape, strides, dtype and device, every other value, and the
  addresses of the state below.
- Nothing falls back to the eager body on CUDA: a capture or a replay
  that fails raises. A failed capture keeps no graph and gives back the
  launches its warm-ups counted; the next call captures anew.

Inputs. ``cache_arg`` is the index of the argument that holds the caches.
A tensor in it that the body returns as the very object it was given (a
KV buffer written in place, a page table passed through) is *state*. The
graph reads and writes the caller's tensor, so its address belongs to the
signature, and the graph holds it only by a weak reference: a graph whose
state is gone is dropped. Every other tensor is copied at each call into
a static input that the graph owns, in one ``torch._foreach_copy_``. An
argument that already is that static input is not copied. So a body
writes in place only the caches it returns.

Outputs. A call returns the graph's static outputs in fresh lists and
dicts. They stay valid until the next call of any graphed unit of the
same model: the graphs of a model share one memory pool (a
``torch.cuda.MemPool``), and its units never run at once. A caller that
keeps an output longer copies it.

Memory. The warm-up runs allocate from the model's pool too, so a capture
reuses the blocks its warm-ups freed and a body with a large peak (an f32
prefill over a long padded prompt) does not need it twice. The pool's free
blocks are earlier graphs' intermediates, which their replays overwrite:
so nothing a body keeps beyond its call may be made in a warm-up. Each
unit makes that first, outside the pool (:meth:`GraphedStep.prepare`).

Randomness. A ``torch.Generator`` argument is registered with the graph
(``CUDAGraph.register_generator_state``), so a replay draws what the
eager body would draw from the same generator state. The two warm-up runs
draw from throwaway generators and leave the caller's untouched.

Launch counts. The kernel wrappers count in Python
(``ops/hopper/_build.launches``), and a replay runs no Python. What the
capture counts is kept as the graph's count and added at every replay.
What the warm-up runs and the capture itself counted is taken back. So a
count still reads "kernels of the calls that ran". Each unit also counts
its ``captures``, its ``replays`` and its ``capture_s``: the host seconds
of warm-up and capture, with the kernels' build at their first use.

Weights. A graph reads the parameters it was captured with. A unit keeps
a fingerprint of its model's parameters and buffers (address, shape,
dtype) from its captures. :meth:`GraphedStep.refresh_weights`, which
``generation._memoized_step`` calls on every hit, drops the unit's graphs
when any of those tensors has been replaced: a ``Parameter`` set anew, a
submodule swapped, a ``.data`` reassigned. ``load_state_dict`` copies in
place and keeps them.

Geometry. The warm-ups and the capture run inside ``_build.unit_scope``:
a kernel wrapper there reads the autotune cost table
(``ops/hopper/autotune.py``) and measures nothing, as a jitted step of
the JAX package reads it. A graph keeps the geometry it was captured
with: a sweep after the capture reaches it only through a new unit.

One replay at a time: the graphs of a model share its pool, and the
decode tail's barrier state of the capture stream.

Threads. A capture runs in torch's default (global) capture-error mode:
a CUDA call from another thread while it records can invalidate it. So
every capture holds :data:`DEVICE_LOCK`, a process-wide reentrant lock,
and so does any other thread's device work that must not overlap a
capture or interleave with a step's replays and the reads of their
outputs: the serving engine holds it across each step and admission,
the correctness sentinel across each of its reference replays
(``observability/sentinel.py``). A host thread that touches no CUDA
tensor needs nothing.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import Counter, OrderedDict

import torch

from ..ops.hopper import _build

# graphs a unit keeps (signatures times state sets), least recently used
# dropped first
MAX_GRAPHS = 8
WARMUP_RUNS = 2

_NODES = (list, tuple, dict)

#: held by every capture and by device work on other threads that must
#: not overlap one (module docstring, "Threads")
DEVICE_LOCK = threading.RLock()


def flatten(tree):
    """(leaves, spec) of nested lists, tuples and dicts; everything else is
    a leaf. ``spec`` is hashable when the dict keys are. (A leaf inside a
    node is taken in the node's loop: a decode step's arguments hold a few
    hundred of them.)"""
    leaves = []
    add = leaves.append

    def walk(x):
        items = x.values() if isinstance(x, dict) else x
        specs = []
        for v in items:
            if isinstance(v, _NODES):
                specs.append(walk(v))
            else:
                add(v)
                specs.append(None)
        if isinstance(x, dict):
            return (dict, tuple(x), tuple(specs))
        return (type(x), tuple(specs))

    if not isinstance(tree, _NODES):
        return [tree], None
    return leaves, walk(tree)


def unflatten(spec, leaves):
    """The nesting of ``spec`` rebuilt, in new containers, around
    ``leaves``."""
    it = iter(leaves)
    take = it.__next__

    def build(s):
        vals = [take() if c is None else build(c) for c in s[-1]]
        if s[0] is dict:
            return dict(zip(s[1], vals))
        return vals if s[0] is list else s[0](vals)

    return take() if spec is None else build(spec)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):     # its device is the call's
        if x.is_contiguous():
            return (x.shape, x.dtype)
        return (x.shape, x.dtype, x.stride())
    if isinstance(x, torch.Generator):
        return ("generator", id(x))
    return (type(x), x)


def weights_of(model):
    """(every parameter and buffer of ``model``, their (address, shape,
    dtype)): what its graphs read."""
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    return tensors, tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors)


# parameter, buffer and submodule registrations seen by the process (a
# Parameter set as a module attribute, ``register_buffer``, a replaced
# submodule), counted by ``torch.nn`` registration hooks installed at the
# first capture: between two of them a weight check only compares the
# addresses of the tensors the graphs read
_registrations = [0]
_watching = []


def _count_registration(*args):
    _registrations[0] += 1


def _watch_registrations() -> None:
    if not _watching:
        from torch.nn.modules import module

        module.register_module_parameter_registration_hook(
            _count_registration)
        module.register_module_buffer_registration_hook(_count_registration)
        module.register_module_module_registration_hook(_count_registration)
        _watching.append(True)


def graph_pool(model):
    """The memory pool (``torch.cuda.MemPool``) the graphs of ``model``
    share, made at its first capture. The warm-up runs allocate from it
    too, so a capture reuses the blocks its warm-ups freed (a prefill whose
    eager peak is large does not need it twice)."""
    pool = model.__dict__.get("_graph_pool")
    if pool is None:
        pool = torch.cuda.MemPool()
        object.__setattr__(model, "_graph_pool", pool)
    return pool


def pool_bytes(model) -> int:
    """Device bytes the allocator holds in ``model``'s graph pool."""
    pool = model.__dict__.get("_graph_pool")
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in pool.snapshot(
        include_traces=False))


def capture_count(mark: Counter, after: Counter) -> Counter:
    """A graph's launch count, added at each of its replays: what its
    capture counted (``after`` it less the ``mark`` just before it). The
    call's counts go back to where they were before the warm-ups."""
    delta = Counter(after)
    delta.subtract(mark)
    return +delta


class _Cuda:
    """The graph layer's calls into CUDA, in one object (a test stands in
    for the card by replacing ``_CUDA``)."""

    def __init__(self):
        self._side = {}

    @staticmethod
    def device_of(leaves, what):
        """The CUDA device of the tensors among ``leaves``, or None when
        there is none; raises for tensors on two devices."""
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        device = next((x.device for x in tensors if x.is_cuda), None)
        if device is not None and any(x.device != device for x in tensors):
            raise ValueError(f"{what}: tensors on two devices; a graphed "
                             "unit takes one CUDA device")
        return device

    def side_stream(self, device):
        s = self._side.get(device)
        if s is None:
            s = self._side[device] = torch.cuda.Stream(device)
        return s

    @staticmethod
    def current_stream(device):
        return torch.cuda.current_stream(device)

    @staticmethod
    def use(stream):
        return torch.cuda.stream(stream)

    @staticmethod
    def warm(model):
        """Allocations inside go to ``model``'s graph pool."""
        return torch.cuda.use_mem_pool(graph_pool(model))

    @staticmethod
    def new_graph():
        return torch.cuda.CUDAGraph()

    @staticmethod
    def pool(model):
        return graph_pool(model)

    @staticmethod
    def record(graph, pool, fn):
        """Capture ``fn()`` into ``graph`` on the current stream; returns
        its outputs. An error in ``fn`` ends the capture and stands."""
        graph.capture_begin(pool=pool.id)
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass    # the capture is invalid; the body's error stands
            raise
        graph.capture_end()
        return out


_CUDA = _Cuda()


class _Graph:
    """One capture: the graph, its static inputs by leaf index, its outputs
    (a static tensor, or the index of the state leaf it returns), the
    launches a replay adds, weak references to its state and the
    generators it draws from."""

    def __init__(self, graph, inputs, out_spec, outputs, launches, state,
                 generators):
        self.graph = graph
        self.inputs = inputs
        self.out_spec = out_spec
        self.outputs = outputs
        self.launches = launches
        self.state = [weakref.ref(t) for t in state]
        # held: the signature keys a generator by its id
        self.generators = generators

    def alive(self) -> bool:
        return all(r() is not None for r in self.state)


class GraphedStep:
    """A step unit: :meth:`eager` is its body; calling the unit runs the
    body on CPU tensors and replays its CUDA graph on CUDA tensors (see the
    module docstring). ``cache_arg``: the index of the caches argument."""

    cache_arg = None

    def __init__(self, model):
        self._model = model
        self._graphs: OrderedDict = OrderedDict()
        self._plans: dict = {}      # signature -> state leaf indices
        # the weights the graphs read: the tensors, their fingerprint and
        # the registration count when it was taken
        self._tensors, self._weights, self._seen = [], None, -1
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def eager(self, *args):
        raise NotImplementedError

    def prepare(self, device) -> None:
        """Make what the body keeps beyond a call (tables it caches, state
        per stream), before the warm-ups: called on the capture stream,
        outside the graph pool. The warm-ups allocate from the pool, whose
        free blocks earlier graphs of the model write when they replay, so
        anything made there and kept would be overwritten."""

    def refresh_weights(self) -> None:
        """Drop the graphs when a parameter or buffer they read has been
        replaced (the model's current weights, as JAX re-reads them). The
        whole fingerprint is taken again only after a registration
        somewhere in the process; else the addresses of the tensors read
        are compared."""
        if not self._graphs:
            return
        if self._seen == _registrations[0] and all(
                t.data_ptr() == w[0]
                for t, w in zip(self._tensors, self._weights)):
            return
        self._take_weights()

    def _take_weights(self) -> None:
        """Fingerprint the model's weights; a changed one drops the
        graphs."""
        _watch_registrations()
        self._seen = _registrations[0]
        self._tensors, weights = weights_of(self._model)
        if weights != self._weights:
            self._graphs.clear()
            self._weights = weights

    def __call__(self, *args):
        leaves, spec = flatten(args)
        device = _CUDA.device_of(leaves, type(self).__name__)
        if device is None:
            return self.eager(*args)
        with torch.inference_mode():
            sig = (spec, device, tuple(_leaf_key(x) for x in leaves))
            graph = None
            state = self._plans.get(sig)
            if state is not None:
                key = (sig, tuple(leaves[i].data_ptr() for i in state))
                graph = self._graphs.get(key)
                if graph is not None and not graph.alive():
                    del self._graphs[key]
                    graph = None
            if graph is None:
                graph = self._capture(sig, args, leaves, spec, device)
            else:
                self._graphs.move_to_end(key)
            return self._replay(graph, leaves)

    # ------------------------------------------------------------------
    def _drop_dead(self) -> None:
        for key in [k for k, g in self._graphs.items() if not g.alive()]:
            del self._graphs[key]

    def _state_of(self, args, leaves, out_leaves):
        """Indices of the cache argument's tensors that the body returned as
        the objects it was given."""
        if self.cache_arg is None:
            return ()
        lo = len(flatten(args[:self.cache_arg])[0])
        hi = lo + len(flatten(args[self.cache_arg])[0])
        returned = {id(x) for x in out_leaves if isinstance(x, torch.Tensor)}
        return tuple(i for i in range(lo, hi)
                     if isinstance(leaves[i], torch.Tensor)
                     and id(leaves[i]) in returned)

    def _capture(self, sig, args, leaves, spec, device):
        """Warm-ups and capture of a new graph. One that fails (out of
        memory in a warm-up or in the capture) keeps no graph, so nothing
        broken is ever replayed, and gives the launch counts back; the
        next call of the signature captures anew."""
        with DEVICE_LOCK:
            before = Counter(_build.launches)
            try:
                return self._capture_new(sig, args, leaves, spec, device,
                                         before)
            except BaseException:
                _build.launches.clear()
                _build.launches.update(before)
                raise

    def _capture_new(self, sig, args, leaves, spec, device, before):
        t0 = time.perf_counter()
        self._take_weights()
        gens = [i for i, x in enumerate(leaves)
                if isinstance(x, torch.Generator)]
        cur = _CUDA.current_stream(device)
        side = _CUDA.side_stream(device)
        side.wait_stream(cur)
        with _CUDA.use(side):
            self.prepare(device)
        with _CUDA.use(side), _CUDA.warm(self._model), _build.unit_scope():
            for _ in range(WARMUP_RUNS):
                warm = list(leaves)
                for i in gens:
                    warm[i] = torch.Generator(device=device)
                out = self.eager(*unflatten(spec, warm))
        state = self._plans.get(sig)
        if state is None:
            state = self._plans[sig] = self._state_of(args, leaves,
                                                      flatten(out)[0])
        del out, warm
        inputs = [(i, x.clone()) for i, x in enumerate(leaves)
                  if isinstance(x, torch.Tensor) and i not in state]
        cap = list(leaves)
        for i, st in inputs:
            cap[i] = st
        graph = _CUDA.new_graph()
        for i in gens:
            graph.register_generator_state(leaves[i])
        side.wait_stream(cur)
        mark = Counter(_build.launches)
        with _CUDA.use(side), _build.unit_scope():
            out = _CUDA.record(graph, _CUDA.pool(self._model),
                               lambda: self.eager(*unflatten(spec, cap)))
        cur.wait_stream(side)
        launches = capture_count(mark, _build.launches)
        _build.launches.clear()
        _build.launches.update(before)
        out_leaves, out_spec = flatten(out)
        index = {id(leaves[i]): i for i in state}
        outputs = []
        for x in out_leaves:
            i = index.get(id(x)) if isinstance(x, torch.Tensor) else None
            outputs.append((True, i) if i is not None else (False, x))
        g = _Graph(graph, inputs, out_spec, outputs, launches,
                   [leaves[i] for i in state], [leaves[i] for i in gens])
        key = (sig, tuple(leaves[i].data_ptr() for i in state))
        self._drop_dead()
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
        self._graphs[key] = g
        side.synchronize()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return g

    def _replay(self, g, leaves):
        dst, src = [], []
        for i, static in g.inputs:
            x = leaves[i]
            if x.data_ptr() != static.data_ptr():
                dst.append(static)
                src.append(x)
        if dst:
            torch._foreach_copy_(dst, src)
        g.graph.replay()
        _build.launches.update(g.launches)
        self.replays += 1
        return unflatten(g.out_spec, [leaves[o] if is_state else o
                                      for is_state, o in g.outputs])
