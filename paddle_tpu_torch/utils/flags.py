"""Global flag registry: the port's own copy of
``paddle_tpu/utils/flags.py``.

Every flag is settable through the environment (``FLAGS_xxx=1`` when the
module is imported), :func:`set_flags`, or, for the calling thread only,
:func:`flag_overrides`. The JAX package reads a flag at trace time; the port
runs eagerly, so a flag is read on every call that consults it.

Only the flags some module of the port reads are defined here.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Iterator, Optional


class _Flag:
    __slots__ = ("name", "default", "value", "help", "typ")

    def __init__(self, name, default, help_str):
        self.name = name
        self.default = default
        self.typ = type(default)
        self.help = help_str
        env = os.environ.get(name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, raw):
        if self.typ is bool:
            return str(raw).lower() in ("1", "true", "yes", "on")
        return self.typ(raw)


_REGISTRY: Dict[str, _Flag] = {}

# thread-local overlay: a reader sees its own overrides on top of the
# global registry, which stays untouched for every other thread
_TLS = threading.local()


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _lookup(name: str) -> _Flag:
    key = _key(name)
    if key not in _REGISTRY:
        raise ValueError(f"unknown flag {name!r}")
    return _REGISTRY[key]


def _coerce(f: _Flag, v):
    return f._parse(v) if isinstance(v, str) else f.typ(v)


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    key = _key(name)
    if key not in _REGISTRY:
        _REGISTRY[key] = _Flag(key, default, help_str)


def get_flags(name: Optional[object] = None) -> Dict[str, Any]:
    """str or list of str -> {name: value}; None -> every flag."""
    ov = getattr(_TLS, "overrides", None) or {}
    if name is None:
        return {k: ov.get(k, f.value) for k, f in _REGISTRY.items()}
    names = [name] if isinstance(name, str) else list(name)
    return {n: ov.get(_key(n), _lookup(n).value) for n in names}


@contextlib.contextmanager
def flag_overrides(d: Dict[str, Any]) -> Iterator[None]:
    """Override flags for this thread only, for the with-block. Unknown
    names raise up front; values go through the flag's parser. Nested
    blocks stack and the outer overlay comes back on exit."""
    layer = {}
    for n, v in d.items():
        f = _lookup(n)
        layer[f.name] = _coerce(f, v)
    prev = getattr(_TLS, "overrides", None)
    _TLS.overrides = dict(prev or {}, **layer)
    try:
        yield
    finally:
        _TLS.overrides = prev


def set_flags(d: Dict[str, Any]) -> None:
    """Set flags for every thread (``paddle.set_flags``)."""
    for n, v in d.items():
        f = _lookup(n)
        f.value = _coerce(f, v)


def flag(name: str) -> Any:
    """One flag's value, honouring this thread's overlay."""
    key = _key(name)
    ov = getattr(_TLS, "overrides", None)
    if ov and key in ov:
        return ov[key]
    return _REGISTRY[key].value


define_flag("check_nan_inf", False,
            "check every op output for NaN/Inf (paddle/fluid/eager/nan_inf_utils.cc)")
define_flag("use_fused_decode_tail", False,
            "fuse the decode tail (norm->qkv->rope and o_proj->residual->"
            "norm) into the two kernels of ops/hopper/decode_tail for S=1 "
            "decode steps and the speculative-verify chunk; off = the "
            "discrete kernels")
define_flag("use_autotune", False,
            "search the hooked kernels' geometry (ops/hopper/autotune.py): "
            "an eager call on the card measures each candidate once per "
            "shape and device and persists the winner; a call inside a "
            "step unit's capture reads the cost table only; off = every "
            "kernel's fixed geometry")
define_flag("perturb_decode_token", False,
            "drill for the correctness sentinel: each serving step replaces "
            "the first active slot's first emitted token with (token + 1) "
            "mod vocab (skipping eos) after the host copy, so the reported "
            "stream leaves the model's own; the JAX package drills the "
            "same fault through its chaos point engine.logits")
define_flag("log_memory_stats", False,
            "log live / peak device bytes at each StepTimer step "
            "(observability/timer.py)")
