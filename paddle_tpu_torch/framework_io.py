"""``save`` / ``load`` — counterpart of ``paddle_tpu/framework_io.py``.

Pickled nested containers (dicts, lists, tuples) whose tensors travel as
numpy payloads, bf16 as its ``uint16`` bit view: the JAX package's format.
``load`` also reads a file that ``paddle_tpu.save`` wrote: its unpickler
maps the JAX payload class onto this module's, so nothing of the JAX
package is imported.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

_JAX_PAYLOAD = ("paddle_tpu.framework_io", "_TensorPayload")


class _TensorPayload:
    """Pickle surrogate of a tensor (the JAX package's slots)."""

    __slots__ = ("array", "is_param", "name", "stop_gradient")

    def __init__(self, array, is_param, name, stop_gradient):
        self.array = array
        self.is_param = is_param
        self.name = name
        self.stop_gradient = stop_gradient


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr = ("bf16", t.view(torch.int16).numpy().view(np.uint16))
        else:
            arr = t.numpy()
        return _TensorPayload(arr, isinstance(obj, nn.Parameter), None,
                              not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        arr = obj.array
        bf16 = isinstance(arr, tuple) and arr[0] == "bf16"
        if bf16:
            t = torch.from_numpy(np.ascontiguousarray(arr[1]).view(
                np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        if return_numpy:
            # numpy has no bf16: such a tensor comes back widened to f32
            return t.float().numpy() if bf16 else t.numpy()
        trainable = not obj.stop_gradient and t.is_floating_point()
        if obj.is_param:
            return nn.Parameter(t, requires_grad=trainable)
        return t.requires_grad_(trainable)
    if isinstance(obj, dict):
        return {k: _decode(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_PAYLOAD:
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` (a file name, its directory made if
    needed, or a writable file object); tensors are copied to the host."""
    if hasattr(path, "write"):
        pickle.dump(_encode(obj), path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_encode(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The object ``save`` (or ``paddle_tpu.save``) wrote, with CPU
    tensors (``nn.Parameter`` where a parameter was saved), or numpy
    arrays with ``return_numpy``."""
    if hasattr(path, "read"):
        return _decode(_Unpickler(path).load(), return_numpy)
    with open(path, "rb") as f:
        return _decode(_Unpickler(f).load(), return_numpy)
