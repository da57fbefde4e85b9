"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

Every ``paddle_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` into its
own shared library at first use on CUDA, all sources in parallel, into
``build/hopper/<hash of sources, csrc/*.cuh headers and flags>/`` at the
root of the checkout (listed in ``.gitignore``). The sources include no
PyTorch header, so a build takes seconds. Nothing is built when this
module is imported, so ``import paddle_tpu_torch`` works on a machine with
no ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises when that is not 0 (a refused launch never runs, and
a later synchronize would not report it).

``launches`` counts kernel launches by wrapper name. A wrapper adds one
exactly where it launches its kernel, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "hopper"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Counter = Counter()

_lock = threading.Lock()
_libs: dict = {}
_functions: dict = {}
# what the last build did: seconds, and each source's ptxas report
build_info: dict = {}


def reset_launches() -> None:
    launches.clear()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are compiled at first use on a machine with the "
                       "CUDA toolkit (set CUDA_HOME)")


def build() -> dict:
    """Compile every source whose library is missing, all at once; return
    {source stem: library path}."""
    with _lock:
        out_dir = build_dir()
        libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources()}
        todo = {stem: p for stem, p in libs.items() if not p.is_file()}
        if not todo:
            return libs
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for stem, lib in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_info.setdefault("ptxas", {})[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu:\n{log}")
            else:
                os.replace(tmp, todo[stem])
        build_info["seconds"] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return libs


def function(stem: str, name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/<stem>.cu``, built and loaded on first
    call, with its argument types set (every pointer and the stream are
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    key = (stem, name)
    fn = _functions.get(key)
    if fn is None:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build()[stem]))
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(code: int, stem: str, what: str) -> None:
    if code != 0:
        msg = _libs[stem].pt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} "
                           f"({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_sm_counts: dict = {}


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, as an int (a
    ``c_void_p`` argument takes it), without building a ``Stream``."""
    import torch

    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``, read once."""
    n = _sm_counts.get(device)
    if n is None:
        import torch

        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n
    return n


VOIDP, INT, INT64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16: the two types the kernels take."""
    import torch

    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def needs_grad(*tensors) -> bool:
    """Whether autograd records a graph through these inputs."""
    import torch

    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_no_grad(what: str, *tensors) -> None:
    """A kernel with no backward refuses inputs that need a gradient: its
    output would carry no ``grad_fn`` and cut the graph silently."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} on CUDA has no backward; call it on tensors that need "
            "no gradient (serving runs under torch.inference_mode())")


def require_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if (t is not tensors[0] and t.device != dev) or dev.type != "cuda":
            raise ValueError(
                f"kernel inputs must all lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
