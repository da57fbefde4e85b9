"""Hand-written Hopper (sm_90a) kernels, one module per Pallas counterpart
in ``paddle_tpu/ops/pallas``. Each wrapper runs its plain PyTorch version
on a CPU tensor and launches its CUDA kernel (built at first use by
``_build``) on a CUDA tensor."""
from ._build import launches, reset_launches  # noqa: F401
