"""paddle.incubate.nn: its functional module (memory-efficient
attention, and ``fused_moe``, which raises as in the JAX package)."""
from . import functional  # noqa: F401
