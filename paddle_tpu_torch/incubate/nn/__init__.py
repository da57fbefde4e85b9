"""paddle.incubate.nn: its functional module (memory-efficient
attention)."""
from . import functional  # noqa: F401
