"""paddle.incubate's preview APIs ported so far: the memory-efficient
attention of ``incubate.nn.functional``."""
from . import nn  # noqa: F401
