"""Kernels of the port (``ops.hopper``: hand-written CUDA for Hopper)."""
