"""Distributed building blocks of the port: the MoE routing and
grouped-expert helpers (``moe``) on one device, and context-parallel
attention with a ring's ranks in one process (``context_parallel``)."""
