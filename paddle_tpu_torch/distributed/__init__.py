"""Distributed building blocks of the port; so far the MoE routing and
grouped-expert helpers (``moe``) on one device."""
