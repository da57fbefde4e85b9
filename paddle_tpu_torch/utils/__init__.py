"""Host-side utilities of the port (the flag registry)."""
