"""Shared services of the port (``kvcache``: the device-relation cache)."""
