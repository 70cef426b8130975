"""Shared services of the port (``kvcache``: the device-relation cache;
``sequence``: sequences and AUTO_INCREMENT counters)."""
