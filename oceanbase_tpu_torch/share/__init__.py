"""Shared services of the port (``kvcache``: the device-relation cache;
``sequence``: sequences and AUTO_INCREMENT counters; ``external``:
external tables read at query time; ``vector_index``: exact and
IVF-Flat nearest-neighbour search)."""
