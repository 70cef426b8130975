"""Bounded KV cache with LRU eviction and hit statistics.

Port of ``oceanbase_tpu/share/kvcache.py``: the cached values are the
port's device relations, so ``relation_bytes`` counts tensor bytes
(``numel() * element_size()``).

Reference analog: the KV storecache framework
(src/share/cache/ob_kv_storecache.h:91) behind the block/row caches —
here one engine-wide cache holds device-resident Relations (the block
cache analog: decoded, dictionary-encoded columns living in HBM), with a
byte budget, LRU eviction, and v$kvcache-visible counters.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


def relation_bytes(rel) -> int:
    """Approximate bytes a cached Relation pins: its tensors, plus the
    host arrays of its string dictionaries."""
    total = 0
    for c in rel.columns.values():
        total += c.data.numel() * c.data.element_size()
        if c.valid is not None:
            total += c.valid.numel() * c.valid.element_size()
        if c.sdict is not None:
            total += int(getattr(c.sdict.values, "nbytes", 0))
    if rel.mask is not None:
        total += rel.mask.numel() * rel.mask.element_size()
    return int(total)


class KvCache:
    def __init__(self, limit_bytes: int = 2 << 30, name: str = "block"):
        self.name = name
        self.limit_bytes = limit_bytes
        self._map: OrderedDict = OrderedDict()  # key -> (bytes, value)
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0

    def get(self, key):
        with self._lock:
            hit = self._map.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)  # LRU touch
            self.hits += 1
            return hit[1]

    def put(self, key, value, nbytes: int | None = None):
        if nbytes is None:
            nbytes = relation_bytes(value)
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= old[0]
            # a single over-budget value is not cacheable
            if nbytes > self.limit_bytes:
                return
            self._map[key] = (nbytes, value)
            self._bytes += nbytes
            self.puts += 1
            while self._bytes > self.limit_bytes and self._map:
                _k, (b, _v) = self._map.popitem(last=False)
                self._bytes -= b
                self.evictions += 1

    def invalidate(self, key=None):
        with self._lock:
            if key is None:
                self._map.clear()
                self._bytes = 0
            else:
                old = self._map.pop(key, None)
                if old is not None:
                    self._bytes -= old[0]

    def resize(self, limit_bytes: int):
        with self._lock:
            self.limit_bytes = limit_bytes
            while self._bytes > self.limit_bytes and self._map:
                _k, (b, _v) = self._map.popitem(last=False)
                self._bytes -= b
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "entries": len(self._map),
                "bytes": self._bytes,
                "limit_bytes": self.limit_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "puts": self.puts,
            }
