"""Index-aware point and range lookups over the tablet LSM.

Port of ``oceanbase_tpu/storage/lookup.py``, plus ``live_keys``: the
batched existence test behind primary-key enforcement and REPLACE.

Reference analog: the DAS iterator stack walking index-block B+-trees to
seek micro blocks (src/sql/das/iter/ob_das_iter.h,
src/storage/blocksstable/index_block/ob_index_block_row_scanner.h).  The
TPU build's segments are key-sorted with per-chunk zone maps on the key
columns (see storage/segment.py::sort_rows_by_keys), so a lookup prunes
to the few chunks whose zone ranges cover the key and decodes only those
— a point ``get`` touches O(chunks-holding-key) rows, not the whole
segment.

All work here is host-side numpy: point/small-range operations are
latency-bound, and a device dispatch costs orders of magnitude more than
decoding one 64k-row chunk on the host.
"""

from __future__ import annotations

import numpy as np

from oceanbase_tpu_torch.storage.segment import key_ids


def _base_tablets(tablet, key=None):
    """Resolve the physical tablets a key could live in."""
    parts = getattr(tablet, "partitions", None)
    if parts is None:
        return [tablet]
    if key is not None:
        t = tablet._route_key(key)
        if t is not None:
            return [t]
    return list(parts)


def _chunk_mask(seg, ranges: dict):
    """AND of per-column zone-map prunes; None -> nothing survives."""
    cm = np.ones(seg.n_chunks, dtype=bool)
    for col, (lo, hi) in ranges.items():
        cm &= seg.prune_chunks(col, lo, hi)
    if not cm.any():
        return None
    return cm


def estimate_rows_in_ranges(tablet, ranges: dict) -> int:
    """Upper bound on rows a pruned scan would decode (zone-map metadata
    only — no decode).  Feeds the access-path cost decision."""
    total = 0
    for t in _base_tablets(tablet):
        sub = {k: v for k, v in ranges.items() if k in t.key_cols}
        for seg in t.segments:
            if not sub:
                total += seg.n_rows
                continue
            cm = _chunk_mask(seg, sub)
            if cm is None:
                continue
            any_col = next(iter(seg.columns.values()))
            total += sum(any_col[i].n for i in np.nonzero(cm)[0])
        total += len(t.active) + sum(len(m) for m in t.frozen)
    return total


_INF = 2**62


def _tablet_newest(t, key: tuple, snapshot: int, tx_id: int):
    """Newest visible version of ``key`` in one physical tablet ->
    (commit_version, row-values | None-if-tombstone, found)."""
    for mt in [t.active] + t.frozen[::-1]:
        v = mt.visible_version(key, snapshot, tx_id)
        if v is not None:
            # own uncommitted writes (commit_version 0) are newest of all
            ver = v.commit_version or _INF
            row = None if v.op == "delete" else dict(v.values)
            return ver, row, True
    ranges = {kc: (kv, kv) for kc, kv in zip(t.key_cols, key)
              if kv is not None}
    best = None
    best_ver = -1
    found = False
    for seg in t.segments[::-1]:
        if seg.min_version > snapshot:
            continue
        cm = _chunk_mask(seg, ranges) if ranges else \
            np.ones(seg.n_chunks, dtype=bool)
        if cm is None:
            continue
        arrays, valids = seg.decode(chunk_mask=None if cm.all() else cm)
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n == 0:
            continue
        sel = np.ones(n, dtype=bool)
        for kc, kv in zip(t.key_cols, key):
            col = arrays[kc]
            vd = valids.get(kc)
            if kv is None:
                sel &= (~vd if vd is not None
                        else np.zeros(n, dtype=bool))
            else:
                sel &= col == kv
                if vd is not None:
                    sel &= vd
        if "__version__" in arrays:
            sel &= arrays["__version__"] <= snapshot
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        vers = arrays.get("__version__")
        i = idx[-1] if vers is None else idx[np.argmax(vers[idx])]
        ver = int(vers[i]) if vers is not None else seg.max_version
        if ver > best_ver:
            best_ver = ver
            found = True
            if arrays.get("__deleted__") is not None and \
                    arrays["__deleted__"][i]:
                best = None
            else:
                row = {}
                for c in t.columns:
                    if c not in arrays:
                        continue
                    vd = valids.get(c)
                    row[c] = (None if vd is not None and not vd[i]
                              else arrays[c][i].item()
                              if hasattr(arrays[c][i], "item")
                              else arrays[c][i])
                best = row
    return best_ver, best, found


def point_lookup(tablet, key: tuple, snapshot: int, tx_id: int = 0):
    """Newest visible row for ``key`` -> values dict | None (absent or
    deleted).

    Memtables are probed newest-first (their versions are strictly newer
    than flushed segments for the same key); segments are probed with
    zone-map pruning on every key column, decoding only surviving chunks.
    When the key cannot be routed to one partition, EVERY candidate
    partition is consulted and the newest version wins — a
    partition-moving update leaves a tombstone in the old partition and a
    live row (same commit version) in the new one, and the live row must
    win the tie."""
    best_ver = -1
    best = None
    for t in _base_tablets(tablet, key):
        ver, row, found = _tablet_newest(t, key, snapshot, tx_id)
        if not found:
            continue
        if ver > best_ver or (ver == best_ver and row is not None):
            best_ver = ver
            best = row
    return best


def range_rows(tablet, ranges: dict, snapshot: int, tx_id: int = 0,
               columns=None):
    """All live rows whose key columns fall in ``ranges`` (inclusive) ->
    (arrays, valids).  Built on the pruned snapshot read, then exactly
    filtered — the result is snapshot-consistent, not a superset."""
    sub = {k: v for k, v in ranges.items()
           if k in tablet.key_cols or k == getattr(tablet, "part_col", None)}
    arrays, valids = tablet.snapshot_arrays(snapshot, tx_id, prune=sub)
    n = len(next(iter(arrays.values()))) if arrays else 0
    if n == 0:
        return arrays, valids
    sel = np.ones(n, dtype=bool)
    for col, (lo, hi) in ranges.items():
        a = arrays[col]
        vd = valids.get(col)
        if vd is not None:
            sel &= vd
        if lo is not None:
            sel &= a >= lo
        if hi is not None:
            sel &= a <= hi
    names = columns if columns is not None else list(arrays)
    return ({c: arrays[c][sel] for c in names},
            {c: (valids[c][sel] if valids.get(c) is not None else None)
             for c in names})


def live_keys(tablet, keys, snapshot: int, tx_id: int = 0) -> set:
    """The keys among ``keys`` (tuples) that hold a live version visible
    at ``snapshot`` (``tx_id``'s own writes included), in the memtables
    OR the segments: the existence test behind primary-key enforcement
    and REPLACE.

    The same answer as ``point_lookup(...) is not None`` per key, for a
    whole statement at once: memtables are probed per key (a dict get),
    and each segment decodes its key columns once, from the chunks whose
    zone maps overlap the batch's key envelope; ``segment.key_ids``
    matches the decoded rows to the batch."""
    keys = list(dict.fromkeys(tuple(k) for k in keys))
    n = len(keys)
    if n == 0:
        return set()
    gb_ver = np.full(n, -1, dtype=np.int64)
    gb_live = np.zeros(n, dtype=bool)
    groups: dict = {}
    for i, k in enumerate(keys):
        for t in _base_tablets(tablet, k):
            groups.setdefault(id(t), (t, []))[1].append(i)
    for t, idx in groups.values():
        idx = np.asarray(idx, dtype=np.int64)
        ver, live, found = _tablet_versions(t, [keys[i] for i in idx],
                                            snapshot, tx_id)
        # across partitions the newest wins, a tie goes to the live row
        better = found & ((ver > gb_ver[idx])
                          | ((ver == gb_ver[idx]) & live))
        gb_ver[idx[better]] = ver[better]
        gb_live[idx[better]] = live[better]
    return {keys[i] for i in np.nonzero(gb_live)[0]}


def _tablet_versions(t, keys: list, snapshot: int, tx_id: int):
    """``_tablet_newest`` of each key in one physical tablet, batched ->
    (version, live, found) arrays over ``keys``."""
    n = len(keys)
    ver = np.full(n, -1, dtype=np.int64)
    live = np.zeros(n, dtype=bool)
    found = np.zeros(n, dtype=bool)
    rest = []
    for i, k in enumerate(keys):
        for mt in [t.active] + t.frozen[::-1]:
            v = mt.visible_version(k, snapshot, tx_id)
            if v is not None:
                # own uncommitted writes (commit_version 0) are newest
                ver[i] = v.commit_version or _INF
                live[i] = v.op != "delete"
                found[i] = True
                break
        else:
            if any(x is None for x in k):
                # a NULL key part: the per-key path matches NULLs
                vv, row, f = _tablet_newest(t, k, snapshot, tx_id)
                ver[i], live[i], found[i] = vv, row is not None, f
            else:
                rest.append(i)
    if not rest or not t.segments:
        return ver, live, found
    rest = np.asarray(rest, dtype=np.int64)
    kc = t.key_cols
    q = [_as_array([keys[i][j] for i in rest]) for j in range(len(kc))]
    ranges = {c: (min(a.tolist()), max(a.tolist())) for c, a in zip(kc, q)}
    qn = len(rest)
    for seg in t.segments[::-1]:
        if seg.min_version > snapshot:
            continue
        cm = _chunk_mask(seg, ranges)
        if cm is None:
            continue
        meta = [c for c in ("__deleted__", "__version__")
                if c in seg.columns]
        a, vd = seg.decode(names=list(kc) + meta,
                           chunk_mask=None if cm.all() else cm)
        m = len(a[kc[0]])
        if m == 0:
            continue
        sel = np.ones(m, dtype=bool)
        for c in kc:
            if vd.get(c) is not None:
                sel &= vd[c]
        if "__version__" in a:
            sel &= a["__version__"] <= snapshot
        rows = np.nonzero(sel)[0]
        if len(rows) == 0:
            continue
        ids = key_ids([np.concatenate([qa, _as_array(a[c][rows])])
                       for qa, c in zip(q, kc)])
        qid, sid = ids[:qn], ids[qn:]
        hit = np.isin(sid, qid)
        if not hit.any():
            continue
        rows, sid = rows[hit], sid[hit]
        vers = (a["__version__"][rows].astype(np.int64)
                if "__version__" in a
                else np.full(len(rows), seg.max_version, dtype=np.int64))
        dele = (a["__deleted__"][rows].astype(bool)
                if "__deleted__" in a else np.zeros(len(rows), dtype=bool))
        # per key: the row ``_tablet_newest`` takes in this segment (the
        # first of its largest version; the last row when unversioned)
        tie = np.arange(len(rows))
        order = np.lexsort((tie if "__version__" in a else -tie, -vers,
                            sid))
        first = np.ones(len(order), dtype=bool)
        first[1:] = sid[order][1:] != sid[order][:-1]
        pick = order[first]
        qorder = np.argsort(qid, kind="stable")
        at = rest[qorder[np.searchsorted(qid[qorder], sid[pick])]]
        # segments newest first: an equal version never replaces
        better = vers[pick] > ver[at]
        at, pick = at[better], pick[better]
        ver[at] = vers[pick]
        live[at] = ~dele[pick]
        found[at] = True
    return ver, live, found


def _as_array(values) -> np.ndarray:
    """Key values as one comparable array (strings as objects)."""
    a = np.asarray(values)
    return a.astype(object) if a.dtype.kind in "USO" else a
