"""External merge sort: ORDER BY over inputs larger than host memory.

The port's copy of ``oceanbase_tpu/exec/external_sort.py`` (host numpy,
line for line).  Reference analog: the vectorized sort operator's
dump/merge path (src/sql/engine/sort/ob_sort_vec_op.h — in-memory
quicksort runs dumped to tmp files, then a k-way merge).  Two phases,
columnar and vectorized:

1. RUN BUILD — input chunks accumulate up to ``budget_rows``, the slab
   sorts with numpy lexsort (per-key direction + MySQL NULL placement),
   and spills as one sorted run of column chunks (storage/tmpfile.py).
2. MERGE — runs merge pairwise (log2(runs) passes).  The 2-way merge is
   chunk-vectorized: both buffers concatenate + lexsort, and every row
   ordered <= min(tail(A), tail(B)) is emitted in one slice — no
   row-at-a-time heap walk.

NULL rule: NULL sorts smallest (first under ASC, last under DESC),
matching exec/ops.py::_sort_key_arrays.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from oceanbase_tpu_torch.storage.tmpfile import TempFileStore

DEFAULT_OUT_CHUNK = 1 << 16


def _null_rank(valid, asc: bool, n: int) -> np.ndarray:
    """More-major lexsort lane placing NULLs per MySQL rule."""
    if valid is None:
        return np.zeros(n, dtype=np.int8)
    return np.where(valid, 0, -1 if asc else 1).astype(np.int8)


def _slab_order(arrays, valids, key_cols: Sequence[str],
                ascending: Sequence[bool]) -> np.ndarray:
    """Sort permutation of an in-memory slab (minor..major lexsort).
    String DESC uses slab-local factorization (codes are only compared
    within this slab, so locality is fine)."""
    n = len(next(iter(arrays.values())))
    lanes = []
    for col, asc in zip(reversed(key_cols), reversed(list(ascending))):
        a = arrays[col]
        if a.dtype == object or a.dtype.kind in "US":
            uniq, codes = np.unique(a.astype("U"), return_inverse=True)
            a = codes.astype(np.int64)
        elif a.dtype == np.bool_:
            a = a.astype(np.int8)
        if not asc:
            # widen before negating: -INT32_MIN wraps silently (DATE
            # columns are int32), matching ops._sort_key_arrays
            a = (-a.astype(np.float64) if a.dtype.kind == "f"
                 else -a.astype(np.int64))
        lanes.append(a)
        lanes.append(_null_rank(valids.get(col), asc, n))
    # reversed() above put the minor key first; null rank is more major
    # than its value lane, so it appends after
    return np.lexsort(tuple(lanes))


def _lex_le(key_arrays, valid_arrays, ascending, thresh) -> np.ndarray:
    """Vectorized row <= thresh under the multi-key ordering.
    ``thresh`` is a tuple of (is_null, is_nan, value) per key.

    Order per key: ASC = NULL, values, NaN; DESC = values (desc), NaN,
    NULL — matching np.lexsort (NaN last in both directions) composed
    with the _null_rank lane."""
    n = len(key_arrays[0])
    lt = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for (a, v, asc), (t_null, t_nan, t_val) in zip(
            zip(key_arrays, valid_arrays, ascending), thresh):
        isnull = ~v if v is not None else np.zeros(n, dtype=bool)
        isnan = (np.isnan(a) & ~isnull if a.dtype.kind == "f"
                 else np.zeros(n, dtype=bool))
        if t_null:
            # threshold is NULL. ASC: NULL sorts first, so nothing is
            # strictly before it.  DESC: NULL sorts last, so every
            # non-NULL row (NaN included) precedes it.
            a_lt = np.zeros(n, dtype=bool) if asc else ~isnull
            a_eq = isnull
        elif t_nan:
            # threshold is NaN: last among non-NULLs in both directions.
            # ASC: NULLs and all non-NaN values precede it.  DESC: only
            # non-NaN values do (NULLs sort after NaN).
            a_lt = ~isnan if asc else ~isnan & ~isnull
            a_eq = isnan
        else:
            with np.errstate(invalid="ignore"):
                raw_lt = a < t_val if asc else a > t_val
                raw_eq = a == t_val
            # a NULL row precedes any non-NULL threshold under ASC,
            # never under DESC; a NaN row never precedes a real value
            # (NaN comparisons are already False)
            a_lt = np.where(isnull, asc, raw_lt)
            a_eq = np.where(isnull, False, raw_eq)
        lt |= eq & a_lt
        eq &= a_eq
    return lt | eq


def _row_key(arrays, valids, key_cols, i):
    """-> ((is_null, is_nan, value), ...) per key.  np.lexsort orders NaN
    strictly LAST among non-NULL values for ASC and (negated-lane) DESC
    alike — NaN gets its own comparator rank so the merge comparators
    agree exactly (collapsing NaN into ±inf would tie it with real
    infinities that lexsort does NOT tie)."""
    out = []
    for c in key_cols:
        v = valids.get(c)
        if v is not None and not v[i]:
            out.append((True, False, None))
        else:
            x = arrays[c][i]
            x = x.item() if hasattr(x, "item") else x
            isnan = isinstance(x, float) and x != x
            out.append((False, isnan, None if isnan else x))
    return tuple(out)


def _concat(parts_a, parts_v, cols):
    arrays = {}
    valids = {}
    for c in cols:
        chunks = [p[c] for p in parts_a]
        if any(x.dtype == object for x in chunks):
            chunks = [x.astype(object) for x in chunks]
        arrays[c] = np.concatenate(chunks)
        if any(v.get(c) is not None for v in parts_v):
            valids[c] = np.concatenate(
                [v[c] if v.get(c) is not None
                 else np.ones(len(a[c]), dtype=bool)
                 for v, a in zip(parts_v, parts_a)])
    return arrays, valids


def _merge_two(store: TempFileStore, a_id: int, b_id: int, cols,
               key_cols, ascending, out_chunk: int) -> int:
    """2-way merge of sorted runs -> new sorted run (chunk-vectorized).

    Loop invariant: BA/BB are sorted buffers whose un-emitted rows are
    the smallest not-yet-output rows of their side.  Each round merges
    both buffers, emits every row <= min(tail(BA), tail(BB)) — such rows
    can never be preceded by unseen input — and carries the remainder as
    the surviving side's buffer while the fully-drained side refills."""
    out_id = store.new_run()
    it_a = store.read_chunks(a_id)
    it_b = store.read_chunks(b_id)

    def flush(arrays, valids, order):
        for s in range(0, len(order), out_chunk):
            sel = order[s:s + out_chunk]
            store.append_chunk(
                out_id,
                {c: arrays[c][sel] for c in cols},
                {c: valids[c][sel] for c in valids})

    BA = BB = None
    while True:
        if BA is None:
            BA = next(it_a, None)
        if BB is None:
            BB = next(it_b, None)
        if BA is None and BB is None:
            break
        if BB is None or BA is None:
            buf, it = (BA, it_a) if BB is None else (BB, it_b)
            while buf is not None:
                arrays, valids = buf
                flush(arrays, valids,
                      np.arange(len(next(iter(arrays.values())))))
                buf = next(it, None)
            break
        (aa, av), (ba, bv) = BA, BB
        ta = _row_key(aa, av, key_cols,
                      len(next(iter(aa.values()))) - 1)
        tb = _row_key(ba, bv, key_cols,
                      len(next(iter(ba.values()))) - 1)
        a_smaller = _key_le(ta, tb, ascending)
        thr = ta if a_smaller else tb
        arrays, valids = _concat([aa, ba], [av, bv], cols)
        order = _slab_order(arrays, valids, key_cols, ascending)
        karrs, varrs = [], []
        for c in key_cols:
            a = arrays[c]
            karrs.append(a.astype("U") if a.dtype == object else a)
            varrs.append(valids.get(c))
        emit_mask = _lex_le(karrs, varrs, ascending, thr)
        emit = order[emit_mask[order]]
        keep = order[~emit_mask[order]]
        flush(arrays, valids, emit)
        kept = None
        if len(keep):
            kept = ({c: arrays[c][keep] for c in cols},
                    {c: valids[c][keep] for c in valids})
        # the side whose tail WAS the threshold is fully emitted (all
        # its rows <= its tail); the remainder belongs to the other
        # side.  None triggers a refill from the run at the loop top.
        if a_smaller:
            BA = None
            BB = kept
        else:
            BB = None
            BA = kept
    store.close_run(a_id)
    store.close_run(b_id)
    return out_id


def _key_le(ta, tb, ascending) -> bool:
    for (an, anan, av), (bn, bnan, bv), asc in zip(ta, tb, ascending):
        if an and bn:
            continue
        if an or bn:
            # NULL smallest in ASC sense; flips under DESC
            smaller_is_a = an if asc else bn
            return smaller_is_a
        if anan and bnan:
            continue
        if anan or bnan:
            return bnan  # NaN sorts last in both directions
        if av == bv:
            continue
        return (av < bv) if asc else (av > bv)
    return True


def external_sort(
    chunks: Iterator, key_cols: Sequence[str],
    ascending: Sequence[bool] | None, store: TempFileStore,
    budget_rows: int, out_chunk: int = DEFAULT_OUT_CHUNK,
):
    """Sort a stream of (arrays, valids) chunks -> yields sorted chunks.

    Peak host memory ~= budget_rows plus two merge buffers; everything
    else lives in the temp-file store."""
    chunks = iter(chunks)
    first = next(chunks, None)
    if first is None:
        return
    cols = list(first[0])
    if ascending is None:
        ascending = [True] * len(key_cols)

    # phase 1: sorted runs of <= budget_rows
    run_ids = []
    slab_a: list = []
    slab_v: list = []
    slab_rows = 0

    def spill_slab():
        nonlocal slab_rows
        if not slab_a:
            return
        arrays, valids = _concat(slab_a, slab_v, cols)
        order = _slab_order(arrays, valids, key_cols, ascending)
        rid = store.new_run()
        n = len(order)
        for s in range(0, n, out_chunk):
            sel = order[s:s + out_chunk]
            store.append_chunk(rid, {c: arrays[c][sel] for c in cols},
                              {c: valids[c][sel] for c in valids})
        run_ids.append(rid)
        slab_a.clear()
        slab_v.clear()
        slab_rows = 0

    item = first
    while item is not None:
        arrays, valids = item
        n = len(next(iter(arrays.values()))) if arrays else 0
        if n:
            slab_a.append(arrays)
            slab_v.append(valids or {})
            slab_rows += n
            if slab_rows >= budget_rows:
                spill_slab()
        item = next(chunks, None)
    spill_slab()

    if not run_ids:
        return
    # phase 2: pairwise merge passes
    while len(run_ids) > 1:
        nxt = []
        for i in range(0, len(run_ids) - 1, 2):
            nxt.append(_merge_two(store, run_ids[i], run_ids[i + 1],
                                  cols, key_cols, ascending, out_chunk))
        if len(run_ids) % 2:
            nxt.append(run_ids[-1])
        run_ids = nxt

    final = run_ids[0]
    for arrays, valids in store.read_chunks(final):
        yield arrays, valids
    store.close_run(final)
