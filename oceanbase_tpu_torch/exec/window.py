"""Window functions on torch tensors.

Port of ``oceanbase_tpu/exec/window.py``.  One lexsort by (partition
keys, order keys), then every supported function is a segment-scan over
the sorted order, and the results scatter back to the original row
order:

- ``row_number``, ``rank``, ``dense_rank``, ``ntile``: positions and
  order-key-change boundaries (``cummax`` / ``cumsum``);
- ``lead``/``lag`` (offset, default), ``first_value``/``last_value``
  under the default frame or a ROWS frame: clamped gathers;
- ``sum``/``avg``/``count``/``count(*)``/``min``/``max``: a segment
  reduce broadcast back (no ORDER BY), a running prefix with RANGE peer
  smearing (ORDER BY, MySQL's default frame), or an explicit ROWS frame
  (prefix differences; a sparse table for min and max).

How the JAX primitives map:

- ``jnp.lexsort``             -> ``ops.lexsort`` (chained stable sorts);
- ``jnp.argsort(order)``      -> a scatter of ``arange`` (the inverse
  permutation, exact, no second sort);
- ``associative_scan(max)``   -> ``torch.cummax``;
- the segmented min/max scan  -> ``_segmented_scan``, a log-step
  (Hillis-Steele) scan over (value, partition-start) pairs with the
  reference's combine, so NaN propagates as it does there;
- ``segment_min/max/sum``     -> ``ops._segment_minmax`` / ``segment_sum``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.exec.ops import (
    _agg_identity,
    _arange,
    _neq_prev,
    _scalar,
    _segment_minmax,
    lexsort,
    merge_dicts,
    segment_sum,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import cast_column, eval_expr
from oceanbase_tpu_torch.vector.column import Column, Relation, take


def window(rel: Relation, specs: Sequence[tuple]) -> Relation:
    """specs: [(out_name, ir.WindowCall)]; returns rel + result columns."""
    out_cols = dict(rel.columns)
    for name, wc in specs:
        out_cols[name] = _one_window(rel, wc)
    return Relation(columns=out_cols, mask=rel.mask)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _segmented_scan(x: torch.Tensor, flags: torch.Tensor, op):
    """Inclusive scan of ``op`` that restarts where ``flags`` is set:
    log2(n) steps, each combining lane i with lane i - d as
    ``(b.flag ? b.v : op(a.v, b.v), a.flag | b.flag)``."""
    v, f = x, flags
    n = x.shape[0]
    d = 1
    while d < n:
        bv, bf = v[d:], f[d:]
        nv = torch.where(bf, bv, op(v[:-d], bv))
        nf = f[:-d] | bf
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def _one_window(rel: Relation, wc: ir.WindowCall) -> Column:
    n = rel.capacity
    m = rel.mask_or_true()
    dev = m.device
    part_cols = [eval_expr(e, rel) for e in (wc.partition_by or [])]
    order_cols = [(eval_expr(e, rel), asc) for e, asc in (wc.order_by or [])]

    # lexsort: dead last, then partition keys, then order keys
    minor_to_major = []
    for c, asc in reversed(order_cols):
        d = c.data.to(torch.int64) if c.data.dtype == torch.bool else c.data
        if not asc:
            d = -d
        minor_to_major.append(d)
        if c.valid is not None:
            minor_to_major.append(torch.where(
                c.valid, _scalar(0, d, torch.int8),
                _scalar(-1 if asc else 1, d, torch.int8)))
    part_data = []
    for c in part_cols:
        d = c.data
        if c.valid is not None:
            d = torch.where(c.valid, d, _scalar(0, d))
        part_data.append(d)
    for c, d in reversed(list(zip(part_cols, part_data))):
        minor_to_major.append(d)
        if c.valid is not None:
            minor_to_major.append((~c.valid).to(torch.int8))
    minor_to_major.append((~m).to(torch.int8))
    order = lexsort(minor_to_major)
    pos = _arange(n, dev)
    inv = torch.empty_like(order).scatter_(0, order, pos)  # scatter-back
    s_live = take(m, order)

    # partition boundaries in sorted order
    new_part = torch.zeros(n, dtype=torch.bool, device=dev)
    new_part[:1] = True
    for c, d in zip(part_cols, part_data):
        new_part = new_part | _neq_prev(take(d, order))
        if c.valid is not None:
            new_part = new_part | _neq_prev(take(c.valid, order))
    part_id = torch.cumsum(new_part.to(torch.int64), 0) - 1
    part_start = _segment_minmax("min", pos, part_id, n)
    start_of_row = take(part_start, part_id)
    pos_in_part = pos - start_of_row

    # order-key change boundaries ("peers" share rank / frame values)
    new_peer = new_part
    for c, _asc in order_cols:
        new_peer = new_peer | _neq_prev(take(c.data, order))
        if c.valid is not None:
            new_peer = new_peer | _neq_prev(take(c.valid, order))

    fn = wc.fn
    # live-row extent per partition: every dead row sorts after every
    # live one, so a partition's live rows are contiguous from its start
    psize = take(segment_sum(s_live.to(torch.int64), part_id, n), part_id)
    last_live = start_of_row + torch.clamp(psize - 1, min=0)

    def _lit_int(e, default):
        if e is None:
            return default
        if isinstance(e, ir.Literal) and isinstance(e.value, int):
            return int(e.value)
        raise NotImplementedError(
            f"window {fn} offset must be an integer literal")

    if fn == "ntile":
        buckets = _lit_int((wc.extra or [None])[0], None)
        if not buckets or buckets < 1:
            raise NotImplementedError("ntile needs a positive bucket count")
        q, r = _floordiv(psize, buckets), torch.remainder(psize, buckets)
        j = pos_in_part
        big = r * (q + 1)
        res = torch.where(j < big,
                          _floordiv(j, torch.clamp(q + 1, min=1)),
                          r + _floordiv(j - big, torch.clamp(q, min=1))) + 1
        return Column(take(res, inv), rel.mask, SqlType.int_())
    if fn == "row_number":
        return Column(take(pos_in_part + 1, inv), rel.mask, SqlType.int_())
    if fn == "rank":
        # start position of the current peer group, relative to partition
        peer_start = torch.cummax(
            torch.where(new_peer, pos, _scalar(0, pos)), 0).values
        res = peer_start - start_of_row + 1
        return Column(take(res, inv), rel.mask, SqlType.int_())
    if fn == "dense_rank":
        cums = torch.cumsum((new_peer & ~new_part).to(torch.int64), 0)
        res = cums - take(cums, start_of_row) + 1
        return Column(take(res, inv), rel.mask, SqlType.int_())

    # window aggregates
    if fn == "count_star":
        ac = Column(torch.ones(n, dtype=torch.int64, device=dev), None,
                    SqlType.int_())
    else:
        assert wc.arg is not None, f"{fn} needs an argument"
        ac = eval_expr(wc.arg, rel)
        if ac.dtype.kind == TypeKind.BOOL:
            ac = cast_column(ac, SqlType.int_())
    s_data = take(ac.data, order)
    s_valid = take(ac.valid, order) if ac.valid is not None else None
    weight = s_live if s_valid is None else (s_live & s_valid)

    # ---- navigation functions (lead/lag/first_value/last_value) --------
    if fn in ("lead", "lag"):
        extra = wc.extra or []
        k = _lit_int(extra[0] if extra else None, 1)
        tgt = pos + (k if fn == "lead" else -k)
        ok = (tgt >= start_of_row) & (tgt <= last_live) & s_live
        data = take(s_data, tgt)
        valid = ok if s_valid is None else (ok & take(s_valid, tgt))
        sdict = ac.sdict
        if len(extra) > 1 and extra[1] is not None:
            dflt = cast_column(eval_expr(extra[1], rel), ac.dtype)
            if sdict is not None and dflt.sdict is not None:
                # a string default: both sides in one merged dictionary
                (src, dflt), sdict = merge_dicts(
                    [Column(data, None, ac.dtype, ac.sdict), dflt])
                data = src.data
            data = torch.where(ok, data, take(dflt.data, order))
            dv = take(dflt.valid, order) if dflt.valid is not None else \
                torch.ones(n, dtype=torch.bool, device=dev)
            valid = torch.where(ok, valid, dv)
        return Column(take(data, inv), take(valid, inv) & m, ac.dtype,
                      sdict=sdict)
    if fn in ("first_value", "last_value"):
        fr = wc.frame
        if fr is None:
            # default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW —
            # first = partition start, last = last peer of current row
            peer_id = torch.cumsum(new_peer.to(torch.int64), 0) - 1
            last_pos = _segment_minmax("max", pos, peer_id, n)
            tgt = start_of_row if fn == "first_value" else \
                torch.minimum(take(last_pos, peer_id), last_live)
        else:
            _unit, fs, fe = fr
            lo = start_of_row if fs is None else \
                torch.maximum(pos + fs, start_of_row)
            hi = last_live if fe is None else \
                torch.minimum(pos + fe, last_live)
            empty = hi < lo
            tgt = torch.where(empty, _scalar(0, lo),
                              lo if fn == "first_value" else hi)
        data = take(s_data, tgt)
        valid = s_live if s_valid is None else take(s_valid, tgt)
        if fr is not None:
            valid = valid & ~empty
        return Column(take(data, inv), take(valid, inv) & m, ac.dtype,
                      sdict=ac.sdict)

    ordered = bool(wc.order_by)
    rt = SqlType.int_() if fn in ("count", "count_star") else \
        (SqlType.double() if fn == "avg" else ac.dtype)

    def running_sum(x):
        """Prefix sums restarting at partition starts."""
        cums = torch.cumsum(x, 0, dtype=x.dtype)
        base = take(cums, start_of_row - 1)
        return cums - torch.where(start_of_row == 0, _scalar(0, base), base)

    minmax = torch.minimum if fn == "min" else torch.maximum
    if wc.frame is not None and fn in ("sum", "avg", "count",
                                       "count_star", "min", "max"):
        # explicit ROWS frame: per-row [lo, hi] clamped to the
        # partition's live extent; sums by prefix differences, min/max by
        # a sparse table (two overlapping power-of-two windows)
        _unit, fs, fe = wc.frame
        lo = start_of_row if fs is None else \
            torch.maximum(pos + fs, start_of_row)
        hi = last_live if fe is None else torch.minimum(pos + fe, last_live)
        empty = (hi < lo) | ~s_live
        lo_c = torch.clamp(lo, 0, max(n - 1, 0))
        hi_c = torch.clamp(hi, 0, max(n - 1, 0))

        def range_sum(vals):
            cums = torch.cumsum(vals, 0, dtype=vals.dtype)
            lower = torch.where(lo_c > 0, take(cums, lo_c - 1),
                                _scalar(0, cums))
            return torch.where(empty, _scalar(0, cums),
                               take(cums, hi_c) - lower)

        cnt = range_sum(weight.to(torch.int64))
        if fn in ("min", "max"):
            ident = _scalar(_agg_identity(fn, s_data.dtype), s_data)
            x = torch.where(weight, s_data, ident)
            # sp[j][i] = op over [i, i + 2^j - 1]; levels cap at
            # log2(max frame length) when both bounds are finite
            if fs is not None and fe is not None:
                max_len = max(fe - fs + 1, 1)
            else:
                max_len = max(n, 2)
            levels = max(int(math.ceil(math.log2(max(max_len, 2)))) + 1, 1)
            table = torch.empty((levels, n), dtype=x.dtype, device=dev)
            table[0] = x
            for j in range(1, levels):
                half = 1 << (j - 1)
                shifted = torch.cat([table[j - 1][half:],
                                     ident.expand(min(half, n))])[:n]
                table[j] = minmax(table[j - 1], shifted)
            ln = hi_c - lo_c + 1
            k = torch.clamp(torch.floor(torch.log2(
                torch.clamp(ln, min=1).to(torch.float64))).to(torch.int64),
                0, levels - 1)
            flat = table.reshape(-1)
            a = take(flat, k * n + lo_c)
            b = take(flat, k * n + torch.clamp(
                hi_c - torch.bitwise_left_shift(torch.ones_like(k), k) + 1,
                min=0))
            run = torch.where(empty, ident, minmax(a, b))
        else:
            if fn in ("sum", "avg"):
                xs = torch.where(weight, s_data, _scalar(0, s_data))
            else:
                xs = weight.to(torch.int64)
            run = range_sum(xs)
        ordered = False  # frame computed exactly; no peer smearing
    elif fn in ("sum", "avg", "count", "count_star"):
        if fn in ("sum", "avg"):
            x = torch.where(weight, s_data, _scalar(0, s_data))
        else:
            x = weight.to(torch.int64)
        w64 = weight.to(torch.int64)
        if ordered:
            run, cnt = running_sum(x), running_sum(w64)
        else:
            run = take(segment_sum(x, part_id, n), part_id)
            cnt = take(segment_sum(w64, part_id, n), part_id)
    elif fn in ("min", "max"):
        ident = _scalar(_agg_identity(fn, s_data.dtype), s_data)
        x = torch.where(weight, s_data, ident)
        w64 = weight.to(torch.int64)
        if ordered:
            run = _segmented_scan(x, new_part, minmax)
            cnt = running_sum(w64)
        else:
            run = take(_segment_minmax(fn, x, part_id, n), part_id)
            cnt = take(segment_sum(w64, part_id, n), part_id)
    else:
        raise NotImplementedError(f"window function {fn}")

    if ordered:
        # RANGE frame: peers share the value at the LAST row of the peer
        # group — gather the running value from each group's last position
        peer_id = torch.cumsum(new_peer.to(torch.int64), 0) - 1
        lp = take(_segment_minmax("max", pos, peer_id, n), peer_id)
        run = take(run, lp)
        cnt = take(cnt, lp)

    if fn == "avg":
        num = run.to(torch.float64)
        if ac.dtype.kind == TypeKind.DECIMAL:
            num = num / (10 ** ac.dtype.scale)
        res = num / torch.clamp(cnt, min=1).to(torch.float64)
        return Column(take(res, inv), take(cnt > 0, inv), rt)
    if fn in ("count", "count_star"):
        return Column(take(cnt, inv), rel.mask, rt)
    return Column(take(run, inv), take(cnt > 0, inv), rt, sdict=ac.sdict)


__all__ = ["window"]
