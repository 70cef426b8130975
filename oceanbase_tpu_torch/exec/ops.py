"""Core vectorized operators (filter/project/group-by/join/sort/limit).

Port of ``oceanbase_tpu/exec/ops.py`` onto eager torch.  Shapes stay
static exactly as in the JAX package: operators carry masks instead of
compacting, every output capacity is the reference's, and data-dependent
overflow goes to the diagnostics lane as a device scalar.  No operator
reads a tensor on the host.

How the JAX primitives map:

- ``jnp.lexsort``        -> ``lexsort``: chained stable ``torch.sort`` from
  the minor key to the major key.
- ``jax.ops.segment_*``  -> ``index_add_`` / ``scatter_reduce_`` onto a
  buffer pre-filled with the aggregate's identity (``include_self=True``),
  so empty segments come out as the reference's do.
- ``jnp.repeat(..., total_repeat_length=cap)`` -> ``_repeat_index``:
  ``searchsorted`` over the inclusive prefix sum, clamped to the last
  index; it pads with the last index and truncates as JAX does.
- ``jnp.take(..., mode="clip")`` and clipped gathers -> ``take``, which
  clamps (an out-of-range CUDA gather is a device-side assert).

- ``lax.top_k``          -> a stable descending ``torch.sort`` cut to k:
  ties keep the lower index first, as ``top_k`` does.
- ``uint64`` hashing      -> int64 with wrap-around multiplies and masked
  arithmetic shifts standing in for logical ones (``_mix64``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.exec import diag
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import (
    cast_column,
    eval_expr,
    eval_predicate,
)
from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    StringDict,
    take,
)

_INT_MAX = int(np.iinfo(np.int64).max)



# ---------------------------------------------------------------------------
# torch counterparts of the JAX primitives
# ---------------------------------------------------------------------------


def _scalar(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """0-d tensor on ``like``'s device (a fill, not a host copy)."""
    return torch.full((), value, dtype=dtype or like.dtype,
                      device=like.device)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _first_flag(n: int, device) -> torch.Tensor:
    """[True, False, ...]: one group spanning every row."""
    flag = torch.zeros(n, dtype=torch.bool, device=device)
    flag[:1] = True
    return flag


def _neq_prev(d: torch.Tensor) -> torch.Tensor:
    """[True, d[1:] != d[:-1]] — the run-boundary flags of a sorted lane."""
    head = torch.ones(1, dtype=torch.bool, device=d.device)
    return torch.cat([head, d[1:] != d[:-1]])


def _sort_stable(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort (``jnp.argsort`` is stable by default)."""
    return torch.sort(keys, stable=True).indices


def lexsort(minor_to_major: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: the last key is the primary one; ties keep input
    order.  Chained stable sorts from the minor key to the major key."""
    order = None
    for k in minor_to_major:
        if k.dtype == torch.bool:
            k = k.to(torch.int8)
        kk = k if order is None else k.index_select(0, order)
        perm = _sort_stable(kk)
        order = perm if order is None else order.index_select(0, perm)
    return order


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` with in-range segment ids."""
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg, data)


def _segment_minmax(fn: str, data: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min/max``: empty segments hold the identity."""
    out = torch.full((num_segments,), _agg_identity(fn, data.dtype),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg, data,
                               reduce="amin" if fn == "min" else "amax",
                               include_self=True)


def _repeat_index(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """``jnp.repeat(arange(len(counts)), counts, total_repeat_length=cap)``.

    Position p goes to the first row whose inclusive prefix sum exceeds p;
    lanes past the total take the last row, and a total above ``cap`` is
    cut, exactly as JAX pads and truncates.  (``repeat_interleave``'s
    ``output_size`` raises whenever the total differs from ``cap``.)"""
    ln = counts.shape[0]
    ends = torch.cumsum(counts, 0)
    pos = _arange(cap, counts.device)
    return torch.searchsorted(ends, pos, right=True).clamp(max=max(ln - 1, 0))


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def filter_rows(rel: Relation, pred: ir.Expr) -> Relation:
    return rel.with_mask(eval_predicate(pred, rel))


def project(rel: Relation, outputs: dict[str, ir.Expr]) -> Relation:
    cols = {name: eval_expr(e, rel) for name, e in outputs.items()}
    return Relation(columns=cols, mask=rel.mask)


def top_n(rel: Relation, key: ir.Expr, ascending: bool, k: int) -> Relation:
    """Fused ORDER BY <single key> LIMIT k: the rows of the k best scores
    in score order, dead rows last; ties keep the lower row first, as
    ``lax.top_k`` does in the JAX package."""
    n = rel.capacity
    m = rel.mask_or_true()
    c = eval_expr(key, rel)
    d = c.data
    if d.is_floating_point():
        score = torch.where(torch.isnan(d), _scalar(float("-inf"), d), d)
        score = -score if ascending else score
        big = float("inf")
        null_last = torch.finfo(score.dtype).min
    else:
        score = -d.to(torch.int64) if ascending else d.to(torch.int64)
        big = _INT_MAX
        null_last = -big + 1
    if c.valid is not None:
        # NULL sorts smallest -> first under ASC, last under DESC; a live
        # NULL still outranks dead rows
        score = torch.where(c.valid, score,
                            _scalar(big if ascending else null_last, score))
    score = torch.where(m, score, _scalar(-big, score))  # dead rows lose
    idx = torch.sort(score, descending=True, stable=True).indices[:min(k, n)]
    return rel.gather(idx, mask=take(m, idx))


def limit(rel: Relation, k: int, offset: int = 0) -> Relation:
    m = rel.mask_or_true()
    rank = torch.cumsum(m.to(torch.int64), 0) - 1  # rank among live rows
    keep = m & (rank >= offset) & (rank < offset + k)
    return rel.with_mask(keep)


def compact(rel: Relation, capacity: int | None = None,
            strict: bool = False) -> Relation:
    """Densify live rows to the front (stable).  ``strict`` reports rows
    that do not fit ``capacity`` on the ``compact_overflow`` lane instead
    of silently truncating."""
    n = rel.capacity
    cap = capacity if capacity is not None else n
    m = rel.mask_or_true()
    if strict and capacity is not None:
        live_n = m.to(torch.int64).sum()
        diag.push("compact_overflow", torch.clamp(live_n - cap, min=0),
                  capacity=cap)
    order = _sort_stable((~m).to(torch.int8))  # live rows first, stable
    idx = order[:cap]
    return rel.gather(idx, mask=take(m, idx))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_key_arrays(rel: Relation, keys: Sequence[ir.Expr],
                     ascending: Sequence[bool],
                     nulls_first: Sequence[bool] | None = None):
    """Build lexsort key arrays (minor..major order for ``lexsort``).

    NULL sorts as the smallest value — first under ASC, last under DESC;
    ``nulls_first`` overrides per key.  Dead rows always sort last.
    """
    m = rel.mask_or_true()
    arrs = []
    for i, (e, asc) in enumerate(zip(keys, ascending)):
        c = eval_expr(e, rel)
        d = c.data
        if d.dtype == torch.bool:
            d = d.to(torch.int32)
        if not asc:
            d = -d if d.is_floating_point() else -d.to(torch.int64)
        if c.valid is not None:
            nf = nulls_first[i] if nulls_first is not None else asc
            nk = torch.where(c.valid, _scalar(0, d, torch.int8),
                             _scalar(-1 if nf else 1, d, torch.int8))
            arrs.append((nk, d))
        else:
            arrs.append((None, d))
    minor_to_major = []
    for nk, d in reversed(arrs):
        minor_to_major.append(d)
        if nk is not None:
            minor_to_major.append(nk)
    minor_to_major.append((~m).to(torch.int8))
    return minor_to_major, m


def sort_rows(rel: Relation, keys: Sequence[ir.Expr],
              ascending: Sequence[bool] | None = None,
              nulls_first: Sequence[bool] | None = None) -> Relation:
    if ascending is None:
        ascending = [True] * len(keys)
    karrs, m = _sort_key_arrays(rel, keys, ascending, nulls_first)
    order = lexsort(karrs)
    return rel.gather(order, mask=take(m, order))


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggSpec:
    """One aggregate output: name -> fn(arg)."""

    name: str
    fn: str  # sum | count | count_star | min | max | avg | count_distinct
    arg: Optional[ir.Expr] = None


def _agg_identity(fn: str, dtype: torch.dtype):
    """The identity element of ``fn`` for values of ``dtype``."""
    if fn in ("sum", "count", "count_star", "avg"):
        return False if dtype == torch.bool else 0
    floating = dtype.is_floating_point
    if fn == "min":
        return float("inf") if floating else torch.iinfo(dtype).max
    if fn == "max":
        return float("-inf") if floating else torch.iinfo(dtype).min
    raise ValueError(fn)


def _agg_result_type(fn: str, argt: SqlType | None) -> SqlType:
    if fn in ("count", "count_star", "count_distinct"):
        return SqlType.int_()
    if fn == "avg":
        return SqlType.double()
    assert argt is not None
    if fn == "sum" and argt.kind == TypeKind.BOOL:
        return SqlType.int_()
    return argt


def _segment_agg(fn: str, data, weight, gid, num_segments):
    """weight: bool lane = live & arg-valid (identity applied when False)."""
    if fn in ("count", "count_star"):
        return segment_sum(weight.to(torch.int64), gid, num_segments)
    if fn in ("sum", "avg", "min", "max"):
        ident = _scalar(_agg_identity(fn, data.dtype), data)
        d = torch.where(weight, data, ident)
        if fn in ("sum", "avg"):
            return segment_sum(d, gid, num_segments)
        return _segment_minmax(fn, d, gid, num_segments)
    raise ValueError(fn)


def _avg_column(ssum, scnt, argt: SqlType) -> Column:
    num = ssum.to(torch.float64)
    if argt.kind == TypeKind.DECIMAL:
        num = num / (10 ** argt.scale)
    res = num / torch.clamp(scnt, min=1).to(torch.float64)
    return Column(res, scnt > 0, SqlType.double())


LOWCARD_GROUP_LIMIT = 4096


def hash_groupby(
    rel: Relation,
    group_by: dict[str, ir.Expr],
    aggs: Sequence[AggSpec],
    out_capacity: int | None = None,
) -> Relation:
    """GROUP BY via sort + segment reduce, with the direct-code fast path
    for small dictionary/bool key spaces (``_lowcard_groupby``).

    Output relation: one row per group, capacity = min(n, out_capacity),
    mask marks real groups.
    """
    n = rel.capacity
    m = rel.mask_or_true()
    dev = m.device

    fast = _lowcard_groupby(rel, group_by, aggs, out_capacity, n, m)
    if fast is not None:
        return fast

    key_cols = {name: eval_expr(e, rel) for name, e in group_by.items()}
    # canonicalize NULL payloads so all NULLs of a key share one group
    for name, c in list(key_cols.items()):
        if c.valid is not None:
            key_cols[name] = c.with_data(
                torch.where(c.valid, c.data, _scalar(0, c.data)))

    # sort: dead rows last, then lexicographic group keys (nulls a group)
    minor_to_major = []
    for name in reversed(list(key_cols)):
        c = key_cols[name]
        d = c.data.to(torch.int64) if c.data.dtype == torch.bool else c.data
        minor_to_major.append(d)
        if c.valid is not None:
            minor_to_major.append((~c.valid).to(torch.int8))
    minor_to_major.append((~m).to(torch.int8))
    order = lexsort(minor_to_major)

    s_live = take(m, order)
    s_keys = {name: c.gather(order) for name, c in key_cols.items()}

    # new-group boundary among live rows
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in s_keys.values():
        dneq = _neq_prev(c.data)
        if c.valid is not None:
            dneq = dneq | _neq_prev(c.valid)
        diff = diff | dneq
    if not key_cols:
        diff = _first_flag(n, dev)
    newgrp = diff & s_live
    gid_live = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    n_groups = torch.clamp(gid_live[-1] + 1, min=0)
    gid = torch.where(s_live, torch.clamp(gid_live, min=0),
                      _scalar(n - 1, gid_live))

    cap = min(out_capacity, n) if out_capacity is not None else n
    # groups beyond capacity would vanish silently — surface them
    gb_overflow = torch.clamp(n_groups - cap, min=0)
    diag.push("groupby_overflow", gb_overflow, capacity=cap)

    # first sorted position of each group -> group key values
    pos = _arange(n, dev)
    first_pos = _segment_minmax(
        "min", torch.where(s_live, pos, _scalar(_INT_MAX, pos)), gid, n)[:cap]
    first_pos_c = torch.clamp(first_pos, 0, n - 1)

    out_cols: dict[str, Column] = {}
    out_mask = _arange(cap, dev) < n_groups
    for name, c in s_keys.items():
        out_cols[name] = c.gather(first_pos_c)

    # aggregate lanes (evaluated pre-sort then permuted)
    for spec in aggs:
        if spec.fn == "count_star":
            res = _segment_agg("count_star", None, s_live, gid, n)[:cap]
            out_cols[spec.name] = Column(res, None, SqlType.int_())
            continue
        assert spec.arg is not None
        ac = eval_expr(spec.arg, rel)
        if ac.dtype.kind == TypeKind.BOOL:
            ac = cast_column(ac, SqlType.int_())
        s_data = take(ac.data, order)
        s_valid = take(ac.valid, order) if ac.valid is not None else None
        weight = s_live if s_valid is None else (s_live & s_valid)
        if spec.fn == "count_distinct":
            res = _count_distinct(minor_to_major, key_cols, rel, spec,
                                  n)[:cap]
            out_cols[spec.name] = Column(res, None, SqlType.int_())
            continue
        if spec.fn == "avg":
            ssum = _segment_agg("sum", s_data, weight, gid, n)[:cap]
            scnt = _segment_agg("count", None, weight, gid, n)[:cap]
            out_cols[spec.name] = _avg_column(ssum, scnt, ac.dtype)
            continue
        res = _segment_agg(spec.fn, s_data, weight, gid, n)[:cap]
        rt = _agg_result_type(spec.fn, ac.dtype)
        if spec.fn in ("min", "max", "sum"):
            # SUM/MIN/MAX over an empty or all-null group is NULL
            cnt = _segment_agg("count", None, weight, gid, n)[:cap]
            out_cols[spec.name] = Column(
                res, cnt > 0, rt,
                sdict=ac.sdict if spec.fn != "sum" else None)
        else:  # count
            out_cols[spec.name] = Column(res, None, rt)

    return Relation(columns=out_cols, mask=out_mask)


def _lowcard_groupby(rel, group_by, aggs, out_capacity, n, m):
    """Direct-code group-by; None when ineligible (falls back to sort).

    The group id IS the combined dictionary code, so one segment reduce
    with a static segment count replaces the sort (Q1's path)."""
    key_cols = {}
    sizes = []
    for name, e in group_by.items():
        c = eval_expr(e, rel)
        if c.dtype.kind == TypeKind.BOOL:
            size = 2
        elif c.sdict is not None:
            size = c.sdict.size
        else:
            return None
        nullable = c.valid is not None
        key_cols[name] = (c, size, nullable)
        sizes.append(size + (1 if nullable else 0))
    if not key_cols:
        return None
    prod = 1
    for s in sizes:
        prod *= s
        if prod > LOWCARD_GROUP_LIMIT:
            return None
    if any(a.fn == "count_distinct" for a in aggs):
        return None
    if out_capacity is not None and out_capacity < prod:
        return None
    if any(a.fn not in ("count_star", "count", "sum", "avg", "min", "max")
           for a in aggs):
        return None  # unsupported agg: the sort path handles (or raises)

    dev = m.device
    # combined group id (lexicographic in key order, so output ordering
    # matches the sort-based path: dictionary codes are order-preserving)
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    for (c, size, nullable), span in zip(key_cols.values(), sizes):
        code = c.data.to(torch.int64)
        if nullable:
            # NULL gets its own slot BELOW real codes (NULL sorts first)
            code = torch.where(c.valid, code + 1, _scalar(0, code))
        gid = gid * span + torch.clamp(code, 0, span - 1)
    gid = torch.where(m, gid, _scalar(prod, gid))  # dead rows -> spill slot
    nseg = prod + 1

    counts = segment_sum(m.to(torch.int64), gid, nseg)[:prod]
    occupied = counts > 0

    # decode group ids back into per-key code columns
    rem = _arange(prod, dev)
    decoded = {}
    for (name, (c, size, nullable)), span in reversed(
            list(zip(key_cols.items(), sizes))):
        code = torch.remainder(rem, span)
        rem = torch.div(rem, span, rounding_mode="floor")
        if nullable:
            valid = code > 0
            data = torch.clamp(code - 1, 0, max(size - 1, 0))
        else:
            valid = None
            data = code
        decoded[name] = Column(data.to(c.data.dtype), valid, c.dtype,
                               c.sdict)
    out_cols: dict[str, Column] = {name: decoded[name] for name in key_cols}

    for spec in aggs:
        if spec.fn == "count_star":
            out_cols[spec.name] = Column(counts, None, SqlType.int_())
            continue
        ac = eval_expr(spec.arg, rel)
        if ac.dtype.kind == TypeKind.BOOL:
            ac = cast_column(ac, SqlType.int_())
        weight = m if ac.valid is None else (m & ac.valid)
        cnt = segment_sum(weight.to(torch.int64), gid, nseg)[:prod]
        if spec.fn == "count":
            out_cols[spec.name] = Column(cnt, None, SqlType.int_())
            continue
        if spec.fn == "avg":
            s = _segment_agg("sum", ac.data, weight, gid, nseg)[:prod]
            out_cols[spec.name] = _avg_column(s, cnt, ac.dtype)
            continue
        res = _segment_agg(spec.fn, ac.data, weight, gid, nseg)[:prod]
        out_cols[spec.name] = Column(
            res, cnt > 0, _agg_result_type(spec.fn, ac.dtype),
            sdict=ac.sdict if spec.fn != "sum" else None)

    return Relation(columns=out_cols, mask=occupied)


def _count_distinct(minor_to_major, key_cols, rel, spec, n):
    """COUNT(DISTINCT arg) per group: re-sort by (group keys, arg) and
    count first-occurrence flags per group.  NULL lanes sort behind the
    valid ones of their group, so a NULL whose payload equals a value
    cannot hide that value's first occurrence (the reference sorts by
    the raw payload alone and can miss it: ROADMAP Queue 3 #5)."""
    ac = eval_expr(spec.arg, rel)
    mm = [ac.data]
    if ac.valid is not None:
        mm.append((~ac.valid).to(torch.int8))
    order2 = lexsort(mm + list(minor_to_major))
    m = rel.mask_or_true()
    l2 = take(m, order2)
    d2 = take(ac.data, order2)
    w2 = l2 if ac.valid is None else (l2 & take(ac.valid, order2))
    # group boundaries in the second order; validity lanes take part so
    # a NULL-key group never merges with the canonicalized-payload group
    diff = torch.zeros(n, dtype=torch.bool, device=m.device)
    for c in key_cols.values():
        diff = diff | _neq_prev(take(c.data, order2))
        if c.valid is not None:
            diff = diff | _neq_prev(take(c.valid, order2))
    if not key_cols:
        diff = _first_flag(n, m.device)
    newgrp2 = diff & l2
    gid2 = torch.where(
        l2, torch.clamp(torch.cumsum(newgrp2.to(torch.int64), 0) - 1, min=0),
        _scalar(n - 1, l2, torch.int64))
    first = (newgrp2 | _neq_prev(d2)) & w2
    return segment_sum(first.to(torch.int64), gid2, n)


def scalar_agg(rel: Relation, aggs: Sequence[AggSpec]) -> Relation:
    """Aggregates without GROUP BY -> single-row relation (always 1 live
    row: COUNT over empty input is 0, SUM/MIN/MAX are NULL)."""
    m = rel.mask_or_true()
    out: dict[str, Column] = {}
    for spec in aggs:
        if spec.fn == "count_star":
            v = m.to(torch.int64).sum()
            out[spec.name] = Column(v.reshape(1), None, SqlType.int_())
            continue
        assert spec.arg is not None
        ac = eval_expr(spec.arg, rel)
        if ac.dtype.kind == TypeKind.BOOL:
            ac = cast_column(ac, SqlType.int_())
        weight = m if ac.valid is None else (m & ac.valid)
        cnt = weight.to(torch.int64).sum()
        nonempty = (cnt > 0).reshape(1)
        if spec.fn == "count":
            out[spec.name] = Column(cnt.reshape(1), None, SqlType.int_())
            continue
        if spec.fn == "count_distinct":
            # counted lanes first, then by value: a NULL or dead lane
            # with a value's payload cannot hide it (ROADMAP Queue 3 #5)
            order = lexsort([ac.data, (~weight).to(torch.int8)])
            newval = _neq_prev(take(ac.data, order))
            v = (newval & take(weight, order)).to(torch.int64).sum()
            out[spec.name] = Column(v.reshape(1), None, SqlType.int_())
            continue
        if spec.fn in ("sum", "avg"):
            d = torch.where(weight, ac.data, _scalar(0, ac.data))
            s = d.sum()
            if spec.fn == "sum":
                out[spec.name] = Column(s.reshape(1), nonempty,
                                        _agg_result_type("sum", ac.dtype))
            else:
                out[spec.name] = _avg_column(s.reshape(1), cnt.reshape(1),
                                             ac.dtype)
            continue
        if spec.fn in ("min", "max"):
            ident = _scalar(_agg_identity(spec.fn, ac.data.dtype), ac.data)
            d = torch.where(weight, ac.data, ident)
            v = d.min() if spec.fn == "min" else d.max()
            out[spec.name] = Column(v.reshape(1), nonempty, ac.dtype,
                                    sdict=ac.sdict)
            continue
        raise ValueError(spec.fn)
    return Relation(columns=out, mask=None)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

_EXACT_KEY_KINDS = (TypeKind.INT, TypeKind.DATE, TypeKind.DATETIME,
                    TypeKind.DECIMAL, TypeKind.BOOL, TypeKind.STRING)


def _as_int64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _as_int64(0xBF58476D1CE4E5B9)
_M2 = _as_int64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (the uint64 ``>>``): shift
    arithmetically, then clear the k sign-filled high bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 lanes, bit-identical to the JAX
    package's uint64 version: the multiplies wrap mod 2^64 in int64."""
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def _combined_key(cols: Sequence[Column]):
    """Combine join key columns into one sortable int64 -> (key, exact).

    A single int-like key is its own exact key.  Several keys, or a float
    key, go through the 64-bit mix; the caller re-checks every candidate
    pair on the real key columns (hash collisions)."""
    if len(cols) == 1 and cols[0].dtype.kind in _EXACT_KEY_KINDS:
        return cols[0].data.to(torch.int64), True
    h = torch.zeros(cols[0].capacity, dtype=torch.int64,
                    device=cols[0].device)
    for c in cols:
        if c.data.is_floating_point():
            k = c.data.to(torch.float64).view(torch.int64)
        else:
            k = c.data.to(torch.int64)
        h = _mix64(h ^ _mix64(k))
    return h, False


def _keys_valid(cols: Sequence[Column], mask):
    v = mask
    for c in cols:
        if c.valid is not None:
            v = v & c.valid
    return v


def join(
    left: Relation,
    right: Relation,
    left_keys: Sequence[ir.Expr],
    right_keys: Sequence[ir.Expr],
    how: str = "inner",
    out_capacity: int | None = None,
) -> Relation:
    """Sort-based equi-join; probe side = left, build side = right.

    how: inner | left | semi | anti | full.  Column names must be
    disjoint.  NULL join keys never match.
    """
    ln, rn = left.capacity, right.capacity
    lm, rm = left.mask_or_true(), right.mask_or_true()
    dev = lm.device

    if not left_keys:  # cross join: constant key matches everything
        left_keys = [ir.Literal(0)]
        right_keys = [ir.Literal(0)]
    lcols = [eval_expr(e, left) for e in left_keys]
    rcols = [eval_expr(e, right) for e in right_keys]
    # string keys across different dictionaries: translate left into right's
    for i, (lc, rc) in enumerate(zip(lcols, rcols)):
        if lc.dtype.is_string and rc.dtype.is_string and \
                lc.sdict is not rc.sdict:
            lcols[i] = _translate_dict(lc, rc)
        if lc.dtype.kind == TypeKind.DECIMAL or \
                rc.dtype.kind == TypeKind.DECIMAL:
            s = max(lc.dtype.scale, rc.dtype.scale)
            lcols[i] = cast_column(lc, SqlType(TypeKind.DECIMAL, 38, s))
            rcols[i] = cast_column(rc, SqlType(TypeKind.DECIMAL, 38, s))

    lkey, exact = _combined_key(lcols)
    rkey, rexact = _combined_key(rcols)
    exact = exact and rexact
    lvalid = _keys_valid(lcols, lm)
    rvalid = _keys_valid(rcols, rm)

    # build: sort right by key, dead/null-key rows pushed to the end
    rkey_s = torch.where(rvalid, rkey, _scalar(_INT_MAX, rkey))
    rkey_sorted, border = torch.sort(rkey_s, stable=True)

    lkey_p = torch.where(lvalid, lkey, _scalar(_INT_MAX - 1, lkey))
    lo = torch.searchsorted(rkey_sorted, lkey_p, right=False)
    hi = torch.searchsorted(rkey_sorted, lkey_p, right=True)
    counts = torch.where(lvalid, hi - lo, _scalar(0, lo))

    if exact and how == "semi":
        return left.with_mask(lm & (counts > 0))
    if exact and how == "anti":
        # NOT EXISTS semantics: NULL keys never match, so they survive
        return left.with_mask(lm & (counts == 0))
    # hashed semi/anti fall through: candidate counts include hash
    # collisions, so matches are verified on the expanded lanes

    keep_unmatched = how in ("left", "full")
    if keep_unmatched:
        ecounts = torch.where(lm, torch.clamp(counts, min=1),
                              _scalar(0, counts))
    else:
        ecounts = counts
    cap = out_capacity if out_capacity is not None else max(ln, rn)

    total = ecounts.sum()
    diag.push("join_overflow", torch.clamp(total - cap, min=0),
              capacity=cap)
    start = torch.cumsum(ecounts, 0) - ecounts  # exclusive prefix
    probe_idx = _repeat_index(ecounts, cap)
    lane = _arange(cap, dev)
    out_live = lane < total
    off = lane - take(start, probe_idx)
    matched = take(counts, probe_idx) > 0
    bpos = torch.clamp(take(lo, probe_idx) + off, 0, rn - 1)
    build_idx = take(border, bpos)

    out_cols: dict[str, Column] = {}
    for name, c in left.columns.items():
        out_cols[name] = c.gather(probe_idx)
    bvalid_lane = out_live & matched
    for name, c in right.columns.items():
        g = c.gather(build_idx)
        v = (g.valid_or_true() & bvalid_lane) if keep_unmatched else g.valid
        out_cols[name] = Column(g.data, v, c.dtype, c.sdict)

    live = out_live & (matched | keep_unmatched)
    match_lane = out_live & matched  # lanes carrying a real build pairing
    if not exact:
        # verify candidate equality on the real key columns (collisions)
        ok = torch.ones(cap, dtype=torch.bool, device=dev)
        for lc, rc in zip(lcols, rcols):
            ok = ok & (take(lc.data, probe_idx) == take(rc.data, build_idx))
        true_lane = out_live & matched & ok
        # true-match count per probe row: a collision neither emits a
        # phantom NULL-extended row nor satisfies semi/anti membership
        tc = segment_sum(true_lane.to(torch.int64), probe_idx, ln)
        if how == "semi":
            return left.with_mask(lm & (tc > 0))
        if how == "anti":
            return left.with_mask(lm & (tc == 0))
        if keep_unmatched:
            # a lane survives as a real match, or as the one
            # NULL-extended row of a probe row with no true match
            null_lane = (off == 0) & (take(tc, probe_idx) == 0)
            live = out_live & (true_lane | null_lane)
            match_lane = true_lane
            for name in right.columns:
                c = out_cols[name]
                out_cols[name] = Column(c.data, c.valid_or_true() & true_lane,
                                        c.dtype, c.sdict)
        else:
            live = live & ok
    if how != "full":
        return Relation(columns=out_cols, mask=live)

    # FULL OUTER: append one lane per build row, live when that row
    # matched no probe lane (NULL-extended left side)
    seg = torch.where(match_lane, build_idx, _scalar(rn, build_idx))
    # segment rn collects the dropped lanes (JAX drops out-of-range ids)
    bmatch = segment_sum(match_lane.to(torch.int64), seg,
                         rn + 1)[:max(rn, 1)]
    app_live = rm & (bmatch == 0)
    zeros = torch.zeros(rn, dtype=torch.int64, device=dev)
    full_cols: dict[str, Column] = {}
    for name, c in out_cols.items():
        if name in left.columns:
            app = left.columns[name].gather(zeros)
            app = Column(app.data, torch.zeros(rn, dtype=torch.bool,
                                               device=dev),
                         app.dtype, app.sdict)
        else:
            app = right.columns[name]
        full_cols[name] = Column(
            torch.cat([c.data, app.data]),
            torch.cat([c.valid_or_true(), app.valid_or_true()]),
            c.dtype, c.sdict)
    return Relation(columns=full_cols, mask=torch.cat([live, app_live]))


def index_probe(
    probe: Relation,
    sidecar: Relation,
    base: Relation,
    key: ir.Expr,
    columns: Sequence[str] | None,
    rename: dict[str, str] | None,
    out_capacity: int | None = None,
) -> Relation:
    """Index nested-loop join: a ``searchsorted`` probe of ``key`` into a
    pre-sorted index sidecar, then a positional gather of the base
    table's rows.

    sidecar: ``__key__`` sorted int64 over the base's live rows with
    valid keys, padded with ``_INT_MAX``; ``__pos__`` the matching row
    positions into ``base``.  Keys are exact ints (the optimizer picks
    this path only for single int-like columns), so every expanded lane
    is a true match.  NULL and dead probe keys never match."""
    ln = probe.capacity
    lm = probe.mask_or_true()
    kc = eval_expr(key, probe)
    lkey = kc.data.to(torch.int64)
    lvalid = _keys_valid([kc], lm)

    skey = sidecar.columns["__key__"].data
    spos = sidecar.columns["__pos__"].data
    sn = sidecar.capacity

    # _INT_MAX - 1, not _INT_MAX: the pad keys are _INT_MAX, so a dead
    # probe lane's sentinel must sort strictly below them
    lkey_p = torch.where(lvalid, lkey, _scalar(_INT_MAX - 1, lkey))
    lo = torch.searchsorted(skey, lkey_p, right=False)
    hi = torch.searchsorted(skey, lkey_p, right=True)
    counts = torch.where(lvalid, hi - lo, _scalar(0, lo))

    cap = out_capacity if out_capacity is not None else max(ln, sn)
    total = counts.sum()
    diag.push("index_probe_overflow", torch.clamp(total - cap, min=0),
              capacity=cap)
    start = torch.cumsum(counts, 0) - counts  # exclusive prefix
    probe_idx = _repeat_index(counts, cap)
    lane = _arange(cap, lm.device)
    out_live = lane < total
    off = lane - take(start, probe_idx)
    span = torch.clamp(take(lo, probe_idx) + off, 0, sn - 1)
    base_idx = take(spos, span)

    out_cols: dict[str, Column] = {}
    for name, c in probe.columns.items():
        out_cols[name] = c.gather(probe_idx)
    names = columns if columns is not None else list(base.columns)
    for bname in names:
        out_cols[(rename or {}).get(bname, bname)] = \
            base.columns[bname].gather(base_idx)
    return Relation(columns=out_cols, mask=out_live)


def semi_join_residual(
    left: Relation,
    right: Relation,
    left_keys: Sequence[ir.Expr],
    right_keys: Sequence[ir.Expr],
    residual: Sequence[ir.Expr],
    anti: bool = False,
    out_capacity: int | None = None,
) -> Relation:
    """Semi/anti join with non-equality correlated predicates: expand the
    equality join, evaluate the residual on the combined rows, then count
    the surviving matches per probe row.  EXISTS keeps rows with a match,
    NOT EXISTS rows with none."""
    ln = left.capacity
    lm = left.mask_or_true()
    # tag probe rows with their position so matches fold back per row
    rid = Column(_arange(ln, lm.device), None, SqlType.int_())
    left2 = Relation(columns={**left.columns, "__rid__": rid},
                     mask=left.mask)
    expanded = join(left2, right, left_keys, right_keys, how="inner",
                    out_capacity=out_capacity)
    ok = expanded.mask_or_true()
    for pred in residual:
        ok = ok & eval_predicate(pred, expanded)
    ridx = torch.clamp(expanded.columns["__rid__"].data, 0, ln - 1)
    matches = segment_sum(ok.to(torch.int64), ridx, ln)
    if anti:
        return left.with_mask(lm & (matches == 0))
    return left.with_mask(lm & (matches > 0))


def merge_dicts(cols: Sequence[Column]) -> tuple[list, StringDict | None]:
    """Re-encode string columns into one merged dictionary.

    Columns already sharing one dictionary come back as they are; else
    the merged dictionary is the sorted union of the values (the order
    the codes keep) and each column's codes are remapped by a gather
    through a host-built lookup table.  Columns without a dictionary
    (all-NULL lanes) pass through."""
    dicts = [c.sdict for c in cols if c.sdict is not None]
    if not dicts:
        return list(cols), None
    if all(d is dicts[0] for d in dicts):
        return list(cols), dicts[0]
    merged = StringDict(np.unique(np.concatenate([d.values
                                                  for d in dicts])))
    out = []
    for c in cols:
        if c.sdict is None:
            out.append(c)
            continue
        remap = np.searchsorted(merged.values,
                                c.sdict.values).astype(np.int32)
        codes = take(torch.from_numpy(remap).to(c.device), c.data)
        out.append(Column(codes, c.valid, c.dtype, merged))
    return out, merged


def concat(rels: Sequence[Relation]) -> Relation:
    """UNION ALL: stack relations (same column ids) into one.  String
    columns with different dictionaries are re-encoded into a merged
    dictionary (``merge_dicts``)."""
    out_cols: dict[str, Column] = {}
    for name in rels[0].columns:
        cols = [r.columns[name] for r in rels]
        if any(c.sdict is not None for c in cols):
            cols, merged = merge_dicts(cols)
            data = torch.cat([c.data for c in cols])
            out_cols[name] = Column(data, _concat_valid(cols),
                                    cols[0].dtype, merged)
            continue
        data = torch.cat([c.data.to(cols[0].data.dtype) for c in cols])
        out_cols[name] = Column(data, _concat_valid(cols), cols[0].dtype)
    mask = torch.cat([r.mask_or_true() for r in rels])
    return Relation(columns=out_cols, mask=mask)


def _concat_valid(cols):
    if all(c.valid is None for c in cols):
        return None
    return torch.cat([c.valid_or_true() for c in cols])


def _translate_dict(lc: Column, rc: Column) -> Column:
    """Map left dict codes into right's dictionary space (-1 = no match)."""
    assert lc.sdict is not None and rc.sdict is not None
    pos = np.searchsorted(rc.sdict.values, lc.sdict.values)
    posc = np.clip(pos, 0, max(rc.sdict.size - 1, 0))
    exact = rc.sdict.values[posc] == lc.sdict.values if rc.sdict.size else \
        np.zeros(lc.sdict.size, dtype=bool)
    lut = torch.from_numpy(np.where(exact, posc, -1).astype(np.int32))
    codes = take(lut.to(lc.device), lc.data)
    return Column(codes, lc.valid, SqlType.string(), rc.sdict)


__all__ = [
    "AggSpec", "compact", "concat", "filter_rows", "hash_groupby",
    "index_probe", "join", "lexsort", "limit", "merge_dicts", "project",
    "scalar_agg", "segment_sum", "semi_join_residual", "sort_rows", "top_n",
]
