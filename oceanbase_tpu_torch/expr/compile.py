"""Evaluate expression IR over device relations, eagerly, with torch.

Port of ``oceanbase_tpu/expr/compile.py``.  ``eval_expr(expr, rel)``
returns a Column computed over whole column tensors on the relation's
device.  Every sub-expression yields (data, valid); three-valued logic is
exact for AND/OR/NOT.  Decimals are scaled int64 and every promotion is
explicit so result dtypes match the JAX package's (which runs with
``jax_enable_x64``).  String predicates lower to host work over the
dictionary plus a device gather.

Scope: every node kind, the scalar functions (dates through Hinnant's
civil-date arithmetic with floor division, math, string functions as
dictionary transforms), the UDF registry, MATCH ... AGAINST and the
VECTOR distance functions (``l2_distance``, ``cosine_distance``,
``inner_product``, ``negative_inner_product``).
"""

from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

from oceanbase_tpu_torch.datatypes import (
    SqlType,
    TypeKind,
    add_result,
    common_numeric,
    date_to_days,
    div_result,
    mul_result,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    StringDict,
    take,
)

_POW10 = [10**i for i in range(38)]

def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


def _host_lut(values: np.ndarray, dtype, device) -> torch.Tensor:
    """Upload a host lookup table built over a dictionary."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# literal -> (host scalar, SqlType)
# ---------------------------------------------------------------------------

def literal_value(e: ir.Literal):
    v, t = e.value, e.dtype
    if t is None:
        if v is None:
            t = SqlType.null()
        elif isinstance(v, bool):
            t = SqlType.bool_()
        elif isinstance(v, int):
            t = SqlType.int_()
        elif isinstance(v, float):
            t = SqlType.double()
        elif isinstance(v, str):
            t = SqlType.string()
        else:
            raise TypeError(f"unsupported literal {v!r}")
    if t.kind == TypeKind.DATE and isinstance(v, str):
        v = date_to_days(v)
    if t.kind == TypeKind.DECIMAL and isinstance(v, str):
        # exact decimal parse; trailing zeros stripped so '0.0001000000'
        # costs scale 4, not 10 (keeps products inside int64 range)
        neg = v.startswith("-")
        body = v.lstrip("+-")
        if "." in body:
            ip, fp = body.split(".")
        else:
            ip, fp = body, ""
        fp = fp.rstrip("0")
        scale = len(fp)
        iv = int(ip or "0") * _POW10[scale] + int(fp or "0")
        v = -iv if neg else iv
        t = SqlType.decimal(t.precision or 15, scale)
    return v, t


def _lit_column(e: ir.Literal, n: int, device) -> Column:
    v, t = literal_value(e)
    if v is None:
        return Column(data=_full(n, 0, torch.int64, device),
                      valid=_full(n, False, torch.bool, device), dtype=t)
    if t.kind == TypeKind.STRING:
        # a bare string literal column: single-value dictionary
        return Column(data=_full(n, 0, torch.int32, device), valid=None,
                      dtype=t, sdict=StringDict(np.array([v])))
    return Column(data=_full(n, v, t.torch_dtype, device), valid=None,
                  dtype=t)


# ---------------------------------------------------------------------------
# numeric alignment helpers
# ---------------------------------------------------------------------------

def _to_float(c: Column, kind=TypeKind.DOUBLE) -> Column:
    dt = torch.float64 if kind == TypeKind.DOUBLE else torch.float32
    data = c.data.to(dt)
    if c.dtype.kind == TypeKind.DECIMAL:
        data = data / _POW10[c.dtype.scale]
    return Column(data=data, valid=c.valid, dtype=SqlType(kind))


def _align_pair(a: Column, b: Column) -> tuple:
    """Align two numeric/date columns to a common physical representation.

    Returns (a_data, b_data, common SqlType)."""
    ta, tb = a.dtype, b.dtype
    temporal = (TypeKind.DATE, TypeKind.DATETIME)
    # date/datetime compare & arith against ints happens raw
    if ta.kind in temporal or tb.kind in temporal:
        ct = ta if ta.kind in temporal else tb
        return a.data.to(torch.int64), b.data.to(torch.int64), ct
    if ta.kind == TypeKind.BOOL and tb.kind == TypeKind.BOOL:
        return a.data, b.data, ta
    ct = common_numeric(ta, tb)
    if ct.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
        return _to_float(a, ct.kind).data, _to_float(b, ct.kind).data, ct
    if ct.kind == TypeKind.DECIMAL:
        s = max(ta.scale, tb.scale)
        da = a.data.to(torch.int64) * _POW10[s - ta.scale]
        db = b.data.to(torch.int64) * _POW10[s - tb.scale]
        return da, db, SqlType(TypeKind.DECIMAL,
                               max(ta.precision, tb.precision), s)
    return a.data.to(torch.int64), b.data.to(torch.int64), ct


def _merge_valid(a: Column, b: Column):
    if a.valid is None:
        return b.valid
    if b.valid is None:
        return a.valid
    return a.valid & b.valid


# ---------------------------------------------------------------------------
# string predicate lowering
# ---------------------------------------------------------------------------

def _string_cmp(op: str, c: Column, s: str, n: int) -> Column:
    """Compare a dict-encoded column against a string literal on codes."""
    sd = c.sdict
    assert sd is not None, "string compare on non-dict column"
    if op in ("=", "!="):
        code = sd.code_of(s)
        if code < 0:
            val = _full(n, op != "=", torch.bool, c.device)
        else:
            val = (c.data == code) if op == "=" else (c.data != code)
        return Column(data=val, valid=c.valid, dtype=SqlType.bool_())
    # order-preserving dict: translate to a code boundary
    lb = sd.lower_bound(s)
    exists = sd.code_of(s) >= 0
    if op == "<":
        val = c.data < lb
    elif op == "<=":
        val = c.data < (lb + 1 if exists else lb)
    elif op == ">":
        val = c.data >= (lb + 1 if exists else lb)
    elif op == ">=":
        val = c.data >= lb
    else:  # pragma: no cover
        raise ValueError(op)
    return Column(data=val, valid=c.valid, dtype=SqlType.bool_())


US_PER_DAY = 86_400_000_000


def _temporal_literal(s: str, kind: TypeKind) -> int:
    """'1994-01-01[ hh:mm:ss]' -> days (DATE) or microseconds (DATETIME)."""
    days = date_to_days(s.split(" ")[0])
    if kind == TypeKind.DATE:
        return days
    us = days * US_PER_DAY
    if " " in s:
        hms = s.split(" ", 1)[1].split(":")
        parts = [float(x) for x in hms] + [0.0] * (3 - len(hms))
        us += int((parts[0] * 3600 + parts[1] * 60 + parts[2]) * 1_000_000)
    return us


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


# ---------------------------------------------------------------------------
# 3-valued logic lanes
# ---------------------------------------------------------------------------

def _tf(c: Column):
    v = c.valid_or_true()
    d = c.data
    if d.dtype != torch.bool:
        # SQL truthiness of a numeric predicate (0/1 ints)
        d = d != 0
    return d & v, (~d) & v


# ---------------------------------------------------------------------------
# main evaluator
# ---------------------------------------------------------------------------

def eval_expr(e: ir.Expr, rel: Relation) -> Column:
    n = rel.capacity
    dev = rel.device

    if isinstance(e, ir.ColumnRef):
        return rel.columns[e.name]

    if isinstance(e, ir.Literal):
        return _lit_column(e, n, dev)

    if isinstance(e, ir.Cmp):
        return _eval_cmp(e, rel, n)

    if isinstance(e, ir.Arith):
        return _eval_arith(e, rel, n)

    if isinstance(e, ir.Logic):
        cols = [eval_expr(a, rel) for a in e.args]
        t, f = _tf(cols[0])
        for c in cols[1:]:
            t2, f2 = _tf(c)
            if e.op == "and":
                t, f = t & t2, f | f2
            else:
                t, f = t | t2, f & f2
        return Column(data=t, valid=t | f, dtype=SqlType.bool_())

    if isinstance(e, ir.Not):
        c = eval_expr(e.arg, rel)
        return Column(data=~c.data, valid=c.valid, dtype=SqlType.bool_())

    if isinstance(e, ir.IsNull):
        c = eval_expr(e.arg, rel)
        isnull = (_full(n, False, torch.bool, dev) if c.valid is None
                  else ~c.valid)
        return Column(data=(~isnull if e.negated else isnull), valid=None,
                      dtype=SqlType.bool_())

    if isinstance(e, ir.InList):
        return _eval_inlist(e, rel, n)

    if isinstance(e, ir.Like):
        c = eval_expr(e.arg, rel)
        assert c.sdict is not None, "LIKE requires a dict-encoded column"
        rx = re.compile(like_to_regex(e.pattern))
        hits = np.asarray(c.sdict.lut(lambda s: rx.match(s) is not None),
                          dtype=np.bool_)
        val = take(_host_lut(hits, torch.bool, dev), c.data)
        if e.negated:
            val = ~val
        return Column(data=val, valid=c.valid, dtype=SqlType.bool_())

    if isinstance(e, ir.Case):
        return _eval_case(e, rel, n)

    if isinstance(e, ir.Cast):
        return cast_column(eval_expr(e.arg, rel), e.dtype)

    if isinstance(e, ir.FuncCall):
        return _eval_func(e, rel, n)

    raise NotImplementedError(f"eval of {type(e).__name__}")


def _as_str(v):
    return v.value if isinstance(v, ir.Literal) else v


def _eval_inlist(e: ir.InList, rel: Relation, n: int) -> Column:
    c = eval_expr(e.arg, rel)
    if c.dtype.is_string and c.sdict is not None:
        vals = [c.sdict.code_of(_as_str(v)) for v in e.values]
        vals = [cd for cd in vals if cd >= 0]
    else:
        vals = []
        for v in e.values:
            lv, lt = literal_value(v if isinstance(v, ir.Literal)
                                   else ir.Literal(v))
            if c.dtype.kind == TypeKind.DECIMAL and lt.kind in (
                    TypeKind.DECIMAL, TypeKind.INT):
                ls = lt.scale if lt.kind == TypeKind.DECIMAL else 0
                if ls <= c.dtype.scale:
                    lv = lv * _POW10[c.dtype.scale - ls]
                else:
                    # literal more precise than the column: exact match
                    # only possible when the extra digits are zero
                    q, r = divmod(lv, _POW10[ls - c.dtype.scale])
                    if r != 0:
                        continue
                    lv = q
            elif c.dtype.kind in (TypeKind.DATE, TypeKind.DATETIME) and \
                    isinstance(lv, str):
                lv = _temporal_literal(lv, c.dtype.kind)
            vals.append(lv)
    if not vals:
        val = _full(n, False, torch.bool, c.device)
    else:
        test = torch.tensor(vals, device=c.device)
        ct = torch.promote_types(c.data.dtype, test.dtype)
        val = torch.isin(c.data.to(ct), test.to(ct))
    if e.negated:
        val = ~val
    return Column(data=val, valid=c.valid, dtype=SqlType.bool_())


def _eval_cmp(e: ir.Cmp, rel: Relation, n: int) -> Column:
    # string-vs-literal fast path on dictionary codes
    lc_is_str_lit = isinstance(e.left, ir.Literal) and \
        isinstance(e.left.value, str)
    rc_is_str_lit = isinstance(e.right, ir.Literal) and \
        isinstance(e.right.value, str)
    if rc_is_str_lit:
        lcol = eval_expr(e.left, rel)
        if lcol.dtype.is_string:
            return _string_cmp(e.op, lcol, e.right.value, n)
        if lcol.dtype.kind in (TypeKind.DATE, TypeKind.DATETIME):
            rv = _temporal_literal(e.right.value, lcol.dtype.kind)
            return _cmp_data(e.op, lcol.data.to(torch.int64),
                             _full(n, rv, torch.int64, lcol.device),
                             lcol.valid)
    if lc_is_str_lit:
        flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=",
                   "!=": "!="}
        return _eval_cmp(ir.Cmp(flipped[e.op], e.right, e.left), rel, n)

    a = eval_expr(e.left, rel)
    b = eval_expr(e.right, rel)
    if a.dtype.is_string and b.dtype.is_string:
        return _string_col_cmp(e.op, a, b)
    da, db, _ = _align_pair(a, b)
    return _cmp_data(e.op, da, db, _merge_valid(a, b))


_CMP_FNS = {
    "=": torch.eq, "!=": torch.ne, "<": torch.lt,
    "<=": torch.le, ">": torch.gt, ">=": torch.ge,
}


def _cmp_data(op, da, db, valid) -> Column:
    return Column(data=_CMP_FNS[op](da, db), valid=valid,
                  dtype=SqlType.bool_())


def _string_col_cmp(op, a: Column, b: Column) -> Column:
    if a.sdict is b.sdict:
        return _cmp_data(op, a.data, b.data, _merge_valid(a, b))
    if op not in ("=", "!="):
        raise NotImplementedError("ordered compare across dictionaries")
    # translate a's codes into b's dictionary space (host, O(|dict|))
    assert a.sdict is not None and b.sdict is not None
    pos = np.searchsorted(b.sdict.values, a.sdict.values).astype(np.int64)
    exact = np.zeros(a.sdict.size, dtype=bool)
    inb = pos < b.sdict.size
    exact[inb] = b.sdict.values[pos[inb]] == a.sdict.values[inb]
    posm = take(_host_lut(pos, torch.int64, a.device), a.data)
    exm = take(_host_lut(exact, torch.bool, a.device), a.data)
    eq = exm & (posm == b.data.to(torch.int64))
    return Column(data=eq if op == "=" else ~eq, valid=_merge_valid(a, b),
                  dtype=SqlType.bool_())


def _eval_arith(e: ir.Arith, rel: Relation, n: int) -> Column:
    a = eval_expr(e.left, rel)
    b = eval_expr(e.right, rel)
    valid = _merge_valid(a, b)
    ta, tb = a.dtype, b.dtype

    # temporal arithmetic: DATE ± days, DATETIME ± days, DATE - DATE;
    # "INT + DATE" commutes, "INT - DATE" is a type error
    temporal = (TypeKind.DATE, TypeKind.DATETIME)
    if tb.kind in temporal and ta.kind == TypeKind.INT:
        if e.op == "+":
            a, b, ta, tb = b, a, tb, ta
        else:
            raise TypeError(f"cannot apply {e.op!r} to INT and {tb.kind.name}")
    if ta.kind in temporal and tb.kind == TypeKind.INT and e.op in "+-":
        d = a.data.to(torch.int64)
        o = b.data.to(torch.int64)
        if ta.kind == TypeKind.DATETIME:
            o = o * US_PER_DAY
        data = d + o if e.op == "+" else d - o
        if ta.kind == TypeKind.DATE:
            data = data.to(torch.int32)
        return Column(data=data, valid=valid, dtype=ta)
    if ta.kind in temporal and tb.kind in temporal and e.op == "-":
        da = a.data.to(torch.int64)
        db = b.data.to(torch.int64)
        if TypeKind.DATETIME in (ta.kind, tb.kind):
            if ta.kind == TypeKind.DATE:
                da = da * US_PER_DAY
            if tb.kind == TypeKind.DATE:
                db = db * US_PER_DAY
        return Column(data=da - db, valid=valid, dtype=SqlType.int_())
    if ta.kind in temporal or tb.kind in temporal:
        raise TypeError(
            f"unsupported arithmetic {ta.kind.name} {e.op} {tb.kind.name}")

    if e.op == "/":
        ct = div_result(ta, tb)
        fa, fb = _to_float(a, ct.kind), _to_float(b, ct.kind)
        zero = fb.data == 0
        quot = fa.data / torch.where(zero, torch.ones_like(fb.data), fb.data)
        data = torch.where(zero, torch.full_like(quot, float("nan")), quot)
        v = valid if valid is not None else _full(n, True, torch.bool,
                                                  zero.device)
        return Column(data=data, valid=v & ~zero, dtype=ct)

    if e.op == "*":
        ct = mul_result(ta, tb)
        if ct.kind == TypeKind.DECIMAL and ct.scale > 10:
            # combined fixed-point scale would overflow int64 on large
            # aggregates: computed in double, as the JAX package does
            fa, fb = _to_float(a), _to_float(b)
            return Column(data=fa.data * fb.data, valid=valid,
                          dtype=SqlType.double())
        if ct.kind == TypeKind.DECIMAL:
            data = a.data.to(torch.int64) * b.data.to(torch.int64)
            return Column(data=data, valid=valid, dtype=ct)
        da, db, c2 = _align_pair(a, b)
        return Column(data=da * db, valid=valid, dtype=c2)

    da, db, ct = _align_pair(a, b)
    if e.op == "+":
        data = da + db
    elif e.op == "-":
        data = da - db
    elif e.op == "%":
        # MySQL MOD: truncated division — result carries the dividend's sign
        zero = db == 0
        safe = torch.where(zero, torch.ones_like(db), db)
        data = torch.sign(da) * torch.remainder(da.abs(), safe.abs())
        data = torch.where(zero, torch.zeros_like(data), data)
        v = valid if valid is not None else _full(n, True, torch.bool,
                                                  zero.device)
        return Column(data=data, valid=v & ~zero, dtype=ct)
    else:  # pragma: no cover
        raise ValueError(e.op)
    return Column(data=data, valid=valid, dtype=add_result(ta, tb))


def _unify_branches(branches: list) -> tuple[list, SqlType, "StringDict | None"]:
    """Unify CASE branch columns to one physical representation.

    Numerics go through common_numeric; strings are re-encoded into a
    merged order-preserving dictionary; other kinds must match.  NULLTYPE
    branches adopt the result type.
    """
    kinds = {b.dtype.kind for b in branches
             if b.dtype.kind != TypeKind.NULLTYPE}
    if not kinds:
        return branches, SqlType.null(), None
    if kinds <= {TypeKind.INT, TypeKind.DECIMAL, TypeKind.FLOAT,
                 TypeKind.DOUBLE, TypeKind.BOOL}:
        if kinds == {TypeKind.BOOL}:
            rt = SqlType.bool_()
        else:
            rt = SqlType.int_()  # BOOL branches widen to INT when mixed
            for b in branches:
                if b.dtype.kind not in (TypeKind.NULLTYPE, TypeKind.BOOL):
                    rt = common_numeric(rt, b.dtype)
        return [cast_column(b, rt) for b in branches], rt, None
    if kinds == {TypeKind.STRING}:
        dicts = [b.sdict for b in branches if b.sdict is not None]
        if all(d is dicts[0] for d in dicts):
            return branches, SqlType.string(), dicts[0]
        allvals = np.unique(np.concatenate([d.values for d in dicts]))
        merged = StringDict(allvals)
        out = []
        for b in branches:
            if b.sdict is None:
                out.append(b)
                continue
            remap = np.searchsorted(allvals, b.sdict.values).astype(np.int32)
            codes = take(_host_lut(remap, torch.int32, b.device), b.data)
            out.append(Column(codes, b.valid, SqlType.string(), merged))
        return out, SqlType.string(), merged
    if len(kinds) == 1:
        rt = next(b.dtype for b in branches
                  if b.dtype.kind != TypeKind.NULLTYPE)
        return branches, rt, None
    raise TypeError(f"CASE branches mix incompatible types: {kinds}")


def _eval_case(e: ir.Case, rel: Relation, n: int) -> Column:
    conds = []
    vals = []
    for c, v in e.whens:
        conds.append(eval_expr(c, rel))
        vals.append(eval_expr(v, rel))
    else_c = eval_expr(e.else_, rel) if e.else_ is not None else None

    branches = vals + ([else_c] if else_c is not None else [])
    branches, rt, sdict = _unify_branches(branches)

    dev = rel.device
    if else_c is not None:
        data = branches[-1].data
        valid = branches[-1].valid_or_true()
    else:
        data = torch.zeros(n, dtype=branches[0].data.dtype, device=dev)
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    for cond, val in zip(conds, branches[: len(vals)]):
        t, _ = _tf(cond)
        sel = t & ~taken
        data = torch.where(sel, val.data.to(data.dtype), data)
        valid = torch.where(sel, val.valid_or_true(), valid)
        taken = taken | t
    return Column(data=data, valid=valid, dtype=rt, sdict=sdict)


def cast_column(c: Column, t: SqlType) -> Column:
    if c.dtype.kind == t.kind and c.dtype.scale == t.scale:
        return c
    if t.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
        return _to_float(c, t.kind)
    if t.kind == TypeKind.DECIMAL:
        if c.dtype.kind == TypeKind.DECIMAL:
            if t.scale >= c.dtype.scale:
                data = c.data * _POW10[t.scale - c.dtype.scale]
            else:
                data = _div_round(c.data, _POW10[c.dtype.scale - t.scale])
            return Column(data=data, valid=c.valid, dtype=t)
        if c.dtype.kind in (TypeKind.INT, TypeKind.BOOL):
            data = c.data.to(torch.int64) * _POW10[t.scale]
            return Column(data=data, valid=c.valid, dtype=t)
        if c.dtype.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
            data = torch.round(c.data * _POW10[t.scale]).to(torch.int64)
            return Column(data=data, valid=c.valid, dtype=t)
    if t.kind == TypeKind.INT:
        if c.dtype.kind == TypeKind.DECIMAL:
            data = _div_round(c.data, _POW10[c.dtype.scale])
        else:
            data = c.data.to(torch.int64)
        return Column(data=data, valid=c.valid, dtype=t)
    if t.kind == TypeKind.NULLTYPE or c.dtype.kind == TypeKind.NULLTYPE:
        return Column(data=c.data, valid=c.valid,
                      dtype=t if t.kind != TypeKind.NULLTYPE else c.dtype)
    if t.kind == TypeKind.BOOL:
        return Column(data=c.data != 0, valid=c.valid, dtype=t)
    raise NotImplementedError(f"cast {c.dtype} -> {t}")


def _div_round(x: torch.Tensor, d: int) -> torch.Tensor:
    """Round-half-away-from-zero integer division (MySQL decimal
    rounding); the divisions floor, as ``//`` does in the JAX package."""
    half = d // 2
    pos = torch.div(x + half, d, rounding_mode="floor")
    neg = -torch.div(-x + half, d, rounding_mode="floor")
    return torch.where(x >= 0, pos, neg)


# ---------------------------------------------------------------------------
# date decomposition (Hinnant civil-from-days, branch-free, floor division)
# ---------------------------------------------------------------------------

def _fdiv(x, d):
    """Floor division, as ``//`` on integer arrays in the JAX package."""
    return torch.div(x, d, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) as int64 lanes."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y, m, d):
    """Inverse of civil_from_days (Hinnant, floor-division form)."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y, m):
    leap = (((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0))
            | (torch.remainder(y, 400) == 0))
    lengths = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    base = take(lengths, torch.clamp(m - 1, 0, 11))
    return torch.where((m == 2) & leap, 29, base)


# ---------------------------------------------------------------------------
# UDF registry: user functions over torch tensors run inside the plan
# ---------------------------------------------------------------------------

_UDFS: dict[str, tuple] = {}


def register_udf(name: str, fn, result_type: "SqlType | None" = None):
    """Register fn(*tensors) -> tensor as a SQL scalar function.

    The function takes the argument columns' data tensors (on the
    relation's device) and returns one tensor of the same length; it must
    not read them on the host.  NULL handling is strict: the result is
    NULL where any input is NULL."""
    _UDFS[name.lower()] = (fn, result_type)


def unregister_udf(name: str):
    _UDFS.pop(name.lower(), None)


def _lut_gather(c: Column, values: np.ndarray, dtype) -> torch.Tensor:
    """Map a dictionary column's codes through a host table built over
    its dictionary (one value per code)."""
    return take(_host_lut(values, dtype, c.device), c.data)


def _eval_func(e: ir.FuncCall, rel: Relation, n: int) -> Column:
    name = e.name.lower()
    dev = rel.device
    if name in _UDFS:
        fn, rt = _UDFS[name]
        cols = [eval_expr(a, rel) for a in e.args]
        data = torch.as_tensor(fn(*[c.data for c in cols]), device=dev)
        valid = None
        for c in cols:
            valid = c.valid if valid is None else (
                valid if c.valid is None else (valid & c.valid))
        if rt is None:
            if data.is_floating_point():
                rt = SqlType.double()
            elif data.dtype == torch.bool:
                rt = SqlType.bool_()
            else:
                rt = SqlType.int_()
        return Column(data, valid, rt)
    if name == "match_against":
        # MATCH(col) AGAINST('terms'): token containment scored over the
        # dictionary on the host, then a gather maps codes to scores
        c = eval_expr(e.args[0], rel)
        terms = e.args[1].value if isinstance(e.args[1], ir.Literal) \
            else ""
        qtoks = [t for t in re.split(r"\W+", str(terms).lower()) if t]
        if c.sdict is None or not qtoks:
            return Column(_full(n, 0.0, torch.float64, dev), c.valid,
                          SqlType.double())

        def score(text):
            toks = set(re.split(r"\W+", str(text).lower()))
            return float(sum(1.0 for t in qtoks if t in toks))

        data = _lut_gather(c, c.sdict.lut(score).astype(np.float64),
                           torch.float64)
        if c.valid is not None:
            data = torch.where(c.valid, data, torch.zeros_like(data))
        return Column(data, c.valid, SqlType.double())
    if name in _VECTOR_FUNCS:
        return _vector_distance(name, e, rel)
    if name in ("extract_year", "year", "extract_month", "month",
                "extract_day", "day", "quarter", "dayofyear", "dayofweek",
                "weekday"):
        c = eval_expr(e.args[0], rel)
        y, m, d = civil_from_days(c.data)
        days = c.data.to(torch.int64)
        if name in ("extract_year", "year"):
            out = y
        elif name in ("extract_month", "month"):
            out = m
        elif name in ("extract_day", "day"):
            out = d
        elif name == "quarter":
            out = _fdiv(m + 2, 3)
        elif name == "dayofyear":
            out = days - days_from_civil(y, torch.ones_like(m),
                                         torch.ones_like(d)) + 1
        elif name == "dayofweek":   # MySQL: 1 = Sunday
            out = torch.remainder(days + 4, 7) + 1
        else:                       # weekday: 0 = Monday
            out = torch.remainder(days + 3, 7)
        return Column(data=out, valid=c.valid, dtype=SqlType.int_())
    if name == "add_months":
        c = eval_expr(e.args[0], rel)
        k = eval_expr(e.args[1], rel)
        y, m, d = civil_from_days(c.data)
        total = y * 12 + (m - 1) + k.data.to(torch.int64)
        y2 = _fdiv(total, 12)
        m2 = total - y2 * 12 + 1
        d2 = torch.minimum(d, _days_in_month(y2, m2))
        out = days_from_civil(y2, m2, d2).to(torch.int32)
        return Column(data=out, valid=_merge_valid(c, k), dtype=c.dtype)
    if name == "datediff":
        a = eval_expr(e.args[0], rel)
        b = eval_expr(e.args[1], rel)
        data = a.data.to(torch.int64) - b.data.to(torch.int64)
        return Column(data=data, valid=_merge_valid(a, b),
                      dtype=SqlType.int_())
    if name == "abs":
        c = eval_expr(e.args[0], rel)
        return c.with_data(torch.abs(c.data))
    if name == "sign":
        c = eval_expr(e.args[0], rel)
        return Column(torch.sign(c.data).to(torch.int64), c.valid,
                      SqlType.int_())
    if name in ("ceil", "ceiling", "floor"):
        c = eval_expr(e.args[0], rel)
        if c.dtype.kind == TypeKind.DECIMAL:
            s = _POW10[c.dtype.scale]
            if name == "floor":
                data = _fdiv(c.data, s)
            else:
                data = -_fdiv(-c.data, s)
            return Column(data, c.valid, SqlType.int_())
        if c.dtype.kind == TypeKind.INT:
            return c
        f = torch.floor if name == "floor" else torch.ceil
        return Column(f(c.data).to(torch.int64), c.valid, SqlType.int_())
    if name in ("round", "truncate"):
        c = eval_expr(e.args[0], rel)
        nd = 0
        if len(e.args) > 1:
            nd = e.args[1].value if isinstance(e.args[1], ir.Literal) else 0
        if c.dtype.kind == TypeKind.DECIMAL:
            target = SqlType(TypeKind.DECIMAL, c.dtype.precision,
                             max(nd, 0))
            if name == "round":
                return cast_column(c, target)
            if nd >= c.dtype.scale:
                return c
            d = _POW10[c.dtype.scale - max(nd, 0)]
            data = torch.where(c.data >= 0, _fdiv(c.data, d),
                               -_fdiv(-c.data, d))
            return Column(data, c.valid, target)
        if c.dtype.kind == TypeKind.INT:
            return c
        scale = 10.0 ** nd
        if name == "round":
            data = torch.round(c.data * scale) / scale
        else:
            data = torch.trunc(c.data * scale) / scale
        return Column(data, c.valid, c.dtype)
    if name in _UNARY_DOUBLE:
        c = _to_float(eval_expr(e.args[0], rel), TypeKind.DOUBLE)
        data = _UNARY_DOUBLE[name](c.data)
        bad = torch.isnan(data) | torch.isinf(data)
        return Column(data, c.valid_or_true() & ~bad, SqlType.double())
    if name in ("power", "pow"):
        a = _to_float(eval_expr(e.args[0], rel), TypeKind.DOUBLE)
        b = _to_float(eval_expr(e.args[1], rel), TypeKind.DOUBLE)
        return Column(torch.pow(a.data, b.data), _merge_valid(a, b),
                      SqlType.double())
    if name == "mod":
        return _eval_arith(ir.Arith("%", e.args[0], e.args[1]), rel, n)
    if name in ("greatest", "least"):
        cols = [eval_expr(a, rel) for a in e.args]
        cols, rt, sdict = _unify_branches(cols)
        opf = torch.maximum if name == "greatest" else torch.minimum
        data = cols[0].data
        valid = cols[0].valid
        for c in cols[1:]:
            data = opf(data, c.data)
            valid = _merge_valid(Column(data, valid, rt), c)
        return Column(data, valid, rt, sdict=sdict)
    if name == "ifnull":
        return _eval_func(ir.FuncCall("coalesce", e.args), rel, n)
    if name == "nullif":
        a = eval_expr(e.args[0], rel)
        t, _f = _tf(_eval_cmp(ir.Cmp("=", e.args[0], e.args[1]), rel, n))
        return Column(a.data, a.valid_or_true() & ~t, a.dtype, a.sdict)
    if name in ("length", "char_length", "character_length"):
        c = eval_expr(e.args[0], rel)
        assert c.sdict is not None, f"{name} requires a string column"
        return Column(_lut_gather(c, c.sdict.lut(len).astype("int64"),
                                  torch.int64), c.valid, SqlType.int_())
    if name in ("trim", "ltrim", "rtrim", "reverse"):
        fns = {"trim": str.strip, "ltrim": str.lstrip,
               "rtrim": str.rstrip, "reverse": lambda s: s[::-1]}
        return _dict_transform(e.args[0], rel, fns[name])
    if name == "replace":
        old = e.args[1].value
        new = e.args[2].value
        return _dict_transform(e.args[0], rel,
                               lambda s: s.replace(old, new))
    if name in ("left", "right"):
        k = e.args[1].value
        if name == "left":
            return _dict_transform(e.args[0], rel, lambda s: s[:k])
        return _dict_transform(e.args[0], rel,
                               lambda s: s[-k:] if k else "")
    if name == "concat":
        return _eval_concat(e, rel, n)
    if name == "coalesce":
        cols = [eval_expr(a, rel) for a in e.args]
        cols, rt, sdict = _unify_branches(cols)
        data = cols[-1].data
        valid = cols[-1].valid_or_true()
        for c in reversed(cols[:-1]):
            v = c.valid_or_true()
            data = torch.where(v, c.data, data)
            valid = v | valid
        return Column(data=data, valid=valid, dtype=rt, sdict=sdict)
    if name in ("substring", "substr", "upper", "lower"):
        return _dict_string_func(name, e, rel)
    if name in ("lcase", "ucase"):
        return _dict_transform(e.args[0], rel,
                               str.lower if name == "lcase" else str.upper)
    if name == "if":
        t = eval_predicate(e.args[0], rel)
        a = eval_expr(e.args[1], rel)
        b = eval_expr(e.args[2], rel)
        (a, b), rt, sdict = _unify_branches([a, b])
        data = torch.where(t, a.data, b.data)
        valid = torch.where(t, a.valid_or_true(), b.valid_or_true())
        return Column(data, valid, rt, sdict)
    if name == "isnull":
        c = eval_expr(e.args[0], rel)
        data = _full(n, False, torch.bool, dev) if c.valid is None \
            else ~c.valid
        return Column(data, None, SqlType.bool_())
    if name in _UNARY_RAW:
        # on the raw lanes (a decimal is not descaled), as in the JAX package
        c = eval_expr(e.args[0], rel)
        out = _UNARY_RAW[name](c.data.to(torch.float64))
        return Column(out, c.valid, SqlType.double())
    if name == "atan2":
        a = eval_expr(e.args[0], rel)
        b = eval_expr(e.args[1], rel)
        out = torch.atan2(a.data.to(torch.float64), b.data.to(torch.float64))
        return Column(out, _merge_valid(a, b), SqlType.double())
    if name == "pi":
        return Column(_full(n, np.pi, torch.float64, dev), None,
                      SqlType.double())
    if name == "log":
        # log(x) = ln; log(base, x) = ln(x)/ln(base) (MySQL)
        if len(e.args) == 1:
            c = eval_expr(e.args[0], rel)
            return Column(torch.log(c.data.to(torch.float64)), c.valid,
                          SqlType.double())
        b = eval_expr(e.args[0], rel)
        c = eval_expr(e.args[1], rel)
        out = torch.log(c.data.to(torch.float64)) / \
            torch.log(b.data.to(torch.float64))
        return Column(out, _merge_valid(b, c), SqlType.double())
    if name == "repeat" and len(e.args) == 2 and \
            isinstance(e.args[1], ir.Literal):
        k = int(e.args[1].value)
        return _dict_transform(e.args[0], rel, lambda s: s * max(k, 0))
    if name in ("lpad", "rpad"):
        k = int(e.args[1].value)
        pad = str(e.args[2].value) if len(e.args) > 2 else " "

        def _pad(s, k=k, pad=pad, left=(name == "lpad")):
            if len(s) >= k:
                return s[:k]
            fill = (pad * k)[: k - len(s)]
            return fill + s if left else s + fill

        return _dict_transform(e.args[0], rel, _pad)
    if name in ("instr", "locate", "position"):
        # instr(str, sub) / locate(sub, str): 1-based, 0 = not found
        if len(e.args) > 2:
            raise NotImplementedError(
                f"{name} with a start position is not supported")
        if name == "instr":
            col_a, sub_a = e.args[0], e.args[1]
        else:
            col_a, sub_a = e.args[1], e.args[0]
        sub = str(sub_a.value) if isinstance(sub_a, ir.Literal) else None
        if sub is None:
            raise NotImplementedError(f"{name} needs a literal needle")
        c = eval_expr(col_a, rel)
        assert c.sdict is not None, f"{name} requires a string column"
        lut = c.sdict.lut(lambda s: s.find(sub) + 1).astype("int64")
        return Column(_lut_gather(c, lut, torch.int64), c.valid,
                      SqlType.int_())
    if name == "ascii":
        c = eval_expr(e.args[0], rel)
        assert c.sdict is not None, "ascii requires a string column"
        lut = c.sdict.lut(lambda s: ord(s[0]) if s else 0).astype("int64")
        return Column(_lut_gather(c, lut, torch.int64), c.valid,
                      SqlType.int_())
    if name == "substring_index" and isinstance(e.args[1], ir.Literal) \
            and isinstance(e.args[2], ir.Literal):
        delim = str(e.args[1].value)
        cnt = int(e.args[2].value)

        def _si(s, d=delim, k=cnt):
            parts = s.split(d)
            return d.join(parts[:k]) if k >= 0 else d.join(parts[k:])

        return _dict_transform(e.args[0], rel, _si)
    if name == "concat_ws":
        sep = str(e.args[0].value) if isinstance(e.args[0], ir.Literal) \
            else None
        if sep is None:
            raise NotImplementedError("concat_ws needs a literal sep")
        if len(e.args) < 2:
            raise NotImplementedError("concat_ws needs value arguments")
        # NULL values are SKIPPED with their separator, unlike CONCAT's
        # null propagation: fold with CASE
        out = e.args[1]
        for a in e.args[2:]:
            out = ir.Case(whens=[
                (ir.FuncCall("isnull", [out]), a),
                (ir.FuncCall("isnull", [a]), out),
            ], else_=ir.FuncCall("concat", [out, ir.Literal(sep), a]))
        out = ir.FuncCall("coalesce", [out, ir.Literal("")])
        return eval_expr(out, rel)
    if name in ("md5", "sha1", "hex"):
        fns = {"md5": lambda s: hashlib.md5(s.encode()).hexdigest(),
               "sha1": lambda s: hashlib.sha1(s.encode()).hexdigest(),
               "hex": lambda s: s.encode().hex().upper()}
        return _dict_transform(e.args[0], rel, fns[name])
    if name in ("dayname", "monthname"):
        c = eval_expr(e.args[0], rel)
        if name == "dayname":
            names = np.array(["Monday", "Tuesday", "Wednesday",
                              "Thursday", "Friday", "Saturday",
                              "Sunday"], dtype=object)
            codes = torch.remainder(c.data.to(torch.int64) + 3, 7)
        else:
            names = np.array(["January", "February", "March", "April",
                              "May", "June", "July", "August",
                              "September", "October", "November",
                              "December"], dtype=object)
            _y, m, _d = civil_from_days(c.data)
            codes = m - 1
        # StringDict values must be sorted (searchsorted code lookups)
        order = np.argsort(names.astype(str))
        remap = _host_lut(np.argsort(order).astype(np.int32), torch.int32,
                          dev)
        return Column(take(remap, codes), c.valid, SqlType.string(),
                      StringDict(names[order]))
    if name == "last_day":
        c = eval_expr(e.args[0], rel)
        y, m, _d = civil_from_days(c.data)
        out = days_from_civil(y, m, _days_in_month(y, m)).to(torch.int32)
        return Column(out, c.valid, c.dtype)
    raise NotImplementedError(f"function {name}")


_VECTOR_FUNCS = ("l2_distance", "inner_product", "negative_inner_product",
                 "cosine_distance")


def parse_vector_text(s: str) -> np.ndarray:
    """'[0.1, 0.2, ...]' -> float32 ndarray (the vector literal format)."""
    body = s.strip()
    if body.startswith("[") and body.endswith("]"):
        body = body[1:-1]
    if not body.strip():
        return np.zeros(0, dtype=np.float32)
    return np.asarray([float(x) for x in body.split(",")],
                      dtype=np.float32)


def _vector_distance(name: str, e: ir.FuncCall, rel: Relation) -> Column:
    """A distance between a VECTOR column and a '[...]' literal or a
    second VECTOR column: [n, d] x [d] (or [n, d] x [n, d]) -> [n]
    DOUBLE, computed in float32 as the JAX package does; NULL where
    either argument is."""
    def arg(x):
        if isinstance(x, ir.Literal) and isinstance(x.value, str):
            v = parse_vector_text(x.value)
            return Column(_host_lut(v, torch.float32, rel.device), None,
                          SqlType.vector(len(v)))
        return eval_expr(x, rel)

    a, b = arg(e.args[0]), arg(e.args[1])
    va, vb = a.data.to(torch.float32), b.data.to(torch.float32)
    if va.ndim == 1 and vb.ndim == 2:
        va, vb = vb, va
    if vb.ndim == 1:
        vb = vb[None, :]
    if name == "l2_distance":
        diff = va - vb
        out = torch.sqrt((diff * diff).sum(dim=-1).to(torch.float64))
    elif name == "cosine_distance":
        num = (va * vb).sum(dim=-1)
        na = torch.sqrt((va * va).sum(dim=-1))
        nb = torch.sqrt((vb * vb).sum(dim=-1))
        out = (1.0 - num / torch.clamp(na * nb, min=1e-12)).to(torch.float64)
    else:
        out = (va * vb).sum(dim=-1).to(torch.float64)
        if name == "negative_inner_product":
            out = -out
    return Column(out, _merge_valid(a, b), SqlType.double())


_UNARY_DOUBLE = {"sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
                 "log2": torch.log2, "log10": torch.log10, "sin": torch.sin,
                 "cos": torch.cos, "tan": torch.tan}

_UNARY_RAW = {"atan": torch.atan, "asin": torch.asin, "acos": torch.acos,
              "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
              "cot": lambda v: 1.0 / torch.tan(v),
              "degrees": torch.rad2deg, "radians": torch.deg2rad}


def _remap_dict(c: Column, mapped: np.ndarray) -> Column:
    """Re-encode a dictionary column whose values map to ``mapped`` (one
    per code): the new sorted dictionary plus a device gather of codes."""
    new_values, inv = np.unique(mapped, return_inverse=True)
    codes = _lut_gather(c, inv.astype(np.int32), torch.int32)
    return Column(codes, c.valid, SqlType.string(), StringDict(new_values))


def _dict_transform(arg: ir.Expr, rel: Relation, fn) -> Column:
    """Apply a host string function through the dictionary (LUT + remap)."""
    c = eval_expr(arg, rel)
    assert c.sdict is not None, "string function requires dict column"
    return _remap_dict(c, c.sdict.lut(fn).astype(object))


_CONCAT_DICT_LIMIT = 1 << 20


def _eval_concat(e: ir.FuncCall, rel: Relation, n: int) -> Column:
    """CONCAT over dict columns/literals.  Column x column concatenation
    materializes the code-pair product dictionary, guarded by a size cap."""
    cols = [eval_expr(a, rel) for a in e.args]
    out = cols[0]
    for c in cols[1:]:
        if out.sdict is None or c.sdict is None:
            raise NotImplementedError("concat requires string operands")
        if out.sdict.size * c.sdict.size > _CONCAT_DICT_LIMIT:
            raise NotImplementedError(
                "concat dictionary product too large (round-1 limit)")
        pairs = np.char.add(
            np.repeat(out.sdict.values.astype(str), c.sdict.size),
            np.tile(c.sdict.values.astype(str), out.sdict.size),
        ).astype(object)
        new_values, inv = np.unique(pairs, return_inverse=True)
        remap = _host_lut(inv.astype(np.int32), torch.int32, out.device)
        a = torch.clamp(out.data.to(torch.int64), 0, out.sdict.size - 1)
        b = torch.clamp(c.data.to(torch.int64), 0, c.sdict.size - 1)
        codes = take(remap, a * c.sdict.size + b)
        out = Column(codes, _merge_valid(out, c), SqlType.string(),
                     StringDict(new_values))
    return out


def _dict_string_func(name: str, e: ir.FuncCall, rel: Relation) -> Column:
    """String functions as dictionary transforms (host) + device remap."""
    c = eval_expr(e.args[0], rel)
    assert c.sdict is not None, f"{name} requires dict-encoded column"
    if name in ("substring", "substr"):
        start = e.args[1].value if isinstance(e.args[1], ir.Literal) \
            else e.args[1]
        length = None
        if len(e.args) > 2:
            length = e.args[2].value if isinstance(e.args[2], ir.Literal) \
                else e.args[2]
        s0 = start - 1

        def f(s):
            return s[s0: s0 + length] if length is not None else s[s0:]
    elif name == "upper":
        def f(s):
            return s.upper()
    else:
        def f(s):
            return s.lower()
    return _remap_dict(c, c.sdict.lut(f))


def eval_predicate(e: ir.Expr, rel: Relation) -> torch.Tensor:
    """Evaluate a WHERE predicate to a live-row bool mask (NULL -> False),
    combined with the relation's existing mask."""
    t, _ = _tf(eval_expr(e, rel))
    return t & rel.mask_or_true()
