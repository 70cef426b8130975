"""TPC-H tables as ``|``-delimited text files, the input LOAD DATA reads.

``write_tbl`` writes one table the way dbgen's ``.tbl`` files carry it
(DECIMAL as ``123.45``, DATE as ``YYYY-MM-DD``, strings as they are),
one row per line, without dbgen's trailing ``|``: the CSV tokenizer
counts fields by delimiter, so a trailing one would read as an extra,
empty column.  Each block of rows is formatted with one format string
(a DECIMAL as sign, whole part and zero-padded fraction; a DATE through
a lookup table of the block's days).
"""

from __future__ import annotations

import numpy as np

from oceanbase_tpu_torch.datatypes import DATE_EPOCH, SqlType, TypeKind

BLOCK_ROWS = 1 << 20
_SIGN = np.array(["", "-"], dtype=object)


def _fields(values: np.ndarray, dtype: SqlType | None):
    """One column block -> (format spec, [lists of format arguments])."""
    kind = dtype.kind if dtype is not None else None
    if kind == TypeKind.DECIMAL and dtype.scale:
        s = dtype.scale
        v = values.astype(np.int64)
        mag = np.abs(v)
        return ("{}{}.{:0%dd}" % s,
                [_SIGN[(v < 0).astype(np.int8)].tolist(),
                 (mag // 10**s).tolist(), (mag % 10**s).tolist()])
    if kind == TypeKind.DATE and len(values):
        lo = int(values.min())
        days = np.arange(lo, int(values.max()) + 1).astype("timedelta64[D]")
        lut = (DATE_EPOCH + days).astype(str).astype(object)
        return "{}", [lut[values.astype(np.int64) - lo].tolist()]
    return "{}", [values.tolist()]


def write_tbl(path: str, arrays: dict, types: dict | None = None,
              columns: list | None = None) -> int:
    """Write ``arrays`` ({column: values}, in ``columns`` order) as
    ``|``-delimited lines -> bytes written."""
    columns = list(columns or arrays)
    n = len(arrays[columns[0]]) if columns else 0
    written = 0
    with open(path, "wb") as f:
        for s in range(0, n, BLOCK_ROWS):
            e = min(s + BLOCK_ROWS, n)
            specs, args = [], []
            for c in columns:
                spec, lists = _fields(np.asarray(arrays[c][s:e]),
                                      (types or {}).get(c))
                specs.append(spec)
                args.extend(lists)
            fmt = "|".join(specs)
            data = ("\n".join(fmt.format(*r) for r in zip(*args))
                    + "\n").encode()
            f.write(data)
            written += len(data)
    return written


def create_table_sql(name: str, arrays: dict, types: dict | None,
                     primary_key: list, partition=None) -> str:
    """CREATE TABLE for generated ``arrays`` (column types from
    ``types``, INT for integers, VARCHAR for strings), with ``partition``
    = (column, [upper bounds]) as RANGE partitions, the last one up to
    MAXVALUE."""
    cols = []
    for c, a in arrays.items():
        t = (types or {}).get(c)
        if t is not None:
            sql = f"decimal({t.precision},{t.scale})" \
                if t.kind == TypeKind.DECIMAL else t.kind.value
        else:
            sql = "varchar(256)" if np.asarray(a).dtype == object else "int"
        cols.append(f"{c} {sql}")
    if primary_key:
        cols.append(f"primary key ({', '.join(primary_key)})")
    text = f"create table {name} ({', '.join(cols)})"
    if partition is not None:
        pcol, bounds = partition
        parts = [f"partition p{i} values less than ({int(b)})"
                 for i, b in enumerate(bounds)]
        parts.append(f"partition p{len(bounds)} values less than maxvalue")
        text += f" partition by range ({pcol}) ({', '.join(parts)})"
    return text


def values_row(arrays: dict, types: dict | None, i: int) -> str:
    """Row ``i`` of generated ``arrays`` as a VALUES tuple (DECIMAL from
    its scaled int, DATE as text, strings quoted)."""
    from oceanbase_tpu_torch.datatypes import days_to_date
    from oceanbase_tpu_torch.server.mysql_protocol import format_decimal

    out = []
    for c, a in arrays.items():
        t = (types or {}).get(c)
        x = a[i]
        if t is not None and t.kind == TypeKind.DECIMAL:
            out.append(format_decimal(int(x), t.scale))
        elif t is not None and t.kind == TypeKind.DATE:
            out.append(f"'{days_to_date(int(x))}'")
        elif isinstance(x, str):
            out.append("'" + x.replace("'", "''") + "'")
        else:
            out.append(str(int(x)))
    return "(" + ", ".join(out) + ")"


__all__ = ["create_table_sql", "values_row", "write_tbl"]
