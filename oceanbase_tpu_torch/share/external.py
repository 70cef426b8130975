"""External (lake) tables + Arrow interop.

Port of ``oceanbase_tpu/share/external.py`` (≙ src/share/external_table:
external files scanned at query time; the Arrow bridge of
src/sql/engine/basic/ob_arrow_basic.h).  Files are read lazily at query
time and mapped into the engine's column domains: dates -> epoch days,
DECIMAL -> scaled int64, strings -> object arrays (dictionary-encoded at
device upload).

A CSV file is read with the port's own tokenizer (``native.csv_tokenize``
and its field parsers, as LOAD DATA reads one; the python ``csv`` module
when the native library is missing or a line is empty), keeping the
value rules the reference gets from ``pyarrow.csv`` with its default
options: the table's column names, ``skip_rows`` lines skipped first,
the delimiter, ``"``-quoted fields with ``""`` escapes, empty lines
ignored, a numeric field in pyarrow's null spellings (the empty field,
``NULL``, ``NaN``, ``N/A``...) is NULL, a string field keeps ``""`` and
is never NULL.  DECIMAL fields parse exactly (round half away from
zero at the column's scale), where the reference rounds through a
float.  Parquet and ``result_to_arrow`` need pyarrow and import it at
call time (``ArrowUnavailable`` names it when it is missing).
"""

from __future__ import annotations

import csv
import io

import numpy as np

from oceanbase_tpu_torch import native
from oceanbase_tpu_torch.datatypes import (
    DATE_EPOCH,
    SqlType,
    TypeKind,
    date_to_days,
    days_to_date,
)

# pyarrow.csv.ConvertOptions' default null spellings (a column read as
# a number or a bool takes these as NULL; a string column never does)
_NULL_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                "-NaN", "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL",
                "NaN", "n/a", "nan", "null")
_TRUE_VALUES = ("1", "True", "TRUE", "true")
_FALSE_VALUES = ("0", "False", "FALSE", "false")


class ArrowUnavailable(ImportError):
    """A format or export that needs pyarrow was asked for without it."""


class ArrowInvalid(ValueError):
    """A CSV the reader cannot take (a ragged line, a field that does
    not convert to its column's type); named as the reference's reader
    (``pyarrow.lib.ArrowInvalid``, also a ValueError) names it."""


def _pyarrow(what: str):
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ArrowUnavailable(f"{what} needs pyarrow, which is not "
                               "installed") from e
    return pa


def _coerce_arrow_column(arr, t: SqlType):
    """One arrow ChunkedArray/Array -> (np array, valid|None) in the
    STORAGE domain for SqlType t."""
    pa = _pyarrow("an Arrow column")

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    valid = None
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
    k = t.kind
    if k == TypeKind.STRING:
        data = np.asarray(arr.cast(pa.string()).to_pylist(), dtype=object)
        data = np.array([v if v is not None else "" for v in data],
                        dtype=object)
        return data, valid
    if k == TypeKind.DATE:
        if pa.types.is_date32(arr.type) or pa.types.is_date64(arr.type):
            days = arr.cast(pa.date32()).cast(pa.int32())
            data = np.asarray(days.to_numpy(zero_copy_only=False))
        else:
            data = np.array([date_to_days(str(v)) if v is not None else 0
                             for v in arr.to_pylist()], dtype=np.int32)
        return data.astype(np.int32), valid
    if k == TypeKind.DECIMAL:
        scale = 10 ** t.scale
        vals = arr.to_pylist()
        data = np.array([int(round(float(v) * scale)) if v is not None
                         else 0 for v in vals], dtype=np.int64)
        return data, valid
    if k in (TypeKind.DOUBLE, TypeKind.FLOAT):
        data = np.asarray(arr.cast(pa.float64())
                          .to_numpy(zero_copy_only=False))
        return np.nan_to_num(data), valid
    if k == TypeKind.BOOL:
        data = np.asarray(arr.cast(pa.bool_())
                          .to_numpy(zero_copy_only=False))
        return np.where(np.asarray(valid, bool) if valid is not None
                        else True, data, False).astype(bool), valid
    data = np.asarray(arr.cast(pa.int64()).to_numpy(zero_copy_only=False))
    if valid is not None:
        data = np.where(valid, data, 0)
    return data.astype(np.int64), valid


def arrow_to_arrays(table, tdef=None):
    """pyarrow Table -> (arrays, valids, types) keyed by column name.
    With a tdef the declared SqlTypes drive coercion; otherwise types
    infer from the arrow schema."""
    pa = _pyarrow("an Arrow table")

    arrays, valids, types = {}, {}, {}
    for i, field in enumerate(table.schema):
        name = field.name
        if tdef is not None:
            t = tdef.column(name).dtype
        else:
            at = field.type
            if pa.types.is_string(at) or pa.types.is_large_string(at):
                t = SqlType.string()
            elif pa.types.is_floating(at):
                t = SqlType.double()
            elif pa.types.is_date(at):
                t = SqlType.date()
            elif pa.types.is_decimal(at):
                t = SqlType.decimal(at.precision, at.scale)
            elif pa.types.is_boolean(at):
                t = SqlType.bool_()
            else:
                t = SqlType.int_()
        data, valid = _coerce_arrow_column(table.column(i), t)
        arrays[name] = data
        if valid is not None:
            valids[name] = valid
        types[name] = t
    return arrays, valids, types


def read_external(location: str, fmt: str, tdef, delimiter: str = ",",
                  skip_lines: int = 0):
    """Read one external file -> (arrays, valids, types)."""
    if fmt == "parquet":
        _pyarrow("FORMAT parquet")
        import pyarrow.parquet as pq

        table = pq.read_table(location,
                              columns=[c.name for c in tdef.columns])
        return arrow_to_arrays(table, tdef)
    if fmt == "csv":
        with open(location, "rb") as f:
            data = f.read()
        return read_csv_bytes(data, tdef, delimiter, skip_lines)
    raise ValueError(f"unsupported external format {fmt!r}")


def _skip_lines(data: bytes, skip: int) -> bytes:
    """Drop the first ``skip`` physical lines (pyarrow's ``skip_rows``)."""
    pos = 0
    for _ in range(skip):
        nl = data.find(b"\n", pos)
        if nl < 0:
            return b""
        pos = nl + 1
    return data[pos:]


def _tokenize(data: bytes, n_cols: int, delimiter: str):
    """-> (data, offsets, lengths, n_rows) for ``data`` cut into fields:
    the native tokenizer when it serves the file, else the python csv
    module (empty lines skipped, a ragged line raises)."""
    tok = None
    if b"\n\n" not in data and b"\r\n\r\n" not in data \
            and not data.startswith((b"\n", b"\r")):
        tok = native.csv_tokenize(data, n_cols, delimiter)
    if tok is not None:
        _buf, offs, lens, n = tok
        return data, offs, lens, n
    rows = []
    text = data.decode("utf-8")
    for i, row in enumerate(csv.reader(io.StringIO(text, newline=""),
                                       delimiter=delimiter)):
        if not row:
            continue  # an empty line
        if len(row) != n_cols:
            raise ArrowInvalid(f"CSV parse error: expected {n_cols} "
                             f"columns, got {len(row)} (line {i + 1})")
        rows.append(row)
    # re-pack the cells as one buffer of fields, unescaped
    parts, offs, lens, pos = [], [], [], 0
    for row in rows:
        for cell in row:
            b = cell.encode("utf-8")
            parts.append(b)
            offs.append(pos)
            lens.append(len(b))
            pos += len(b)
    return (b"".join(parts), np.asarray(offs, dtype=np.uint64),
            np.asarray(lens, dtype=np.uint32), len(rows))


def _cells(data: bytes, offs, lens) -> np.ndarray:
    fixed = native.field_bytes(data, offs, lens)
    if fixed is not None:
        return fixed.astype("U")
    return native.field_strings(data, offs, lens).astype("U")


def _csv_column(data: bytes, offs, lens, t: SqlType, name: str):
    """One tokenized column -> (np array, valid|None) in the storage
    domain of ``t``, with pyarrow's value rules."""
    n = len(offs)
    k = t.kind
    if k == TypeKind.STRING:
        return native.field_strings(data, offs, lens), None
    cells = _cells(data, offs, lens)
    if k == TypeKind.DATE:
        try:
            d64 = cells.astype("datetime64[D]")
        except ValueError:
            # the reference's per-value parse raises on the bad cell
            return np.array([date_to_days(str(v)) for v in cells],
                            dtype=np.int32), None
        return (d64 - DATE_EPOCH).astype(np.int32), None
    if k == TypeKind.DECIMAL:
        out, valid = native.parse_int64_fields(
            np.frombuffer(data, dtype=np.uint8), offs, lens, t.scale)
        if not valid.all():
            bad = cells[~valid][0]
            raise ValueError(f"could not convert {bad!r} to "
                             f"{t} in column {name!r}")
        return out, None
    null = np.isin(cells, _NULL_VALUES)
    valid = ~null
    if k in (TypeKind.DOUBLE, TypeKind.FLOAT):
        data_f = np.zeros(n, dtype=np.float64)
        try:
            data_f[valid] = cells[valid].astype(np.float64)
        except ValueError:
            raise ArrowInvalid(f"CSV conversion error to double in "
                               f"column {name!r}") from None
        return np.nan_to_num(data_f), (valid if null.any() else None)
    if k == TypeKind.BOOL:
        tv = np.isin(cells, _TRUE_VALUES)
        fv = np.isin(cells, _FALSE_VALUES)
        if (valid & ~tv & ~fv).any():
            # a column of other integers is read as int64, then cast
            try:
                ints = np.zeros(n, dtype=np.int64)
                ints[valid] = cells[valid].astype(np.int64)
            except ValueError:
                raise ArrowInvalid(f"CSV conversion error to bool in "
                                   f"column {name!r}") from None
            tv = valid & (ints != 0)
        return (tv & valid).astype(bool), (valid if null.any() else None)
    out, ok = native.parse_int64_fields(
        np.frombuffer(data, dtype=np.uint8), offs, lens, 0)
    bad = valid & ~ok
    if bad.any():
        # an integral float (``1.0``) casts to int64, anything else is
        # the reference's cast error
        for i in np.nonzero(bad)[0]:
            try:
                f = float(cells[i])
            except ValueError:
                f = None
            if f is None or not np.isfinite(f) or f != int(f):
                raise ArrowInvalid(f"CSV conversion error to int64 in "
                                   f"column {name!r}: {cells[i]!r}")
            out[i] = int(f)
    out = np.where(valid, out, 0).astype(np.int64)
    return out, (valid if null.any() else None)


def read_csv_bytes(data: bytes, tdef, delimiter: str = ",",
                   skip_lines: int = 0):
    """CSV bytes -> (arrays, valids, types) for ``tdef``'s columns."""
    n_cols = len(tdef.columns)
    body, offsets, lengths, n = _tokenize(_skip_lines(data, skip_lines),
                                          n_cols, delimiter)
    arrays, valids, types = {}, {}, {}
    for j, c in enumerate(tdef.columns):
        offs = np.ascontiguousarray(offsets[j::n_cols][:n])
        lens = np.ascontiguousarray(lengths[j::n_cols][:n])
        arr, valid = _csv_column(body, offs, lens, c.dtype, c.name)
        arrays[c.name] = arr
        if valid is not None:
            valids[c.name] = valid
        types[c.name] = c.dtype
    return arrays, valids, types


def result_to_arrow(result):
    """Result -> pyarrow Table (the Arrow export boundary)."""
    pa = _pyarrow("result_to_arrow")

    cols, names = [], []
    for name in result.names:
        a = result.arrays[name]
        v = result.valids.get(name)
        t = result.dtypes.get(name)
        if t is not None and t.kind == TypeKind.DECIMAL:
            vals = [None if (v is not None and not v[i])
                    else float(a[i]) / (10 ** t.scale)
                    for i in range(len(a))]
            cols.append(pa.array(vals, type=pa.float64()))
        elif t is not None and t.kind == TypeKind.DATE:
            vals = [None if (v is not None and not v[i])
                    else days_to_date(int(a[i])) for i in range(len(a))]
            cols.append(pa.array(vals, type=pa.string()))
        else:
            vals = [None if (v is not None and not v[i]) else
                    (a[i].item() if hasattr(a[i], "item") else a[i])
                    for i in range(len(a))]
            cols.append(pa.array(vals))
        names.append(name)
    return pa.table(dict(zip(names, cols)))
