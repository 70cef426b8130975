"""SQLite oracle for result-parity testing.

The port's own copy of ``oceanbase_tpu/bench/oracle.py``.

≙ the reference's mysqltest result diffing against a known-good engine
(tools/deploy/mysql_test, SURVEY §4 tier 4).  Loads the generated TPC-H
data into an in-memory SQLite database and translates our MySQL-ish SQL
into SQLite's dialect (date literals/arithmetic, EXTRACT, SUBSTRING).
"""

from __future__ import annotations

import re
import sqlite3

import numpy as np

from oceanbase_tpu_torch.datatypes import DATE_EPOCH, TypeKind


def load_sqlite(tables: dict, types: dict) -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    for name, cols in tables.items():
        colnames = list(cols)
        decls = ", ".join(colnames)
        conn.execute(f"create table {name} ({decls})")
        n = len(next(iter(cols.values())))
        pycols = []
        for c in colnames:
            arr = cols[c]
            t = types.get(c)
            # decimals and dates convert as whole arrays (the same values
            # as days_to_date and an int / 10**scale, row by row)
            if t is not None and t.kind == TypeKind.DECIMAL:
                pycols.append((arr / (10 ** t.scale)).tolist())
            elif t is not None and t.kind == TypeKind.DATE:
                pycols.append(np.datetime_as_string(
                    DATE_EPOCH + arr.astype("timedelta64[D]")).tolist())
            elif arr.dtype == object or arr.dtype.kind in "US":
                pycols.append([str(v) for v in arr])
            else:
                pycols.append(arr.tolist())
        rows = list(zip(*pycols))
        ph = ",".join("?" * len(colnames))
        conn.executemany(f"insert into {name} values ({ph})", rows)
    # index every *key column (PKs and FKs) so correlated subqueries and
    # joins in the ORACLE don't go quadratic at SF>=0.1 — the oracle's
    # job is to be correct AND fast enough to produce SF1 evidence
    for name, cols in tables.items():
        for c in cols:
            if c.endswith("key"):
                conn.execute(
                    f"create index idx_{name}_{c} on {name} ({c})")
    conn.execute("analyze")
    conn.commit()
    return conn


_DATE_RE = re.compile(r"date\s+'([0-9-]+)'", re.I)
_INTERVAL_RE = re.compile(
    r"'([0-9-]+)'\s*([+-])\s*interval\s+'(\d+)'\s+(year|month|day)", re.I)
_EXTRACT_RE = re.compile(r"extract\s*\(\s*year\s+from\s+([a-z0-9_.]+)\s*\)", re.I)
_SUBSTR_RE = re.compile(
    r"substring\s*\(\s*([a-z0-9_.]+)\s+from\s+(\d+)\s+for\s+(\d+)\s*\)", re.I)


def to_sqlite_sql(sql: str) -> str:
    s = _DATE_RE.sub(r"'\1'", sql)
    # fold '<date>' +/- interval 'n' unit  -> literal date
    while True:
        m = _INTERVAL_RE.search(s)
        if not m:
            break
        base, sign, n, unit = m.groups()
        d = np.datetime64(base, "D")
        k = int(n) if sign == "+" else -int(n)
        if unit.lower() == "day":
            d2 = d + np.timedelta64(k, "D")
        elif unit.lower() == "month":
            mm = d.astype("datetime64[M]") + np.timedelta64(k, "M")
            day = (d - d.astype("datetime64[M]")).astype(int)
            d2 = mm.astype("datetime64[D]") + np.timedelta64(int(day), "D")
        else:
            yy = d.astype("datetime64[Y]") + np.timedelta64(k, "Y")
            rest = d - d.astype("datetime64[Y]").astype("datetime64[D]")
            d2 = yy.astype("datetime64[D]") + rest
        s = s[: m.start()] + f"'{d2}'" + s[m.end():]
    s = _EXTRACT_RE.sub(r"cast(strftime('%Y', \1) as integer)", s)
    s = _SUBSTR_RE.sub(r"substr(\1, \2, \3)", s)
    return s


def run_oracle(conn: sqlite3.Connection, sql: str) -> list[tuple]:
    cur = conn.execute(to_sqlite_sql(sql))
    return [tuple(r) for r in cur.fetchall()]


def run_oracle_stmt(conn: sqlite3.Connection, sql: str):
    """Any statement -> (rows, rowcount); a DML statement's rowcount is
    the rows it changed (SQLite's ``changes()``), a query's is -1."""
    cur = conn.execute(to_sqlite_sql(sql))
    return [tuple(r) for r in cur.fetchall()], cur.rowcount


def rows_match(got: list[tuple], want: list[tuple], ordered: bool,
               rtol: float = 1e-6) -> tuple[bool, str]:
    if len(got) != len(want):
        return False, f"row count {len(got)} != {len(want)}"

    def key(row):
        return tuple((x is None, str(type(x).__name__) if False else "",
                      round(x, 6) if isinstance(x, float) else x)
                     for x in row)

    g = got if ordered else sorted(got, key=key)
    w = want if ordered else sorted(want, key=key)
    for i, (gr, wr) in enumerate(zip(g, w)):
        if len(gr) != len(wr):
            return False, f"row {i} arity mismatch"
        for j, (a, b) in enumerate(zip(gr, wr)):
            if a is None or b is None:
                if a is not b:
                    return False, f"row {i} col {j}: {a!r} != {b!r}"
                continue
            if isinstance(a, float) or isinstance(b, float):
                fa, fb = float(a), float(b)
                if abs(fa - fb) > rtol * max(1.0, abs(fa), abs(fb)):
                    return False, f"row {i} col {j}: {fa} != {fb}"
                continue
            if a != b:
                return False, f"row {i} col {j}: {a!r} != {b!r}"
    return True, ""
