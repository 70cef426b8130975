"""The port's external tables against the JAX package's: CREATE EXTERNAL
TABLE over a CSV read at query time (by the port's own tokenizer, never
pyarrow), joins with stored tables, a file that changes under the
table, persistence with a Database and DROP, Parquet and Arrow export
(these two need pyarrow in both packages), and the CSV value rules the
reference gets from ``pyarrow.csv`` — column names from the table,
skipped lines, the delimiter, pyarrow's null spellings for numbers, an
empty string field kept, quoted fields, empty lines — each pinned
against the reference.  The reference rounds a DECIMAL field through a
float; the port parses it exactly (ROADMAP Queue 3 #20), and the cases
at such values hold the port against SQLite's text arithmetic instead.
The cases mirror ``tests/test_external_tables.py``."""

from __future__ import annotations

import os
import sqlite3
import time

import numpy as np
import pytest
import torch

from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu_torch.sql import Session as TSession
from test_torch_sql_frontend import align_colids
from torch_pair import both, outcome

torch.set_num_threads(2)


def _sessions():
    return [("jax", JSession()), ("port", TSession(device="cpu"))]


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def _outcome(s, sql):
    try:
        r = s.execute(sql)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__)
    return ("ok", r.names, r.rows())


def _both_sessions(ddl, queries):
    """Run ``ddl`` then ``queries`` in a JAX and a port catalog session;
    -> the port's outcomes, held equal to the reference's."""
    (_j, js), (_t, ts) = _sessions()
    js.execute(ddl)
    ts.execute(ddl)
    outs = {"jax": [], "port": []}
    for q in queries:
        align_colids()
        outs["jax"].append(_outcome(js, q))
        outs["port"].append(_outcome(ts, q))
    assert outs["port"] == outs["jax"], outs
    return outs["port"]


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------


def test_external_csv_table(tmp_path):
    p = tmp_path / "sales.csv"
    _write(p, "1,north,2024-01-05,10.50\n2,south,2024-02-11,3.25\n"
              "3,north,2024-03-02,7.00\n")
    outs = {}
    for name, s in _sessions():
        s.execute(f"create external table sales (id int, region "
                  f"varchar(16), d date, amt decimal(10,2)) location '{p}'")
        s.catalog.load_numpy("dim", {
            "region": np.array(["north", "south"], dtype=object),
            "mgr": np.array(["ann", "bob"], dtype=object)})
        outs[name] = []
        for q in ("select region, sum(amt), count(*) from sales"
                  " group by region order by region",
                  "select id from sales where d >= date '2024-02-01'"
                  " order by id",
                  "select mgr, count(*) from sales join dim using (region)"
                  " group by mgr order by mgr",
                  "select * from sales order by id"):
            align_colids()
            outs[name].append(_outcome(s, q)[::2])  # outcome and rows
        s.execute("drop table sales")
        outs[name].append(s.catalog.has_table("sales"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][1] == [("north", 17.5, 2), ("south", 3.25, 1)]
    assert outs["port"][-1] is False


def test_external_csv_reflects_file_changes(tmp_path):
    p = tmp_path / "t.csv"
    counts = {}
    for name, s in _sessions():
        _write(p, "1,10\n")
        s.execute(f"create external table t (k int, v int) location '{p}'")
        got = [s.execute("select count(*) from t").rows()]
        _write(p, "1,10\n2,20\n3,30\n")
        os.utime(p, (time.time() + 5, time.time() + 5))
        got.append(s.execute("select count(*) from t").rows())
        counts[name] = got
    assert counts["port"] == counts["jax"] == [[(1,)], [(3,)]]


def _scn_persists(P, root):
    p = root / "e.csv"
    root.mkdir(parents=True)
    _write(p, "1,5\n2,6\n")
    db = P.db(root / "db")
    s = db.session()
    s.execute(f"create external table e (k int, v int) location '{p}'")
    out = [s.execute("select sum(v) from e").rows()]
    s.execute("create table base (k int primary key)")
    out.append(outcome(s.execute,
                       f"create external table base (k int) location '{p}'"))
    out.append(outcome(s.execute, "create table e (k int)"))
    out.append(outcome(s.execute, "create view e as select 1"))
    out.append(sorted(s.catalog.tables()))
    db.close()
    db2 = P.db(root / "db")
    s2 = db2.session()
    out.append(s2.execute("select count(*) from e").rows())
    out.append(s2.execute("select v from e where k > 1").rows())
    s2.execute("drop table e")
    db2.close()
    db3 = P.db(root / "db")
    out.append(db3.session().catalog.has_table("e"))
    db3.close()
    return out


def test_external_table_persists_with_database(tmp_path):
    out = both(_scn_persists, tmp_path)
    assert out[0] == [(11,)] and out[1] == ("error", "ValueError")
    assert out[-1] is False


def test_create_external_table_with_a_database(tmp_path):
    """The statement the port refused before this plane: parity with a
    Database (a missing file surfaces at query time in both)."""
    def scn(P, root):
        db = P.db(root / "db")
        s = db.session()
        s.execute("create table t (k int primary key, v int)")
        out = [outcome(s.execute,
                       "create external table e (a int) location '/x.csv'"),
               sorted(s.catalog.tables()),
               outcome(s.execute, "select * from e"),
               outcome(s.execute, "create external table if not exists e "
                                  "(a int) location '/y.csv'")]
        db.close()
        return [o if not (isinstance(o, tuple) and o[0] == "ok") else "ok"
                for o in out]

    assert both(scn, tmp_path) == ["ok", ["e", "t"],
                                   ("error", "FileNotFoundError"), "ok"]


def test_external_parquet_table(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"k": pa.array([1, 2, 3]),
                             "name": pa.array(["a", "b", None]),
                             "score": pa.array([1.5, 2.5, 3.5])}), p)
    out = _both_sessions(
        f"create external table d (k int, name varchar(8), score double)"
        f" location '{p}' format parquet",
        ["select k, name, score from d order by k",
         "select sum(score) from d"])
    assert out[0][2] == [(1, "a", 1.5), (2, "b", 2.5), (3, None, 3.5)]


def test_arrow_interop_roundtrip():
    pa = pytest.importorskip("pyarrow")
    from oceanbase_tpu.share import external as jext
    from oceanbase_tpu_torch.share import external as text

    t = pa.table({"k": pa.array([1, 2]), "s": pa.array(["x", "y"]),
                  "m": pa.array([1.25, None])})
    outs = []
    for ext, (_n, s) in zip((jext, text), _sessions()):
        arrays, valids, types = ext.arrow_to_arrays(t)
        s.catalog.load_numpy("a", arrays, types=types,
                             valids=valids or None)
        res = s.execute("select k, upper(s) as u, m from a order by k")
        out = ext.result_to_arrow(res)
        outs.append({c: out.column(c).to_pylist() for c in out.column_names})
    assert outs[0] == outs[1]
    assert outs[1]["u"] == ["X", "Y"] and outs[1]["m"] == [1.25, None]


def test_arrow_formats_name_pyarrow_when_missing(monkeypatch, tmp_path):
    import builtins

    from oceanbase_tpu_torch.share import external as text

    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name.split(".")[0] == "pyarrow":
            raise ImportError("no pyarrow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(text.ArrowUnavailable, match="pyarrow"):
        text.result_to_arrow(None)
    s = TSession(device="cpu")
    s.execute(f"create external table d (k int) location "
              f"'{tmp_path / 'd.parquet'}' format parquet")
    with pytest.raises(text.ArrowUnavailable, match="FORMAT parquet"):
        s.execute("select * from d")
    # a CSV needs no pyarrow at all
    p = tmp_path / "c.csv"
    _write(p, "1\n2\n")
    s.execute(f"create external table c (k int) location '{p}'")
    assert s.execute("select sum(k) from c").rows() == [(3,)]


# ---------------------------------------------------------------------------
# the CSV value rules, each pinned against the reference
# ---------------------------------------------------------------------------

_RULES = {
    "nulls_in_numbers": (
        "a int, b double, c varchar(8)",
        "1,1.5,x\n,,\nNULL,NaN,NULL\nnull,N/A,\n4,nan,\"\"\n", ",", 0),
    "skip_lines": (
        "a int, s varchar(10)", "header,line\n# note\n1,a\n2,b\n", ",", 2),
    "pipe_delimiter": (
        "k int, d date, s varchar(20)",
        "1|1994-01-02|x y\n2|1995-12-31|\n3|1996-02-29|z\n", "|", 0),
    "quoted_fields": (
        "k int, s varchar(20)",
        '1,"a,b"\n2,"say ""hi"""\n3,plain\n4,""\n', ",", 0),
    "empty_lines": (
        "k int, v int", "1,2\n\n3,4\n\n\n5,6\n", ",", 0),
    "crlf": ("k int, s varchar(5)", "1,a\r\n2,b\r\n", ",", 0),
    "negative_and_big": (
        "k bigint, v double",
        "-5,-0.5\n9007199254740993,1e300\n7,2E-3\n", ",", 0),
    "integral_float_in_int": ("k int", "1\n2.0\n3\n", ",", 0),
    "bools": ("b boolean, k int", "true,1\nfalse,2\n1,3\n0,4\n,5\n", ",", 0),
    "garbage_int": ("k int", "1\nx\n", ",", 0),
    "ragged": ("k int, v int", "1,2\n3\n", ",", 0),
    "trailing_delimiter": ("k int, v int", "1,2,\n", ",", 0),
    "empty_decimal": ("k int, m decimal(10,2)", "1,2.5\n2,\n", ",", 0),
    "tab_delimited_unicode": (
        "k int, s varchar(10)", "1\tcafé\n2\tnaïve\n", "\t", 0),
}


@pytest.mark.parametrize("case", sorted(_RULES))
def test_csv_value_rules_match_the_reference(tmp_path, case):
    cols, text, delim, skip = _RULES[case]
    p = tmp_path / "f.csv"
    with open(p, "w", newline="") as fh:
        fh.write(text)
    opts = (f" fields terminated by '{delim}'" if delim != "," else "")
    if delim == "\t":
        opts = " fields terminated by '\t'"
    skip_sql = f" ignore {skip} lines" if skip else ""
    ddl = f"create external table e ({cols}) location '{p}'{opts}{skip_sql}"
    _both_sessions(ddl, ["select * from e", "select count(*) from e"])


# ---------------------------------------------------------------------------
# DECIMAL: the reference rounds through a float, the port is exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text,scale", [
    ("0.285", 2), ("1.005", 2), ("2.675", 2), ("0.125", 2),
    ("-0.285", 2), ("10.50", 2), ("3.14159", 4), ("7", 2)])
def test_decimal_fields_parse_exactly(tmp_path, text, scale):
    p = tmp_path / "d.csv"
    _write(p, f"1,{text}\n")
    got = {}
    for name, s in _sessions():
        s.execute(f"create external table d (k int, m decimal(12,{scale}))"
                  f" location '{p}'")
        got[name] = s.execute("select m from d").rows()[0][0]
    # SQLite's round() of the text's value, and the exact decimal
    # rounded half away from zero: the port equals both
    con = sqlite3.connect(":memory:")
    lite = con.execute("select round(cast(? as real), ?)",
                       (text, scale)).fetchone()[0]
    from decimal import ROUND_HALF_UP, Decimal

    exact = Decimal(text).quantize(Decimal(1).scaleb(-scale),
                                   rounding=ROUND_HALF_UP)
    assert got["port"] == float(exact) == lite
    # the reference: Python's round() of the float product
    assert got["jax"] == round(float(text) * 10 ** scale) / 10 ** scale
    if text in ("0.285", "1.005", "-0.285", "0.125"):
        # Queue 3 #20: the float product falls below the half (0.285,
        # 1.005) or round() goes to even (0.125)
        assert got["jax"] != got["port"]


# ---------------------------------------------------------------------------
# poisoned lanes: the padded lanes past the file's rows never count
# ---------------------------------------------------------------------------


def test_padded_lanes_never_count(tmp_path):
    p = tmp_path / "p.csv"
    _write(p, "".join(f"{i},{i * 2},s{i % 3}\n" for i in range(37)))
    out = _both_sessions(
        f"create external table p (k int, v int, s varchar(4)) "
        f"location '{p}'",
        ["select count(*), sum(v), min(k), max(k) from p",
         "select s, count(*) from p group by s order by s",
         "select count(*) from p where v >= 0"])
    assert out[0][2] == [(37, sum(i * 2 for i in range(37)), 0, 36)]
    s = TSession(device="cpu")
    s.execute(f"create external table p (k int, v int, s varchar(4)) "
              f"location '{p}'")
    rel = s.catalog.table_data("p")
    assert rel.capacity >= 37
    # poison every padded lane's values: answers stay the same
    mask = rel.mask_or_true()
    for c in rel.columns.values():
        if c.data.dtype.is_floating_point or c.data.dtype == torch.int64:
            c.data[~mask] = -(1 << 40)
    assert s.execute("select count(*), sum(v), min(k) from p").rows() == \
        [(37, sum(i * 2 for i in range(37)), 0)]
