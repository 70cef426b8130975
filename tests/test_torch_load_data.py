"""LOAD DATA INFILE on the port's ``Database`` against the JAX package's,
on the CPU: the native CSV tokenizer and field parsers (the cases of
``tests/test_native_csv.py``), the load semantics of both routes (the
native tokenizer and the python ``csv`` module), the arrays a load
produces held byte-equal to the reference's, ``test_udf_loaddata.py``'s
LOAD DATA case, TRUNCATE then LOAD DATA across a restart
(``test_advice_r2_fixes.py``), and TPC-H ``.tbl`` files loaded into
range-partitioned tables."""

import numpy as np
import pytest

from oceanbase_tpu import native as jnative
from oceanbase_tpu.sql.parser import parse_sql as jparse
from oceanbase_tpu_torch import native as tnative
from oceanbase_tpu_torch.bench.tbl import create_table_sql, write_tbl
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu_torch.sql import session as tsession
from oceanbase_tpu_torch.sql.parser import parse_sql as tparse
from test_torch_database import Pair


def _columns(tok, n_cols, j):
    _buf, offs, lens, _n = tok
    return (np.ascontiguousarray(offs[j::n_cols]),
            np.ascontiguousarray(lens[j::n_cols]))


@pytest.mark.parametrize("data,n_cols,delim", [
    (b'1,"hello, world",2.5\n2,"say ""hi""",3.5\n3,,4.5\n', 3, ","),
    (b"1|a b|1994-01-02\r\n2||\\N\r\n3|z|2000-12-31", 3, "|"),
    (b"10,\xc3\xa9t\xc3\xa9,-1.005\n11,plain,7\n", 3, ","),
    (b"1,2\r3,4\r", 2, ","),
])
def test_tokenizer_and_field_parsers_match(data, n_cols, delim,
                                           monkeypatch):
    """Tokens, strings and scaled ints equal the reference's, through
    the library and through the python fallbacks (each against the
    reference's own: the fallback truncates where the library rounds)."""
    tt = tnative.csv_tokenize(data, n_cols, delim)
    jt = jnative.csv_tokenize(data, n_cols, delim)
    assert tt[3] == jt[3]
    np.testing.assert_array_equal(tt[1], jt[1])
    np.testing.assert_array_equal(tt[2], jt[2])
    for j in range(n_cols):
        offs, lens = _columns(tt, n_cols, j)
        strs = tnative.field_strings(data, offs, lens)
        assert list(strs) == list(jnative.field_strings(data, offs, lens))
        assert all(type(x) is str for x in strs)
        for scale in (0, 2):
            for use_native in (True, False):
                with monkeypatch.context() as m:
                    if not use_native:
                        m.setattr(jnative, "_load", lambda: None)
                    want = jnative.parse_int64_fields(jt[0], offs, lens,
                                                      scale)
                got = tnative.parse_int64_fields(tt[0], offs, lens, scale,
                                                 use_native=use_native)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


def test_tokenizer_quoting_and_ragged():
    data = b'1,"hello, world",2.5\n2,"say ""hi""",3.5\n3,,4.5\n'
    tok = tnative.csv_tokenize(data, 3)
    offs, lens = _columns(tok, 3, 1)
    assert list(tnative.field_strings(tok[0], offs, lens)) == \
        ["hello, world", 'say "hi"', ""]
    assert tnative.field_bytes(data, offs, lens) is None  # escaped field
    assert tnative.csv_tokenize(b"1,2,3\n4,5\n", 3) is None
    assert tnative.csv_tokenize(data, 3, use_native=False) is None


SEMANTICS = [
    ("cr", "create table c1 (k int primary key, v int)",
     b"1,10\r2,20\r3,30\r4,40\r"),
    ("overflow", "create table c2 (k int primary key, v int)",
     b"1,99999999999999999999999\n"),
    ("rounding", "create table c3 (k int primary key, v decimal(10,2))",
     b"1,2.555\n2,-2.555\n"),
    ("garbage", "create table c4 (k int primary key, v int)",
     b"1,abc\n"),
    ("ragged", "create table c5 (k int primary key, v int)",
     b"1,2\n3\n"),
    ("nulls", "create table c6 (k int primary key, d date, x double, "
     "s varchar(8))", b"1,\\N,\\n,\\N\n2,,2.5,\n3,1999-02-03,1e3,\\n\n"),
]


@pytest.mark.parametrize("name,ddl,data", SEMANTICS,
                         ids=[c[0] for c in SEMANTICS])
def test_load_semantics_match(tmp_path, name, ddl, data):
    """Lone-CR endings, int overflow, decimal rounding, garbage cells,
    ragged rows (the python route) and the NULL spellings give the
    reference's outcome and rows."""
    p = Pair(tmp_path)
    p.run(ddl)
    table = ddl.split()[2]
    path = tmp_path / f"{name}.csv"
    path.write_bytes(data)
    p.run(f"load data infile '{path}' into table {table} "
          f"fields terminated by ','")
    p.run(f"select * from {table} order by k")
    p.close()


def _quoted_csv(tmp_path, n, rng):
    names = rng.choice(np.array(["ann", "bob, jr.", 'says "hi"', "",
                                 "\\N"]), n)
    lines = ["k,v,name,d"]
    for i in range(n):
        nm = names[i]
        if "," in nm or '"' in nm:
            nm = '"' + nm.replace('"', '""') + '"'
        d = f"19{90 + i % 10}-0{1 + i % 9}-15" if i % 13 else ""
        lines.append(f"{i},{rng.uniform(0, 1000):.2f},{nm},{d}")
    path = tmp_path / "big.csv"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_native_arrays_byte_equal_to_the_reference(tmp_path):
    """The native route's arrays (ints, decimals, numpy-parsed dates and
    fixed-width strings) are the reference's, byte for byte, and the
    python ``csv`` route gives the same rows."""
    path = _quoted_csv(tmp_path, 3000, np.random.default_rng(3))
    p = Pair(tmp_path)
    ddl = ("create table t (k int primary key, v decimal(10,2), "
           "name varchar(40), d date)")
    p.run(ddl)
    sql = (f"load data infile '{path}' into table t "
           f"fields terminated by ',' ignore 1 lines")
    tstmt, jstmt = tparse(sql), jparse(sql)
    td = p.t.catalog.table_def("t")
    got = tsession.Session._load_data_native(tstmt, td, path.read_bytes())
    want = p.js[0]._load_data_native(jstmt, p.j.catalog.table_def("t"))
    assert got[2] == want[2] == 3000
    assert sorted(got[0]) == sorted(want[0])
    assert sorted(got[1]) == sorted(want[1])
    for c in want[0]:
        g, w = got[0][c], want[0][c]
        assert g.dtype == w.dtype, c
        if w.dtype == object:
            assert g.tolist() == w.tolist(), c
        else:
            assert g.tobytes() == w.tobytes(), c
    for c in want[1]:
        assert got[1][c].tobytes() == want[1][c].tobytes(), c
    arrays, valids, n = tsession._load_data_csv(tstmt, td)
    assert n == 3000
    for c in arrays:
        ok = got[1].get(c, np.ones(n, dtype=bool))
        assert valids.get(c, np.ones(n, dtype=bool)).tolist() == ok.tolist()
        assert arrays[c][ok].tolist() == got[0][c][ok].tolist(), c
    assert p.run(sql)[1] == 3000
    assert p.ts[0].last_load["route"] == "native"
    for q in ("select count(*), sum(v), min(d), max(k) from t",
              "select count(*) from t where name = 'bob, jr.'",
              "select count(*) from t where name is null",
              "select name, count(*) from t group by name"):
        p.run(q)
    p.close()


def test_load_data_infile(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text("k,v,name,d\n1,10.50,ann,2020-01-01\n"
                        "2,20.25,bob,2021-06-15\n3,,carol,2022-12-31\n")
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v decimal(10,2), "
          "name varchar(20), d date)")
    assert p.run(f"load data infile '{csv_path}' into table t "
                 f"fields terminated by ',' ignore 1 lines")[1] == 3
    rows = p.rows("select k, v, name, d from t order by k")
    assert rows[0] == (1, 10.5, "ann", "2020-01-01") and rows[2][1] is None
    # a direct load: a baseline segment, no memtable rows
    assert p.t.engine.tables["t"].tablet.segments
    assert len(p.t.engine.tables["t"].tablet.active) == 0
    p.close()


def test_truncate_then_load_data_survives_restart(tmp_path):
    csv = tmp_path / "rows.csv"
    csv.write_text("5,50\n6,60\n")
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run("insert into t values (1, 1), (2, 2)")
    p.run("truncate table t")
    p.run(f"load data infile '{csv}' into table t fields terminated by ','")
    assert p.rows("select k from t order by k") == [(5,), (6,)]
    p.close()
    p.open()
    assert p.rows("select k from t order by k") == [(5,), (6,)]
    p.close()


def test_tpch_tbl_load_into_partitions(tmp_path):
    """The eight TPC-H tables at SF0.005, written as ``|``-delimited
    text, load through the native route into tables whose lineitem and
    orders are RANGE-partitioned on the order key (4 partitions): every
    table's snapshot equals the reference's, column for column."""
    tables, types = gen_tpch(sf=0.005)
    p = Pair(tmp_path)
    top = int(tables["orders"]["o_orderkey"].max()) + 1
    for name, arrays in tables.items():
        ty = {k: v for k, v in types.items() if k in arrays}
        part = None
        if name in ("orders", "lineitem"):
            part = (name[0] + "_orderkey", [top * i // 4 for i in (1, 2, 3)])
        p.run(create_table_sql(name, arrays, ty, TPCH_PRIMARY_KEYS[name],
                               part))
        path = tmp_path / f"{name}.tbl"
        write_tbl(str(path), arrays, ty)
        assert p.run(f"load data infile '{path}' into table {name} "
                     f"fields terminated by '|'")[1] == len(
                         next(iter(arrays.values())))
        assert p.ts[0].last_load["route"] == "native"
    for name in tables:
        tt = p.t.engine.tables[name].tablet
        jt = p.j.engine.tables[name].tablet
        ta, tv = tt.snapshot_arrays(p.t.tx.gts.current())
        ja, jv = jt.snapshot_arrays(p.j.tx.gts.current())
        for c in ja:
            assert ta[c].tolist() == ja[c].tolist(), (name, c)
            assert (tv[c] is None) == (jv[c] is None), (name, c)
        if name in ("orders", "lineitem"):
            assert [sum(s.n_rows for s in part.segments)
                    for part in tt.partitions] == \
                [sum(s.n_rows for s in part.segments)
                 for part in jt.partitions]
    p.rows("select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
           "from lineitem group by l_returnflag, l_linestatus "
           "order by l_returnflag, l_linestatus")
    p.close()
