"""Stored procedures in the port against the JAX package's on the CPU:
the four cases of ``tests/test_procedures.py`` (control flow, parameters
in queries, persistence across a restart, a catalog-only session), each
statement's outcome held equal between the packages.  Both write the
same ``procedures.json``, and a port ``Database`` opened on the file the
reference wrote runs those procedures.
"""

import json

import numpy as np
import pytest
import torch

from oceanbase_tpu.sql import Session as JSession
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.sql import Session as TSession
from test_torch_database import Pair

torch.set_num_threads(2)

FILL = """
create procedure fill(in n int)
begin
  declare i int default 0;
  while i < n do
    insert into t values (i, i * i);
    set i = i + 1;
  end while;
end"""

JUDGE = """
create procedure judge(in x int)
begin
  if x > 10 then
    select 'big';
  elseif x > 5 then
    select 'mid';
  else
    select 'small';
  end if;
end"""


def test_procedure_control_flow(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key, v int)")
    p.run(FILL)
    p.run("call fill(5)")
    assert p.rows("select count(*), sum(v) from t") == [(5, 30)]
    p.run(JUDGE)
    for x, want in ((20, "big"), (7, "mid"), (1, "small")):
        assert p.rows(f"call judge({x})") == [(want,)]
    assert p.run("call judge(1, 2)") == ("error", "ValueError")
    assert p.run("call nope()") == ("error", "KeyError")
    assert p.run(JUDGE) == ("error", "ValueError")  # exists
    p.close()


def test_procedure_params_in_queries(tmp_path):
    p = Pair(tmp_path)
    p.run("create table acc (id int primary key, bal int)")
    p.run("insert into acc values (1, 100), (2, 50)")
    p.run("""
create procedure transfer(in src int, in dst int, in amt int)
begin
  update acc set bal = bal - amt where id = src;
  update acc set bal = bal + amt where id = dst;
  select bal from acc where id = dst;
end""")
    assert p.rows("call transfer(1, 2, 30)") == [(80,)]
    assert p.rows("select bal from acc order by id") == [(70,), (80,)]
    p.close()


def test_procedure_persists_across_restart(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (k int primary key)")
    p.run("create procedure p1(in k int) begin insert into t values (k); "
          "end")
    p.run(FILL.replace("insert into t values (i, i * i)",
                       "insert into t values (100 + i)"))
    files = [json.loads((tmp_path / d / "procedures.json").read_text())
             for d in ("jax", "port")]
    assert files[0] == files[1]
    p.close()
    p.open()
    p.run("call p1(7)")
    p.run("call fill(2)")
    assert p.rows("select k from t order by k") == [(7,), (100,), (101,)]
    p.run("drop procedure p1")
    assert p.run("call p1(8)") == ("error", "KeyError")
    p.close()
    # a port database on the file the reference wrote
    root = tmp_path / "copy"
    root.mkdir()
    (root / "procedures.json").write_text(
        json.dumps({"fill": files[0]["fill"]}))
    db = Database(str(root), device="cpu")
    s = db.session()
    s.execute("create table t (k int primary key)")
    s.execute("call fill(3)")
    assert s.execute("select k from t order by k").rows() == \
        [(100,), (101,), (102,)]
    db.close()


@pytest.mark.parametrize("which", ["reference", "port"])
def test_procedure_in_memory_session(which):
    s = JSession() if which == "reference" else TSession(device="cpu")
    s.catalog.load_numpy("t", {"k": np.arange(4),
                               "v": np.array([1, 2, 3, 4])},
                         primary_key=["k"])
    s.execute("create procedure q(in lo int) begin "
              "select sum(v) from t where k >= lo; end")
    assert s.execute("call q(2)").rows() == [(7,)]


def test_typed_literals_in_a_procedure_body(tmp_path):
    """ROADMAP Queue 3 #18: a body statement with a DECIMAL or DATE
    literal.  The reference's variable substitution assigns into the
    literal's frozen SqlType and fails; the port runs it."""
    p = Pair(tmp_path)
    p.run("create table o (k int primary key, p decimal(10,2), d date, "
          "s varchar(10))")
    body = ("create procedure addo(in base int, in n int) begin declare i "
            "int default 0; while i < n do insert into o values (base + i, "
            "1.25, '1998-01-01', 'x'); set i = i + 1; end while; select "
            "count(*), sum(p) from o; end")
    p.js[0].execute(body)
    p.ts[0].execute(body)
    with pytest.raises(Exception, match="cannot assign to field"):
        p.js[0].execute("call addo(10, 3)")
    assert p.ts[0].execute("call addo(10, 3)").rows() == [(3, 3.75)]
    assert p.ts[0].execute("select k, p, d from o order by k").rows() == \
        [(10, 1.25, "1998-01-01"), (11, 1.25, "1998-01-01"),
         (12, 1.25, "1998-01-01")]
    p.close()
