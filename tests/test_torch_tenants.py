"""Tenants other than ``sys`` in the port's ``Database`` against the JAX
package's on the CPU: ``test_multi_tenant_isolation``
(``tests/test_server_runtime.py``), a tenant's LOAD DATA into a
RANGE-partitioned table, DROP TENANT removing the tenant's directory,
and users and tenants after a reopen.  Each statement's outcome is held
equal between the packages."""

import os

import pytest
import torch

from oceanbase_tpu_torch.bench.tbl import create_table_sql, write_tbl
from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
from oceanbase_tpu_torch.server.database import Database
from test_torch_database import Pair

torch.set_num_threads(2)


class TenantPair(Pair):
    """A Pair whose sessions can move to another tenant."""

    def enter(self, tenant):
        self.js = [self.j.session(tenant=tenant)]
        self.ts = [self.t.session(tenant=tenant)]


def test_multi_tenant_isolation(tmp_path):
    p = TenantPair(tmp_path)
    p.run("create tenant t1")
    assert p.run("create tenant t1") == ("error", "ValueError")
    p.enter("t1")
    p.run("create table x (a int)")
    p.run("insert into x values (1)")
    assert p.rows("select count(*) from x") == [(1,)]
    p.enter("sys")
    assert p.run("select * from x")[0] == "error"   # sys does not see x
    p.run("create table x (b int)")                  # its own x
    assert p.rows("select count(*) from x") == [(0,)]
    assert p.t.session(tenant="t1").tenant.name == "t1"
    assert p.t.session(tenant="t1").catalog is p.t.tenant("t1").catalog
    p.close()
    p.open()                                         # a restart
    assert set(p.t.tenants) == set(p.j.tenants) == {"sys", "t1"}
    p.enter("t1")
    assert p.rows("select count(*) from x") == [(1,)]
    assert p.t.tenant("t1").catalog.table_data("x").device.type == "cpu"
    p.close()


def test_tenant_load_data_and_partitions(tmp_path):
    """A second tenant LOADs TPC-H orders into a RANGE-partitioned table
    through the native tokenizer; the rows per partition and the reads
    equal the reference's, and sys sees none of it."""
    tables, types = gen_tpch(sf=0.002)
    od = tables["orders"]
    ty = {k: v for k, v in types.items() if k in od}
    path = tmp_path / "orders.tbl"
    write_tbl(str(path), od, ty)
    top = int(od["o_orderkey"].max()) + 1
    p = TenantPair(tmp_path)
    p.run("create tenant t2")
    p.enter("t2")
    p.run(create_table_sql("orders", od, ty, TPCH_PRIMARY_KEYS["orders"],
                           ("o_orderkey", [top // 3, 2 * top // 3])))
    n = p.run(f"load data infile '{path}' into table orders fields "
              f"terminated by '|'")[1]
    assert n == len(od["o_orderkey"])
    assert p.ts[0].last_load["route"] == "native"
    assert [sum(s.n_rows for s in part.segments) for part in
            p.t.tenant("t2").engine.tables["orders"].tablet.partitions] == \
        [sum(s.n_rows for s in part.segments) for part in
         p.j.tenant("t2").engine.tables["orders"].tablet.partitions]
    p.rows("select o_orderstatus, count(*), sum(o_totalprice) from orders "
           "group by o_orderstatus order by o_orderstatus")
    p.run(f"update orders set o_orderkey = {top + 5} where o_orderkey = "
          f"{int(od['o_orderkey'][0])}")           # moves partition
    p.rows(f"select o_custkey from orders where o_orderkey = {top + 5}")
    assert "orders" not in p.t.tenant("sys").engine.tables
    p.enter("sys")
    assert p.run("select count(*) from orders")[0] == "error"
    p.close()


def test_drop_tenant_removes_its_directory(tmp_path):
    p = TenantPair(tmp_path)
    p.run("create tenant t3")
    p.enter("t3")
    p.run("create table y (a int primary key)")
    p.run("insert into y values (1), (2)")
    p.enter("sys")
    dirs = [tmp_path / d / "tenants" / "t3" for d in ("jax", "port")]
    assert all(d.is_dir() for d in dirs)
    p.run("drop tenant t3")
    assert not any(d.exists() for d in dirs)
    assert "t3" not in p.t.tenants
    assert p.run("drop tenant sys") == ("error", "ValueError")
    p.close()
    p.open()
    assert set(p.t.tenants) == {"sys"}
    p.close()


def test_users_and_tenants_after_reopen(tmp_path):
    p = TenantPair(tmp_path)
    p.run("create tenant t4")
    p.run("create user ann identified by 'pw'")
    p.run("create user bob identified by 'x'")
    p.run("drop user bob")
    assert p.run("drop user root") == ("error", "ValueError")
    assert p.run("set password for zed = 'y'") == ("error", "KeyError")
    p.enter("t4")
    p.run("create table z (k int primary key, v int)")
    p.run("insert into z values (1, 10)")
    p.close()                                       # no checkpoint
    p.open()
    assert set(p.t.users) == set(p.j.users) == {"root", "ann"}
    assert p.t.users == p.j.users                   # the same hashes
    p.enter("t4")
    assert p.rows("select k, v from z") == [(1, 10)]
    p.close()


def test_session_of_unknown_tenant_raises(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    with pytest.raises(KeyError):
        db.session(tenant="nope")
    assert os.listdir(tmp_path / "db" / "tenants") == ["sys"]
    db.close()
