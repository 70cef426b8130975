"""SQL beyond the 22 TPC-H queries, over the TPC-H tables: the statements
``chip_smoke.py`` runs at SF1 on the card and the CPU tests run at a
small scale, each held against SQLite.

- ``IP1``: a join the optimizer answers with an index probe once every
  ``*key`` column carries a secondary index (the JAX package's SF1
  parity configuration, ``scripts/sf_parity.py``): a few hundred orders
  probe the lineitem index.
- ``READS``: window functions (W1-W4) and unions (U1, U2).
- ``D1``: a DML script on a copy of orders; its UPDATE sets a string
  column to a value the column's dictionary lacks.
- ``S1``: an ORDER BY over every lineitem row that the spill tier
  (``exec/spill_exec.py``) answers with an external sort through disk.

Every name here maps to SQL text in the dialect the port's parser reads;
``bench.oracle.to_sqlite_sql`` turns it into SQLite's.
"""

IP1 = ("select sum(l_extendedprice), count(*) from orders, lineitem "
       "where o_orderkey = l_orderkey and o_orderdate = date '1995-03-15'")

#: at SF1 it sorts 6,002,357 rows, more than the reference database's
#: default work area (``sql_work_area_rows`` = 2^22 rows)
S1 = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
      "order by l_extendedprice desc, l_orderkey, l_linenumber limit 1000")

READS: dict[str, str] = {
    # a window over every order, ~10 orders a customer
    "W1": "select rn, count(*) from (select row_number() over (partition "
          "by o_custkey order by o_totalprice desc, o_orderkey) as rn "
          "from orders) x group by rn order by rn",
    # a running decimal sum over every lineitem row
    "W2": "select count(*), sum(rq) from (select sum(l_quantity) over "
          "(partition by l_orderkey order by l_linenumber) as rq "
          "from lineitem) x",
    # a ROWS frame and navigation
    "W3": "select sum(a), sum(d) from (select avg(o_totalprice) over "
          "(partition by o_custkey order by o_orderdate, o_orderkey rows "
          "between 2 preceding and current row) as a, o_totalprice - "
          "lag(o_totalprice, 1, 0) over (partition by o_custkey order by "
          "o_orderdate, o_orderkey) as d from orders) x",
    # unpartitioned windows
    "W4": "select o_orderkey, rank() over (order by o_totalprice desc) as "
          "r, dense_rank() over (order by o_orderpriority) as dr from "
          "orders order by r, o_orderkey limit 100",
    "U1": "select count(*), sum(p) from (select l_extendedprice as p from "
          "lineitem where l_shipdate < date '1992-03-01' union all select "
          "o_totalprice as p from orders where o_orderdate < "
          "date '1992-02-01') x",
    # a distinct union over three different dictionaries
    "U2": "select c_mktsegment as v from customer union select p_mfgr "
          "from part union select n_name from nation order by 1",
}

#: READS whose ORDER BY fixes the row order
ORDERED = {"W1", "W4", "U2"}

#: READS held to a tighter relative tolerance than ``rows_match``'s
#: 1e-6, so that a few wrong window rows fail them: W2's values are sums
#: of integer quantities, exact in float64 on both sides; W3's float
#: sums agree with SQLite's to about 1e-14 (TPC-H SF0.05 on the CPU)
RTOL = {"W2": 0.0, "W3": 1e-10}

D1: list[tuple[str, str]] = [
    ("create", "create table ocopy (o_orderkey int, o_custkey int, "
               "o_orderstatus varchar(1), o_totalprice decimal(15,2), "
               "o_orderdate date, o_orderpriority varchar(15))"),
    ("insert_select", "insert into ocopy select o_orderkey, o_custkey, "
                      "o_orderstatus, o_totalprice, o_orderdate, "
                      "o_orderpriority from orders"),
    ("update", "update ocopy set o_totalprice = o_totalprice + 1.00, "
               "o_orderpriority = '6-NONE' where o_orderdate < "
               "date '1993-01-01'"),
    ("delete", "delete from ocopy where o_orderstatus = 'P'"),
    ("insert_values", "insert into ocopy values (9000001, 1, 'O', 100.50, "
                      "'1998-12-01', '6-NONE'), (9000002, 2, 'F', 200.25, "
                      "'1998-12-02', '1-URGENT')"),
    ("select", "select o_orderpriority, count(*), sum(o_totalprice) from "
               "ocopy group by o_orderpriority order by 1"),
]
