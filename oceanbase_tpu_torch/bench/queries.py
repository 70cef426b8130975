"""Hand-built physical plans for the TPC-H ladder (Q6 -> Q1 -> Q14).

The port's copy of ``oceanbase_tpu/bench/queries.py``, built on the
port's own plan nodes and IR, so both executors run the same plans.
"""

from __future__ import annotations

from oceanbase_tpu_torch.datatypes import SqlType
from oceanbase_tpu_torch.exec.ops import AggSpec
from oceanbase_tpu_torch.exec.plan import (
    Filter, GroupBy, HashJoin, Project, ScalarAgg, Sort, TableScan,
)
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.vector.column import Relation, from_numpy

#: the columns the Q6/Q1/Q14 plans read, per table
SLICE_COLUMNS = {
    "lineitem": ["l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                 "l_partkey"],
    "part": ["p_partkey", "p_type"],
}


def slice_tables(tables, types, device=None) -> dict[str, Relation]:
    """Put the columns of ``SLICE_COLUMNS`` from ``gen_tpch``'s host
    arrays on ``device`` (default ``"cuda"``)."""
    out = {}
    for name, cols in SLICE_COLUMNS.items():
        arrays = {c: tables[name][c] for c in cols}
        out[name] = from_numpy(
            arrays, types={c: types[c] for c in cols if c in types},
            device=device)
    return out


def dec(s: str) -> ir.Literal:
    return ir.lit(s, SqlType.decimal())


def date(s: str) -> ir.Literal:
    return ir.lit(s, SqlType.date())


def q6_plan():
    """TPC-H Q6: SELECT sum(l_extendedprice*l_discount) AS revenue
    FROM lineitem WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
    AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24."""
    pred = (
        (ir.col("l_shipdate") >= date("1994-01-01"))
        .and_(ir.col("l_shipdate") < date("1995-01-01"))
        .and_(ir.col("l_discount").between(dec("0.05"), dec("0.07")))
        .and_(ir.col("l_quantity") < dec("24.00"))
    )
    scan = TableScan(
        "lineitem",
        columns=["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"],
    )
    return ScalarAgg(
        Filter(scan, pred),
        [AggSpec("revenue", "sum",
                 ir.col("l_extendedprice") * ir.col("l_discount"))],
    )


def q1_plan():
    """TPC-H Q1: 4-group GROUP BY over lineitem with 8 aggregates."""
    disc_price = ir.col("l_extendedprice") * (dec("1.00") - ir.col("l_discount"))
    charge = disc_price * (dec("1.00") + ir.col("l_tax"))
    scan = TableScan(
        "lineitem",
        columns=[
            "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate",
        ],
    )
    filt = Filter(scan, ir.col("l_shipdate") <= date("1998-09-02"))
    gb = GroupBy(
        filt,
        keys={"l_returnflag": ir.col("l_returnflag"),
              "l_linestatus": ir.col("l_linestatus")},
        aggs=[
            AggSpec("sum_qty", "sum", ir.col("l_quantity")),
            AggSpec("sum_base_price", "sum", ir.col("l_extendedprice")),
            AggSpec("sum_disc_price", "sum", disc_price),
            AggSpec("sum_charge", "sum", charge),
            AggSpec("avg_qty", "avg", ir.col("l_quantity")),
            AggSpec("avg_price", "avg", ir.col("l_extendedprice")),
            AggSpec("avg_disc", "avg", ir.col("l_discount")),
            AggSpec("count_order", "count_star"),
        ],
        out_capacity=16,
    )
    return Sort(gb, keys=[ir.col("l_returnflag"), ir.col("l_linestatus")])


def q14_plan(lineitem_rows: int):
    """TPC-H Q14: promo revenue percent over lineitem ⋈ part for one month."""
    scan_l = TableScan(
        "lineitem",
        columns=["l_partkey", "l_extendedprice", "l_discount", "l_shipdate"],
    )
    filt = Filter(
        scan_l,
        (ir.col("l_shipdate") >= date("1995-09-01"))
        .and_(ir.col("l_shipdate") < date("1995-10-01")),
    )
    scan_p = TableScan("part", columns=["p_partkey", "p_type"])
    j = HashJoin(
        filt, scan_p, [ir.col("l_partkey")], [ir.col("p_partkey")],
        how="inner", out_capacity=lineitem_rows,
    )
    disc_price = ir.col("l_extendedprice") * (dec("1.00") - ir.col("l_discount"))
    promo = ir.Case(
        whens=[(ir.col("p_type").like("PROMO%"), disc_price)],
        else_=ir.lit("0.0000", SqlType.decimal(15, 4)),
    )
    agg = ScalarAgg(j, [
        AggSpec("promo", "sum", promo),
        AggSpec("total", "sum", disc_price),
    ])
    return Project(
        agg,
        {"promo_revenue": ir.lit(100.0) * ir.col("promo") / ir.col("total")},
    )
