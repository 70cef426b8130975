"""TPC-H: the eight tables at a scale factor, and the 22 queries.

The data come from ``tpch_gen.gen_tpch(sf, seed)``, a frozen copy of the
port's generator, and go to the program through ``catalog.load_numpy``
with their primary keys, then ``ANALYZE TABLE``; no secondary index.
The statements are the query texts of ``tpch_queries.py``, picked by
number.  The answers are judged by ``reference/tpch.py``.
"""

from __future__ import annotations

from obbench.compare import compare
from obbench.datasets import tpch_gen
from obbench.datasets.tpch_queries import QUERIES
from obbench.reference.tpch import Ref


def make(cfg: dict, seed: int, device) -> dict:
    tables, types = tpch_gen.gen_tpch(sf=float(cfg["scale_factor"]),
                                      seed=seed)
    return {"tables": tables, "types": types}


def _sql_type(spec):
    from oceanbase_tpu_torch.datatypes import SqlType

    if spec[0] == "decimal":
        return SqlType.decimal(spec[1], spec[2])
    if spec[0] == "date":
        return SqlType.date()
    raise ValueError(f"unknown type spec {spec!r}")


def load(sess, cfg: dict, data: dict) -> None:
    types = data["types"]
    for name, arrays in data["tables"].items():
        sess.catalog.load_numpy(
            name, arrays, primary_key=tpch_gen.PRIMARY_KEYS[name],
            types={k: _sql_type(v) for k, v in types.items() if k in arrays})
    for name in data["tables"]:
        sess.execute(f"analyze table {name}")


def statements(cfg: dict, traffic: dict, data: dict, rng) -> list:
    """The queries ``traffic["queries"]`` names, in that order ->
    [(label, sql, key)], ``key`` the query's number."""
    return [(f"tpch.q{q}", QUERIES[q], int(q)) for q in traffic["queries"]]


def facts(cfg: dict, data: dict) -> dict:
    return {"lineitem_rows": len(data["tables"]["lineitem"]["l_orderkey"])}


def judge(cfg: dict, data: dict, samples: list, device) -> dict:
    """Every sampled answer against the NumPy reference -> {"wrong_rows":
    rows wrong or missing, "float_gap": the largest relative gap of a
    double}."""
    ref = Ref(data["tables"])
    expected: dict = {}
    wrong, gap = 0, 0.0
    for key, rows in samples:
        if key not in expected:
            expected[key] = ref.run(key)
        w, g = compare(rows, expected[key])
        wrong += w
        gap = max(gap, g)
    return {"wrong_rows": wrong, "float_gap": gap}
