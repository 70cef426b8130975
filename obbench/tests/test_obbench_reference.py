"""The plain references and the comparison, against answers worked out
by hand, and the frozen generator against the port's."""

import numpy as np
import pytest

from obbench.compare import compare
from obbench.datasets import tpch_gen
from obbench.reference import vectors as vref
from obbench.reference.tpch import Expected, Ref

D = tpch_gen.date_to_days


def _lineitem(rows):
    cols = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate")
    li = {c: [] for c in cols}
    for r in rows:
        for c, v in zip(cols, r):
            li[c].append(v)
    out = {c: np.array(v, dtype=object) for c, v in li.items()
           if c in ("l_returnflag", "l_linestatus")}
    for c in cols[2:6]:
        out[c] = np.array(li[c], dtype=np.int64)
    out["l_shipdate"] = np.array([D(d) for d in li["l_shipdate"]],
                                 dtype=np.int32)
    return out


def test_q1_by_hand():
    # quantities and prices scaled by 100, discount and tax by 100
    li = _lineitem([
        ("A", "F", 1000, 200000, 10, 5, "1995-01-01"),
        ("A", "F", 3000, 100000, 0, 0, "1996-01-01"),
        ("N", "O", 500, 50000, 5, 8, "1998-09-02"),
        ("N", "O", 700, 70000, 0, 0, "1998-09-03"),   # after the cut
    ])
    e = Ref({"lineitem": li}).q1()
    assert e.order == [(0, False), (1, False)]
    af, no = e.rows
    # A/F: qty 40.00, base 3000.00, disc_price 2000*0.90 + 1000 = 2800.00,
    # charge 1800*1.05 + 1000 = 2890.00; avg qty 20, price 1500, disc .05
    assert af == ("A", "F", 40.0, 3000.0, 2800.0, 2890.0, 20.0, 1500.0,
                  0.05, 2)
    # N/O: 5.00, 500.00, 475.00, 513.00
    assert no == ("N", "O", 5.0, 500.0, 475.0, 513.0, 5.0, 500.0, 0.05, 1)


def test_q6_by_hand():
    li = _lineitem([
        ("A", "F", 1000, 100000, 6, 0, "1994-06-01"),   # in: 1000 * .06
        ("A", "F", 2400, 100000, 6, 0, "1994-06-01"),   # qty not < 24
        ("A", "F", 1000, 100000, 8, 0, "1994-06-01"),   # discount out
        ("A", "F", 1000, 50000, 5, 0, "1994-12-31"),    # in: 500 * .05
        ("A", "F", 1000, 50000, 5, 0, "1995-01-01"),    # date out
    ])
    assert Ref({"lineitem": li}).q6().rows == [(85.0,)]
    empty = _lineitem([("A", "F", 1000, 1, 0, 0, "1990-01-01")])
    assert Ref({"lineitem": empty}).q6().rows == [(None,)]


def test_compare_ties_under_limit():
    exp = Expected(rows=[(1, 9.0), (2, 7.0), (3, 7.0), (4, 5.0)],
                   kinds="xx", order=[(1, True)], limit=2)
    assert compare([(1, 9.0), (3, 7.0)], exp) == (0, 0.0)
    assert compare([(1, 9.0), (2, 7.0)], exp) == (0, 0.0)
    assert compare([(1, 9.0), (4, 5.0)], exp)[0] > 0
    assert compare([(3, 7.0), (1, 9.0)], exp)[0] > 0     # out of order
    assert compare([(1, 9.0)], exp)[0] == 1              # one missing


def test_compare_doubles_by_gap():
    exp = Expected(rows=[("a", 1.0), ("b", 2.0)], kinds="xf", order=[])
    w, g = compare([("b", 2.0), ("a", 1.0 + 1e-12)], exp)
    assert w == 0 and g == pytest.approx(1e-12, rel=1e-3)
    assert compare([("a", 1.0), ("c", 2.0)], exp)[0] == 1


def test_knn_by_hand():
    base = np.array([[0, 0], [3, 4], [1, 1], [6, 8], [3, 4]], dtype=np.uint8)
    q = np.array([0, 0], dtype=np.uint8)
    want = np.array([0.0, 2.0, 25.0])          # squared: ids 0, 2, 1|4
    rows = [(0, 0.0), (2, 2 ** 0.5), (4, 5.0)]
    assert vref.wrong_rows(rows, base, q, want, 3) == 0
    assert vref.wrong_rows([(0, 0.0), (2, 2 ** 0.5), (1, 5.0)], base, q,
                           want, 3) == 0      # the tie may be either id
    assert vref.wrong_rows([(0, 0.0), (2, 2 ** 0.5), (3, 10.0)], base, q,
                           want, 3) == 1      # not among the 3 smallest
    assert vref.wrong_rows([(0, 0.0), (2, 1.5), (1, 5.0)], base, q,
                           want, 3) == 1      # not id 2's own distance
    assert vref.wrong_rows([(0, 0.0), (0, 0.0), (1, 5.0)], base, q,
                           want, 3) == 1      # a repeated id
    assert vref.wrong_rows(rows[:2], base, q, want, 3) == 1
    kth = vref._exact_kth(base, q[None, :], 3, "cpu")
    assert kth.tolist() == [want.tolist()]


def test_frozen_generator_matches_the_port():
    from oceanbase_tpu_torch.bench.tpch import gen_tpch

    a, _ = gen_tpch(sf=0.002, seed=31)
    b, types = tpch_gen.gen_tpch(sf=0.002, seed=31)
    assert a.keys() == b.keys()
    for t in a:
        for c in a[t]:
            assert np.array_equal(a[t][c], b[t][c]), (t, c)
    assert types["l_extendedprice"] == ("decimal", 15, 2)


def test_reference_agrees_with_the_port_at_sf001():
    from oceanbase_tpu_torch.server.database import Database
    from obbench.datasets import tpch
    from obbench.datasets.tpch_queries import QUERIES

    data = tpch.make({"scale_factor": 0.01}, 2**33 + 1, "cpu")
    db = Database(None, device="cpu")
    sess = db.session()
    tpch.load(sess, {}, data)
    ref = Ref(data["tables"])
    for q in range(1, 23):
        w, g = compare(sess.execute(QUERIES[q]).rows(), ref.run(q))
        assert w == 0 and g < 1e-12, q
