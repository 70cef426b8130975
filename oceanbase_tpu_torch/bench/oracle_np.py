"""Numpy oracles for the Q6/Q1/Q14 slice, computed independently of the
executor on the generator's host arrays (``bench.tpch.gen_tpch``).

Integer and decimal results are exact int64 sums (decimals stay scaled:
Q6 revenue and Q1's price products at scale 4, Q1's plain sums at
scale 2).  Averages are float64 over the exact sums, as the executor
computes them.
"""

from __future__ import annotations

import numpy as np

from oceanbase_tpu_torch.datatypes import date_to_days

Q6_BOUNDS = dict(ship_lo=date_to_days("1994-01-01"),
                 ship_hi=date_to_days("1995-01-01"),
                 disc_lo=5, disc_hi=7, qty_hi=2400)
Q1_CUTOFF = date_to_days("1998-09-02")
Q14_RANGE = (date_to_days("1995-09-01"), date_to_days("1995-10-01"))


def numpy_q6(li) -> int:
    """Q6 revenue, scale 4."""
    b = Q6_BOUNDS
    sel = (
        (li["l_shipdate"] >= b["ship_lo"]) & (li["l_shipdate"] < b["ship_hi"])
        & (li["l_discount"] >= b["disc_lo"])
        & (li["l_discount"] <= b["disc_hi"])
        & (li["l_quantity"] < b["qty_hi"])
    )
    return int((li["l_extendedprice"][sel] * li["l_discount"][sel]).sum())


def numpy_q1(li) -> dict[str, np.ndarray]:
    """Q1 rows in (returnflag, linestatus) order, one array per column."""
    sel = li["l_shipdate"] <= Q1_CUTOFF
    rf = li["l_returnflag"][sel].astype(str)
    ls = li["l_linestatus"][sel].astype(str)
    qty = li["l_quantity"][sel]
    price = li["l_extendedprice"][sel]
    disc = li["l_discount"][sel]
    tax = li["l_tax"][sel]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    keys = sorted(set(zip(rf.tolist(), ls.tolist())))
    out = {name: [] for name in (
        "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
        "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
        "count_order")}
    for f, s in keys:
        g = (rf == f) & (ls == s)
        cnt = int(g.sum())
        out["l_returnflag"].append(f)
        out["l_linestatus"].append(s)
        out["sum_qty"].append(int(qty[g].sum()))
        out["sum_base_price"].append(int(price[g].sum()))
        out["sum_disc_price"].append(int(disc_price[g].sum()))
        out["sum_charge"].append(int(charge[g].sum()))
        out["avg_qty"].append(float(qty[g].sum()) / 100 / cnt)
        out["avg_price"].append(float(price[g].sum()) / 100 / cnt)
        out["avg_disc"].append(float(disc[g].sum()) / 100 / cnt)
        out["count_order"].append(cnt)
    return {k: np.asarray(v) for k, v in out.items()}


def numpy_q14(li, part) -> float:
    """Q14 promo revenue percent (float64)."""
    d0, d1 = Q14_RANGE
    sel = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    # p_partkey is 1..n, so a part row sits at partkey - 1
    ptype = part["p_type"][li["l_partkey"][sel] - 1].astype(str)
    disc = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    promo = disc[np.char.startswith(ptype, "PROMO")].sum()
    return 100.0 * promo / disc.sum()
