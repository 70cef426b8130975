"""The plain reference of the 22 TPC-H queries, in NumPy.

Each query is written out by hand from its text in TPC-H v3 §2.4 (with
the parameters of ``obbench/datasets/tpch_queries.py``) over the host
arrays the generator made.  It imports nothing of the program and reads
nothing the program made.

Decimals are exact scaled int64 (``money=np.int64``); a product's scale
is the sum of its factors' scales, as SQL's decimal arithmetic keeps it.
A comparison against a fraction of an aggregate (Q11, Q17, Q20, Q22) is
made exactly, in integers.  A result comes back in the form the port's
``Result.rows()`` gives it: a decimal as ``float(scaled) / 10**scale``,
a date as ``'YYYY-MM-DD'``, an empty SUM as None.

``money=np.float32`` carries every decimal as a float32 instead: that is
the control, the reference computed in a precision below the one the
configuration states, which the comparison has to refuse.

Each query returns an :class:`Expected`: every row of the result in its
ORDER BY order (ties in any order), which columns are doubles (compared
by a relative gap) and which are exact, the ORDER BY columns and the
LIMIT.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from obbench.datasets.tpch_gen import date_to_days, days_to_date

D = date_to_days


@dataclass
class Expected:
    rows: list            # every row, in ORDER BY order, before LIMIT
    kinds: str            # per column: "x" exact, "f" double
    order: list           # [(column index, descending)]
    limit: int | None = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _like(pattern: str):
    """SQL LIKE with % only (the queries use no _) -> predicate."""
    rx = re.compile("^" + ".*".join(re.escape(p) for p in pattern.split("%"))
                    + "$", re.S)
    return lambda s: rx.match(s) is not None


def _isin(arr, values) -> np.ndarray:
    m = np.zeros(len(arr), dtype=bool)
    for v in values:
        m |= arr == v
    return m


def _codes(arr) -> tuple[np.ndarray, list]:
    """Dense codes of an array's values in sorted order -> (codes,
    values)."""
    if arr.dtype != object:
        vals, inv = np.unique(arr, return_inverse=True)
        return inv.astype(np.int64), list(vals)
    vals = sorted(set(arr.tolist()))
    if len(vals) <= 64:
        codes = np.empty(len(arr), dtype=np.int64)
        for i, v in enumerate(vals):
            codes[arr == v] = i
        return codes, vals
    pos = {v: i for i, v in enumerate(vals)}
    return np.fromiter((pos[s] for s in arr), np.int64, len(arr)), vals


def _group(*keys) -> tuple[np.ndarray, np.ndarray]:
    """Group rows by non-negative integer key columns -> (inverse, first
    row of each group), groups in ascending key order."""
    n = len(keys[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    comb = np.zeros(n, dtype=np.int64)
    span = 1
    for k in keys:
        k = np.asarray(k).astype(np.int64)
        lo, hi = int(k.min()), int(k.max())
        width = hi - lo + 1
        if span * width >= 1 << 62:
            raise OverflowError("group keys too wide to combine")
        comb = comb * width + (k - lo)
        span *= width
    if span <= max(4 * n, 1 << 16):
        # dense: present keys by counting, no sort
        present = np.bincount(comb, minlength=span) > 0
        remap = np.cumsum(present) - 1
        inv = remap[comb]
        g = int(present.sum())
    else:
        _u, inv = np.unique(comb, return_inverse=True)
        inv = inv.reshape(-1)
        g = len(_u)
    first = np.full(g, n, dtype=np.int64)
    np.minimum.at(first, inv, np.arange(n, dtype=np.int64))
    return inv, first


def _gsum(inv, vals, n) -> np.ndarray:
    """Per-group sums, in the values' own dtype (exact for int64)."""
    out = np.zeros(n, dtype=vals.dtype)
    np.add.at(out, inv, vals)
    return out


def _gcount(inv, n) -> np.ndarray:
    return np.bincount(inv, minlength=n).astype(np.int64)


def _index(keys: np.ndarray, probe: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Rows of unique ``keys`` that ``probe`` names -> (row, found)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.searchsorted(sk, probe)
    pos_c = np.minimum(pos, len(sk) - 1)
    found = sk[pos_c] == probe
    return order[pos_c], found


def _pair(a, b, bmax) -> np.ndarray:
    return a.astype(np.int64) * (int(bmax) + 1) + b.astype(np.int64)


def _sort_rows(rows: list, order: list) -> list:
    for col, desc in reversed(order):
        rows.sort(key=lambda r, c=col: (r[c] is None, r[c]), reverse=desc)
    return rows


class Ref:
    """The 22 queries over one set of generated tables."""

    def __init__(self, tables: dict, money=np.int64):
        self.t = tables
        self.money = money
        self._memo: dict = {}

    def rows_of(self, table: str, key: str, ptable: str, pkey: str):
        """Rows of ``table`` whose unique ``key`` each row of ``ptable``
        names in ``pkey`` -> (row, found), computed once."""
        m = ("rows", table, key, ptable, pkey)
        if m not in self._memo:
            self._memo[m] = _index(self.t[table][key], self.t[ptable][pkey])
        return self._memo[m]

    def codes(self, table: str, col: str):
        """Dense codes of a column -> (codes, values), computed once."""
        m = ("codes", table, col)
        if m not in self._memo:
            self._memo[m] = _codes(self.t[table][col])
        return self._memo[m]

    def eq(self, table: str, col: str, value) -> np.ndarray:
        codes, vals = self.codes(table, col)
        return codes == (vals.index(value) if value in vals else -1)

    def isin(self, table: str, col: str, values) -> np.ndarray:
        codes, vals = self.codes(table, col)
        return np.isin(codes, [vals.index(v) for v in values if v in vals])

    def like(self, table: str, col: str, pred) -> np.ndarray:
        codes, vals = self.codes(table, col)
        return np.array([bool(pred(v)) for v in vals], dtype=bool)[codes]

    # -- column access and output ------------------------------------------
    def dec(self, table: str, col: str) -> np.ndarray:
        return self.t[table][col].astype(self.money)

    def out_dec(self, x, scale: int):
        if x is None:
            return None
        if self.money is np.int64:
            return float(int(x)) / 10 ** scale
        return float(x) / 10 ** scale

    def sum_or_none(self, v):
        return v.sum(dtype=v.dtype) if len(v) else None

    def run(self, q: int) -> Expected:
        return getattr(self, f"q{q}")()

    # -- the queries ---------------------------------------------------------
    def q1(self):
        li = self.t["lineitem"]
        sel = li["l_shipdate"] <= D("1998-09-02")
        rf, rfv = self.codes("lineitem", "l_returnflag")
        ls, lsv = self.codes("lineitem", "l_linestatus")
        rf, ls = rf[sel], ls[sel]
        inv, first = _group(rf, ls)
        n = len(first)
        qty = self.dec("lineitem", "l_quantity")[sel]
        price = self.dec("lineitem", "l_extendedprice")[sel]
        disc = self.dec("lineitem", "l_discount")[sel]
        tax = self.dec("lineitem", "l_tax")[sel]
        disc_price = price * (self.money(100) - disc)
        charge = disc_price * (self.money(100) + tax)
        s_qty, s_price = _gsum(inv, qty, n), _gsum(inv, price, n)
        s_dp, s_ch = _gsum(inv, disc_price, n), _gsum(inv, charge, n)
        s_disc, cnt = _gsum(inv, disc, n), _gcount(inv, n)
        rows = []
        for g in range(n):
            rows.append((
                rfv[rf[first[g]]], lsv[ls[first[g]]],
                self.out_dec(s_qty[g], 2), self.out_dec(s_price[g], 2),
                self.out_dec(s_dp[g], 4), self.out_dec(s_ch[g], 6),
                float(s_qty[g]) / 100 / int(cnt[g]),
                float(s_price[g]) / 100 / int(cnt[g]),
                float(s_disc[g]) / 100 / int(cnt[g]), int(cnt[g])))
        order = [(0, False), (1, False)]
        return Expected(_sort_rows(rows, order), "xxxxxxfffx", order)

    def _nations_of_region(self, region: str) -> np.ndarray:
        r = self.t["region"]
        rk = r["r_regionkey"][r["r_name"] == region]
        n = self.t["nation"]
        return n["n_nationkey"][np.isin(n["n_regionkey"], rk)]

    def _nation_name(self, keys) -> np.ndarray:
        n = self.t["nation"]
        row, ok = _index(n["n_nationkey"], keys)
        assert ok.all()
        return n["n_name"][row]

    def q2(self):
        p, s, ps = self.t["part"], self.t["supplier"], self.t["partsupp"]
        eu = self._nations_of_region("EUROPE")
        srow, sok = self.rows_of("supplier", "s_suppkey", "partsupp", "ps_suppkey")
        ps_eu = sok & np.isin(s["s_nationkey"][srow], eu)
        cost = self.dec("partsupp", "ps_supplycost")
        # the correlated minimum: per part, over its European offers
        pk = ps["ps_partkey"][ps_eu]
        inv, first = _group(pk)
        mins = np.full(len(first), np.inf if self.money is not np.int64
                       else np.iinfo(np.int64).max, dtype=cost.dtype)
        np.minimum.at(mins, inv, cost[ps_eu])
        min_of = dict(zip(pk[first].tolist(), mins.tolist()))
        pmask = (p["p_size"] == 15) & self.like(
            "part", "p_type", lambda x: x.endswith("BRASS"))
        good_parts = set(p["p_partkey"][pmask].tolist())
        idx = np.nonzero(ps_eu)[0]
        rows = []
        acct = self.dec("supplier", "s_acctbal")
        prow, _ok = _index(p["p_partkey"], ps["ps_partkey"][idx])
        for i, pr in zip(idx.tolist(), prow.tolist()):
            key = int(ps["ps_partkey"][i])
            if key not in good_parts or cost[i] != min_of[key]:
                continue
            sr = srow[i]
            rows.append((
                self.out_dec(acct[sr], 2), s["s_name"][sr],
                self._nation_name(s["s_nationkey"][sr:sr + 1])[0],
                key, p["p_mfgr"][pr], s["s_address"][sr], s["s_phone"][sr],
                s["s_comment"][sr]))
        order = [(0, True), (2, False), (1, False), (3, False)]
        return Expected(_sort_rows(rows, order), "xxxxxxxx", order, 100)

    def _revenue(self, sel):
        price = self.dec("lineitem", "l_extendedprice")[sel]
        disc = self.dec("lineitem", "l_discount")[sel]
        return price * (self.money(100) - disc)

    def q3(self):
        c, o, li = self.t["customer"], self.t["orders"], self.t["lineitem"]
        cut = D("1995-03-15")
        cust = c["c_custkey"][c["c_mktsegment"] == "BUILDING"]
        omask = (o["o_orderdate"] < cut) & np.isin(o["o_custkey"], cust)
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        sel = ook & omask[orow] & (li["l_shipdate"] > cut)
        rev = self._revenue(sel)
        inv, first = _group(li["l_orderkey"][sel])
        sums = _gsum(inv, rev, len(first))
        okeys = li["l_orderkey"][sel][first]
        orr = orow[sel][first]
        rows = [(int(k), self.out_dec(v, 4),
                 days_to_date(o["o_orderdate"][r]),
                 int(o["o_shippriority"][r]))
                for k, v, r in zip(okeys, sums, orr)]
        order = [(1, True), (2, False)]
        return Expected(_sort_rows(rows, order), "xxxx", order, 10)

    def q4(self):
        o, li = self.t["orders"], self.t["lineitem"]
        late = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
        sel = ((o["o_orderdate"] >= D("1993-07-01"))
               & (o["o_orderdate"] < D("1993-10-01"))
               & np.isin(o["o_orderkey"], late))
        pr, prv = _codes(o["o_orderpriority"][sel])
        cnt = np.bincount(pr, minlength=len(prv))
        rows = [(prv[i], int(cnt[i])) for i in range(len(prv)) if cnt[i]]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xx", order)

    def q5(self):
        c, o, li, s = (self.t["customer"], self.t["orders"],
                       self.t["lineitem"], self.t["supplier"])
        asia = self._nations_of_region("ASIA")
        omask = ((o["o_orderdate"] >= D("1994-01-01"))
                 & (o["o_orderdate"] < D("1995-01-01")))
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        crow, cok = (x[orow] for x in self.rows_of(
            "customer", "c_custkey", "orders", "o_custkey"))
        srow, sok = self.rows_of("supplier", "s_suppkey", "lineitem", "l_suppkey")
        snat = s["s_nationkey"][srow]
        sel = (ook & omask[orow] & cok & sok
               & (c["c_nationkey"][crow] == snat) & np.isin(snat, asia))
        rev = self._revenue(sel)
        inv, first = _group(snat[sel])
        sums = _gsum(inv, rev, len(first))
        names = self._nation_name(snat[sel][first])
        rows = [(nm, self.out_dec(v, 4)) for nm, v in zip(names, sums)]
        order = [(1, True)]
        return Expected(_sort_rows(rows, order), "xx", order)

    def q6(self):
        li = self.t["lineitem"]
        disc = self.dec("lineitem", "l_discount")
        sel = ((li["l_shipdate"] >= D("1994-01-01"))
               & (li["l_shipdate"] < D("1995-01-01"))
               & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
               & (li["l_quantity"] < 2400))
        v = self.dec("lineitem", "l_extendedprice")[sel] * disc[sel]
        return Expected([(self.out_dec(self.sum_or_none(v), 4),)], "x", [])

    def _year(self, days) -> np.ndarray:
        return (np.asarray(days).astype("datetime64[D]")
                .astype("datetime64[Y]").astype(np.int64) + 1970)

    def q7(self):
        s, li, o, c = (self.t["supplier"], self.t["lineitem"],
                       self.t["orders"], self.t["customer"])
        sel = ((li["l_shipdate"] >= D("1995-01-01"))
               & (li["l_shipdate"] <= D("1996-12-31")))
        srow, sok = self.rows_of("supplier", "s_suppkey", "lineitem", "l_suppkey")
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        crow, cok = (x[orow] for x in self.rows_of(
            "customer", "c_custkey", "orders", "o_custkey"))
        sn = s["s_nationkey"][srow]
        cn = c["c_nationkey"][crow]
        nat = self.t["nation"]
        fr = int(nat["n_nationkey"][nat["n_name"] == "FRANCE"][0])
        de = int(nat["n_nationkey"][nat["n_name"] == "GERMANY"][0])
        sel &= sok & ook & cok & (((sn == fr) & (cn == de))
                                  | ((sn == de) & (cn == fr)))
        rev = self._revenue(sel)
        year = self._year(li["l_shipdate"][sel])
        inv, first = _group(sn[sel], cn[sel], year)
        sums = _gsum(inv, rev, len(first))
        sname = self._nation_name(sn[sel][first])
        cname = self._nation_name(cn[sel][first])
        rows = [(a, b, int(y), self.out_dec(v, 4))
                for a, b, y, v in zip(sname, cname, year[first], sums)]
        order = [(0, False), (1, False), (2, False)]
        return Expected(_sort_rows(rows, order), "xxxx", order)

    def q8(self):
        p, s, li, o, c = (self.t["part"], self.t["supplier"],
                          self.t["lineitem"], self.t["orders"],
                          self.t["customer"])
        america = self._nations_of_region("AMERICA")
        prow, pok = self.rows_of("part", "p_partkey", "lineitem", "l_partkey")
        ptype_ok = p["p_type"] == "ECONOMY ANODIZED STEEL"
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        crow, cok = (x[orow] for x in self.rows_of(
            "customer", "c_custkey", "orders", "o_custkey"))
        srow, sok = self.rows_of("supplier", "s_suppkey", "lineitem", "l_suppkey")
        odate = o["o_orderdate"][orow]
        sel = (pok & ptype_ok[prow] & ook & cok & sok
               & np.isin(c["c_nationkey"][crow], america)
               & (odate >= D("1995-01-01")) & (odate <= D("1996-12-31")))
        vol = self._revenue(sel)
        nat = self._nation_name(s["s_nationkey"][srow][sel])
        brazil = np.where(nat == "BRAZIL", vol, self.money(0))
        year = self._year(odate[sel])
        inv, first = _group(year)
        num = _gsum(inv, brazil, len(first))
        den = _gsum(inv, vol, len(first))
        rows = [(int(y), float(a) / float(b))
                for y, a, b in zip(year[first], num, den)]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xf", order)

    def q9(self):
        p, s, li, ps, o = (self.t["part"], self.t["supplier"],
                           self.t["lineitem"], self.t["partsupp"],
                           self.t["orders"])
        green = self.like("part", "p_name", lambda x: "green" in x)
        prow, pok = self.rows_of("part", "p_partkey", "lineitem", "l_partkey")
        sel = pok & green[prow]
        nsupp = int(ps["ps_suppkey"].max())
        psrow, psok = _index(_pair(ps["ps_partkey"], ps["ps_suppkey"], nsupp),
                             _pair(li["l_partkey"], li["l_suppkey"], nsupp))
        srow, sok = self.rows_of("supplier", "s_suppkey", "lineitem", "l_suppkey")
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        sel &= psok & sok & ook
        cost = self.dec("partsupp", "ps_supplycost")[psrow[sel]]
        qty = self.dec("lineitem", "l_quantity")[sel]
        amount = self._revenue(sel) - cost * qty
        nk = s["s_nationkey"][srow[sel]]
        year = self._year(o["o_orderdate"][orow[sel]])
        inv, first = _group(nk, year)
        sums = _gsum(inv, amount, len(first))
        names = self._nation_name(nk[first])
        rows = [(nm, int(y), self.out_dec(v, 4))
                for nm, y, v in zip(names, year[first], sums)]
        order = [(0, False), (1, True)]
        return Expected(_sort_rows(rows, order), "xxx", order)

    def q10(self):
        c, o, li = self.t["customer"], self.t["orders"], self.t["lineitem"]
        omask = ((o["o_orderdate"] >= D("1993-10-01"))
                 & (o["o_orderdate"] < D("1994-01-01")))
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        sel = ook & omask[orow] & self.eq("lineitem", "l_returnflag", "R")
        crow, cok = (x[orow[sel]] for x in self.rows_of(
            "customer", "c_custkey", "orders", "o_custkey"))
        assert cok.all()
        rev = self._revenue(sel)
        inv, first = _group(crow)
        sums = _gsum(inv, rev, len(first))
        acct = self.dec("customer", "c_acctbal")
        rows = []
        for g, r in enumerate(crow[first].tolist()):
            rows.append((int(c["c_custkey"][r]), c["c_name"][r],
                         self.out_dec(sums[g], 4), self.out_dec(acct[r], 2),
                         self._nation_name(c["c_nationkey"][r:r + 1])[0],
                         c["c_address"][r], c["c_phone"][r],
                         c["c_comment"][r]))
        order = [(2, True)]
        return Expected(_sort_rows(rows, order), "xxxxxxxx", order, 20)

    def q11(self):
        ps, s = self.t["partsupp"], self.t["supplier"]
        nat = self.t["nation"]
        de = nat["n_nationkey"][nat["n_name"] == "GERMANY"]
        srow, sok = self.rows_of("supplier", "s_suppkey", "partsupp", "ps_suppkey")
        sel = sok & np.isin(s["s_nationkey"][srow], de)
        val = (self.dec("partsupp", "ps_supplycost")[sel]
               * ps["ps_availqty"][sel].astype(self.money))
        total = val.sum(dtype=val.dtype)
        inv, first = _group(ps["ps_partkey"][sel])
        sums = _gsum(inv, val, len(first))
        # value > total * 0.0001, exactly
        keep = sums * self.money(10000) > total
        rows = [(int(k), self.out_dec(v, 2))
                for k, v in zip(ps["ps_partkey"][sel][first][keep],
                                sums[keep])]
        order = [(1, True)]
        return Expected(_sort_rows(rows, order), "xx", order)

    def q12(self):
        o, li = self.t["orders"], self.t["lineitem"]
        sel = (self.isin("lineitem", "l_shipmode", ("MAIL", "SHIP"))
               & (li["l_commitdate"] < li["l_receiptdate"])
               & (li["l_shipdate"] < li["l_commitdate"])
               & (li["l_receiptdate"] >= D("1994-01-01"))
               & (li["l_receiptdate"] < D("1995-01-01")))
        orow, ook = _index(o["o_orderkey"], li["l_orderkey"][sel])
        assert ook.all()
        high = self.isin("orders", "o_orderpriority",
                         ("1-URGENT", "2-HIGH"))[orow]
        mode, modev = _codes(li["l_shipmode"][sel])
        hi = np.bincount(mode, weights=high, minlength=len(modev))
        lo = np.bincount(mode, weights=~high, minlength=len(modev))
        rows = [(modev[i], int(hi[i]), int(lo[i])) for i in range(len(modev))]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xxx", order)

    def q13(self):
        c, o = self.t["customer"], self.t["orders"]
        ok = ~self.like("orders", "o_comment", _like("%special%requests%"))
        crow, cok = _index(c["c_custkey"], o["o_custkey"][ok])
        per_cust = np.bincount(crow[cok], minlength=len(c["c_custkey"]))
        cc, ccv = _codes(per_cust)
        dist = np.bincount(cc, minlength=len(ccv))
        rows = [(int(ccv[i]), int(dist[i])) for i in range(len(ccv))]
        order = [(1, True), (0, True)]
        return Expected(_sort_rows(rows, order), "xx", order)

    def q14(self):
        p, li = self.t["part"], self.t["lineitem"]
        sel = ((li["l_shipdate"] >= D("1995-09-01"))
               & (li["l_shipdate"] < D("1995-10-01")))
        prow, pok = self.rows_of("part", "p_partkey", "lineitem", "l_partkey")
        sel &= pok
        promo = self.like("part", "p_type", lambda x: x.startswith("PROMO"))
        rev = self._revenue(sel)
        if not len(rev):
            return Expected([(None,)], "f", [])
        num = np.where(promo[prow[sel]], rev, self.money(0)).sum(
            dtype=rev.dtype)
        den = rev.sum(dtype=rev.dtype)
        return Expected([(100.0 * float(num) / float(den),)], "f", [])

    def q15(self):
        s, li = self.t["supplier"], self.t["lineitem"]
        sel = ((li["l_shipdate"] >= D("1996-01-01"))
               & (li["l_shipdate"] < D("1996-04-01")))
        rev = self._revenue(sel)
        inv, first = _group(li["l_suppkey"][sel])
        sums = _gsum(inv, rev, len(first))
        best = sums.max()
        keys = li["l_suppkey"][sel][first][sums == best]
        srow, sok = _index(s["s_suppkey"], keys)
        rows = [(int(k), s["s_name"][r], s["s_address"][r], s["s_phone"][r],
                 self.out_dec(best, 4))
                for k, r, f in zip(keys, srow, sok) if f]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xxxxx", order)

    def q16(self):
        p, ps, s = self.t["part"], self.t["partsupp"], self.t["supplier"]
        bad = s["s_suppkey"][self.like("supplier", "s_comment",
                                       _like("%Customer%Complaints%"))]
        pmask = ((p["p_brand"] != "Brand#45")
                 & ~self.like("part", "p_type", _like("MEDIUM POLISHED%"))
                 & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
        prow, pok = self.rows_of("part", "p_partkey", "partsupp", "ps_partkey")
        sel = pok & pmask[prow] & ~np.isin(ps["ps_suppkey"], bad)
        b, bv = self.codes("part", "p_brand")
        t, tv = self.codes("part", "p_type")
        pr = prow[sel]
        gb, gt, gs = b[pr], t[pr], p["p_size"][pr]
        supp = ps["ps_suppkey"][sel]
        # count(distinct ps_suppkey) per group
        _inv, dfirst = _group(gb, gt, gs, supp)
        inv, first = _group(gb[dfirst], gt[dfirst], gs[dfirst])
        cnt = _gcount(inv, len(first))
        rows = [(bv[gb[dfirst][f]], tv[gt[dfirst][f]], int(gs[dfirst][f]),
                 int(n)) for f, n in zip(first, cnt)]
        order = [(3, True), (0, False), (1, False), (2, False)]
        return Expected(_sort_rows(rows, order), "xxxx", order)

    def q17(self):
        p, li = self.t["part"], self.t["lineitem"]
        parts = p["p_partkey"][(p["p_brand"] == "Brand#23")
                               & (p["p_container"] == "MED BOX")]
        on = np.isin(li["l_partkey"], parts)
        qty = li["l_quantity"][on]
        inv, first = _group(li["l_partkey"][on])
        qsum = _gsum(inv, qty.astype(np.int64), len(first))
        qcnt = _gcount(inv, len(first))
        # l_quantity < 0.2 * avg(l_quantity), exactly: 5 * cnt * q < sum
        keep = 5 * qcnt[inv] * qty < qsum[inv]
        price = self.dec("lineitem", "l_extendedprice")[on][keep]
        if not len(price):
            return Expected([(None,)], "f", [])
        tot = price.sum(dtype=price.dtype)
        return Expected([(float(tot) / 100 / 7.0,)], "f", [])

    def q18(self):
        c, o, li = self.t["customer"], self.t["orders"], self.t["lineitem"]
        inv, first = _group(li["l_orderkey"])
        qsum = _gsum(inv, self.dec("lineitem", "l_quantity"), len(first))
        big = qsum > self.money(30000)
        keys = li["l_orderkey"][first][big]
        sums = qsum[big]
        orow, ook = _index(o["o_orderkey"], keys)
        crow, cok = (x[orow] for x in self.rows_of(
            "customer", "c_custkey", "orders", "o_custkey"))
        price = self.dec("orders", "o_totalprice")
        rows = [(c["c_name"][cr], int(c["c_custkey"][cr]), int(k),
                 days_to_date(o["o_orderdate"][orr]),
                 self.out_dec(price[orr], 2), self.out_dec(q, 2))
                for k, q, orr, cr, f in zip(keys, sums, orow, crow, ook & cok)
                if f]
        order = [(4, True), (3, False)]
        return Expected(_sort_rows(rows, order), "xxxxxx", order, 100)

    def q19(self):
        li = self.t["lineitem"]
        prow, pok = self.rows_of("part", "p_partkey", "lineitem", "l_partkey")
        base = np.nonzero(
            pok & self.isin("lineitem", "l_shipmode", ("AIR", "AIR REG"))
            & self.eq("lineitem", "l_shipinstruct", "DELIVER IN PERSON"))[0]
        pr = prow[base]
        size = self.t["part"]["p_size"][pr]
        qty = li["l_quantity"][base]
        hit = np.zeros(len(base), dtype=bool)
        for b, conts, qlo, qhi, smax in (
                ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                 1, 11, 5),
                ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                 10, 20, 10),
                ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
                 20, 30, 15)):
            hit |= (self.eq("part", "p_brand", b)[pr]
                    & self.isin("part", "p_container", conts)[pr]
                    & (qty >= qlo * 100) & (qty <= qhi * 100)
                    & (size >= 1) & (size <= smax))
        sel = np.zeros(len(li["l_quantity"]), dtype=bool)
        sel[base[hit]] = True
        rev = self._revenue(sel)
        return Expected([(self.out_dec(self.sum_or_none(rev), 4),)], "x", [])

    def q20(self):
        p, ps, li, s = (self.t["part"], self.t["partsupp"],
                        self.t["lineitem"], self.t["supplier"])
        forest = p["p_partkey"][self.like(
            "part", "p_name", lambda x: x.startswith("forest"))]
        yr = ((li["l_shipdate"] >= D("1994-01-01"))
              & (li["l_shipdate"] < D("1995-01-01")))
        nsupp = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max()))
        lkey = _pair(li["l_partkey"][yr], li["l_suppkey"][yr], nsupp)
        inv, first = _group(lkey)
        qsum = dict(zip(lkey[first].tolist(),
                        _gsum(inv, li["l_quantity"][yr].astype(np.int64),
                              len(first)).tolist()))
        cand = np.isin(ps["ps_partkey"], forest)
        pkey = _pair(ps["ps_partkey"], ps["ps_suppkey"], nsupp)
        good = set()
        for i in np.nonzero(cand)[0].tolist():
            q = qsum.get(int(pkey[i]))
            # availqty > 0.5 * sum(l_quantity), exactly; an empty sum is
            # NULL and keeps nothing
            if q is not None and 200 * int(ps["ps_availqty"][i]) > q:
                good.add(int(ps["ps_suppkey"][i]))
        nat = self.t["nation"]
        ca = nat["n_nationkey"][nat["n_name"] == "CANADA"]
        smask = np.isin(s["s_suppkey"], list(good)) & np.isin(
            s["s_nationkey"], ca)
        rows = [(a, b) for a, b in zip(s["s_name"][smask],
                                       s["s_address"][smask])]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xx", order)

    def q21(self):
        s, li, o = self.t["supplier"], self.t["lineitem"], self.t["orders"]
        nat = self.t["nation"]
        sa = nat["n_nationkey"][nat["n_name"] == "SAUDI ARABIA"]
        late = li["l_receiptdate"] > li["l_commitdate"]
        ok_, sk = li["l_orderkey"], li["l_suppkey"]
        nsupp = int(sk.max())
        # distinct suppliers per order, over all lines and late lines
        pair = _pair(ok_, sk, nsupp)
        u_all = np.unique(pair)
        n_all = np.bincount(u_all // (nsupp + 1),
                            minlength=int(ok_.max()) + 1)
        u_late = np.unique(pair[late])
        n_late = np.bincount(u_late // (nsupp + 1),
                             minlength=int(ok_.max()) + 1)
        orow, ook = self.rows_of("orders", "o_orderkey", "lineitem", "l_orderkey")
        srow, sok = self.rows_of("supplier", "s_suppkey", "lineitem", "l_suppkey")
        sel = (late & ook & sok & self.eq("orders", "o_orderstatus", "F")[orow]
               & np.isin(s["s_nationkey"][srow], sa)
               & (n_all[ok_] >= 2) & (n_late[ok_] == 1))
        inv, first = _group(srow[sel])
        cnt = _gcount(inv, len(first))
        rows = [(s["s_name"][r], int(n))
                for r, n in zip(srow[sel][first], cnt)]
        order = [(1, True), (0, False)]
        return Expected(_sort_rows(rows, order), "xx", order, 100)

    def q22(self):
        c, o = self.t["customer"], self.t["orders"]
        codes = ("13", "31", "23", "29", "30", "18", "17")
        cc = np.array([ph[:2] for ph in c["c_phone"]], dtype=object)
        inset = _isin(cc, codes)
        acct = self.dec("customer", "c_acctbal")
        pos = inset & (acct > 0)
        asum = acct[pos].sum(dtype=acct.dtype)
        acnt = int(pos.sum())
        # c_acctbal > avg(...), exactly: acctbal * count > sum
        rich = acct * self.money(acnt) > asum
        no_orders = ~np.isin(c["c_custkey"], o["o_custkey"])
        sel = inset & rich & no_orders
        g, gv = _codes(cc[sel])
        n = np.bincount(g, minlength=len(gv))
        tot = _gsum(g, acct[sel], len(gv))
        rows = [(gv[i], int(n[i]), self.out_dec(tot[i], 2))
                for i in range(len(gv))]
        order = [(0, False)]
        return Expected(_sort_rows(rows, order), "xxx", order)
