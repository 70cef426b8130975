"""TPC-H data: a frozen copy of the port's ``bench/tpch.py::gen_tpch``.

The same ``seed`` gives array-for-array the tables the port's generator
gives (``tests/test_obbench_tpch.py`` holds the two together at a small
scale), but this copy imports nothing of the program, so the yardstick
stays fixed whatever later changes do to the port's own generator.

All 8 tables of TPC-H v3 §1.4, with the spec's row counts per scale
factor and approximations of the value distributions that drive the
queries' selectivities.  Decimals are scaled int64 (cents, basis
points), dates int32 days since 1970-01-01, strings numpy object arrays.
"""

from __future__ import annotations

import numpy as np

_EPOCH = np.datetime64("1970-01-01", "D")


def date_to_days(s: str) -> int:
    """'1994-01-01' -> days since 1970-01-01."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


def days_to_date(d: int) -> str:
    return str(_EPOCH + np.timedelta64(int(d), "D"))


REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

_COMMENT_WORDS = (
    "the of and to in that was his he it with is for as had you not be her "
    "on at by which have or from this him but all she they were my are me "
    "one their so an said them we who would been will no when there if more "
    "out up into do any your what has man could other than our some very "
    "time upon about may its only now like little then can made should did "
    "us such great before must two these seen know over much down after "
    "first mr good men own never most old shall day where those came come "
    "himself way work life without go make well through being went left "
    "again while last might us place found thought quickly carefully "
    "furiously slyly blithely quietly deposits requests instructions "
    "accounts packages ideas theodolites pinto beans foxes dependencies "
    "excuses platelets asymptotes courts dolphins multipliers sauternes "
    "warthogs frets dinos attainments somas braids pains grouches wheat "
    "special pending regular express unusual final ironic even bold silent"
).split()


def _comment_pool(rng, pool_size: int, trigger=None, trigger_frac=0.009):
    """Build a pool of comment strings; optionally seed `trigger` phrases
    ('word1%word2' -> both words in order) at the given fraction."""
    lens = rng.integers(4, 9, pool_size)
    words = rng.choice(np.array(_COMMENT_WORDS), (pool_size, 9))
    out = np.empty(pool_size, dtype=object)
    for i in range(pool_size):
        out[i] = " ".join(words[i, : lens[i]])
    if trigger:
        w1, w2 = trigger
        k = max(1, int(pool_size * trigger_frac))
        idx = rng.choice(pool_size, k, replace=False)
        for i in idx:
            out[i] = out[i] + f" {w1} extra {w2}"
    return out


def _money(rng, lo_cents, hi_cents, n):
    return rng.integers(lo_cents, hi_cents, n, dtype=np.int64)


D = date_to_days
_START = D("1992-01-01")
_END = D("1998-08-02")
_CURRENT = D("1995-06-17")


def gen_tpch(sf: float = 0.01, seed: int = 19920101):
    """Generate all 8 tables; returns (tables, types) where tables maps
    table -> {column -> numpy array} and types maps column -> a type
    spec: ``("decimal", precision, scale)`` or ``("date",)``."""
    rng = np.random.default_rng(seed)
    n_part = int(200_000 * sf)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = int(150_000 * sf)
    n_ord = int(1_500_000 * sf)

    types: dict[str, tuple] = {}
    tables: dict[str, dict[str, np.ndarray]] = {}

    # ---- region / nation ------------------------------------------------
    tables["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": _comment_pool(rng, 5),
    }
    nname = np.array([n for n, _ in NATIONS], dtype=object)
    nreg = np.array([r for _, r in NATIONS], dtype=np.int64)
    tables["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": nname,
        "n_regionkey": nreg,
        "n_comment": _comment_pool(rng, 25),
    }

    # ---- supplier -------------------------------------------------------
    s_comment_pool = _comment_pool(
        rng, max(200, n_supp // 10), trigger=("Customer", "Complaints"),
        trigger_frac=0.005,
    )
    tables["supplier"] = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
                           dtype=object),
        "s_address": _comment_pool(rng, max(100, n_supp // 20))[
            rng.integers(0, max(100, n_supp // 20), n_supp)],
        "s_nationkey": rng.integers(0, 25, n_supp, dtype=np.int64),
        "s_phone": np.array(
            [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for _ in range(n_supp)], dtype=object),
        "s_acctbal": _money(rng, -99999, 999999, n_supp),
        "s_comment": s_comment_pool[rng.integers(0, len(s_comment_pool), n_supp)],
    }
    types["s_acctbal"] = ("decimal", 15, 2)

    # ---- part -----------------------------------------------------------
    pname_words = rng.choice(np.array(COLORS), (n_part, 5))
    p_name = np.array([" ".join(row) for row in pname_words], dtype=object)
    p_mfgr_i = rng.integers(1, 6, n_part)
    p_brand_i = p_mfgr_i * 10 + rng.integers(1, 6, n_part)
    p_type = (
        np.char.add(
            np.char.add(
                rng.choice(np.array(TYPE_S1), n_part).astype("U16"), " "
            ),
            np.char.add(
                np.char.add(rng.choice(np.array(TYPE_S2), n_part).astype("U16"), " "),
                rng.choice(np.array(TYPE_S3), n_part).astype("U16"),
            ),
        )
    ).astype(object)
    p_container = np.char.add(
        np.char.add(rng.choice(np.array(CONTAINER_S1), n_part).astype("U8"), " "),
        rng.choice(np.array(CONTAINER_S2), n_part).astype("U8"),
    ).astype(object)
    p_retail = (90000 + ((np.arange(1, n_part + 1) // 10) % 20001)
                + 100 * (np.arange(1, n_part + 1) % 1000)).astype(np.int64)
    tables["part"] = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": p_name,
        "p_mfgr": np.array([f"Manufacturer#{i}" for i in p_mfgr_i], dtype=object),
        "p_brand": np.array([f"Brand#{i}" for i in p_brand_i], dtype=object),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part, dtype=np.int64),
        "p_container": p_container,
        "p_retailprice": p_retail,
        "p_comment": _comment_pool(rng, max(100, n_part // 50))[
            rng.integers(0, max(100, n_part // 50), n_part)],
    }
    types["p_retailprice"] = ("decimal", 15, 2)

    # ---- partsupp (4 suppliers per part) --------------------------------
    n_ps = n_part * 4
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_suppkey = (
        (ps_partkey + (np.tile(np.arange(4), n_part))
         * ((n_supp // 4) + 1)) % n_supp + 1
    ).astype(np.int64)
    tables["partsupp"] = {
        "ps_partkey": ps_partkey,
        "ps_suppkey": ps_suppkey,
        "ps_availqty": rng.integers(1, 10000, n_ps, dtype=np.int64),
        "ps_supplycost": _money(rng, 100, 100001, n_ps),
        "ps_comment": _comment_pool(rng, 200)[rng.integers(0, 200, n_ps)],
    }
    types["ps_supplycost"] = ("decimal", 15, 2)

    # ---- customer -------------------------------------------------------
    tables["customer"] = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
                           dtype=object),
        "c_address": _comment_pool(rng, max(100, n_cust // 30))[
            rng.integers(0, max(100, n_cust // 30), n_cust)],
        "c_nationkey": rng.integers(0, 25, n_cust, dtype=np.int64),
        "c_phone": np.array(
            [f"{10 + (i % 25)}-{100 + (i * 7) % 900}-{100 + (i * 13) % 900}-{1000 + (i * 31) % 9000}"
             for i in range(1, n_cust + 1)], dtype=object),
        "c_acctbal": _money(rng, -99999, 999999, n_cust),
        "c_mktsegment": rng.choice(np.array(SEGMENTS), n_cust).astype(object),
        "c_comment": _comment_pool(rng, max(200, n_cust // 30))[
            rng.integers(0, max(200, n_cust // 30), n_cust)],
    }
    types["c_acctbal"] = ("decimal", 15, 2)

    # ---- orders ---------------------------------------------------------
    # spec: only 2/3 of customers have orders (clustered on odd custkeys)
    o_orderkey = np.arange(1, n_ord + 1, dtype=np.int64)
    o_custkey = rng.integers(1, max(n_cust, 2), n_ord, dtype=np.int64)
    o_custkey = np.where(o_custkey % 3 == 0, np.maximum(o_custkey - 1, 1), o_custkey)
    o_orderdate = rng.integers(_START, _END - 151, n_ord, dtype=np.int64)
    o_comment_pool = _comment_pool(
        rng, max(500, n_ord // 100), trigger=("special", "requests"),
        trigger_frac=0.01,
    )
    tables["orders"] = {
        "o_orderkey": o_orderkey,
        "o_custkey": o_custkey,
        "o_orderstatus": np.empty(n_ord, dtype=object),  # filled below
        "o_totalprice": np.zeros(n_ord, dtype=np.int64),  # filled below
        "o_orderdate": o_orderdate.astype(np.int32),
        "o_orderpriority": rng.choice(np.array(PRIORITIES), n_ord).astype(object),
        "o_clerk": np.array([f"Clerk#{i:09d}" for i in
                             rng.integers(1, max(n_ord // 1000, 2), n_ord)],
                            dtype=object),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": o_comment_pool[rng.integers(0, len(o_comment_pool), n_ord)],
    }
    types["o_orderdate"] = ("date",)
    types["o_totalprice"] = ("decimal", 15, 2)

    # ---- lineitem -------------------------------------------------------
    n_lines = rng.integers(1, 8, n_ord)
    n_li = int(n_lines.sum())
    l_orderkey = np.repeat(o_orderkey, n_lines)
    l_odate = np.repeat(o_orderdate, n_lines)
    l_linenumber = (np.arange(n_li) -
                    np.repeat(np.cumsum(n_lines) - n_lines, n_lines) + 1)
    l_partkey = rng.integers(1, max(n_part, 2), n_li, dtype=np.int64)
    # supplier consistent with partsupp: one of the 4 suppliers of the part
    j = rng.integers(0, 4, n_li)
    l_suppkey = ((l_partkey + j * ((n_supp // 4) + 1)) % n_supp + 1).astype(np.int64)
    l_quantity = rng.integers(1, 51, n_li, dtype=np.int64) * 100  # scale 2
    l_extendedprice = (l_quantity // 100) * p_retail[l_partkey - 1]
    l_discount = rng.integers(0, 11, n_li, dtype=np.int64)  # scale 2: 0.00-0.10
    l_tax = rng.integers(0, 9, n_li, dtype=np.int64)
    l_shipdate = l_odate + rng.integers(1, 122, n_li)
    l_commitdate = l_odate + rng.integers(30, 91, n_li)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li)
    l_linestatus = np.where(l_shipdate > _CURRENT, "O", "F").astype(object)
    rf = rng.integers(0, 2, n_li)
    l_returnflag = np.where(
        l_receiptdate <= _CURRENT, np.where(rf == 0, "R", "A"), "N"
    ).astype(object)
    tables["lineitem"] = {
        "l_orderkey": l_orderkey,
        "l_partkey": l_partkey,
        "l_suppkey": l_suppkey,
        "l_linenumber": l_linenumber.astype(np.int64),
        "l_quantity": l_quantity,
        "l_extendedprice": l_extendedprice,
        "l_discount": l_discount,
        "l_tax": l_tax,
        "l_returnflag": l_returnflag,
        "l_linestatus": l_linestatus,
        "l_shipdate": l_shipdate.astype(np.int32),
        "l_commitdate": l_commitdate.astype(np.int32),
        "l_receiptdate": l_receiptdate.astype(np.int32),
        "l_shipinstruct": rng.choice(np.array(SHIPINSTRUCT), n_li).astype(object),
        "l_shipmode": rng.choice(np.array(SHIPMODES), n_li).astype(object),
        "l_comment": _comment_pool(rng, 500)[rng.integers(0, 500, n_li)],
    }
    for c in ("l_quantity", "l_extendedprice"):
        types[c] = ("decimal", 15, 2)
    types["l_discount"] = ("decimal", 15, 2)
    types["l_tax"] = ("decimal", 15, 2)
    for c in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        types[c] = ("date",)

    # back-fill orders totals/status from lineitem
    disc_price = l_extendedprice * (100 - l_discount) // 100
    charged = disc_price * (100 + l_tax) // 100
    o_total = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(o_total, l_orderkey, charged)
    tables["orders"]["o_totalprice"] = o_total[1:]
    all_f = np.ones(n_ord + 1, dtype=bool)
    any_f = np.zeros(n_ord + 1, dtype=bool)
    isf = l_linestatus == "F"
    np.logical_and.at(all_f, l_orderkey, isf)
    np.logical_or.at(any_f, l_orderkey, isf)
    tables["orders"]["o_orderstatus"] = np.where(
        all_f[1:], "F", np.where(any_f[1:], "P", "O")
    ).astype(object)

    return tables, types


PRIMARY_KEYS = {
    "region": ["r_regionkey"],
    "nation": ["n_nationkey"],
    "supplier": ["s_suppkey"],
    "part": ["p_partkey"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
    "customer": ["c_custkey"],
    "orders": ["o_orderkey"],
    "lineitem": ["l_orderkey", "l_linenumber"],
}
