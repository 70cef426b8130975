"""Peaks of the card and the bytes a statement has to move.

Each count takes every input byte once, at widths fixed here, so it is
the same whatever implementation runs: what the statement needs, not
what a plan reads.  A roofline share is those bytes over the
statement's device busy time, against the published peak.
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 80GB (HBM3) data sheet: 3.35 TB/s at its 700 W limit
H100_HBM_BYTES_S = 3.35e12

#: widths of the TPC-H types: a flag (CHAR(1)) 1 B, a DATE 4 B, a
#: DECIMAL 8 B
FLAG_B, DATE_B, DECIMAL_B = 1, 4, 8

#: Q1 reads l_returnflag, l_linestatus (flags), l_quantity,
#: l_extendedprice, l_discount, l_tax (decimals) and l_shipdate (a date)
Q1_ROW_B = 2 * FLAG_B + 4 * DECIMAL_B + DATE_B

#: a vector coordinate as the configuration stores it (float32)
VECTOR_COORD_B = 4


def q1_bytes(lineitem_rows: int) -> int:
    """Bytes Q1 reads: 38 per lineitem row."""
    return Q1_ROW_B * int(lineitem_rows)


def knn_bytes(rows: int, dim: int) -> int:
    """Bytes an exact search over the table reads: every coordinate of
    every row once (the query vector and the k results are noise)."""
    return int(rows) * int(dim) * VECTOR_COORD_B
