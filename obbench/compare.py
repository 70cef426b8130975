"""Rows the program returned against the reference's :class:`Expected`.

Two numbers come out of one comparison:

- ``wrong``: rows of the answer that are wrong or missing.  Every
  column but a double is compared exactly: strings, integers, dates and
  decimals (a decimal arrives as ``float(scaled) / 10**scale``, which
  the reference forms the same way, so an exact decimal compares
  equal).  The ORDER BY columns have to come in the reference's order.
  Under a LIMIT, rows that tie with the last row on every ORDER BY
  column may be any of the tied rows.
- ``gap``: the largest relative gap of a double column (an AVG or a
  ratio of sums) between a row and the reference row it matched.
"""

from __future__ import annotations


def _gap(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is b else float("inf")
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def compare(got: list, exp) -> tuple[int, float]:
    """-> (wrong rows, largest relative gap of a double)."""
    ref = exp.rows
    n_want = len(ref) if exp.limit is None else min(exp.limit, len(ref))
    ocols = [c for c, _desc in exp.order]
    xcols = [i for i, k in enumerate(exp.kinds) if k == "x"]
    fcols = [i for i, k in enumerate(exp.kinds) if k == "f"]

    def okey(r):
        return tuple(r[c] for c in ocols)

    def xkey(r):
        return tuple(r[c] for c in xcols)

    cand = list(ref[:n_want])
    if n_want and n_want < len(ref) and ocols:
        last = okey(ref[n_want - 1])
        cand += [r for r in ref[n_want:] if okey(r) == last]
    wrong = abs(len(got) - n_want)
    bad_width = [r for r in got if len(r) != len(exp.kinds)]
    if bad_width:
        return wrong + len(bad_width), float("inf")
    if ocols:
        # the ORDER BY columns in the reference's order, position by
        # position (ties give the same key sequence whichever rows tie)
        wrong += sum(1 for g, r in zip(got, ref) if okey(g) != okey(r))
    pool: dict = {}
    for r in cand:
        pool.setdefault(xkey(r), []).append(r)
    gap = 0.0
    for g in got:
        rows = pool.get(xkey(g))
        if not rows:
            wrong += 1
            continue
        r = rows.pop()
        for c in fcols:
            gap = max(gap, _gap(g[c], r[c]))
    return wrong, gap
