#!/usr/bin/env python3
"""The 22 TPC-H queries with and without secondary indexes, interleaved.

    python3 scripts/torch_index_ab.py

Loads TPC-H SF1 into the port's ``Catalog`` on the card and ANALYZEs it,
as ``chip_smoke.py`` does, then alternates two configurations of the same
catalog: A without secondary indexes, B with an index on every ``*key``
column (the JAX package's SF1 parity configuration,
``scripts/sf_parity.py``).  Ten pairs run A then B or B then A, in turns.
In each pass every query runs once untimed (which also rebuilds the
sidecars DROP INDEX discarded), then three times timed, host clock
around ``Session.execute`` with CUDA synchronized; the pass keeps the
median.  Prints one JSON line per pass and a summary line: per query and
for the sum of the 22, the median and quartiles over passes of each
configuration and the number of pairs B won.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SF = 1.0
PAIRS = 10
RUNS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_index_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from oceanbase_tpu_torch.bench.harness import (
        card_line, key_indexes, timed_statement, tpch_session,
    )
    from oceanbase_tpu_torch.bench.tpch import gen_tpch
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES

    tables, types = gen_tpch(sf=SF)
    sess, _load_s, _analyze_s = tpch_session(tables, types)
    indexes = key_indexes(tables)
    del tables
    card = card_line()

    def configure(indexed: bool):
        for ix, table, col in indexes:
            sess.execute(
                f"create index if not exists {ix} on {table} ({col})"
                if indexed else f"drop index if exists {ix} on {table}")

    def one_pass() -> dict:
        return {q: timed_statement(sess, sql, RUNS)[1]
                for q, sql in sorted(QUERIES.items())}

    passes = {"A": [], "B": []}
    for pair in range(PAIRS):
        order = "AB" if pair % 2 == 0 else "BA"
        for config in order:
            configure(config == "B")
            ms = one_pass()
            passes[config].append(ms)
            print(json.dumps({"pair": pair, "config": config,
                              "sum_ms": sum(ms.values()),
                              "ms": {str(q): round(v, 3)
                                     for q, v in ms.items()}}), flush=True)

    def summary(key):
        a = [p[key] if key else sum(p.values()) for p in passes["A"]]
        b = [p[key] if key else sum(p.values()) for p in passes["B"]]
        return {"A_ms": statistics.median(a), "B_ms": statistics.median(b),
                "A_quartiles_ms": statistics.quantiles(a, n=4),
                "B_quartiles_ms": statistics.quantiles(b, n=4),
                "B_wins": sum(y < x for x, y in zip(a, b))}

    print(json.dumps({"card": card, "sf": SF, "pairs": PAIRS,
                      "sum": summary(None),
                      "per_query": {str(q): summary(q)
                                    for q in sorted(QUERIES)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
