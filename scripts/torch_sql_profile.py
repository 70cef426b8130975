#!/usr/bin/env python3
"""Where the port's SQL path spends its time on the GPU, per TPC-H query.

    python3 scripts/torch_sql_profile.py            # all 22 queries
    python3 scripts/torch_sql_profile.py 9 18 21    # some of them
    python3 scripts/torch_sql_profile.py --px 8 9 18   # through PX, 8 shards

Loads TPC-H SF1 into the port's ``Catalog`` on the card and ANALYZEs it,
as ``chip_smoke.py`` does.  For each query it prints one JSON line: the
host's bind time (parse, bind and optimize, including the scalar
subqueries the binder folds by running them; median of 3), then
``Session.execute`` profiled under ``torch.profiler`` (3 runs after a
warm-up): wall ms per run, device-busy ms per run, the idle share and the
kernels that took the most device time.  With ``--px N`` the session
runs with ``px_dop = N`` over N shards on the card
(``px.exchange.set_mesh_size``), and each line says whether the query
ran distributed.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SF = 1.0
RUNS = 3


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sql_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    from torch_slice_profile import profile_calls

    from oceanbase_tpu_torch.bench.harness import card_line, tpch_session
    from oceanbase_tpu_torch.bench.tpch import gen_tpch
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.px.exchange import set_mesh_size
    from oceanbase_tpu_torch.sql.parser import parse_sql

    px = 0
    if argv[:1] == ["--px"]:
        px, argv = int(argv[1]), argv[2:]
    qnums = [int(a) for a in argv] or sorted(QUERIES)
    tables, types = gen_tpch(sf=SF)
    sess, _load_s, _analyze_s = tpch_session(tables, types)
    del tables
    if px:
        set_mesh_size(px)
        sess.variables["px_dop"] = px
    card = card_line()
    for q in qnums:
        sql = QUERIES[q]
        sess.execute(sql)
        binds = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess._plan_select(parse_sql(sql), None)
            torch.cuda.synchronize()
            binds.append((time.perf_counter() - t0) * 1e3)
        rec = {"query": q, "sf": SF, "card": card,
               "bind_ms": statistics.median(binds),
               **profile_calls(torch, lambda s=sql: sess.execute(s), RUNS),
               "retries": sess.last_retries, "px_dop": px,
               "distributed": bool(sess._last_px)}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
