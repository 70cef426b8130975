#!/usr/bin/env python3
"""Where a top-10 vector query spends its host time on the GPU, per path.

    python3 scripts/torch_vector_profile.py

Loads phase "vector"'s table of ``chip_smoke.py`` (1,000,000 x 128
synthetic SIFT1M-shaped vectors from the same seed) into a catalog-only
``Session`` on the card, then for each access path (no index, an exact
vector index, an approximate one) times 30 ``ORDER BY l2_distance(...)
LIMIT 10`` queries (wall ms per query, CUDA-synchronized), runs the same
30 again under ``cProfile`` and prints the host functions with the most
self time (a blocking device read shows as the time of the call that
waits).  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import cProfile
import pstats
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
QUERIES = 30
TOP = 14
DEVICE = "cuda"


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_vector_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.datatypes import SqlType
    from oceanbase_tpu_torch.sql import Session

    card = card_line()
    rng = np.random.default_rng(cs.VECTOR_SEED)
    centres = rng.integers(0, 256, (cs.VECTOR_CENTRES, cs.VECTOR_DIM)).astype(
        np.float32)
    base = cs.sift_like(rng, cs.VECTOR_ROWS, cs.VECTOR_DIM, centres)
    queries = cs.sift_like(rng, 2 * QUERIES + 1, cs.VECTOR_DIM, centres)
    s = Session(device=DEVICE)
    s.catalog.load_numpy(
        "items", {"id": np.arange(cs.VECTOR_ROWS), "emb": base},
        primary_key=["id"], types={"emb": SqlType.vector(cs.VECTOR_DIM)})
    sql = ("select id, l2_distance(emb, '{}') as d from items "
           "order by d limit 10")

    def run(texts):
        out = []
        for t in texts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.execute(t).rows()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for tag, ddl, path in (
            ("no index", None, None),
            ("exact index", "create vector index iv on items (emb) "
             "with (metric = 'l2')", "exact"),
            ("ivf index", "create vector index ia on items (emb) "
             "with (metric = 'l2', approximate = true)", "ivf")):
        if path == "ivf":
            s.execute("drop index iv on items")
        if ddl is not None:
            s.execute(ddl)
        run([sql.format(cs._vtext(queries[-1]))])      # warm-up, builds
        if s.last_ann_path != path:
            raise AssertionError(f"{tag}: path {s.last_ann_path}")
        texts = [sql.format(cs._vtext(q)) for q in queries[:QUERIES]]
        ms = run(texts)
        prof = cProfile.Profile()
        texts = [sql.format(cs._vtext(q))
                 for q in queries[QUERIES:2 * QUERIES]]
        prof.enable()
        prof_ms = run(texts)
        prof.disable()
        print(f"[vector-profile] {tag}: {QUERIES} queries, median "
              f"{statistics.median(ms):.3f} ms (under cProfile "
              f"{statistics.median(prof_ms):.3f} ms); {card}")
        st = pstats.Stats(prof)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:TOP]
        for (fn, line, name), (_cc, nc, tt, ct, _callers) in rows:
            where = f"{Path(fn).name}:{line}" if line else fn
            print(f"[vector-profile]   {tag}: self {tt / QUERIES * 1e3:.3f} "
                  f"ms/query, cumulative {ct / QUERIES * 1e3:.3f} ms/query, "
                  f"{nc / QUERIES:.1f} calls/query  {where}({name})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
