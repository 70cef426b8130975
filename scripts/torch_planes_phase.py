#!/usr/bin/env python3
"""Phase "planes" of ``chip_smoke.py`` alone, on the GPU.

    python3 scripts/torch_planes_phase.py                  # SF1
    OB_SMOKE_SF=0.1 python3 scripts/torch_planes_phase.py

Runs ``chip_smoke.phase_planes`` (the overhead halves of the reference's
``scripts/{trace,metrics,profile,workload,planqual}_bench.py`` over
2,000,000 rows of the TPC-H slice, gv$time_model against the wall, the
restart and the feedback join) and the 22-query halves
(``chip_smoke._planes_tpch``: roofline, coverage, deep profile).  In the
whole run those use phase measure's database; here a ``Database`` of its
own holds TPC-H at ``OB_SMOKE_SF``, direct-loaded, ANALYZEd, with a
work area over lineitem's rows and one ``ALTER SYSTEM CALIBRATE``.  The
kernels' launch counts are set to 0 just before and printed after.
Prints the phase's lines, each part's seconds and the card's name and
power limit, and exits nonzero at the first broken non-timing gate or at
any launch of ``q6_filter_sum``.  Needs a CUDA device; imports nothing
of JAX.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_planes_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from oceanbase_tpu_torch.bench import planes
    from oceanbase_tpu_torch.bench.harness import card_line
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
    from oceanbase_tpu_torch.ops import _build
    from oceanbase_tpu_torch.server.database import Database

    card = card_line()
    dev = torch.device("cuda", 0)
    sf = float(os.environ.get("OB_SMOKE_SF", "1"))
    _build.reset_launch_counts()
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    chip_smoke.phase_planes(torch, dev, card)
    torch.cuda.synchronize()
    print(f"[time] phase planes (its own Database): "
          f"{time.perf_counter() - t0:.3f} s")
    root = tempfile.mkdtemp(prefix="ob_planes_tpch_")
    try:
        t0 = time.perf_counter()
        tables, types = gen_tpch(sf=sf)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db = Database(os.path.join(root, "db"), device=dev)
        db.config.set("sql_work_area_rows",
                      chip_smoke.MEASURE_WORK_AREA_ROWS)
        s = db.session()
        planes.load_tpch(s, tables, types, TPCH_PRIMARY_KEYS)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.execute("alter system calibrate")
        s.close()
        print(f"[planes] TPC-H sf={sf}: generated in {gen_s:.3f} s, "
              f"direct-loaded and ANALYZEd in {load_s:.3f} s, calibrated "
              f"in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        chip_smoke._planes_tpch(db, tables, card)
        torch.cuda.synchronize()
        print(f"[time] the 22-query halves: {time.perf_counter() - t0:.3f} s")
        db.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = _build.launch_counts()
    print(f"[planes] kernel launches: {counts}")
    print(f"[time] all: {time.perf_counter() - t_all:.3f} s")
    print(card, flush=True)
    return 1 if counts.get("q6_filter_sum", 0) else 0


if __name__ == "__main__":
    sys.exit(main())
