"""The port's top-level entry points, twins of ``__graft_entry__.py``.

- ``entry(device)`` -> ``(forward, (tables,))``: the single-card forward
  step, the port's TPC-H Q1 plan (``bench/queries.py``: scan -> filter ->
  group-by -> sort) lowered over an SF0.001 catalog's lineitem on the
  card (``__graft_entry__.py:28-54``).
- ``dryrun_multichip(n, device)``: the distributed query step over ``n``
  shards of one card (``px/exchange.py``, ``px/dist_ops.py``): a
  filtered group-by through the HASH all_to_all, a HASH-HASH join and
  datahub psums on tiny shapes, held to numpy (:57-137); then the 22
  TPC-H queries at SF0.002 with ``px_dop = 0`` against ``px_dop = n``,
  equal and all 22 distributed (:139-190).  Raises AssertionError where
  the reference asserts; -> a record of what ran.

    python -m oceanbase_tpu_torch.graft_entry            # N_DEVICES=8, on the card
    N_DEVICES=4 python -m oceanbase_tpu_torch.graft_entry --device cpu

Runs on the card unless the caller asks for the CPU; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

#: the catalogs of the two steps (``__graft_entry__.py:28``, :146)
ENTRY_SF = 0.001
DRYRUN_SF = 0.002
#: rows per shard of the tiny step, and its part table (:91-101)
STEP_ROWS_PER_SHARD = 128
STEP_PARTS = 32
#: float agreement of a distributed answer with the serial one (:155-166)
RTOL = 1e-9


def _tiny_catalog(sf: float = ENTRY_SF, device=None):
    from oceanbase_tpu_torch.bench.tpch import TPCH_PRIMARY_KEYS, gen_tpch
    from oceanbase_tpu_torch.catalog import Catalog

    tables, types = gen_tpch(sf=sf)
    cat = Catalog(device=device)
    for name, arrays in tables.items():
        cat.load_numpy(name, arrays,
                       types={k: v for k, v in types.items() if k in arrays},
                       primary_key=TPCH_PRIMARY_KEYS[name])
    return cat


def entry(device=None):
    """-> ``(forward, (tables,))``: ``forward(tables)`` lowers the Q1
    plan over ``tables`` (the Relations it scans) to its result
    Relation."""
    from oceanbase_tpu_torch.bench.queries import q1_plan
    from oceanbase_tpu_torch.exec.plan import _lower, referenced_tables

    cat = _tiny_catalog(device=device)
    plan = q1_plan()
    tables = {t: cat.table_data(t) for t in referenced_tables(plan)}

    def forward(tables):
        return _lower(plan, tables)

    return forward, (tables,)


def _step(n: int, mesh, dev) -> dict:
    """The Q1-shaped distributed step (:87-137): sharded scan -> filter
    -> partial agg -> HASH all_to_all -> final agg; a HASH-HASH PK-FK
    join; datahub psums; each held to numpy."""
    from oceanbase_tpu_torch.exec.ops import AggSpec
    from oceanbase_tpu_torch.expr import ir
    from oceanbase_tpu_torch.px.dist_ops import (dist_groupby_shard,
                                                 dist_join_shard)
    from oceanbase_tpu_torch.px.exchange import (datahub_psum,
                                                 shard_relation,
                                                 unshard_relation)
    from oceanbase_tpu_torch.vector import from_numpy, to_numpy

    rng = np.random.default_rng(0)
    rows = STEP_ROWS_PER_SHARD * n
    cols = {"flag": rng.integers(0, 3, rows),
            "qty": rng.integers(1, 50, rows),
            "price": rng.integers(100, 10000, rows),
            "pk_ref": rng.integers(0, STEP_PARTS, rows)}
    li = from_numpy(cols, device=dev)
    pt = from_numpy({"pk": np.arange(STEP_PARTS),
                     "ptype": rng.integers(0, 5, STEP_PARTS)}, device=dev)
    li_s, pt_s = shard_relation(li, mesh), shard_relation(pt, mesh)
    filtered = [r.with_mask((r.columns["qty"].data < 40) & r.mask_or_true())
                for r in li_s]
    grouped, g_ovf = dist_groupby_shard(
        filtered, {"flag": ir.col("flag")},
        [AggSpec("s", "sum", ir.col("price")), AggSpec("c", "count_star"),
         AggSpec("a", "avg", ir.col("qty"))],
        mesh, local_cap=32, out_cap=32)
    joined, j_ovf = dist_join_shard(
        li_s, pt_s, [ir.col("pk_ref")], [ir.col("pk")], mesh,
        cap_per_dest=rows, out_capacity=2 * rows)
    total = int(datahub_psum([r.count() for r in joined]))
    # the step's end (the reference's block_until_ready): the asserts
    # obcheck: ok(trace.host-sync) read the psums
    overflow = int(datahub_psum(list(g_ovf) + list(j_ovf)))
    assert overflow == 0, f"exchange overflow: {overflow} rows"
    res = to_numpy(unshard_relation(grouped))
    sel = cols["qty"] < 40
    keys = np.unique(cols["flag"][sel])
    assert len(res["flag"]) == len(keys), (res, keys)
    order = np.argsort(res["flag"])
    np.testing.assert_array_equal(
        res["s"][order], [cols["price"][sel & (cols["flag"] == k)].sum()
                          for k in keys])
    assert total == rows  # every row matches exactly one pk
    return {"rows": rows, "groups": len(keys), "join_rows": total}


def _rows_equal(a, b) -> bool:
    """Row lists equal as multisets, floats at ``RTOL`` (:151-166)."""
    def key(r):
        return tuple((x is None, round(x, 4) if isinstance(x, float) else x)
                     for x in r)

    if len(a) != len(b):
        return False
    for ra, rb in zip(sorted(a, key=key), sorted(b, key=key)):
        for xa, xb in zip(ra, rb):
            if isinstance(xa, float) or isinstance(xb, float):
                fa, fb = float(xa), float(xb)
                if abs(fa - fb) > RTOL * max(1.0, abs(fa), abs(fb)):
                    return False
            elif xa != xb:
                return False
    return True


def dryrun_multichip(n_devices: int, device=None, log=print) -> dict:
    """The distributed step and the 22 queries over ``n_devices`` shards
    of one card (of the CPU with ``device="cpu"``) -> {"step": ...,
    "distributed": [...], "serial_fallback": [...]}."""
    from oceanbase_tpu_torch import default_device
    from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
    from oceanbase_tpu_torch.px import exchange
    from oceanbase_tpu_torch.sql import Session

    dev = default_device(device)
    saved = exchange._MESH_SIZE
    exchange.set_mesh_size(n_devices)
    try:
        mesh = exchange.default_mesh(n_devices, dev)
        step = _step(n_devices, mesh, dev)
        log(f"dryrun_multichip({n_devices}): distributed groupby/join/psum "
            f"OK on {dev}")
        sess = Session(_tiny_catalog(DRYRUN_SF, dev))
        px_qs, serial_qs = [], []
        for qnum in sorted(QUERIES):
            sess.variables["px_dop"] = 0
            serial = sess.execute(QUERIES[qnum]).rows()
            sess.variables["px_dop"] = n_devices
            dist = sess.execute(QUERIES[qnum]).rows()
            assert _rows_equal(serial, dist), f"Q{qnum} mismatch"
            used = bool(getattr(sess, "_last_px", False))
            (px_qs if used else serial_qs).append(qnum)
            log(f"  TPC-H Q{qnum:02d}: serial == px({n_devices}) "
                f"({len(dist)} rows) "
                f"[{'DISTRIBUTED' if used else 'serial fallback'}]")
        sess.variables["px_dop"] = 0
    finally:
        exchange.set_mesh_size(saved)
    log(f"dryrun_multichip({n_devices}): OK — all 22 TPC-H queries "
        f"verified on {n_devices} shards of {dev}; {len(px_qs)}/22 ran "
        f"distributed {px_qs}, serial fallback {serial_qs}")
    assert len(px_qs) == len(QUERIES), \
        f"PX coverage regressed: only {len(px_qs)}/22 distribute"
    return {"step": step, "distributed": px_qs,
            "serial_fallback": serial_qs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("graft_entry: no CUDA device", file=sys.stderr)
            return 2
    dryrun_multichip(int(os.environ.get("N_DEVICES", "8")), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
