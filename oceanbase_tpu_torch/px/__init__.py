"""PX — intra-query parallel execution over a shard mesh.

Port of ``oceanbase_tpu/px`` (≙ the PX framework, src/sql/engine/px —
ObPxCoordOp ob_px_coord_op.h:25, DFOs ob_dfo.h:475).  The reference
lowers a plan to one ``shard_map`` program over a device mesh; the port
drives P shards in lockstep from one controller:

- a DFO (plan fragment x dop workers)  -> the plan lowered over a list of
  P per-shard relations (``px/planner.py``)
- HASH / PKEY repartition              -> bucket-sort + all_to_all
- BROADCAST                            -> all_gather
- datahub (barrier/rollup/range)       -> a sum / concatenation on the
  device
- flow control                         -> static per-destination budgets
  chosen by the planner; overflow is counted and re-planned

``set_mesh_size(n)`` puts n shards on the visible devices (round-robin),
as the reference's tests force n host devices.  The network exchange
between node processes is ``px/dtl.py``: plan pushdown of a partial plan
to each replica over the rpc frame, merged on the coordinator.
"""

from oceanbase_tpu_torch.px.exchange import (
    Mesh,
    all_to_all_repartition,
    broadcast_gather,
    default_mesh,
    set_mesh_size,
    shard_relation,
    unshard_relation,
)

__all__ = [
    "Mesh", "default_mesh", "set_mesh_size", "shard_relation",
    "unshard_relation", "all_to_all_repartition", "broadcast_gather",
]
