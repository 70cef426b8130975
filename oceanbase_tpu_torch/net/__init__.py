"""Host plane between nodes, as far as the port has it: the fault plane
(``faults.FaultPlane``: seeded rpc drop/delay/reset rules and the disk
rules — enospc, eio, partial writes, bitflip, truncate — that the
storage, WAL, temp-file and backup writers consult).  The rpc frame,
codec, health monitor, node server and rebuild client wait for ROADMAP
Queue 1 item 10."""

from oceanbase_tpu_torch.net.faults import FaultDrop, FaultPlane, FaultReset

__all__ = ["FaultPlane", "FaultDrop", "FaultReset"]
