"""Host plane between node processes (port of ``oceanbase_tpu/net``):
the binary codec (``codec``), the rpc frame with its verb policies
(``rpc``), the fault plane (``faults``: seeded rpc drop/delay/reset
rules and the disk rules the durable writers consult), the failure
detector (``health``), the node server (``node``: one ``Database``
tenant per process over a networked PALF group, on its device) and the
wiped-replica rebuild (``rebuild``)."""

from oceanbase_tpu_torch.net.codec import decode_msg, encode_msg
from oceanbase_tpu_torch.net.faults import FaultDrop, FaultPlane, FaultReset
from oceanbase_tpu_torch.net.health import HealthMonitor
from oceanbase_tpu_torch.net.rpc import (
    DeadlineExceeded,
    ProtocolError,
    RpcClient,
    RpcError,
    RpcServer,
    VerbPolicy,
    verb_policy,
)

__all__ = ["encode_msg", "decode_msg", "RpcServer", "RpcClient",
           "RpcError", "ProtocolError", "DeadlineExceeded",
           "VerbPolicy", "verb_policy", "FaultPlane", "FaultDrop",
           "FaultReset", "HealthMonitor"]
