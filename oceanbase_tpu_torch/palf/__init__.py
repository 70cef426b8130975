"""PALF — the replicated write-ahead log (port of ``oceanbase_tpu/palf``,
host control plane): a leader-based majority-ack log with term/lease
elections, group commit and on-disk log files with torn-tail recovery,
run as an in-process multi-replica cluster, or as one replica per node
process over the rpc frame (``netcluster.NetPalf``); the WAL writers
raise the disk manager's typed errors and consult the disk-fault
plane."""

from oceanbase_tpu_torch.palf.cluster import PalfCluster
from oceanbase_tpu_torch.palf.log import LogEntry, PalfReplica

__all__ = ["LogEntry", "PalfReplica", "PalfCluster"]
