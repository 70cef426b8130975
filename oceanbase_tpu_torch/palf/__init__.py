"""PALF — the replicated write-ahead log (port of ``oceanbase_tpu/palf``,
host control plane): a leader-based majority-ack log with term/lease
elections, group commit and on-disk log files with torn-tail recovery,
run as an in-process multi-replica cluster.  The multi-node
``netcluster`` waits for ROADMAP Queue 1 item 5b."""

from oceanbase_tpu_torch.palf.cluster import PalfCluster
from oceanbase_tpu_torch.palf.log import LogEntry, PalfReplica

__all__ = ["LogEntry", "PalfReplica", "PalfCluster"]
