"""Transaction plane of the port: MVCC transactions, GTS and two-phase
commit over the PALF WAL, and table locks with deadlock detection
(port of ``oceanbase_tpu/tx``, host-side numpy as in the reference)."""

from oceanbase_tpu_torch.tx.errors import TxAborted, WriteConflict

__all__ = ["WriteConflict", "TxAborted"]
