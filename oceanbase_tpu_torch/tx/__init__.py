"""Transaction plane of the port: MVCC transactions, GTS and two-phase
commit over the PALF WAL (port of ``oceanbase_tpu/tx``, host-side
numpy as in the reference).  Table locks wait for ROADMAP Queue 1
item 5b."""

from oceanbase_tpu_torch.tx.errors import TxAborted, WriteConflict

__all__ = ["WriteConflict", "TxAborted"]
