"""Transaction error types (≙ OB_TRY_LOCK_ROW_CONFLICT / OB_TRANS_*).

A copy of ``oceanbase_tpu/tx/errors.py``."""


class WriteConflict(RuntimeError):
    """Row is write-locked by another live transaction."""


class TxAborted(RuntimeError):
    """Transaction was aborted (conflict, deadlock, or explicit rollback)."""


class DuplicateKey(WriteConflict):
    """INSERT over an existing visible primary key."""
