"""The executor's host dispatch per statement: ``dispatch_s`` of the
statement's gv$sql_audit record (``exec/plan.py`` ``ExecTimes``), mean
over the traced window, in ms."""


def read(run):
    return run.mean_ms("dispatch_s")
