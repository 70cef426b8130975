"""The device's idle share: 1 minus the union of kernel, copy and memset
intervals over the traced window, in %."""


def read(run):
    return run.idle_share_pct()
