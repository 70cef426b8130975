"""Device busy time per statement: the union of kernel, copy and memset
intervals from the statement's start to the next one's, mean over the
traced window, in ms."""


def read(run):
    return run.mean_ms("busy_s")
