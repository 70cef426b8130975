"""knn_p95_ms: the 95th percentile of the latency of every search in the
window, from the call to ``execute`` to the rows in hand (host clock)."""


def read(run):
    return run.percentile_ms(95)
