"""knn_qps: top-k searches completed in the window, over the window
(host clock)."""


def read(run):
    return run.rate()
