"""tpch_qps: analytic statements completed in the window, over the
window (host clock; every statement and every second of the window)."""


def read(run):
    return run.rate()
