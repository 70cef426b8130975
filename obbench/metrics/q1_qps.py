"""q1_qps: TPC-H Q1 statements completed in the window, over the window
(host clock; every statement and every second of the window)."""


def read(run):
    return run.rate()
