"""The session's envelope per statement: the device's idle time while
the host is inside ``Session.execute`` but outside its ``compile`` and
``execute`` spans (parse, admission, audit, trace, the result's
materialization) or in ``Result.rows()``, from the device trace, mean
over the traced window, in ms."""


def read(run):
    return run.mean_ms("envelope_s")
