"""The program's ``compile`` span (parse, bind, plan; ``sql/session.py``)
per statement, mean over the traced window, in ms."""


def read(run):
    return run.mean_ms("compile_s")
