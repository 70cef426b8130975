"""setup_s: seconds from the process's start to the first timed
statement (data made and loaded, tables analyzed, statements warmed)."""


def read(run):
    return run.setup_s
