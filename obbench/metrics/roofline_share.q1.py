"""Q1's share of the HBM roofline: the bytes Q1 has to read
(``roofline.q1_bytes``) over Q1's mean device busy time, against the
H100's 3.35 TB/s, in %."""

from obbench import roofline


def read(run):
    return run.roofline_pct("tpch.q1",
                            roofline.q1_bytes(run.facts["lineitem_rows"]))
