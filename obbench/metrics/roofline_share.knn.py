"""A search's share of the HBM roofline: the bytes of the whole table
(``roofline.knn_bytes``) over a search's mean device busy time, against
the H100's 3.35 TB/s, in %."""

from obbench import roofline


def read(run):
    return run.roofline_pct("knn.query", roofline.knn_bytes(
        run.facts["vector_rows"], run.facts["vector_dim"]))
