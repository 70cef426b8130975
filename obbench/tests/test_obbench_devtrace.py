"""The trace reduction on a hand-made timeline."""

from obbench import devtrace

MS = 1_000_000  # ns


def test_busy_union_statements_and_gaps():
    wall = 5_000 * MS            # the wall clock at the capture's start
    off = 7 * MS                 # the profiler's clock runs 7 ms ahead
    ev = [
        (wall + off, wall + off, "ob:clock", False),
        (wall + off + 0, wall + off + 100 * MS, "ob:q.a", False),
        (wall + off + 100 * MS, wall + off + 200 * MS, "ob:q.b", False),
        (wall + off + 10 * MS, wall + off + 30 * MS, "k1", True),
        (wall + off + 20 * MS, wall + off + 50 * MS, "k2", True),   # overlaps
        (wall + off + 150 * MS, wall + off + 160 * MS, "k1", True),
        (wall + off + 120 * MS, wall + off + 120 * MS, "ob:q.b", True),
    ]
    # statement a: compile 0-5 ms, execute 5-60 ms; statement b: none
    spans = [[("compile", (wall) / 1e9, 0.005),
              ("execute", (wall + 5 * MS) / 1e9, 0.055),
              ("statement", wall / 1e9, 0.09)], []]
    gcs = [(wall + 170 * MS, wall + 190 * MS, 2)]
    red = devtrace.reduce(ev, wall, spans, gcs)
    assert red.window_s == 0.2
    assert abs(red.busy_s - 0.05) < 1e-12
    assert [round(b, 9) for b in red.stmt_busy_s] == [0.04, 0.01]
    assert red.device_ops[0] == ["k1", 0.03] and red.device_ops[1][0] == "k2"
    labels = dict((lab, round(t, 6)) for lab, t in red.idle_gaps)
    # a gap is named at its middle: 0-10 ms (middle 5 ms, a's execute),
    # 50-150 ms (middle 100 ms, b, which has no spans), 160-200 ms (b,
    # under a generation-2 collection)
    assert labels == {"q.a/execute": 0.01, "q.b/rows": 0.1,
                      "q.b/rows:gc2": 0.04}
    assert [{k: round(v, 9) for k, v in d.items()}
            for d in red.stmt_idle_s] == [{"execute": 0.01}, {"rows": 0.14}]
