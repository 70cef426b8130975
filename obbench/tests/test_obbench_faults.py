"""A run with the timed path broken under it comes out not correct.

Each fault is planted in the program's result boundary,
``Result.rows()``, at a tiny size on the CPU; the rest of the run (the
data, the load, the window, the reference and the comparison) is the
harness's own, with only its look for a card skipped.
"""

import pytest

from obbench import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _alter(rows):
    """One value of the first row changed where it is produced."""
    if not rows:
        return [("?",)]
    first = list(rows[0])
    for j, v in enumerate(first):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            first[j] = v + 1
            break
        if isinstance(v, str):
            first[j] = v + "x"
            break
    return [tuple(first)] + rows[1:]


def _half(rows):
    """Half of the answer left out."""
    return rows[: len(rows) // 2]


class _Stale:
    """Each statement answered with the rows of the one before it."""

    def __init__(self):
        self.last = None

    def __call__(self, rows):
        prev, self.last = self.last, rows
        return prev if prev is not None else rows


FAULTS = {"altered": lambda: _alter, "half": lambda: _half,
          "stale": _Stale}


def _run(tiny, cell, monkeypatch, fault=None):
    from oceanbase_tpu_torch.sql import session

    if fault is not None:
        orig = session.Result.rows
        broken = FAULTS[fault]()
        monkeypatch.setattr(session.Result, "rows",
                            lambda self: broken(orig(self)))
    return tiny.run_cell(SPEC, tiny.find_cell(SPEC, cell), 2**32 + 11,
                         0.3, False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell, monkeypatch):
    assert _run(tiny, cell, monkeypatch)["correct"] is True


# a cell that repeats one statement has the same right answer each time,
# so an answer one statement late is no fault there
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if not (f == "stale" and c == "tpch_sf1.q1")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(tiny, cell, fault, monkeypatch):
    out = _run(tiny, cell, monkeypatch, fault)
    assert out["correct"] is False
    assert out["checks"]["wrong_rows"]["value"] > 0
