"""The port's top-level entry points (``oceanbase_tpu_torch/graft_entry.py``)
against the reference's ``__graft_entry__.py``, on the CPU.

- ``entry()``: the port's forward of the Q1 plan over the SF0.001
  catalog equals the reference's forward column for column (ints
  exact, floats at 1e-9 relative), the same column names and rows;
- ``dryrun_multichip(4)``: the distributed step's group-by, join and
  psums held to numpy inside it, and the 22 TPC-H queries at SF0.002
  with ``px_dop = 4`` all distributed and equal to serial; the process
  mesh size is put back after it;
- ``python -m oceanbase_tpu_torch.graft_entry --device cpu`` prints the
  reference's verdict lines, and without a card asks for one.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

from oceanbase_tpu.vector import to_numpy as jto_numpy
from oceanbase_tpu_torch import graft_entry
from oceanbase_tpu_torch.px import exchange
from oceanbase_tpu_torch.vector import to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_forward_equals_the_reference():
    jfwd, (jtables,) = _reference().entry()
    want = jto_numpy(jfwd(jtables))
    fwd, (tables,) = graft_entry.entry("cpu")
    assert set(tables) == set(jtables) == {"lineitem"}
    assert all(r.device.type == "cpu" for r in tables.values())
    got = to_numpy(fwd(tables))
    assert list(got) == list(want)
    assert len(got["l_returnflag"]) == 4
    for name, col in want.items():
        if col.dtype.kind == "f":
            np.testing.assert_allclose(got[name], col, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(got[name], col)


def test_dryrun_multichip_distributes_all_22():
    lines = []
    rec = graft_entry.dryrun_multichip(4, "cpu", log=lines.append)
    assert rec["distributed"] == list(range(1, 23))
    assert rec["serial_fallback"] == []
    assert rec["step"] == {"rows": 512, "groups": 3, "join_rows": 512}
    assert lines[-1].startswith("dryrun_multichip(4): OK")
    assert sum("serial == px(4)" in ln for ln in lines) == 22
    assert exchange._MESH_SIZE is None


def test_module_runs_on_the_cpu_and_wants_a_card_by_default():
    env = {**os.environ, "N_DEVICES": "2", "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "oceanbase_tpu_torch.graft_entry", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "22/22 ran distributed" in out.stdout.splitlines()[-1]
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "oceanbase_tpu_torch.graft_entry"],
            capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
        assert out.returncode == 2 and "no CUDA device" in out.stderr
