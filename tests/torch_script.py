"""Run one of the port's ``scripts/torch_*_bench.py`` on the CPU, for the
tests of ``bench/{overload,disk,recompile}.py`` and of the five
measurement-plane benches."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _top_files() -> list:
    """The repo's top-level files with their sizes and mtimes (where the
    reference scripts write their ``*_BENCH.json``)."""
    out = []
    for n in sorted(os.listdir(REPO)):
        path = os.path.join(REPO, n)
        if os.path.isfile(path):
            st = os.stat(path)
            out.append((n, st.st_size, st.st_mtime_ns))
    return out


def run_script(name: str, env: dict, args=()):
    """``scripts/<name> --device cpu [args]`` with ``env`` added, on two
    CPU threads as the tests run -> (its exit code, its one JSON line,
    the repo's top-level files before, after)."""
    before = _top_files()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", name), "--device",
         "cpu", *args], capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2", **env}, cwd=REPO)
    lines = [x for x in out.stdout.splitlines() if x.strip()]
    assert len(lines) == 1, out.stdout + out.stderr
    return out.returncode, json.loads(lines[0]), before, _top_files()
