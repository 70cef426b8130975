"""The one traffic generator: a closed loop of one client.

A traffic mix is a data file, ``obbench/traffic/<name>.json``, read
here.  Its keys:

- the statements: whatever the configuration's dataset module reads from
  the mix (``queries`` for TPC-H; the searches take every query vector,
  in an order drawn from the seed), turned into a list of statements by
  that module; the client cycles through the list, and sends the next
  statement when the last one's rows are back;
- ``close``: ``statement`` (the window closes with the first statement
  that ends past ``--seconds``) or ``pass`` (with the first pass through
  the whole list that ends past it, so every pass in the window is
  whole);
- ``warm``: ``each`` (every distinct statement once before the window),
  or a number n (the last n statements of the list, which a window of
  the cell's length does not reach);
- ``check_share``: the share of the window's statements whose rows are
  kept and judged after the window, drawn from the seed; the first
  execution of each statement in the window is always kept.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("close", "statement") not in ("statement", "pass"):
        raise ValueError(f"traffic {name}: close is statement or pass")
    return mix


class Schedule:
    def __init__(self, dataset, cfg: dict, mix: dict, data: dict,
                 seed: int):
        rng = np.random.default_rng(seed)
        self.stmts = dataset.statements(cfg, mix, data, rng)
        if not self.stmts:
            raise ValueError("the traffic mix gives no statement")
        self.by_pass = mix.get("close", "statement") == "pass"
        warm = mix.get("warm", "each")
        if warm == "each":
            seen: dict = {}
            for s in self.stmts:
                seen.setdefault(s[1], s)
            self.warm = list(seen.values())
        else:
            self.warm = self.stmts[-int(warm):]
        self.share = float(mix.get("check_share", 1.0))
        self._keep_rng = np.random.default_rng([seed, 1])
        self._seen: set = set()

    def __getitem__(self, i: int):
        return self.stmts[i % len(self.stmts)]

    def closes_after(self, i: int) -> bool:
        """May the window close after statement i (0-based)?"""
        return not self.by_pass or (i + 1) % len(self.stmts) == 0

    def keep(self, i: int) -> bool:
        """Are statement i's rows kept for the check?"""
        first = self[i][1] not in self._seen
        self._seen.add(self[i][1])
        draw = self._keep_rng.random() < self.share
        return first or draw
