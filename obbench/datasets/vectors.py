"""Clustered integer vectors shaped like BIGANN's SIFT descriptors.

A torch copy of the port's ``chip_smoke.py::sift_like`` with its
constants: ``centres`` random centres with integer coordinates in
[0, 255], every vector a centre plus Gaussian noise of ``spread`` per
coordinate, rounded and clipped to [0, 255].  Made on the card from the
seed in a few large calls, then handed to the program as float32 (its
VECTOR type), through ``catalog.load_numpy`` as
``items(id int primary key, emb vector(d))``.  Every squared distance
between two such vectors is an integer below 2^24, so float32 holds it
exactly, and the exact top-k is the only right answer.
"""

from __future__ import annotations

import numpy as np

from obbench.reference import vectors as ref

TABLE = "items"
SQL = "select id, l2_distance(emb, '{}') as d from items order by d limit {}"


def _sift_like(torch, gen, n, d, centres, spread, device):
    out = torch.empty((n, d), dtype=torch.uint8, device=device)
    step = 1 << 21
    for lo in range(0, n, step):
        m = min(step, n - lo)
        idx = torch.randint(0, len(centres), (m,), generator=gen,
                            device=device)
        x = centres[idx]
        x += torch.randn((m, d), generator=gen, device=device) * spread
        out[lo:lo + m] = x.round_().clamp_(0, 255).to(torch.uint8)
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """-> {"base": uint8 [rows, dim], "queries": uint8 [queries, dim]},
    host numpy arrays made on ``device`` from ``seed``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = int(cfg["dim"])
    centres = torch.randint(0, 256, (int(cfg["centres"]), d), generator=gen,
                            device=device).to(torch.float32)
    spread = float(cfg["spread"])
    base = _sift_like(torch, gen, int(cfg["rows"]), d, centres, spread,
                      device)
    queries = _sift_like(torch, gen, int(cfg["queries"]), d, centres,
                         spread, device)
    return {"base": base.cpu().numpy(), "queries": queries.cpu().numpy()}


def load(sess, cfg: dict, data: dict) -> None:
    from oceanbase_tpu_torch.datatypes import SqlType

    base = data["base"]
    sess.catalog.load_numpy(
        TABLE, {"id": np.arange(len(base), dtype=np.int64),
                "emb": base.astype(np.float32)},
        primary_key=["id"], types={"emb": SqlType.vector(base.shape[1])})


def vector_text(v) -> str:
    return "[" + ",".join(str(int(x)) for x in v) + "]"


def statements(cfg: dict, traffic: dict, data: dict, rng) -> list:
    """One search per query vector, in a seeded order -> [(label, sql,
    key)], ``key`` the query's row in ``data["queries"]``."""
    q = data["queries"]
    k = int(cfg["k"])
    return [("knn.query", SQL.format(vector_text(q[i]), k), int(i))
            for i in rng.permutation(len(q))]


def facts(cfg: dict, data: dict) -> dict:
    return {"vector_rows": int(data["base"].shape[0]),
            "vector_dim": int(data["base"].shape[1])}


def judge(cfg: dict, data: dict, samples: list, device) -> dict:
    """Every sampled search against the exact top-k -> {"wrong_rows"}."""
    return ref.judge(data["base"], data["queries"], int(cfg["k"]), samples,
                     device)
