"""The plain reference of exact top-k search under the L2 distance.

Plain torch over the benchmark's own uint8 vectors: it imports nothing
of the program and reads nothing the program made.  Squared distances
are integers below 2^24; the reference forms them in float64, in blocks
of rows (``|x|^2 + |q|^2 - 2 x.q``, exact for integers this small), and
a returned row's own distance in int64.  ``l2_distance`` is the square
root of the squared distance, which the program returns as a double.

``control_rows`` is the control: the same search with the distances
computed in bfloat16, the precision below the float32 the configuration
states, which the comparison has to refuse.
"""

from __future__ import annotations

import numpy as np

BLOCK_ROWS = 1 << 20
QUERY_CHUNK = 512


def _exact_kth(base, queries, k, device):
    """The k smallest squared distances of each query, ascending, as
    float64 [len(queries), k]."""
    import torch

    out = []
    for q0 in range(0, len(queries), QUERY_CHUNK):
        q = torch.from_numpy(np.ascontiguousarray(
            queries[q0:q0 + QUERY_CHUNK])).to(device, torch.float64)
        qn = (q * q).sum(1)
        best = None
        for lo in range(0, len(base), BLOCK_ROWS):
            x = torch.from_numpy(base[lo:lo + BLOCK_ROWS]).to(
                device).to(torch.float64)
            d2 = (x * x).sum(1)[:, None] + qn[None, :] - 2.0 * (x @ q.T)
            part = torch.topk(d2, min(k, len(x)), dim=0,
                              largest=False).values
            best = part if best is None else torch.topk(
                torch.cat([best, part]), k, dim=0, largest=False).values
            del x, d2
        out.append(best.T.sort(dim=1).values.cpu().numpy())
    return np.concatenate(out)


def own_sq_dist(base, ids, qvec) -> np.ndarray:
    """Exact squared distances of rows ``ids`` to one query (int64)."""
    diff = base[ids].astype(np.int64) - qvec.astype(np.int64)[None, :]
    return (diff * diff).sum(1)


def wrong_rows(rows, base, qvec, want_d2, k) -> int:
    """Rows of one answer that are wrong: a missing row, an id out of
    range or repeated, a distance that is not the id's own, or a
    distance list that is not the k smallest, ascending.  A returned
    distance d stands for the integer squared distance rint(d * d): the
    square root's last bit is the program's to round, the integer it
    stands for is exact."""
    wrong = abs(len(rows) - k)
    rows = rows[:k]
    ids = np.array([r[0] for r in rows], dtype=np.int64)
    got = np.array([r[1] for r in rows], dtype=np.float64)
    got_d2 = np.rint(got * got)
    ok = (ids >= 0) & (ids < len(base))
    first = np.zeros(len(ids), dtype=bool)
    first[np.unique(ids, return_index=True)[1]] = True
    own = np.full(len(ids), -1.0)
    own[ok] = own_sq_dist(base, ids[ok], qvec)
    bad = (~ok | ~first | (own != got_d2)
           | (got_d2 != want_d2[:len(rows)])
           | (np.abs(got - np.sqrt(got_d2)) > 1e-9 * np.maximum(got, 1.0)))
    return wrong + int(bad.sum())


def judge(base, queries, k, samples, device) -> dict:
    """samples: [(query row, rows returned)] -> {"wrong_rows": n}."""
    if not samples:
        return {"wrong_rows": 0}
    keys = np.array([key for key, _rows in samples], dtype=np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    kth = _exact_kth(base, queries[uniq], k, device)
    wrong = 0
    for (key, rows), j in zip(samples, inv.reshape(-1)):
        wrong += wrong_rows(rows, base, queries[key], kth[j], k)
    return {"wrong_rows": wrong}


def control_rows(base, queries, k, keys, device) -> list:
    """The reference's search in bfloat16, one query at a time -> the
    rows it would return: [(id, distance)] per key."""
    import torch

    out = []
    for key in keys:
        q = torch.from_numpy(queries[key]).to(device, torch.bfloat16)
        parts_d, parts_i = [], []
        for lo in range(0, len(base), BLOCK_ROWS):
            x = torch.from_numpy(base[lo:lo + BLOCK_ROWS]).to(device).to(
                torch.bfloat16)
            d2 = ((x - q) ** 2).sum(1)
            v, i = torch.topk(d2.float(), min(k, len(x)), largest=False)
            parts_d.append(v)
            parts_i.append(i + lo)
        v, j = torch.topk(torch.cat(parts_d), k, largest=False)
        ids = torch.cat(parts_i)[j]
        out.append([(int(a), float(np.sqrt(float(b))))
                    for a, b in zip(ids.tolist(), v.tolist())])
    return out
