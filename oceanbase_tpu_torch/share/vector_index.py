"""Vector indexes: exact and IVF-Flat nearest-neighbour search on torch.

Port of ``oceanbase_tpu/share/vector_index.py``.  The search is matrix
products and top-k, so it is plain torch ops on the vectors' device:

- exact search = one [q,d]x[d,n] product + top-k
- IVF-Flat     = k-means partition; search = centroid product ->
                 top-nprobe clusters -> gather padded buckets ->
                 candidate product -> top-k

Metrics: l2 | ip | cosine (cosine normalizes at build and search).
Scores are "higher = closer"; ``exact_search`` and ``IvfFlatIndex.search``
return (scores [q,k], indices [q,k]) in descending score order, a tie
broken by the lower index (``jax.lax.top_k``'s order).  Products run in
full float32: the l2 expansion below ranks wrongly under TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from oceanbase_tpu_torch import default_device


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _scores(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """Higher = closer.  l2 uses the -||q-v||^2 expansion so the inner
    loop is still a matrix product."""
    if metric == "l2":
        qn = (q * q).sum(dim=-1, keepdim=True)
        vn = (v * v).sum(dim=-1)
        return 2.0 * (q @ v.T) - qn - vn[None, :]
    return q @ v.T  # ip / cosine (pre-normalized)


def _top_k(s: torch.Tensor, k: int):
    """Top-k of float32 scores along the last axis in descending order,
    as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order
    among ties): IEEE total order (+NaN first, -0 below +0, -NaN last),
    a tie to the lower index.  One ``torch.topk`` over int64 keys that
    order by the score's bits, then by the lower index."""
    bits = s.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = s.shape[-1]
    lower = n - 1 - torch.arange(n, device=s.device)
    idx = torch.topk(ordered * (1 << 32) + lower, k, dim=-1).indices
    return torch.gather(s, -1, idx), idx


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    # obcheck: ok(trace.host-sync) query vectors arrive from the host
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


def exact_search(queries, vectors, k: int, metric: str = "l2",
                 device=None):
    """-> (scores [q,k], indices [q,k]) exact top-k.  ``vectors`` (a
    tensor keeps its device) or ``device`` picks where it runs."""
    dev = (vectors.device if isinstance(vectors, torch.Tensor)
           else default_device(device))
    q, v = _as_tensor(queries, dev), _as_tensor(vectors, dev)
    if metric == "cosine":
        q, v = _normalize(q), _normalize(v)
    return _top_k(_scores(q, v, metric), min(k, v.shape[0]))


def _kmeans(vectors: torch.Tensor, init_idx, n_clusters: int,
            iters: int = 10):
    """``iters`` steps of assign (argmax of the l2 score, the first
    maximum on a tie as ``jnp.argmax``) and update (the one-hot product
    of the JAX package; an empty cluster keeps its centroid) ->
    (centroids [c,d], assignment [n])."""
    # obcheck: ok(trace.host-sync) the seeded centres, once per build
    init = torch.as_tensor(np.asarray(init_idx), dtype=torch.int64,
                           device=vectors.device)
    cent = vectors[init]
    for _ in range(iters):
        assign = torch.argmax(_scores(vectors, cent, "l2"), dim=1)
        one = torch.zeros((vectors.shape[0], n_clusters),
                          dtype=vectors.dtype, device=vectors.device)
        one.scatter_(1, assign[:, None], 1.0)
        sums = one.T @ vectors
        counts = one.sum(dim=0)[:, None]
        cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                           cent)
        del one, sums
    return cent, torch.argmax(_scores(vectors, cent, "l2"), dim=1)


class IvfFlatIndex:
    """IVF-Flat over device-resident vectors.

    Buckets are padded to a uniform capacity so search is static-shaped:
    [nprobe] cluster ids -> gather [q, nprobe*cap] candidates -> product
    -> top-k.  Padding slots score -inf and report index -1.
    """

    def __init__(self, vectors, n_clusters: int | None = None,
                 metric: str = "l2", kmeans_iters: int = 10, seed: int = 0,
                 device=None):
        self.metric = metric
        dev = (vectors.device if isinstance(vectors, torch.Tensor)
               else default_device(device))
        v = _as_tensor(vectors, dev)
        if metric == "cosine":
            v = _normalize(v)
        n, d = v.shape
        c = n_clusters or max(1, int(np.sqrt(n)))
        rng = np.random.default_rng(seed)
        init = rng.choice(n, size=c, replace=n < c)
        cent, assign = _kmeans(v, init, c, kmeans_iters)
        # obcheck: ok(trace.host-sync) an IVF build buckets on the host
        assign_np = assign.cpu().numpy()
        order = np.argsort(assign_np, kind="stable")
        counts = np.bincount(assign_np, minlength=c)
        cap = max(int(counts.max()), 1)
        # padded bucket matrix [c, cap] of row indices (-1 = empty)
        buckets = np.full((c, cap), -1, dtype=np.int64)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(n) - np.repeat(start, counts)
        buckets[assign_np[order], slot] = order
        self.vectors = v
        self.centroids = cent
        self.buckets = torch.from_numpy(buckets).to(dev)
        self.n, self.dim, self.n_clusters, self.cap = n, d, c, cap

    def search(self, queries, k: int, nprobe: int = 8):
        """-> (scores [q,k], indices [q,k]); approximate (IVF recall)."""
        q = _as_tensor(queries, self.vectors.device)
        if self.metric == "cosine":
            q = _normalize(q)
        nprobe = min(nprobe, self.n_clusters)
        return _ivf_search(q, self.vectors, self.centroids, self.buckets,
                           k, nprobe, self.metric)


def _ivf_search(q, vectors, centroids, buckets, k, nprobe, metric):
    _, probe = _top_k(_scores(q, centroids, metric), nprobe)  # [nq, nprobe]
    cand = buckets[probe].reshape(q.shape[0], -1)           # [nq, nprobe*cap]
    cand_clipped = torch.clamp(cand, min=0)
    cv = vectors[cand_clipped]                              # [nq, m, d]
    if metric == "l2":
        qn = (q * q).sum(dim=-1, keepdim=True)
        vn = (cv * cv).sum(dim=-1)
        s = 2.0 * torch.einsum("qd,qmd->qm", q, cv) - qn - vn
    else:
        s = torch.einsum("qd,qmd->qm", q, cv)
    s = torch.where(cand < 0, float("-inf"), s)             # padding loses
    top_s, top_i = _top_k(s, min(k, s.shape[1]))
    idx = torch.gather(cand_clipped, 1, top_i)
    # fewer than k real candidates in the probed buckets: report -1, not
    # an arbitrary clipped vector id
    idx = torch.where(torch.isneginf(top_s), -1, idx)
    return top_s, idx


__all__ = ["IvfFlatIndex", "exact_search"]
