"""The port's ``share/vector_index.py`` against the JAX package's on the
CPU, on the same seeded inputs: exact search under every metric, k-means
from the same initial rows, IVF-Flat buckets and search (the -1 padding
included), small inputs, and IVF recall on the reference's clustered
case.  Ids and bucket matrices are compared exactly; float32 centroids
at 1e-5 relative, and float32 scores at 1e-5 relative to the size of
their terms (the l2 expansion's score is a small difference of large
terms).  Every input has distinct scores, so the
two packages' tie orders never decide an id."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.share import vector_index as jvi
from oceanbase_tpu_torch.share import vector_index as tvi

torch.set_num_threads(2)

RTOL = 1e-5


def _close(t, j, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=atol)


def _scale(queries, vecs) -> float:
    """The size of the l2 expansion's terms (|q|^2 + |v|^2): its float32
    score carries an error relative to them, not to the small
    difference it returns."""
    return float((queries ** 2).sum(-1).max() + (vecs ** 2).sum(-1).max())


def _clustered(rng, n_clusters=20, per=200, d=32, n_queries=5):
    """The reference's clustered case (tests/test_vector_index.py)."""
    centers = rng.normal(size=(n_clusters, d)) * 10
    vecs = np.concatenate([c + rng.normal(size=(per, d))
                           for c in centers]).astype(np.float32)
    queries = (centers[:n_queries] + rng.normal(size=(n_queries, d)) * 0.5
               ).astype(np.float32)
    return vecs, queries


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,d,k", [(2000, 64, 5), (500, 32, 3),
                                   (7, 3, 7)])
def test_exact_search_matches_jax(metric, n, d, k):
    rng = np.random.default_rng(n + d)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(4, d)).astype(np.float32)
    js, ji = jvi.exact_search(qs, vecs, k, metric=metric)
    ts, ti = tvi.exact_search(qs, vecs, k, metric=metric, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts, js, atol=RTOL * _scale(qs, vecs))


def test_exact_search_keeps_a_device_tensor():
    rng = np.random.default_rng(3)
    vecs = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    s, i = tvi.exact_search(vecs[:2].numpy(), vecs, 1)
    assert i.device == vecs.device and i[:, 0].tolist() == [0, 1]


@pytest.mark.parametrize("seed,n,c", [(0, 2000, 20), (1, 4000, 63),
                                      (2, 300, 7)])
def test_kmeans_matches_jax(seed, n, c):
    rng = np.random.default_rng(seed)
    vecs, _ = _clustered(rng, n_clusters=c, per=n // c, d=16)
    init = rng.choice(len(vecs), size=c, replace=False)
    jc, ja = jvi._kmeans(jnp.asarray(vecs), jnp.asarray(init), c, 10)
    tc, ta = tvi._kmeans(torch.from_numpy(vecs), init, c, 10)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tc, jc, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_ivf_buckets_and_search_match_jax(metric):
    """One k-means cluster per true cluster: with more, k-means splits a
    true cluster, and a point on the split scores a near-tie that the
    two packages' float32 sums may break either way."""
    rng = np.random.default_rng(11)
    vecs, queries = _clustered(rng)
    jx = jvi.IvfFlatIndex(vecs, n_clusters=20, metric=metric, seed=1)
    tx = tvi.IvfFlatIndex(vecs, n_clusters=20, metric=metric, seed=1,
                          device="cpu")
    assert (tx.n, tx.dim, tx.n_clusters, tx.cap) == \
        (jx.n, jx.dim, jx.n_clusters, jx.cap)
    np.testing.assert_array_equal(tx.buckets.numpy(), np.asarray(jx.buckets))
    _close(tx.centroids, jx.centroids, atol=1e-5)
    for nprobe in (1, 4, 8):
        js, ji = jx.search(queries, k=10, nprobe=nprobe)
        ts, ti = tx.search(queries, k=10, nprobe=nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(ts, js, atol=RTOL * _scale(queries, vecs))


def test_ivf_recall_equals_jax():
    rng = np.random.default_rng(0)
    vecs, queries = _clustered(rng)
    recalls = []
    for vi, kw in ((jvi, {}), (tvi, {"device": "cpu"})):
        idx = vi.IvfFlatIndex(vecs, n_clusters=32, metric="l2", seed=1,
                              **kw)
        _, approx = idx.search(queries, k=10, nprobe=8)
        _, exact = vi.exact_search(queries, vecs, 10, metric="l2", **kw)
        approx, exact = np.asarray(approx), np.asarray(exact)
        recalls.append(np.mean([len(set(approx[i]) & set(exact[i])) / 10
                                for i in range(len(queries))]))
    assert recalls[1] == recalls[0] >= 0.9


def test_ivf_small_inputs_match_jax():
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(5, 8)).astype(np.float32)
    jx = jvi.IvfFlatIndex(vecs, n_clusters=2)
    tx = tvi.IvfFlatIndex(vecs, n_clusters=2, device="cpu")
    _, jg = jx.search(vecs[:2], k=3, nprobe=2)
    _, tg = tx.search(vecs[:2], k=3, nprobe=2)
    assert tg.shape == (2, 3) and tg[0, 0] == 0
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # more clusters than rows (rows drawn with replacement)
    jx = jvi.IvfFlatIndex(vecs[:3], n_clusters=4, seed=2)
    tx = tvi.IvfFlatIndex(vecs[:3], n_clusters=4, seed=2, device="cpu")
    np.testing.assert_array_equal(tx.buckets.numpy(), np.asarray(jx.buckets))


def test_ivf_padding_reports_minus_one_as_jax():
    vecs = np.concatenate([np.zeros((3, 4)), np.full((50, 4), 100.0)]
                          ).astype(np.float32)
    q = np.zeros((1, 4), np.float32)
    jx = jvi.IvfFlatIndex(vecs, n_clusters=2, seed=3)
    tx = tvi.IvfFlatIndex(vecs, n_clusters=2, seed=3, device="cpu")
    js, jg = jx.search(q, k=10, nprobe=1)
    ts, tg = tx.search(q, k=10, nprobe=1)
    pad = np.isneginf(ts.numpy()[0])
    assert pad.any() and (tg.numpy()[0][pad] == -1).all()
    assert set(tg.numpy()[0][~pad]) == {0, 1, 2}
    np.testing.assert_array_equal(pad, np.isneginf(np.asarray(js)[0]))
    np.testing.assert_array_equal(tg.numpy()[0][pad],
                                  np.asarray(jg)[0][pad])
    assert set(tg.numpy()[0][~pad]) == set(np.asarray(jg)[0][~pad])


def test_ties_keep_the_lower_row_first():
    """``jax.lax.top_k``'s order on a tie; ``torch.topk`` promises none."""
    vecs = np.array([[1, 0], [0, 1], [1, 0], [1, 0], [0, 0]], np.float32)
    q = np.array([[1, 0]], np.float32)
    _, ji = jvi.exact_search(q, vecs, 4, metric="ip")
    _, ti = tvi.exact_search(q, vecs, 4, metric="ip", device="cpu")
    assert ti[0].tolist() == np.asarray(ji)[0].tolist() == [0, 2, 3, 1]


@pytest.mark.parametrize("seed,n,k", [(0, 50, 7), (1, 1000, 64),
                                      (2, 300, 300), (3, 9, 1)])
def test_top_k_breaks_ties_as_lax(seed, n, k):
    """``_top_k`` (one ``torch.topk`` over (score, lower index) keys)
    against ``jax.lax.top_k`` on scores with many ties, signed zeros,
    NaNs of both signs and -inf padding: the same values (NaN where
    NaN) and indices in the same order."""
    import jax

    rng = np.random.default_rng(seed)
    s = rng.integers(-4, 4, size=(3, n)).astype(np.float32)
    s[rng.random((3, n)) < 0.1] = -np.inf
    s[rng.random((3, n)) < 0.1] = -0.0
    s[rng.random((3, n)) < 0.02] = np.nan
    s[rng.random((3, n)) < 0.02] = -np.float32(np.nan)
    jv, ji = jax.lax.top_k(s, k)
    tv, ti = tvi._top_k(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
