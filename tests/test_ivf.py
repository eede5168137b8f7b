"""IVF recall floors and edge cases (reference: tests/test_ivf.py)."""

import numpy as np
import pytest

from tinyknn_tpu import FastPQ, IVF, knn_brute


def test_small_n():
    d = 10
    np.random.seed(10)
    for metric in ["euclidean", "angular"]:
        for n in range(1, 5):
            X = np.random.randn(n, d).astype(np.float32)
            q = np.random.randn(d).astype(np.float32)
            ivf = IVF(metric, 1, FastPQ(2))
            ivf.fit(X).build(X, n_probes=1)
            res = np.asarray(ivf.query(q, n))
            assert all(0 <= i < n for i in res)


def test_far_small_n():
    d = 10
    np.random.seed(10)
    for metric in ["euclidean", "angular"]:
        for n in range(2, 5):
            X = np.random.randn(n, d).astype(np.float32)
            X[0, :] = 10**5
            q = np.random.randn(d).astype(np.float32)
            ivf = IVF(metric, 1, pq=FastPQ(2))
            ivf.fit(X).build(X, n_probes=1)
            res = np.asarray(ivf.query(q, n))
            assert all(0 <= i < n for i in res)


def test_batched_matches_single():
    np.random.seed(11)
    n, d, nq = 200, 12, 8
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    ivf = IVF("euclidean", 10, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    batched = np.asarray(ivf.query(qs, k=5, n_probes=3))
    for i in range(nq):
        single = np.asarray(ivf.query(qs[i], k=5, n_probes=3))
        np.testing.assert_array_equal(batched[i], single)


def _test_recall_inner(n, d, nq, dpb, at, metric, n_probes):
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    if at < n:
        trus = np.asarray(knn_brute(qs, X, k=at))
    else:
        trus = np.broadcast_to(np.arange(n), (nq, n))
    ivf = IVF(metric, int(n**0.5), FastPQ(dpb))
    ivf.fit(X).build(X)
    guesses = np.asarray(ivf.query(qs, k=at, n_probes=n_probes))
    recall_at = sum(
        len(set(g.tolist()) & set(t.tolist()))
        for g, t in zip(guesses, trus))
    return recall_at / nq / at


def test_euclidean_recall():
    np.random.seed(10)
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "euclidean", 1) > 0.1
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "euclidean", 2) > 0.2
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "euclidean", 4) > 0.35
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "euclidean", 8) > 0.50


def test_angular_recall():
    np.random.seed(10)
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "angular", 1) > 0.09
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "angular", 2) > 0.18
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "angular", 4) > 0.27
    assert _test_recall_inner(10**2, 20, 10, 2, 10, "angular", 8) > 0.36


def test_small():
    np.random.seed(10)
    assert _test_recall_inner(15, 10, 30, 2, 10, "euclidean", 1) > 0.05


def test_bucket_gather_mode_parity():
    np.random.seed(12)
    n, d, nq = 400, 16, 10
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    ivf = IVF("euclidean", 20, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    a = np.asarray(ivf.query(qs, k=5, n_probes=4, mode="bucket"))
    b = np.asarray(ivf.query(qs, k=5, n_probes=4, mode="gather"))
    # gather rescores a superset of the bucketed pass_1 cut: results can
    # only tie or dominate; overlap must be near-total
    for i in range(nq):
        da = ((X[a[i]] - qs[i]) ** 2).sum(-1).max()
        db = ((X[b[i]] - qs[i]) ** 2).sum(-1).max()
        assert db <= da + 1e-4
    overlap = np.mean([len(set(a[i].tolist()) & set(b[i].tolist())) / 5
                       for i in range(nq)])
    assert overlap >= 0.9, overlap


def test_query_stats():
    np.random.seed(13)
    n, d = 300, 12
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(50, d).astype(np.float32)
    ivf = IVF("euclidean", 10, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    out, stats = ivf.query(qs, k=5, n_probes=3, with_stats=True,
                           mode="bucket")
    assert out.shape == (50, 5)
    assert stats["mode"] == "bucket"
    assert 0 <= stats["dropped_probe_pairs"] <= stats["total_probe_pairs"]
    # generous default capacity: no drops on an even workload
    assert stats["dropped_probe_pairs"] == 0


def test_adaptive_r_bucket_vs_gather_medium():
    """At high n_probes, the bucketed path truncates per-pair candidates
    to r=3k < pass_1; recall vs the exhaustive gather path must not
    regress beyond tie-noise."""
    np.random.seed(14)
    n, d, nq, k, P = 5000, 16, 64, 10, 12
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=k))
    ivf = IVF("euclidean", 70, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    rec = {}
    for mode in ["bucket", "gather"]:
        g = np.asarray(ivf.query(qs, k=k, n_probes=P, mode=mode))
        rec[mode] = np.mean([len(set(a.tolist()) & set(t.tolist())) / k
                             for a, t in zip(g, trus)])
    assert rec["bucket"] >= rec["gather"] - 0.02, rec


def test_fused_scan_matches_xla():
    """The CSR kernel path must agree with the XLA path (interpret mode
    on CPU, compiled on a GPU; bit-exact selection up to ties)."""
    np.random.seed(15)
    n, d, nq = 600, 16, 32
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    a_idx = IVF("euclidean", 16, FastPQ(2, seed=3), scan_impl="xla",
                pass1_method="exact")
    a_idx.fit(X).build(X, n_probes=2)
    b_idx = IVF("euclidean", 16, FastPQ(2, seed=3), scan_impl="fused",
                pass1_method="exact")
    b_idx.fit(X).build(X, n_probes=2)
    a = np.asarray(a_idx.query(qs, k=8, n_probes=4, mode="bucket"))
    b = np.asarray(b_idx.query(qs, k=8, n_probes=4, mode="bucket"))
    for i in range(nq):
        da = np.sort(((X[a[i]] - qs[i]) ** 2).sum(-1))
        db = np.sort(((X[b[i]] - qs[i]) ** 2).sum(-1))
        np.testing.assert_allclose(da, db, rtol=1e-5)


def test_auto_scan_is_the_compiled_kernel_on_gpu(gpu):
    """On the GPU the default engine is the compiled CSR kernel, and it
    returns what the XLA scan returns."""
    from tinyknn_tpu.models.ivf import _resolve_scan_impl
    np.random.seed(15)
    X = np.random.randn(3000, 32).astype(np.float32)
    qs = np.random.randn(64, 32).astype(np.float32)
    ivf = IVF("euclidean", 24, FastPQ(2, seed=3))
    ivf.fit(X).build(X, n_probes=2)
    assert _resolve_scan_impl(ivf) == "fused"
    a = np.asarray(ivf.query(qs, k=8, n_probes=3, mode="bucket"))
    ivf.set_scan_impl("xla")
    b = np.asarray(ivf.query(qs, k=8, n_probes=3, mode="bucket"))
    da = np.sort(((X[a] - qs[:, None]) ** 2).sum(-1), axis=1)
    db = np.sort(((X[b] - qs[:, None]) ** 2).sum(-1), axis=1)
    np.testing.assert_allclose(da, db, rtol=1e-5)
    ivf.set_scan_impl("exact")
    assert _resolve_scan_impl(ivf) == "exact"
    tru = np.asarray(knn_brute(qs, X, k=8))
    got = np.asarray(ivf.query(qs, k=8, n_probes=24, mode="bucket"))
    rec = np.mean([len(set(g.tolist()) & set(t.tolist())) / 8
                   for g, t in zip(got, tru)])
    assert rec >= 0.99, rec


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("n_probes", [1, 3, 12])
def test_exact_xla_bucket_matches_gather_and_brute(metric, n_probes):
    """The plain-XLA exact bucket scan (what scan_impl='exact' runs on
    the CPU) ranks like the exact gather path, and with every list
    probed it reproduces brute force."""
    from tinyknn_tpu.models.ivf import _resolve_scan_impl
    rng = np.random.default_rng(50 + n_probes)
    X = rng.standard_normal((1500, 20)).astype(np.float32)
    qs = rng.standard_normal((40, 20)).astype(np.float32)
    ivf = IVF(metric, 12, FastPQ(2, rotate_dim=None), scan_impl="exact")
    ivf.fit(X).build(X, n_probes=1)
    assert _resolve_scan_impl(ivf) == "exact_xla"
    a = np.asarray(ivf.query(qs, k=10, n_probes=n_probes, mode="bucket"))
    b = np.asarray(ivf.query(qs, k=10, n_probes=n_probes, mode="gather"))
    Xn, qn = X, qs
    if metric == "angular":
        Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
        qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    da = np.sort(((Xn[a] - qn[:, None]) ** 2).sum(-1), axis=1)
    db = np.sort(((Xn[b] - qn[:, None]) ** 2).sum(-1), axis=1)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)
    if n_probes == 12:
        tru = np.asarray(knn_brute(qs, X, k=10, metric=metric))
        rec = np.mean([len(set(g.tolist()) & set(t.tolist())) / 10
                       for g, t in zip(a, tru)])
        assert rec >= 0.99, rec


def test_fused_segmented_approx_recall():
    """pass1_method='approx' + fused scan triggers the segmented
    extraction; recall must stay within tolerance of exact."""
    np.random.seed(16)
    n, d, nq, k = 2000, 16, 40, 10
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=k))

    def recall(**kw):
        ivf = IVF("euclidean", 40, FastPQ(2, seed=4), **kw)
        ivf.fit(X).build(X, n_probes=2)
        g = np.asarray(ivf.query(qs, k=k, n_probes=6, mode="bucket"))
        return np.mean([len(set(a.tolist()) & set(t.tolist())) / k
                        for a, t in zip(g, trus)])

    r_exact = recall(scan_impl="fused", pass1_method="exact")
    r_seg = recall(scan_impl="fused", pass1_method="approx")
    assert r_seg >= r_exact - 0.03, (r_exact, r_seg)


def test_tune_n_probes():
    from tinyknn_tpu.models.ivf import tune_n_probes
    np.random.seed(17)
    n, d, nq, k = 1500, 12, 30, 10
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=k))
    ivf = IVF("euclidean", 38, FastPQ(2))
    ivf.fit(X).build(X, n_probes=4)
    # NamedTuple result still unpacks as a plain 4-tuple
    p, p1, recall, curve = tune_n_probes(ivf, qs, trus, k=k,
                                         target_recall=0.8)
    assert recall >= 0.8
    assert p1 >= 2 * ((p + 1) * k + 1)  # smallest searched mult is x2
    assert curve[(p, p1)] == recall
    # minimality over n_probes: at the previously-probed n_probes even
    # the widest pass-1 pool stayed below target
    probed = sorted({np_ for np_, _ in curve})
    i = probed.index(p)
    if i > 0:
        best_prev = max(r for (np_, _), r in curve.items()
                        if np_ == probed[i - 1])
        assert best_prev < 0.8
    # minimality over pass_1: a cheaper searched pool at the same
    # n_probes (if any was measured) stayed below target
    for (np_, p1_other), r in curve.items():
        if np_ == p and p1_other < p1:
            assert r < 0.8


def test_tune_n_probes_exact_mode():
    """tune_n_probes on an exact-scan index: pass_1 there means the f32
    rescore-sliver width (mult * k * n_probes, engine default 4kP), and
    the tuner must reach a high target the PQ pool sizing can't express
    (VERDICT r4 #10: the 0.95-recall engine gets a tested auto-tuner)."""
    from tinyknn_tpu.models.ivf import tune_n_probes
    np.random.seed(19)
    n, d, nq, k = 1500, 12, 30, 10
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=k))
    ivf = IVF("euclidean", 38, FastPQ(2, rotate_dim=None),
              scan_impl="exact")
    ivf.fit(X).build(X, n_probes=1)
    p, p1, recall, curve = tune_n_probes(ivf, qs, trus, k=k,
                                         target_recall=0.97)
    assert recall >= 0.97, (p, p1, recall)
    assert p1 >= 2 * k * max(p, 1)  # exact-mode sliver sizing (min mult x2)
    assert curve[(p, p1)] == recall
    # the tuned point reproduces through the public query API
    g = np.asarray(ivf.query(qs, k=k, n_probes=p, pass_1=p1))
    got = np.mean([len(set(a.tolist()) & set(t.tolist())) / k
                   for a, t in zip(g, trus)])
    assert got == recall


def test_skewed_query_batch():
    """Queries concentrated near one cluster must not lose their nearest
    probe to bucket-capacity overflow at moderate batch sizes."""
    np.random.seed(18)
    n, d = 2000, 12
    X = np.random.randn(n, d).astype(np.float32)
    # every query near the same data region
    base = X[7]
    qs = (base + 0.05 * np.random.randn(30, d)).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=5))
    ivf = IVF("euclidean", 44, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    out, stats = ivf.query(qs, k=5, n_probes=4, mode="bucket",
                           with_stats=True)
    assert stats["dropped_probe_pairs"] == 0, stats
    g = np.asarray(out)
    recall = np.mean([len(set(a.tolist()) & set(t.tolist())) / 5
                      for a, t in zip(g, trus)])
    assert recall > 0.5, recall


def test_heavily_skewed_batch_recall():
    """A large batch of near-duplicate queries (everyone's nearest
    cluster is the same list) must match per-query results: the retry
    ladder escalates the round-0 capacity qc0, ending at a can't-drop
    cap (regression: qc0 was a fixed formula inside the jit, so retries
    could never fix round-0 drops and recall collapsed)."""
    np.random.seed(19)
    n, d, Q = 3000, 16, 600
    X = np.random.randn(n, d).astype(np.float32)
    base = X[42]
    qs = (base + 0.02 * np.random.randn(Q, d)).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=10))
    ivf = IVF("euclidean", 54, FastPQ(2))
    ivf.fit(X).build(X, n_probes=2)
    out, stats = ivf.query(qs, k=10, n_probes=2, mode="bucket",
                           with_stats=True)
    assert stats["dropped_probe_pairs"] == 0, stats
    g = np.asarray(out)
    recall = np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                      for a, t in zip(g, trus)])
    # uniform-batch recall on this config is ~the same; the bug dropped
    # this to ~0.06
    assert recall > 0.5, recall


def test_query_stream_matches_query():
    """query_stream (R batches per dispatch) must agree with per-batch
    query when no bucket-capacity escalation triggers."""
    np.random.seed(21)
    X = np.random.randn(600, 16).astype(np.float32)
    qs = np.random.randn(3, 40, 16).astype(np.float32)
    ivf = IVF("euclidean", 12, FastPQ(2, rotate_dim=None),
              queries_per_cluster=64)
    ivf.fit(X).build(X, n_probes=2)
    stream = np.asarray(ivf.query_stream(qs, k=8, n_probes=4))
    assert stream.shape == (3, 40, 8)
    for i in range(3):
        single = np.asarray(ivf.query(qs[i], k=8, n_probes=4))
        np.testing.assert_array_equal(stream[i], single)


def test_query_stream_device_out():
    """device_out=True (the pipelined-serving form) returns DEVICE
    arrays with the same positional ids as the host path."""
    import jax
    np.random.seed(22)
    X = np.random.randn(600, 16).astype(np.float32)
    qs = np.random.randn(2, 40, 16).astype(np.float32)
    ivf = IVF("euclidean", 12, FastPQ(2, rotate_dim=None))
    ivf.fit(X).build(X, n_probes=2)
    host = np.asarray(ivf.query_stream(qs, k=8, n_probes=4))
    out, dropped = ivf.query_stream(qs, k=8, n_probes=4,
                                    device_out=True)
    assert isinstance(out, jax.Array) and isinstance(dropped, jax.Array)
    np.testing.assert_array_equal(np.asarray(out), host)
    assert int(dropped) == 0
    with pytest.raises(ValueError, match="device_out"):
        ivf.query_stream(qs, k=8, n_probes=4, device_out=True,
                         with_stats=True)


def test_query_stream_device_out_labels_exact_rr():
    """The device_out contract with the full serving configuration:
    exact engine + rescore_rows + int64 user labels. The host path
    returns LABELS; device_out returns POSITIONAL ids (the on-device
    currency) — mapping them through ivf.labels must reproduce the
    host output exactly."""
    np.random.seed(23)
    X = np.random.randn(500, 16).astype(np.float32)
    qs = np.random.randn(2, 32, 16).astype(np.float32)
    labels = (np.arange(500, dtype=np.int64) * 7 + 3) << 33
    ivf = IVF("angular", 10, scan_impl="exact", rescore_rows=True)
    ivf.fit(X).build(X, n_probes=2, labels=labels)
    host = np.asarray(ivf.query_stream(qs, k=6, n_probes=3))
    assert host.dtype == np.int64 and np.isin(host, labels).all()
    out, dropped = ivf.query_stream(qs, k=6, n_probes=3,
                                    device_out=True)
    pos = np.asarray(out)
    assert pos.dtype == np.int32
    np.testing.assert_array_equal(labels[pos], host)
    assert int(dropped) == 0


def test_query_stream_adaptive_qc():
    """A skewed stream self-tunes its bucket capacities: the first call
    at a shape measures the per-cluster load (pre-pass) and scans
    drop-free where the mean-load heuristic alone overflows; results
    match query()'s escalated (drop-free) output. adaptive_qc=False
    restores the raw heuristic and its (auditable) drops."""
    np.random.seed(31)
    n, d, Q = 3000, 16, 64
    X = np.random.randn(n, d).astype(np.float32)
    base = X[13]
    qs = (base + 0.02 * np.random.randn(2, Q, d)).astype(np.float32)
    ivf = IVF("euclidean", 24, FastPQ(2, rotate_dim=None))
    ivf.fit(X).build(X, n_probes=2)

    # the scenario bites: the heuristic alone drops pairs on this batch
    _, st_raw = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True,
                                 adaptive_qc=False)
    assert st_raw["dropped_probe_pairs"] > 0, st_raw

    out, st = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] == 0, st
    assert (Q, 3) in ivf._stream_qc_floors  # floor cached for the shape
    for i in range(2):
        single = np.asarray(ivf.query(qs[i], k=8, n_probes=3,
                                      mode="bucket"))
        np.testing.assert_array_equal(np.asarray(out)[i], single)


def test_query_stream_adaptive_qc_drift_escalation():
    """If query drift overflows a cached floor, the overflowing stream
    reports its drops (free piggybacked counter) and the floor is
    RE-MEASURED on the dropping stream so the next same-shape stream
    is clean (re-measure converges; blind 4x escalation caused a
    recompile-per-call collapse at scale — r5_euclid_stream_diag)."""
    np.random.seed(32)
    n, d, Q = 3000, 16, 64
    X = np.random.randn(n, d).astype(np.float32)
    qs = (X[13] + 0.02 * np.random.randn(1, Q, d)).astype(np.float32)
    ivf = IVF("euclidean", 24, FastPQ(2, rotate_dim=None))
    ivf.fit(X).build(X, n_probes=2)
    # seed the cache with a stale (too-low) floor, as if earlier
    # streams at this shape had been uniform
    ivf._stream_qc_floors = {(Q, 3): (8, 8)}
    _, st1 = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st1["dropped_probe_pairs"] > 0, st1
    assert ivf._stream_qc_floors[(Q, 3)][0] > 8  # refreshed for next
    _, st2 = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st2["dropped_probe_pairs"] == 0, st2


def test_query_stream_adaptive_qc_exact_mode():
    """Adaptive stream capacity in exact-scan mode: the raised floors
    flow through the fold-width budget derivation and the skewed
    stream still agrees with query()."""
    np.random.seed(33)
    n, d, Q = 2000, 16, 48
    X = np.random.randn(n, d).astype(np.float32)
    qs = (X[5] + 0.02 * np.random.randn(1, Q, d)).astype(np.float32)
    ivf = IVF("euclidean", 16, FastPQ(2, rotate_dim=None),
              scan_impl="exact")
    ivf.fit(X).build(X, n_probes=1)
    out, st = ivf.query_stream(qs, k=6, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] == 0, st
    single = np.asarray(ivf.query(qs[0], k=6, n_probes=3))
    np.testing.assert_array_equal(np.asarray(out)[0], single)


def test_ivf_bf16_tables_fused_and_xla():
    """Unquantized bf16 tables through both IVF scan paths (the
    beyond-reference quality mode: int32 fold encoding is replaced by
    order-preserving bf16 value bits)."""
    np.random.seed(23)
    X = np.random.randn(800, 16).astype(np.float32)
    qs = np.random.randn(30, 16).astype(np.float32)
    tru = np.asarray(knn_brute(qs, X, k=5))
    recalls = {}
    for impl in ("fused", "xla"):
        ivf = IVF("euclidean", 10,
                  FastPQ(2, rotate_dim=None, table_dtype="bf16"),
                  scan_impl=impl)
        ivf.fit(X).build(X, n_probes=2)
        ids = np.asarray(ivf.query(qs, k=5, n_probes=4))
        recalls[impl] = np.mean(
            [len(set(a) & set(b)) / 5 for a, b in zip(ids, tru)])
    assert recalls["fused"] >= recalls["xla"] - 0.05, recalls
    assert recalls["fused"] >= 0.5, recalls


def test_int64_labels_survive_pipeline():
    """64-bit user labels >= 10^12 survive the whole pack -> scan ->
    dedup -> rescore pipeline, in every query mode (the reference
    threads int64 labels through its kernel heap and pins this with
    reference tests/test_pq.py:143-158; here points ride as int32
    positions and winners map through the label table)."""
    np.random.seed(29)
    n, d, k = 900, 12, 7
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(25, d).astype(np.float32)
    labels = 10**12 + 3 * np.arange(n, dtype=np.int64)

    plain = IVF("euclidean", 24, FastPQ(2))
    plain.fit(X).build(X, n_probes=2)
    tagged = IVF("euclidean", 24, FastPQ(2))
    tagged.fit(X).build(X, n_probes=2, labels=labels)

    for mode in ("bucket", "gather"):
        pos = np.asarray(plain.query(qs, k=k, n_probes=3, mode=mode))
        got = tagged.query(qs, k=k, n_probes=3, mode=mode)
        assert got.dtype == np.int64
        want = np.where(pos >= 0, labels[np.maximum(pos, 0)],
                        np.int64(-1))
        np.testing.assert_array_equal(got, want)
    # streaming path too
    pos = np.asarray(plain.query(qs, k=k, n_probes=3, mode="bucket"))
    stream = tagged.query_stream(qs[None], k=k, n_probes=3)
    assert stream.dtype == np.int64
    np.testing.assert_array_equal(
        stream[0], np.where(pos >= 0, labels[np.maximum(pos, 0)], -1))


def test_corpus_row_cap_asserted():
    """The int32 positional-id cap (2^31 rows) is asserted at build
    time rather than silently overflowing."""
    ivf = IVF("euclidean", 4, FastPQ(2))
    X = np.random.randn(64, 8).astype(np.float32)
    ivf.fit(X)

    class _Huge:
        shape = (2**31, 8)

    try:
        ivf.build(_Huge(), n_probes=1)
        assert False, "expected the 2^31-row cap assert"
    except AssertionError as e:
        assert "2^31" in str(e)


def test_fold_mult_knob():
    """fold_mult shrinks the fused kernel's fold buffer (the pass-1
    pool); recall degrades at most marginally at moderate widths and
    the knob round-trips through the query paths."""
    np.random.seed(33)
    X = np.random.randn(2500, 16).astype(np.float32)
    qs = np.random.randn(50, 16).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=10))

    def recall(**kw):
        ivf = IVF("euclidean", 50, FastPQ(2, rotate_dim=None),
                  scan_impl="fused", **kw)
        ivf.fit(X).build(X, n_probes=2)
        g = np.asarray(ivf.query(qs, k=10, n_probes=6, pass_1=120))
        return np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                        for a, t in zip(g, trus)])

    wide, narrow = recall(), recall(fold_mult=2)
    assert narrow >= wide - 0.1, (wide, narrow)
    assert wide >= 0.6, wide


def test_exact_mode_full_probe_is_exact():
    """scan_impl='exact' with every cluster probed must reproduce the
    true kNN (no PQ estimate anywhere; bf16 rounding can only swap
    near-ties, which the seeded gaps here don't produce)."""
    np.random.seed(44)
    for metric in ["euclidean", "angular"]:
        X = np.random.randn(600, 12).astype(np.float32)
        qs = np.random.randn(20, 12).astype(np.float32)
        trus = np.asarray(knn_brute(qs, X, k=5, metric=metric))
        ivf = IVF(metric, 8, FastPQ(2, rotate_dim=None),
                  scan_impl="exact")
        ivf.fit(X).build(X, n_probes=1)
        got = np.asarray(ivf.query(qs, k=5, n_probes=8))
        rec = np.mean([len(set(g.tolist()) & set(t.tolist())) / 5
                       for g, t in zip(got, trus)])
        assert rec >= 0.99, (metric, rec)


def test_exact_mode_gather_small_batch():
    """Exact-engine gather (latency) mode: per-query list gather with
    true bf16 distances + thin f32 rescore. Must reproduce true kNN at
    full coverage, agree with the bucket engine at partial coverage,
    and serve a single (d,) query (the reference's per-query shape,
    tinyknn/ivf.py:106) — VERDICT r4 #9."""
    np.random.seed(47)
    for metric in ["euclidean", "angular"]:
        X = np.random.randn(800, 12).astype(np.float32)
        qs = np.random.randn(8, 12).astype(np.float32)
        trus = np.asarray(knn_brute(qs, X, k=5, metric=metric))
        ivf = IVF(metric, 8, FastPQ(2, rotate_dim=None),
                  scan_impl="exact")
        ivf.fit(X).build(X, n_probes=1)
        # full coverage -> exact kNN through the gather path
        got, st = ivf.query(qs, k=5, n_probes=8, with_stats=True)
        assert st["mode"] == "gather", st  # Q*P=64 <= threshold
        got = np.asarray(got)
        rec = np.mean([len(set(g.tolist()) & set(t.tolist())) / 5
                       for g, t in zip(got, trus)])
        assert rec >= 0.99, (metric, rec)
        # partial coverage: gather and bucket agree (same selection
        # semantics; both rescore their sliver in f32)
        a = np.asarray(ivf.query(qs, k=5, n_probes=3, mode="gather"))
        b = np.asarray(ivf.query(qs, k=5, n_probes=3, mode="bucket"))
        overlap = np.mean([len(set(x.tolist()) & set(y.tolist())) / 5
                           for x, y in zip(a, b)])
        assert overlap >= 0.9, (metric, overlap)
        # single-query shape
        one = np.asarray(ivf.query(qs[0], k=5, n_probes=8))
        assert one.shape == (5,)
        assert set(one.tolist()) == set(got[0].tolist())


def test_exact_mode_beats_pq_recall():
    """At equal probes the exact scan's recall dominates the PQ
    estimate + rescore path (it has no estimate noise)."""
    np.random.seed(45)
    X = np.random.randn(3000, 16).astype(np.float32)
    qs = np.random.randn(40, 16).astype(np.float32)
    trus = np.asarray(knn_brute(qs, X, k=10))

    def run(scan_impl):
        ivf = IVF("euclidean", 50, FastPQ(2, rotate_dim=None),
                  scan_impl=scan_impl)
        ivf.fit(X).build(X, n_probes=2)
        g = np.asarray(ivf.query(qs, k=10, n_probes=5))
        return np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                        for a, t in zip(g, trus)])

    exact, pq = run("exact"), run("xla")
    assert exact >= pq - 0.02, (exact, pq)
    assert exact >= 0.7, exact


def test_exact_mode_dedup_and_stream():
    """build_probes spill duplicates are removed in exact mode, and
    query_stream agrees with query."""
    np.random.seed(46)
    X = np.random.randn(900, 12).astype(np.float32)
    qs = np.random.randn(16, 12).astype(np.float32)
    ivf = IVF("angular", 12, FastPQ(2, rotate_dim=None),
              scan_impl="exact")
    ivf.fit(X).build(X, n_probes=3)
    got = np.asarray(ivf.query(qs, k=8, n_probes=6))
    for row in got:
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid), row
    stream = np.asarray(ivf.query_stream(
        np.stack([qs, qs]), k=8, n_probes=6))
    np.testing.assert_array_equal(stream[0], got)
    np.testing.assert_array_equal(stream[1], got)


def test_exact_mode_save_load(tmp_path):
    """csr_vecs are derived state: a reloaded exact index rebuilds them
    and answers identically."""
    from tinyknn_tpu.io import load_ivf, save_ivf
    np.random.seed(47)
    X = np.random.randn(500, 10).astype(np.float32)
    qs = np.random.randn(10, 10).astype(np.float32)
    ivf = IVF("euclidean", 10, FastPQ(2, rotate_dim=None),
              scan_impl="exact")
    ivf.fit(X).build(X, n_probes=2)
    want = np.asarray(ivf.query(qs, k=5, n_probes=4))
    path = tmp_path / "exact.npz"
    save_ivf(path, ivf)
    ivf2 = load_ivf(path)
    assert ivf2.csr_vecs is not None
    got = np.asarray(ivf2.query(qs, k=5, n_probes=4))
    np.testing.assert_array_equal(want, got)


def test_rescore_rows_matches_default(tmp_path):
    """rescore_rows=True (CSR-ordered raw copy + deferred id decode)
    must return identical results to the default path, including
    through save/load and build-probes spill dedup."""
    from tinyknn_tpu.io import load_ivf, save_ivf
    np.random.seed(48)
    X = np.random.randn(900, 12).astype(np.float32)
    qs = np.random.randn(32, 12).astype(np.float32)
    for metric, impl in [("euclidean", "fused"), ("angular", "fused"),
                         ("angular", "exact"), ("euclidean", "exact")]:
        a_ivf = IVF(metric, 12, FastPQ(2, seed=5, rotate_dim=None),
                    seed=2, scan_impl=impl)
        a_ivf.fit(X).build(X, n_probes=2)
        b_ivf = IVF(metric, 12, FastPQ(2, seed=5, rotate_dim=None),
                    seed=2, scan_impl=impl, rescore_rows=True)
        b_ivf.fit(X).build(X, n_probes=2)
        assert b_ivf.csr_raw is not None
        a = np.asarray(a_ivf.query(qs, k=7, n_probes=4))
        b = np.asarray(b_ivf.query(qs, k=7, n_probes=4))
        np.testing.assert_array_equal(a, b)
        stream = np.asarray(b_ivf.query_stream(qs[None], k=7,
                                               n_probes=4))
        np.testing.assert_array_equal(stream[0], b)
        path = tmp_path / f"rr_{metric}.npz"
        save_ivf(path, b_ivf)
        b2 = load_ivf(path)
        assert b2.csr_raw is not None
        np.testing.assert_array_equal(
            np.asarray(b2.query(qs, k=7, n_probes=4)), b)


def test_query_stream_exact_guard():
    """query_stream mirrors query()'s exact-mode precondition: a clear
    error instead of a cryptic NoneType jit trace when scan_impl is
    'exact' but the bf16 vector tiles were never built."""
    rng = np.random.default_rng(13)
    X = rng.standard_normal((200, 8)).astype(np.float32)
    ivf = IVF("euclidean", 8, FastPQ(2, rotate_dim=None))
    ivf.fit(X).build(X, n_probes=2)
    ivf.scan_impl = "exact"  # bypass set_scan_impl on purpose
    with pytest.raises(AssertionError, match="scan_impl='exact'"):
        ivf.query_stream(np.zeros((1, 4, 8), np.float32), k=3)


def test_scan_budget_bytes_knob():
    """scan_budget_bytes bounds the can't-drop capacity caps: a tiny
    budget clamps the adaptive stream's floors below a skewed stream's
    measured peak (drops surface in stats), and the default budget
    scans the same stream drop-free. The knob round-trips persistence."""
    np.random.seed(51)
    n, d, Q = 3000, 16, 64
    X = np.random.randn(n, d).astype(np.float32)
    qs = (X[13] + 0.02 * np.random.randn(1, Q, d)).astype(np.float32)

    tiny = IVF("euclidean", 24, FastPQ(2, rotate_dim=None),
               scan_budget_bytes=24 * 16 * 4 * 128)
    tiny.fit(X).build(X, n_probes=2)
    _, st = tiny.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] > 0, st

    # same index state, default budget: drop-free
    import copy
    free = copy.copy(tiny)
    free.scan_budget_bytes = 2 << 30
    free._stream_qc_floors = {}
    _, st2 = free.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st2["dropped_probe_pairs"] == 0, st2


def test_scan_budget_bytes_persists(tmp_path):
    from tinyknn_tpu.io import save_ivf, load_ivf
    np.random.seed(52)
    X = np.random.randn(400, 12).astype(np.float32)
    ivf = IVF("euclidean", 8, FastPQ(2, rotate_dim=None),
              scan_budget_bytes=123456)
    ivf.fit(X).build(X, n_probes=1)
    path = tmp_path / "b.npz"
    save_ivf(path, ivf)
    assert load_ivf(path).scan_budget_bytes == 123456


def test_stream_refresh_converges_under_budget_clamp():
    """A budget-clamped stream pays the pre-pass re-measure at most
    once per (shape, budget): once the refresh confirms the cached
    floor already covers the true peak, further dropping calls skip
    the extra dispatch (advisor r5 — the re-measure must not become a
    permanent per-call tax)."""
    np.random.seed(53)
    n, d, Q = 3000, 16, 64
    X = np.random.randn(n, d).astype(np.float32)
    qs = (X[13] + 0.02 * np.random.randn(1, Q, d)).astype(np.float32)
    ivf = IVF("euclidean", 24, FastPQ(2, rotate_dim=None),
              scan_budget_bytes=24 * 16 * 4 * 128)
    ivf.fit(X).build(X, n_probes=2)

    from tinyknn_tpu.models import ivf as ivf_mod
    calls = {"n": 0}
    real = ivf_mod._stream_peak_loads

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    ivf_mod._stream_peak_loads = counting
    try:
        _, st1 = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
        assert st1["dropped_probe_pairs"] > 0, st1
        # the floor was measured on THIS stream (first call at the
        # shape), so the drop can only be the budget clamp: the refresh
        # must NOT re-measure the same batches (just_measured skip)
        n_after_first = calls["n"]
        assert n_after_first == 1, calls
        _, st2 = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
        assert st2["dropped_probe_pairs"] > 0, st2
        assert calls["n"] == n_after_first  # no further pre-pass calls
        # the reported floors are the APPLIED (clamped) capacities
        assert st2["adaptive_qc_floors"][1] <= \
            st2["queries_per_cluster_cap"]
        # raising the budget invalidates the converged marker: the
        # same stream re-adapts and scans drop-free
        ivf.scan_budget_bytes = 2 << 30
        ivf._stream_qc_floors = {}
        _, st3 = ivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
        assert st3["dropped_probe_pairs"] == 0, st3
    finally:
        ivf_mod._stream_peak_loads = real
