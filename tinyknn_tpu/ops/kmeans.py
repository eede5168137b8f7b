"""Jitted KMeans: k-means++ init + chunked Lloyd iterations.

Replaces the reference's two sklearn.KMeans call sites:
  * per-block 16-center PQ codebook fits (reference: tinyknn/fast_pq.py:109-145)
    — here a single ``vmap`` over all blocks at once instead of a Python
    loop of d/dpb sklearn fits;
  * the IVF coarse clustering (reference: tinyknn/ivf.py:31-45).

Accelerator-first structure: the assignment step is an (n, d) x (d, k)
matrix product; the centroid update is a one-hot matmul (counts & sums) instead
of a scatter; both run inside a ``lax.scan`` over fixed-size row chunks
so memory stays bounded at any n. Shapes are static; masked padding rows
carry zero weight.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.padding import round_up


def _pairwise_sq(X, C):
    """(n, d), (k, d) -> (n, k) squared distances, matmul form."""
    xn = jnp.einsum("ij,ij->i", X, X)
    cn = jnp.einsum("ij,ij->i", C, C)
    inner = jax.lax.dot_general(
        X, C, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    return xn[:, None] + cn[None, :] - 2.0 * inner


INIT_POOL_FACTOR = 16  # k-means++ candidate pool: INIT_POOL_FACTOR * k rows


def _init_pool(key, n: int, k: int):
    """Row indices of the k-means++ candidate pool.

    Seeding on the full dataset costs one full-data pass *per center*
    (bandwidth-bound: ~500 GB of device-memory reads at 1.2M rows x 1k
    centers);
    a 16k-point pool preserves seeding quality at a fraction of the
    traffic — the same tradeoff sklearn's MiniBatchKMeans makes.
    """
    pool = min(n, max(2048, INIT_POOL_FACTOR * k))
    if pool == n:
        return None
    return jax.random.permutation(key, n)[:pool]


def _plus_plus_init(key, X, w, k: int):
    """k-means++ seeding. X: (n, d) f32, w: (n,) weights (0 for padding)."""
    n = X.shape[0]
    k0, key = jax.random.split(key)
    logits0 = jnp.where(w > 0, 0.0, -jnp.inf)
    first = jax.random.categorical(k0, logits0)
    min_d2 = jnp.sum((X - X[first]) ** 2, axis=1)

    def step(carry, key_i):
        min_d2, _ = carry
        scores = min_d2 * w
        logits = jnp.log(jnp.maximum(scores, 1e-30))
        # If every point has zero score (k > #distinct points), fall back
        # to uniform over valid rows.
        degenerate = jnp.max(scores) <= 0
        logits = jnp.where(degenerate, logits0, logits)
        idx = jax.random.categorical(key_i, logits)
        c = X[idx]
        min_d2 = jnp.minimum(min_d2, jnp.sum((X - c) ** 2, axis=1))
        return (min_d2, idx), c

    keys = jax.random.split(key, k - 1)
    (_, _), rest = jax.lax.scan(step, (min_d2, first), keys)
    return jnp.concatenate([X[first][None], rest], axis=0)


def _lloyd_iter(X, w, C, chunk: int):
    """One Lloyd iteration with chunked assignment+accumulation."""
    n, d = X.shape
    k = C.shape[0]
    n_chunks = n // chunk
    Xc = X.reshape(n_chunks, chunk, d)
    wc = w.reshape(n_chunks, chunk)

    def body(carry, xs):
        sums, counts, inertia = carry
        Xi, wi = xs
        d2 = _pairwise_sq(Xi, C)
        assign = jnp.argmin(d2, axis=1)
        best = jnp.min(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * wi[:, None]
        sums = sums + jax.lax.dot_general(
            onehot, Xi, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(onehot, axis=0)
        inertia = inertia + jnp.sum(jnp.maximum(best, 0.0) * wi)
        return (sums, counts, inertia), None

    init = (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32),
            jnp.float32(0.0))
    (sums, counts, inertia), _ = jax.lax.scan(body, init, (Xc, wc))
    new_C = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), C)
    return new_C, counts, inertia


def _relocate_empty(C, counts, Xp, wp):
    """Re-seed empty clusters at far points (sklearn-style relocation).

    sklearn reassigns empty clusters to the points with the largest
    inertia contribution; scanning all of X for them every iteration would
    cost a full extra pass, so candidates come from the (16k-row)
    k-means++ pool — the far-point tail is dense there. Empty cluster
    #e (in cluster order) takes the pool point with the e-th largest
    min-distance to the current centers. Static shapes throughout.
    """
    k = C.shape[0]
    kf = min(k, Xp.shape[0])  # tiny datasets: fewer candidates than k
    d2 = _pairwise_sq(Xp, C).min(axis=1)
    d2 = jnp.where(wp > 0, d2, -jnp.inf)              # ignore padding
    _, far = jax.lax.top_k(d2, kf)                    # far pool rows
    empty = counts <= 0
    rank = jnp.cumsum(empty.astype(jnp.int32)) - 1    # e-th empty -> e
    repl = Xp[far[jnp.clip(rank, 0, kf - 1)]]
    return jnp.where(empty[:, None], repl, C)


@partial(jax.jit, static_argnames=("k", "iters", "chunk"))
def _kmeans_single(key, X, w, k: int, iters: int, chunk: int):
    kp, key = jax.random.split(key)
    pool = _init_pool(kp, X.shape[0], k)
    if pool is None:
        Xp, wp = X, w
    else:
        Xp, wp = X[pool], w[pool]
    C0 = _plus_plus_init(key, Xp, wp, k)

    def body(C, _):
        C, counts, inertia = _lloyd_iter(X, w, C, chunk)
        C = _relocate_empty(C, counts, Xp, wp)
        return C, inertia

    C, inertias = jax.lax.scan(body, C0, None, length=iters)
    return C, inertias[-1]


def kmeans_fit(X, k: int, *, key=None, iters: int = 25, n_init: int = 1,
               chunk: int = 16384):
    """Fit k centers to rows of X. Returns (centers (k, d) f32, inertia).

    ``n_init`` independent runs keep the best inertia, mirroring
    sklearn's n_init (reference uses n_init=2 for PQ blocks,
    tinyknn/fast_pq.py:117, and n_init=1 for the coarse index,
    tinyknn/ivf.py:32).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape
    assert n >= 1
    chunk = min(chunk, round_up(n, 8))
    n_pad = round_up(n, chunk)
    w = jnp.ones((n,), jnp.float32)
    if n_pad != n:
        X = jnp.pad(X, ((0, n_pad - n), (0, 0)))
        w = jnp.pad(w, (0, n_pad - n))

    best_C, best_inertia = None, None
    for i in range(n_init):
        C, inertia = _kmeans_single(jax.random.fold_in(key, i), X, w, k,
                                    iters, chunk)
        if best_inertia is None or float(inertia) < float(best_inertia):
            best_C, best_inertia = C, inertia
    return best_C, best_inertia


@partial(jax.jit, static_argnames=("k", "iters", "chunk", "n_init"))
def blockwise_kmeans(key, cols, k: int = 16, iters: int = 25,
                     chunk: int = 16384, n_init: int = 2):
    """Fit k centers independently for each block column.

    ``cols``: (B, n, dpb) f32 — the d/dpb block columns. Returns
    (B, k, dpb) centers. This is the reference's per-block sklearn loop
    (tinyknn/fast_pq.py:117-125) as one jitted computation. All blocks
    advance together *inside* a single chunked scan over rows — a vmap
    of whole-array kmeans would buffer per-block copies of the data and
    blow device memory at millions of rows; this formulation's live set is one
    (B, chunk, k) block regardless of n.
    """
    B, n, dpb = cols.shape
    c = min(chunk, round_up(n, 8))
    n_pad = round_up(n, c)
    w = jnp.ones((n,), jnp.float32)
    if n_pad != n:
        cols = jnp.pad(cols, ((0, 0), (0, n_pad - n), (0, 0)))
        w = jnp.pad(w, (0, n_pad - n))
    n_chunks = n_pad // c
    cols_c = cols.reshape(B, n_chunks, c, dpb).transpose(1, 0, 2, 3)
    w_c = w.reshape(n_chunks, c)
    barange = jnp.arange(B)
    kp, key = jax.random.split(key)
    pool = _init_pool(kp, n, k)
    cols_i = cols if pool is None else cols[:, pool, :]  # (B, n_i, dpb)
    w_i = w if pool is None else w[pool]
    n_i = cols_i.shape[1]
    logits0 = jnp.broadcast_to(jnp.where(w_i > 0, 0.0, -jnp.inf), (B, n_i))

    def ppp_init(key):
        """Batched k-means++ over all B blocks at once (pooled rows)."""
        k0, key = jax.random.split(key)
        first = jax.random.categorical(k0, logits0, axis=-1)     # (B,)
        c0 = cols_i[barange, first]                              # (B, dpb)
        min_d2 = jnp.sum((cols_i - c0[:, None, :]) ** 2, axis=-1)

        def step(carry, key_i):
            min_d2 = carry
            scores = min_d2 * w_i[None, :]
            logits = jnp.log(jnp.maximum(scores, 1e-30))
            degenerate = jnp.max(scores, axis=1, keepdims=True) <= 0
            logits = jnp.where(degenerate, logits0, logits)
            idx = jax.random.categorical(key_i, logits, axis=-1)
            cc = cols_i[barange, idx]                            # (B, dpb)
            min_d2 = jnp.minimum(
                min_d2, jnp.sum((cols_i - cc[:, None, :]) ** 2, axis=-1))
            return min_d2, cc

        keys = jax.random.split(key, k - 1)
        _, rest = jax.lax.scan(step, min_d2, keys)               # (k-1, B, dpb)
        return jnp.concatenate([c0[None], rest], axis=0).transpose(1, 0, 2)

    def lloyd_iter(C):
        """One Lloyd step for all blocks, chunked over rows."""
        cn = jnp.einsum("bkd,bkd->bk", C, C)

        def body(carry, xs):
            sums, counts, inertia = carry
            x, wi = xs                                  # (B, c, dpb), (c,)
            d2 = cn[:, None, :] - 2.0 * jnp.einsum(
                "bcd,bkd->bck", x, C)                    # (B, c, k) + ||x||²
            assign = jnp.argmin(d2, axis=2)
            xn = jnp.einsum("bcd,bcd->bc", x, x)
            best = jnp.min(d2, axis=2) + xn
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            onehot = onehot * wi[None, :, None]
            sums = sums + jnp.einsum("bck,bcd->bkd", onehot, x)
            counts = counts + jnp.sum(onehot, axis=1)
            inertia = inertia + jnp.sum(
                jnp.maximum(best, 0.0) * wi[None, :], axis=1)
            return (sums, counts, inertia), None

        init = (jnp.zeros((B, k, dpb), jnp.float32),
                jnp.zeros((B, k), jnp.float32), jnp.zeros((B,), jnp.float32))
        (sums, counts, inertia), _ = jax.lax.scan(body, init, (cols_c, w_c))
        newC = jnp.where(counts[..., None] > 0,
                         sums / jnp.maximum(counts[..., None], 1.0), C)
        return newC, counts, inertia

    def relocate(C, counts):
        """Per-block empty-cluster relocation (see _relocate_empty)."""
        xn = jnp.einsum("bnd,bnd->bn", cols_i, cols_i)
        cn = jnp.einsum("bkd,bkd->bk", C, C)
        d2 = (xn[:, :, None] + cn[:, None, :]
              - 2.0 * jnp.einsum("bnd,bkd->bnk", cols_i, C))
        d2min = jnp.where(w_i[None, :] > 0, jnp.min(d2, axis=2), -jnp.inf)
        kf = min(k, n_i)  # tiny datasets: fewer candidates than k
        _, far = jax.lax.top_k(d2min, kf)              # (B, kf)
        empty = counts <= 0
        rank = jnp.cumsum(empty.astype(jnp.int32), axis=1) - 1
        sel = jnp.take_along_axis(far, jnp.clip(rank, 0, kf - 1), axis=1)
        repl = cols_i[barange[:, None], sel]           # (B, k, dpb)
        return jnp.where(empty[..., None], repl, C)

    best_C, best_inertia = None, None
    for i in range(n_init):
        C = ppp_init(jax.random.fold_in(key, i))

        def body(C, _):
            C, counts, inertia = lloyd_iter(C)
            C = relocate(C, counts)
            return C, inertia

        C, inertias = jax.lax.scan(body, C, None, length=iters)
        inertia = inertias[-1]                                   # (B,)
        if best_C is None:
            best_C, best_inertia = C, inertia
        else:
            take = (inertia < best_inertia)[:, None, None]
            best_C = jnp.where(take, C, best_C)
            best_inertia = jnp.minimum(inertia, best_inertia)
    return best_C
