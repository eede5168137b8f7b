"""Exact (brute-force) distance math — both library code and test oracle.

Accelerator counterpart of the reference's NumPy brute-force layer
(reference: tinyknn/utils.py:22-92). Where the reference chunks matmuls
in Python to stay inside CPU cache, here everything is a single jitted
XLA computation: the (n, d) x (d, m) distance matmul, and
``jax.lax.top_k`` replaces argpartition.

All functions accept NumPy or JAX arrays and return JAX arrays.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def sq_dists(X, Y):
    """Squared Euclidean distances: R[i, j] = ||X_i - Y_j||^2.

    Computed as ||x||^2 + ||y||^2 - 2<x, y> with the inner-product term
    a float32 matrix product.

    precision=HIGHEST everywhere: this is the library's ground-truth
    oracle. A matmul at DEFAULT precision rounds its f32 inputs (to
    TF32 on the GPU), which swaps near-tie ids: a truth computed with
    bf16-rounded inputs once carried ~2% wrong top-10 ids on the
    GloVe-shape clustered data (docs/PERFORMANCE.md).
    """
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    nx = jnp.einsum("ij,ij->i", X, X, precision=hi)
    ny = jnp.einsum("ij,ij->i", Y, Y, precision=hi)
    inner = jax.lax.dot_general(
        X, Y,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=hi,
    )
    return nx[:, None] + ny[None, :] - 2.0 * inner


def cdist(X, Y, chunk: int | None = None):
    """Squared Euclidean cdist (reference: tinyknn/utils.py:44-63).

    ``chunk`` is accepted for API parity but ignored: XLA tiles the
    matmul itself.
    """
    del chunk
    return sq_dists(X, Y)


def l2_normalize(X, axis=-1, eps=0.0):
    X = jnp.asarray(X, jnp.float32)
    norm = jnp.linalg.norm(X, axis=axis, keepdims=True)
    if eps:
        norm = jnp.maximum(norm, eps)
    return X / norm


@partial(jax.jit, static_argnames=("k",))
def bottom_k(arr, k: int):
    """Indices of the k smallest entries (sorted by value ascending).

    Mirrors reference tinyknn/utils.py:22-25: if k >= len(arr), returns
    arange(len(arr)).
    """
    arr = jnp.asarray(arr)
    if k >= arr.shape[0]:
        return jnp.arange(arr.shape[0])
    _, idx = jax.lax.top_k(-arr, k)
    return idx


@partial(jax.jit, static_argnames=("k",))
def bottom_k_2d(arr, k: int):
    """Row-wise indices of the k smallest entries per row.

    Mirrors reference tinyknn/utils.py:28-31: if k >= n_cols, returns
    arange(n_cols) broadcast over rows.
    """
    arr = jnp.asarray(arr)
    n, m = arr.shape
    if k >= m:
        return jnp.broadcast_to(jnp.arange(m), (n, m))
    _, idx = jax.lax.top_k(-arr, k)
    return idx


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def _knn_brute_jit(X, Y, k: int, metric: str, chunk: int):
    if metric == "angular":
        X = l2_normalize(X)
        Y = l2_normalize(Y)
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    n, d = X.shape
    m = Y.shape[0]
    # Bound the live (chunk, m) distance block to ~1 GB regardless of
    # target-set size.
    budget_rows = max(8, (1 << 28) // max(m, 1))
    chunk = min(chunk, budget_rows - budget_rows % 8 or 8)
    if n <= chunk:
        _, idx = jax.lax.top_k(-sq_dists(X, Y), k)
        return idx
    # Memory-bounded path: scan fixed-size row chunks so the (n, m)
    # distance matrix never materializes (the device analogue of the
    # reference's cache-friendly chunking, tinyknn/utils.py:81-85).
    n_pad = n + (-n) % chunk
    Xp = jnp.pad(X, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, d)
    yn = jnp.einsum("ij,ij->i", Y, Y,
                precision=jax.lax.Precision.HIGHEST)

    def body(Xi):
        hi = jax.lax.Precision.HIGHEST
        xn = jnp.einsum("ij,ij->i", Xi, Xi, precision=hi)
        d2 = xn[:, None] + yn[None, :] - 2.0 * jax.lax.dot_general(
            Xi, Y, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=hi)
        _, idx = jax.lax.top_k(-d2, k)
        return idx

    idx = jax.lax.map(body, Xp).reshape(n_pad, k)
    return idx[:n]


def knn_brute(X, Y, k, metric="euclidean", chunk=65536):
    """Exact kNN of each row of X among the rows of Y.

    Returns an (n, k) index array, nearest first (the reference's
    argpartition output is unordered; sorted output satisfies the same
    contract). Reference: tinyknn/utils.py:66-86. ``chunk`` bounds the
    live distance-matrix memory for large n.
    """
    if metric not in ("euclidean", "angular"):
        raise ValueError(f"Metric not supported: {metric}")
    assert k <= Y.shape[0], f"Can't find knn with {k=} and {Y.shape[0]} targets."
    return _knn_brute_jit(jnp.asarray(X), jnp.asarray(Y), int(k), metric,
                          int(chunk) if chunk else 65536)


@partial(jax.jit, static_argnames=("k",))
def knn_brute1(x, Y, k: int):
    """Single-query exact kNN (reference: tinyknn/utils.py:89-92)."""
    x = jnp.asarray(x, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    diff = Y - x
    dists = jnp.einsum("ij,ij->i", diff, diff,
                       precision=jax.lax.Precision.HIGHEST)
    return bottom_k(dists, k)
