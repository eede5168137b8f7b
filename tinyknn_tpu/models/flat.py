"""Flat (exact brute-force) index.

The reference exposes brute-force search only as utility functions
(knn_brute / knn_brute1); on an accelerator exact search over a few
million vectors is a single matrix product + top_k and deserves an index-shaped API of its
own — it is both the ground-truth generator for benchmarks and a
perfectly usable index at small scale.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.bruteforce import knn_brute, l2_normalize


class Flat:
    """Exact nearest-neighbor index with the IVF calling convention."""

    def __init__(self, metric="euclidean"):
        assert metric in ["euclidean", "angular"]
        self.metric = metric
        self.data = None

    def fit(self, X, verbose=False):
        return self

    def build(self, X, n_probes=None, verbose=False):
        X = jnp.asarray(X, jnp.float32)
        if self.metric == "angular":
            X = l2_normalize(X)
        self.data = X
        return self

    def query(self, q, k, n_probes=None, pass_1=None):
        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        k = min(k, int(self.data.shape[0]))
        idx = knn_brute(q, self.data, k, metric=self.metric)
        return idx[0] if single else idx
