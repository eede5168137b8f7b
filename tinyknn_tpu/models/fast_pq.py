"""FastPQ: 4-bit product quantizer, batched for an accelerator.

Same capability as the reference FastPQ (reference: tinyknn/fast_pq.py):
fit 16-center codebooks per block of ``dims_per_block`` dims, encode data
to 4-bit codes, build per-query int8 distance tables, estimate distances
with a table-sum scan, and run the two-pass (estimate -> exact rescore)
top-k. Differences are all accelerator-first by design:

  * codes live as plain ``uint8[n_pad, n_blocks]`` tiles (nibble-packed
    in device memory) — not the Quick-ADC pshufb layout;
  * the scan is an int8 one-hot matrix product accumulated in int32
    (no saturating-int8 semantics; see ops/scan.py);
  * every entry point is batched over queries and jit-compiled — the
    reference's per-query Python loops become a leading batch axis;
  * codebook training is one vmapped k-means++/Lloyd computation instead
    of a Python loop of sklearn fits.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kmeans import blockwise_kmeans
from ..ops.quantization import (
    QuantizedTables,
    block_dists_blocked,
    dequantize_estimates,
    quantize_tables_signed,
    quantize_tables_unsigned,
    tables_bf16,
)
from ..ops.packing import pack_codes
from ..ops.scan import estimate_scan
from ..utils.padding import pad2, round_up

ROW_PAD = 8       # row alignment of the code matrix
BLOCK_PAD = 8     # block-count alignment => one-hot width is a multiple of 128


class TransformedData(NamedTuple):
    """Encoded dataset: true row count + nibble-packed code matrix.

    Mirrors the reference's ``TransformedData(size, packed)``
    (tinyknn/fast_pq.py:30). ``packed`` is uint8[n_pad, n_blocks // 2]
    — two 4-bit codes per byte, the same 4 bits/block storage cost as
    the reference's Quick-ADC layout (tinyknn/_transform.py:4-77) —
    zero-padded rows beyond ``size``. Scans unpack fused into the
    one-hot expansion; ``codes`` materializes the unpacked
    uint8[n_pad, n_blocks] view for inspection/tests.
    """
    size: int
    packed: jax.Array

    @property
    def codes(self):
        """Unpacked uint8[n_pad, n_blocks] view (values 0..15)."""
        from ..ops.packing import unpack_codes
        return unpack_codes(self.packed)


class FastPQ:
    """4-bit product quantizer (reference: tinyknn/fast_pq.py:33-252)."""

    def __init__(self, dims_per_block=2, use_kmeans=True, rotate_dim=64,
                 seed=0, kmeans_iters=25, kmeans_n_init=2,
                 table_dtype="int8"):
        assert table_dtype in ("int8", "bf16", "f32")
        self.dims_per_block = dims_per_block
        self.use_kmeans = use_kmeans
        self.rotate_dim = rotate_dim
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.kmeans_n_init = kmeans_n_init
        # "int8": the reference's quantized tables (equal memory, int8
        # matrix products). "bf16"/"f32": unquantized — slightly better
        # tail ranks (no rounding error).
        self.table_dtype = table_dtype
        self.centers = None        # (16, d) f32, reference layout
        self.center_blocks = None  # (B, 16, dpb) f32
        self.sqrt_n_blocks = None
        self.R = None              # optional (d_out, d_in) rotation

    # ------------------------------------------------------------- fit

    def fit(self, data, verbose=False):
        """Fit per-block codebooks (reference: tinyknn/fast_pq.py:50-104).

        Pads rows/cols, optionally applies a random orthogonal
        rotation/projection to ``rotate_dim`` dims (skipped when the raw
        dimensionality is exactly 100, matching the reference's GloVe
        special case at fast_pq.py:77), then fits 16 centers per block —
        all blocks at once via a vmapped k-means++/Lloyd.
        """
        data = np.asarray(data, dtype=np.float32)
        assert data.size > 0, "Can't fit no data"
        true_n, true_d = data.shape
        dpb = self.dims_per_block

        data = pad2(data, ROW_PAD, BLOCK_PAD * dpb)
        n, d = data.shape

        if self.rotate_dim is not None and true_d != 100:
            rng = np.random.default_rng(self.seed)
            q, _ = np.linalg.qr(rng.standard_normal((d, d)))
            R = np.ascontiguousarray(q.T, dtype=np.float32)
            if d > self.rotate_dim:
                d = round_up(self.rotate_dim, BLOCK_PAD * dpb)
                R = R[:d]
            self.R = jnp.asarray(R)
            data = data @ np.asarray(R).T

        B = d // dpb
        cols = jnp.asarray(
            np.ascontiguousarray(
                data.reshape(n, B, dpb).transpose(1, 0, 2)))
        if self.use_kmeans:
            centers = blockwise_kmeans(
                jax.random.PRNGKey(self.seed), cols, k=16,
                iters=self.kmeans_iters, n_init=self.kmeans_n_init)
        else:
            centers = _fixed_gaussian_code(np.asarray(cols), dpb)
        self.center_blocks = jnp.asarray(centers, jnp.float32)  # (B, 16, dpb)
        self.centers = jnp.asarray(
            np.asarray(self.center_blocks).transpose(1, 0, 2).reshape(16, d))
        self.sqrt_n_blocks = float(np.sqrt(B))
        return self

    def fit_transform(self, data, verbose=False):
        return self.fit(data, verbose).transform(data, verbose)

    # ------------------------------------------------------------ encode

    def transform(self, data, verbose=False) -> TransformedData:
        """Encode rows to 4-bit codes (reference: tinyknn/fast_pq.py:147-184).

        Accepts NumPy or JAX arrays; a JAX input stays on device
        (no host readback).
        """
        assert self.centers is not None, "PQ has not been fitted"
        if not isinstance(data, jnp.ndarray):
            data = np.asarray(data, dtype=np.float32)
        if data.size == 0:
            B = self.center_blocks.shape[0]
            return TransformedData(0, jnp.zeros((0, B // 2), jnp.uint8))
        true_n = data.shape[0]
        data = pad2(jnp.asarray(data, jnp.float32), ROW_PAD,
                    BLOCK_PAD * self.dims_per_block)
        codes = _encode(data, self.center_blocks, self.R,
                        self.dims_per_block)
        return TransformedData(true_n, pack_codes(codes))

    # ----------------------------------------------------- distance tables

    def distance_table(self, q):
        """Signed int8 distance table(s) for query/queries ``q``.

        Accepts (d,) or (Q, d); batched everywhere downstream.
        Reference: tinyknn/fast_pq.py:186-222.
        """
        return self._table(q, signed=True)

    def udistance_table(self, q):
        """Unsigned-scheme tables (reference: tinyknn/fast_pq.py:224-252)."""
        return self._table(q, signed=False)

    def _table(self, q, signed: bool):
        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        raw_q = jnp.asarray(q)
        qt = _build_tables(raw_q, self.center_blocks, self.R,
                           self.dims_per_block, signed, self.table_dtype)
        return _FastDistanceTable(self, qt, raw_q, single)

    # ------------------------------------------------------------ search

    def search(self, q, transformed_data, data, k=1, rescore=None,
               method="auto", signed=True):
        """Fully fused batched search: tables + estimate + two-pass top-k
        in a single jitted computation (one device dispatch).

        Equivalent to ``distance_table(q).top(...)`` but without the
        host round-trip between the two stages; this is the serving
        path. Returns (Q, k) indices, or (k,) for a single query.
        """
        qn = np.asarray(q, dtype=np.float32)
        single = qn.ndim == 1
        if single:
            qn = qn[None]
        true_n, codes = transformed_data
        data = jnp.asarray(data, jnp.float32)
        k = min(k, true_n)
        if not rescore:
            rescore = min(2 * k + 10, true_n)
        assert true_n >= rescore >= k
        idx = _fused_search(jnp.asarray(qn), codes, data,
                            self.center_blocks, self.R,
                            self.dims_per_block, signed, true_n, k,
                            rescore, _resolve_method(method),
                            self.table_dtype)
        return idx[0] if single else idx


def _fixed_gaussian_code(cols, dpb):
    """Data-independent ring code for dpb=2 (reference: fast_pq.py:127-144).

    A fixed 16-point code (center + two rings) affinely matched to each
    block's mean/covariance via a Cholesky factor.
    """
    assert dpb == 2, "Fixed code only defined for dpb = 2"
    base = np.array(
        [(0.0, 0.0)]
        + [(r * np.cos(th), r * np.sin(th))
           for r, num in zip([1, 2], [6, 9])
           for th in np.linspace(0, 2 * np.pi, num, endpoint=False)],
        dtype=np.float64)
    out = []
    for col in cols:  # (n, 2)
        mu = np.mean(col, axis=0)
        S = np.cov(col.T, bias=True)
        S = np.atleast_2d(S) + 1e-9 * np.eye(2)
        out.append(base @ np.linalg.cholesky(S).T + mu)
    return np.stack(out).astype(np.float32)  # (B, 16, 2)


@partial(jax.jit, static_argnames=("dpb", "chunk"))
def _encode(data, center_blocks, R, dpb: int, chunk: int = 65536):
    if R is not None:
        data = data @ R.T
    n, d = data.shape
    B = d // dpb
    cn = jnp.einsum("bkd,bkd->bk", center_blocks, center_blocks)

    def assign(rows):  # (m, d) -> (m, B) uint8
        cols = rows.reshape(rows.shape[0], B, dpb)
        # argmin over 16 centers per block: -2<x,c> + ||c||^2 suffices
        d2 = (jnp.einsum("nbd,bkd->nbk", cols, center_blocks) * -2.0
              + cn[None])
        return jnp.argmin(d2, axis=2).astype(jnp.uint8)

    if n <= chunk:
        return assign(data)
    n_pad = n + (-n) % chunk
    padded = jnp.pad(data, ((0, n_pad - n), (0, 0)))
    out = jax.lax.map(assign, padded.reshape(-1, chunk, d))
    return out.reshape(n_pad, B)[:n]


@partial(jax.jit, static_argnames=("dpb", "signed", "table_dtype"))
def _build_tables(q, center_blocks, R, dpb: int, signed: bool,
                  table_dtype: str = "int8"):
    Q, true_d = q.shape
    B = center_blocks.shape[0]
    d_in = B * dpb if R is None else R.shape[1]
    q = jnp.pad(q, ((0, 0), (0, d_in - true_d)))
    if R is not None:
        q = q @ R.T
    q_blocks = q.reshape(Q, B, dpb)
    dists = block_dists_blocked(q_blocks, center_blocks)
    if table_dtype == "bf16":
        return tables_bf16(dists)
    if table_dtype == "f32":
        from ..ops.quantization import QuantizedTables
        return QuantizedTables(dists, jnp.zeros((Q,), jnp.float32),
                               jnp.ones((Q,), jnp.float32), True)
    if signed:
        return quantize_tables_signed(dists)
    return quantize_tables_unsigned(dists)


class _FastDistanceTable:
    """Batched distance table (reference: tinyknn/fast_pq.py:255-312)."""

    def __init__(self, pq: FastPQ, qt: QuantizedTables, raw_q, single: bool):
        self.pq = pq
        self.qt = qt
        self.raw_q = raw_q
        self.single = single

    @property
    def tables(self):
        return self.qt.tables

    def __repr__(self):
        return (f"FastDistanceTable(Q={self.qt.tables.shape[0]}, "
                f"n_blocks={self.qt.n_blocks}, signed={self.qt.signed})")

    def estimate_distances(self, transformed_data, out=None, rescale=False):
        """int32 estimated table-sums (or f32 sq-dists when rescale).

        Reference: tinyknn/fast_pq.py:270-282; int32 accumulation
        replaces the saturated int8 output.
        """
        del out  # API parity only
        true_n, codes = transformed_data
        est = estimate_scan(codes, self.qt.tables, packed=True)
        est = est[:, :true_n]
        if rescale:
            est = dequantize_estimates(est, self.qt)
        return est[0] if self.single else est

    def top(self, transformed_data, data, k=1, rescore=None, method="auto"):
        """Two-pass top-k: estimate -> exact fp32 rescore.

        Reference: tinyknn/fast_pq.py:284-312. Returns (Q, k) indices,
        or (k,) for a single query. ``method`` selects the pass-1
        candidate collector: 'exact' (lax.top_k) or 'approx'
        (lax.approx_max_k, which has no approximate lowering on the GPU
        or the CPU and selects exactly there); 'auto' is 'exact'.
        """
        true_n, codes = transformed_data
        data = jnp.asarray(data, jnp.float32)
        assert data.shape[0] == true_n
        k = min(k, true_n)
        if not rescore:
            rescore = min(2 * k + 10, true_n)
        assert true_n >= rescore >= k
        idx = _two_pass_top(codes, self.qt.tables, self.raw_q, data,
                            true_n, k, rescore, _resolve_method(method))
        return idx[0] if self.single else idx


def _resolve_method(method: str) -> str:
    """'auto' -> 'exact': on the GPU and the CPU approx_max_k has no
    approximate lowering and selects exactly."""
    if method == "auto":
        return "exact"
    assert method in ("exact", "approx")
    return method


def pass1_topk(neg_vals, k: int, method: str):
    """Pass-1 candidate collection: lax.top_k or lax.approx_max_k."""
    if method == "approx":
        return jax.lax.approx_max_k(neg_vals.astype(jnp.float32), k)
    return jax.lax.top_k(neg_vals, k)


@partial(jax.jit, static_argnames=("dpb", "signed", "true_n", "k",
                                   "rescore", "method", "table_dtype"))
def _fused_search(q, codes, data, center_blocks, R, dpb: int, signed: bool,
                  true_n: int, k: int, rescore: int, method: str,
                  table_dtype: str = "int8"):
    qt = _build_tables(q, center_blocks, R, dpb, signed, table_dtype)
    return _two_pass_top(codes, qt.tables, q, data, true_n, k, rescore,
                         method)


@partial(jax.jit, static_argnames=("true_n", "k", "rescore", "method"))
def _two_pass_top(codes, tables, raw_q, data, true_n: int, k: int,
                  rescore: int, method: str):
    est = estimate_scan(codes, tables, packed=True)  # (Q, n_pad)
    n_pad = codes.shape[0]
    if n_pad > true_n:
        mask = jnp.arange(n_pad) < true_n
        big = (jnp.inf if jnp.issubdtype(est.dtype, jnp.floating)
               else jnp.iinfo(jnp.int32).max)
        est = jnp.where(mask[None, :], est, big)
    _, cand = pass1_topk(-est, rescore, method)      # (Q, rescore)
    if rescore <= k:
        return cand
    gathered = data[cand]                            # (Q, rescore, d)
    diff = gathered - raw_q[:, None, :]
    d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
    _, best = jax.lax.top_k(-d2, k)
    return jnp.take_along_axis(cand, best, axis=1)
