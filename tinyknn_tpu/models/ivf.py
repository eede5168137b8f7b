"""IVF: inverted-file index over FastPQ codes, batched for an accelerator.

Same capability as the reference IVF (reference: tinyknn/ivf.py:8-163):
coarse k-means clustering, build-time spill of each point into its
``build_probes`` nearest lists, query-time scan of the ``n_probes``
nearest lists with a shared candidate pool, exact fp32 rescore.

Accelerator-first re-design (none of this is a translation):

  * inverted lists are CSR-tiled: codes live in a flat tile array
    ``csr_codes[T, B/2, 128]`` (nibble-packed blocks on the middle
    axis, points on the last) where list i owns ``ceil(len_i / 128)``
    consecutive tiles starting at ``tile_offsets[i]``, with flat ids
    ``csr_ids[T * 128]`` (-1 = padding) — instead of Python lists of
    arrays (reference: tinyknn/ivf.py:14,100-102). Memory is
    ~len-rounded-to-128 per list (reference-equal 4 bits/block plus
    <=6% tile padding); the earlier dense pad-to-max-length grid
    wasted ~2.5x on Zipf-ish cluster sizes;
  * queries are processed in batches and *bucketed by cluster*: the
    (query, probe) pairs of a batch are inverted into per-cluster query
    lists, so each list is scanned once per batch for every query
    probing it (the CSR kernel, ops/kernels.py, on the GPU; a one-hot
    int8 matrix product in XLA elsewhere). A per-query Python loop over
    clusters (reference: tinyknn/ivf.py:140-150) would leave the
    device idle;
  * the shared Cython heap becomes: per-(cluster, query) top-r, a
    gather-back, sort-based dedup of build-spill duplicates, and a final
    ``lax.top_k`` (see ops/topk.py);
  * probe selection uses exact fp32 distances to the active centers —
    at ~sqrt(n) centers this is one tiny matrix product; the reference's
    PQ-estimate + rescore of the centers (tinyknn/ivf.py:128-131) is a
    CPU-side economy with strictly worse recall.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.bruteforce import knn_brute
from ..utils.grouping import invert_assignments_csr_tiled
from ..utils.padding import round_up
from ..utils.timing import timer
from ..ops import platform
from ..ops.kernels import (ENC_INVALID, csr_fold_scan, int8_col_bits,
                           kernel_tables)
from ..ops.kmeans import kmeans_fit
from ..ops.packing import LANE_TILE, pack_codes_tiled, unpack_codes
from ..ops.topk import dedup_candidates
from .fast_pq import FastPQ, _build_tables, _resolve_method, pass1_topk

FOLD_MULT = 8       # fold-width headroom over r (see _fold_tiles)


def _tiles_to_dense(csr_codes, tile_offsets, max_tiles: int):
    """Gather each list's tiles into a dense (C, cap, Bs) view.

    The XLA fallback scan and the gather (latency) mode want dense
    per-list blocks; a list is ``max_tiles`` consecutive tiles starting
    at ``tile_offsets`` (over-reads into the next list are masked by
    counts downstream). tile_offsets may be any integer shape (...,);
    output is (..., max_tiles * 128, Bs).
    """
    T = csr_codes.shape[0]
    idx = tile_offsets[..., None] + jnp.arange(max_tiles, dtype=jnp.int32)
    idx = jnp.minimum(idx, T - 1)
    tiles = csr_codes[idx]            # (..., mt, Bs, 128)
    tiles = jnp.swapaxes(tiles, -1, -2)   # (..., mt, 128, Bs)
    shape = tiles.shape[:-3] + (max_tiles * LANE_TILE, tiles.shape[-1])
    return tiles.reshape(shape)


def _rows_of(tile_offsets, cap: int, n_rows: int):
    """Flat row indices (..., cap) of each list's slots in csr_ids /
    flat vector space (clipped; over-read masked by counts)."""
    rows = (tile_offsets.astype(jnp.int32) * LANE_TILE)[..., None] \
        + jnp.arange(cap, dtype=jnp.int32)
    return jnp.minimum(rows, n_rows - 1)


class IVF:
    """Inverted-file ANN index (reference: tinyknn/ivf.py)."""

    # ShardedIVF derives per-shard raw/augmented arrays in _place();
    # the base build skips the single-device versions for it
    _sharded = False

    def __init__(self, metric, n_clusters, pq=None, seed=0,
                 kmeans_iters=30, queries_per_cluster=None,
                 pass1_method="auto", scan_impl="auto",
                 fold_mult=FOLD_MULT, rescore_rows=False,
                 scan_budget_bytes=2 << 30):
        """``scan_impl``: 'auto' (the CSR kernel over PQ codes on the
        GPU when its encoding fits, else the XLA scan), 'fused' (the
        kernel), 'xla', or 'exact' — a mode beyond the reference: raw
        bf16 vectors ride the CSR tiles and the scan computes true
        squared distances (no PQ estimate; the pass-1 pool collapses to ~4k and a thin
        exact f32 rescore fixes bf16 near-tie swaps). 4x the memory of
        4-bit codes at dims_per_block=2; exact-rank quality. Opt-in
        because PQ is the capacity story — see docs/PERFORMANCE.md.

        ``rescore_rows``: store a CSR-ordered copy of the raw vectors
        at build (+1 data copy in device memory) so the rescore gathers by flat
        row directly and ids decode only for the final winners —
        removes one of the two multi-million-element gathers that
        dominate the PQ-path query.

        ``scan_budget_bytes``: ceiling for the (C, qc, S) bucket-scan
        grids that bucket capacities (adaptive stream floors and the
        query drop-retry caps) may grow into. On extremely skewed
        streams (peak per-cluster load 30x+ the mean) the default 2 GB
        clamps the capacity below the measured peak and the residual
        drops surface in ``with_stats``; raise it to trade memory and
        scan time for drop-free streams (or pin queries_per_cluster).
        """
        assert metric in ["euclidean", "angular"]
        self.metric = metric
        self.pq = FastPQ(dims_per_block=2) if pq is None else pq
        assert self.pq.centers is None, "PQ should not be pre-fitted"
        self.n_clusters = n_clusters
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.queries_per_cluster = queries_per_cluster
        self.pass1_method = pass1_method
        self.scan_impl = scan_impl
        self.fold_mult = fold_mult
        self.scan_budget_bytes = int(scan_budget_bytes)
        self.list_counts = None  # (C,) int32 true list lengths
        self.all_centers = None
        self.active_centers = None
        self.rescore_rows = rescore_rows
        self.csr_codes = None    # (T, B/2, 128) uint8 code tiles
        self.csr_vecs = None     # (T, d_aug, 128) bf16 (exact mode)
        self.csr_raw = None      # (T * 128, d) f32 (rescore_rows)
        self.csr_ids = None      # (T * 128,) int32, -1 padding
        self.tile_offsets = None  # (C,) int32, list i starts at tile [i]
        self.max_tiles = None    # host int: longest list in tiles
        self.data = None         # (n, d) f32 (normalized when angular)
        self.labels = None       # optional (n,) int64 user labels

    # --------------------------------------------------------------- fit

    def fit(self, X, verbose=False):
        """Coarse clustering + PQ codebook fit (reference: ivf.py:19-51)."""
        X = np.asarray(X, dtype=np.float32)
        n, d = X.shape
        assert n >= 1
        with timer(verbose, "Fitting IVF cluster centers..."):
            if self.metric == "angular":
                X = X / np.linalg.norm(X, axis=1, keepdims=True)
            centers, _ = kmeans_fit(
                X, min(self.n_clusters, n),
                key=jax.random.PRNGKey(self.seed),
                iters=self.kmeans_iters, n_init=1)
            centers = np.asarray(centers)
            if self.metric == "angular":
                norms = np.linalg.norm(centers, axis=1, keepdims=True)
                centers = centers / np.maximum(norms, 1e-12)
            self.all_centers = centers
        with timer(verbose, "Fitting PQ to data..."):
            self.pq.fit(X, verbose=verbose)
        return self

    # ------------------------------------------------------------- build

    def build(self, X, n_probes=2, labels=None, verbose=False):
        """Assign points to their n_probes nearest lists and encode them.

        Reference: tinyknn/ivf.py:53-104. The padded-grid layout means
        "transform each group" becomes: encode all rows once, then
        gather into the grid.

        ``labels``: optional (n,) int64 user labels. Internally points
        ride as int32 *positional* row ids (the corpus is capped at
        2^31 rows — asserted below); queries then map winners through
        this table host-side, so arbitrary 64-bit labels survive the
        whole pack -> scan -> dedup -> rescore pipeline (the reference
        threads int64 labels through its kernel heap instead:
        tinyknn/_fast_pq.pyx:117, tests/test_pq.py:143-158). Label-
        mapped query results come back as NumPy int64 arrays. Note:
        duplicate labels are treated as distinct points (positional
        dedup happens before mapping).
        """
        assert self.all_centers is not None, (
            "IVF has not been fitted: call fit(X) before build(X)")
        assert n_probes <= self.n_clusters, (
            f"Can't assign points to {n_probes} clusters, as index only "
            f"has {self.n_clusters}")
        assert X.shape[0] < 2**31, (
            "corpus capped at 2^31 rows (int32 positional ids); shard "
            "the index (parallel.ShardedIVF) or split it")
        if labels is not None:
            labels = np.asarray(labels, dtype=np.int64).reshape(-1)
            assert labels.shape[0] == X.shape[0], (
                "labels must have one entry per data row")
            self.labels = labels
        else:
            self.labels = None
        # One upload; everything else stays on device.
        data = jnp.asarray(X, jnp.float32)
        if self.metric == "angular":
            norms = jnp.linalg.norm(data, axis=1, keepdims=True)
            data = data / jnp.maximum(norms, 1e-30)
        self.data = data

        with timer(verbose, "Computing nearest clusters..."):
            n_probes_eff = min(n_probes, len(self.all_centers))
            self.build_probes = n_probes_eff
            nearest = np.asarray(knn_brute(
                data, self.all_centers, k=n_probes_eff, metric=self.metric))

        with timer(verbose, "Activating non-empty centers..."):
            active = np.unique(nearest)
            remap = np.full(len(self.all_centers), -1, dtype=np.int32)
            remap[active] = np.arange(len(active), dtype=np.int32)
            nearest = remap[nearest]
            self.active_centers = jnp.asarray(
                np.ascontiguousarray(self.all_centers[active],
                                     dtype=np.float32))

        with timer(verbose, "Encoding points into lists..."):
            # codes arrive nibble-packed (4 bits/block, reference-equal
            # memory: tinyknn/_transform.py:4-77) and are laid out CSR:
            # each list = ceil(len/128) consecutive (B/2, 128) tiles.
            # The scans unpack on-chip.
            true_n, codes = self.pq.transform(data)
            flat_ids, toff, counts = invert_assignments_csr_tiled(
                nearest, len(active), tile=LANE_TILE)
            self.csr_ids = jnp.asarray(flat_ids)
            # Device-side gather into tiles; padding slots reuse row 0's
            # codes but are masked by list counts at query time.
            self.csr_codes = pack_codes_tiled(codes, self.csr_ids)
            self.tile_offsets = jnp.asarray(toff)
            self.list_counts = jnp.asarray(counts.astype(np.int32))
            self.max_tiles = max(
                1, int(-(-int(counts.max(initial=0)) // LANE_TILE)))
        if self.scan_impl == "exact":
            assert self.max_tiles * LANE_TILE <= 1 << 16, (
                "exact mode: longest list exceeds the 16-bit fold "
                "position field; raise n_clusters")
            if not self._sharded:  # ShardedIVF._place re-derives
                with timer(verbose, "Storing raw vector tiles..."):
                    self.csr_vecs = _augment_data_csr(data, self.csr_ids)
        if self.rescore_rows and not self._sharded:
            # (the sharded path always rescores by row from its
            # per-shard vecs_l and defers id decode — no copy needed)
            with timer(verbose, "Storing CSR-ordered raw rows..."):
                self.csr_raw = _csr_raw_rows(data, self.csr_ids)
        return self

    def set_scan_impl(self, scan_impl):
        """Switch the list-scan engine on a built index, rebuilding the
        engine's derived state (exact mode's bf16 vector tiles /
        rescore_rows' raw-row copy are derived from (data, csr_ids),
        so archives are scan-engine-independent)."""
        assert scan_impl in ("auto", "fused", "xla", "exact")
        self.scan_impl = scan_impl
        if (scan_impl == "exact" and self.csr_vecs is None
                and self.csr_ids is not None):
            assert self.max_tiles * LANE_TILE <= 1 << 16, (
                "exact mode: longest list exceeds the 16-bit fold "
                "position field; raise n_clusters")
            self.csr_vecs = _augment_data_csr(self.data, self.csr_ids)
        elif scan_impl != "exact":
            # free the bf16 tile copy on disable (symmetric with
            # set_rescore_rows; it is derived state, rebuilt on demand)
            self.csr_vecs = None
        return self

    def set_rescore_rows(self, enabled=True):
        """Toggle the CSR-ordered raw-row rescore copy on a built
        index (see the constructor's ``rescore_rows``)."""
        self.rescore_rows = enabled
        if enabled and self.csr_raw is None and self.csr_ids is not None:
            self.csr_raw = _csr_raw_rows(self.data, self.csr_ids)
        if not enabled:
            self.csr_raw = None
        return self

    # ------------------------------------------------------------- query

    def query(self, q, k, n_probes=1, pass_1=None, mode="auto",
              with_stats=False):
        """Top-k ids for one query or a (Q, d) batch.

        Reference: tinyknn/ivf.py:106-163. Returns (k,) for a single
        query or (Q, k) for a batch; slots that found no valid candidate
        (possible only when fewer than k points are reachable) hold -1.

        ``mode``: 'bucket' (cluster-bucketed shared-matrix scan — the
        throughput path), 'gather' (per-query list gather — lower
        latency for small batches), or 'auto'. ``with_stats=True``
        additionally returns a diagnostics dict (probe pairs dropped by
        the bucket capacity, configured capacities).

        Exact-mode cost note (``scan_impl='exact'``): the default f32
        rescore sliver is ``4*k*n_probes`` — LINEAR in ``n_probes``,
        deliberately uncapped (near-ties at the selection boundary grow
        with the number of scanned lists; a fixed cap measurably loses
        recall at P>=3, docs/PERFORMANCE.md). Raising ``n_probes`` on
        an exact-mode index therefore grows the (Q, 4kP, d) rescore
        gather and the tail fold width proportionally — unlike the PQ
        path, where ``pass_1`` alone sets the rescore width. Pass an
        explicit ``pass_1`` to pin the sliver (floored at k).
        """
        assert self.csr_codes is not None, (
            "IVF index is empty: call fit(X) and build(X) before query")
        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        # Deep candidate budget (r) for each query's nearest cluster (it
        # holds most true neighbors and estimate noise makes depth
        # matter); shallow budget (r_tail) for the remaining probes — a
        # distant cluster can contribute at most a few winners.
        k, n_probes, pass_1, r, r_tail, qc, qc0 = _query_params(
            self, q.shape[0], k, n_probes, pass_1)
        method = _resolve_method(self.pass1_method)
        fold_mult = getattr(self, "fold_mult", FOLD_MULT)
        scan_impl = _resolve_scan_impl(self)
        if scan_impl in ("exact", "exact_xla"):
            assert self.csr_vecs is not None, (
                "exact mode requires an index built with "
                "scan_impl='exact' (raw vector tiles)")
        if mode == "auto":
            mode = "gather" if q.shape[0] * n_probes <= 64 else "bucket"

        if mode == "gather":
            out = _ivf_query_gather(
                jnp.asarray(q), self.pq.center_blocks, self.pq.R,
                self.active_centers,
                self.csr_vecs if self.scan_impl == "exact"
                else self.csr_codes,
                self.csr_ids, self.tile_offsets, self.list_counts,
                self.data, dpb=self.pq.dims_per_block, metric=self.metric,
                k=k, n_probes=n_probes, pass_1=pass_1,
                max_tiles=self.max_tiles,
                table_dtype=self.pq.table_dtype,
                exact=self.scan_impl == "exact")
            # host array like the bucket path (whose drop check
            # device_gets) — the public return type must not depend on
            # which mode 'auto' picked
            out = jax.device_get(out)
            dropped = np.int32(0)
        else:
            # Drop-aware escalation: a skewed query batch (everyone near
            # the same clusters) can overflow the bucket capacity, and a
            # retry at 4x capacity is cheap relative to losing probes.
            # Both rounds escalate — round 0 (each query's nearest
            # cluster) concentrates the worst skew, e.g. a batch of
            # near-duplicate queries all landing in one list. The check
            # is free per successful call: (out, dropped) come back in
            # ONE device_get (the caller needs out on the host anyway),
            # so it defaults on for every batch size — clustered
            # real-world queries skew at ANY batch size (a round-3
            # GloVe sweep lost 1-2pp recall at P>=3/Q=10k to silent
            # tail-round drops before this). queries_per_cluster pins
            # the capacity and disables the escalation.
            check_drops = not self.queries_per_cluster
            attempts = 3 if check_drops else 1
            # If the budget-bounded cap still drops pairs (pathological
            # skew), the final attempt's count surfaces in with_stats.
            qc_full, qc0_full = _qc_caps(
                self, q.shape[0], n_probes, r, r_tail, qc, qc0,
                fold_mult)
            codes_arg = (self.csr_vecs if self.scan_impl == "exact"
                         else self.csr_codes)
            for _attempt in range(attempts):
                out, dropped = _ivf_query(
                    jnp.asarray(q), self.pq.center_blocks, self.pq.R,
                    self.active_centers, codes_arg, self.csr_ids,
                    self.tile_offsets, self.list_counts,
                    self.data, self.csr_raw,
                    dpb=self.pq.dims_per_block, metric=self.metric,
                    k=k, n_probes=n_probes, pass_1=pass_1, r=r,
                    r_tail=r_tail, qc=qc, qc0=qc0, method=method,
                    scan_impl=scan_impl, max_tiles=self.max_tiles,
                    build_probes=getattr(self, "build_probes", 2),
                    table_dtype=self.pq.table_dtype,
                    fold_mult=fold_mult,
                    scan_budget_bytes=self.scan_budget_bytes)
                # one transfer for both: the drop check costs no extra
                # host round trip on the (overwhelmingly common) clean
                # attempt
                out, dropped = jax.device_get((out, dropped))
                if _attempt + 1 == attempts or int(dropped) == 0:
                    break
                if _attempt + 2 == attempts:  # last try: can't-drop caps
                    qc, qc0 = qc_full, qc0_full
                else:
                    qc = min(round_up(4 * qc, 8), qc_full)
                    qc0 = min(round_up(4 * qc0, 8), qc0_full)
        out = out[0] if single else out
        out = _map_labels(self.labels, out)
        if with_stats:
            return out, {
                "mode": mode,
                "dropped_probe_pairs": int(dropped),
                "total_probe_pairs": int(q.shape[0]) * n_probes,
                "queries_per_cluster_cap": qc,
                "queries_per_cluster_cap_round0": qc0,
                "pass_1": pass_1,
                "per_pair_candidates": (r, r_tail),
            }
        return out


def _map_labels(labels, out):
    """Map positional ids -> user labels (host-side; -1 stays -1).

    int64 labels cannot ride device arrays without jax_enable_x64, so
    the (Q, k) winner block is mapped on the host — the same readback
    the caller does anyway to consume results."""
    if labels is None:
        return out
    out = np.asarray(out)
    return np.where(out >= 0, labels[np.maximum(out, 0)], np.int64(-1))


@jax.jit
def _csr_raw_rows(data, flat_ids):
    """CSR-ordered copy of the raw rows (padding slots reuse row 0;
    they are masked by validity wherever the copy is read)."""
    return data[jnp.maximum(flat_ids, 0)]


def _aug_dim(d: int) -> int:
    """Width of the augmented exact-scan vectors: [x (d) | norm_hi |
    norm_lo | 1] padded to a multiple of 16 (the kernel contracts it in
    power-of-two pieces of at least 16)."""
    return round_up(d + 3, 16)


@jax.jit
def _augment_data_csr(data, flat_ids):
    """Raw vectors -> the exact-scan kernel's CSR tile layout.

    data: f32[n, d] (normalized already for angular); flat_ids:
    int32[T * 128] CSR row ids (padding reuses row 0, masked by
    counts). Returns bf16[T, d_aug, 128]: points on the last axis,
    augmented dims on the middle — [x, hi(||x||^2), lo(||x||^2), 1,
    0...]. The
    norm rides as a two-term bf16 hi/lo split (~16 significant bits);
    with the query side's [-2q, 1, 1, ||q||^2] the kernel's single
    matmul yields the true squared distance (>= 0, so the IEEE-bit
    fold encoding stays order-preserving)."""
    d = data.shape[1]
    rows = data[jnp.maximum(flat_ids, 0)]             # (T*128, d) f32
    xn = jnp.einsum("nd,nd->n", rows, rows,
                    precision=jax.lax.Precision.HIGHEST)
    hi = xn.astype(jnp.bfloat16).astype(jnp.float32)
    aug = jnp.zeros((rows.shape[0], _aug_dim(d)), jnp.float32)
    aug = aug.at[:, :d].set(rows)
    aug = aug.at[:, d].set(hi)
    aug = aug.at[:, d + 1].set(xn - hi)
    aug = aug.at[:, d + 2].set(1.0)
    T = flat_ids.shape[0] // LANE_TILE
    return (aug.astype(jnp.bfloat16)
            .reshape(T, LANE_TILE, -1).transpose(0, 2, 1))


def _augment_queries(q):
    """f32[Q, d] -> bf16[Q, d_aug] in the exact-scan query layout
    [-2q, 1, 1, ||q||^2, 0...]. ||q||^2 rides in one bf16 slot — its
    rounding error is constant per query, so candidate *ranking* is
    unaffected (unlike the per-point norms, which get the hi/lo
    split)."""
    d = q.shape[1]
    qn = jnp.einsum("qd,qd->q", q, q,
                    precision=jax.lax.Precision.HIGHEST)
    aug = jnp.zeros((q.shape[0], _aug_dim(d)), jnp.float32)
    aug = aug.at[:, :d].set(-2.0 * q)
    aug = aug.at[:, d].set(1.0)
    aug = aug.at[:, d + 1].set(1.0)
    aug = aug.at[:, d + 2].set(qn)
    return aug.astype(jnp.bfloat16)


def _fold_tiles(r: int, max_tiles: int, mult: int = FOLD_MULT,
                budget_tiles: int = 0) -> int:
    """Fold width (in 128-point tiles) for the CSR kernel, never wider
    than the longest list: at least ``mult``x headroom over r, which
    keeps position-class collisions (the fold's approximation) rare,
    and up to ``budget_tiles`` — the widest (C, qc, S) fold grid the
    scan budget admits. A fold as wide as the list has no collisions,
    so the kernel then selects exactly what the XLA scan selects."""
    return max(1, min(max_tiles, max(-(-mult * r // LANE_TILE),
                                     budget_tiles)))


def _fused_ok(pq, cap: int) -> bool:
    """Whether the CSR kernel's int32 value+position encoding fits
    lists of ``cap`` points (int8 tables: value bits + position bits;
    bf16/f32 tables: bf16 bits << 16 | 16-bit position)."""
    if pq.table_dtype == "int8":
        return int8_col_bits(cap, pq.center_blocks.shape[0]) is not None
    return cap <= 1 << 16


def _resolve_scan_impl(self) -> str:
    """The list scan this index runs on this platform: 'fused' or
    'exact' (the CSR kernel over PQ codes or exact vector tiles), or
    'xla' or 'exact_xla' (the plain XLA scans). The kernel is the
    default on the GPU wherever its encoding fits; on the CPU only an
    explicit scan_impl='fused' runs it (in interpret mode)."""
    kernels = platform.use_kernels()
    if self.scan_impl == "exact":
        return "exact" if kernels else "exact_xla"
    if self.scan_impl == "auto":
        cap = self.max_tiles * LANE_TILE
        return "fused" if kernels and _fused_ok(self.pq, cap) else "xla"
    return self.scan_impl


def _cluster_chunk(n_clusters: int, cap: int, qc: int, row_bytes: int,
                   budget: int) -> int:
    """Clusters the XLA list scan densifies per lax.map step: as many
    as keep the step's (CH, cap) expanded rows (``row_bytes`` each) and
    its (CH, qc, cap) 4-byte estimates, twice over for temporaries,
    under ``budget`` bytes (IVF ``scan_budget_bytes``)."""
    per_cluster = 2 * cap * (row_bytes + 4 * qc)
    return max(1, min(n_clusters, budget // per_cluster))


def _exact_widths(mult, max_tiles, n_active, qc, qc0, k, pass_1,
                  n_probes=1):
    """Exact-mode fold widths (shared by the single-chip and sharded
    paths): (r, r_tail, pass_1) such that _fold_tiles(r, ...) hits the
    target tile widths — full longest list for round 0 under a ~512 MB
    (C, qc, S) grid budget, a narrower budgeted fold for tails."""
    b0_tiles = max(1, (512 << 20)
                   // (4 * max(n_active, 1) * qc0 * LANE_TILE))
    bt_tiles = max(1, (512 << 20)
                   // (4 * max(n_active, 1) * qc * LANE_TILE))
    # floor at k: the selection width p1 = f * pass_1 feeds a final
    # top_k(k), so a user pass_1 < k must not shrink it below k.
    # Default sliver width scales with n_probes: selection ranks by the
    # bf16-rounded scan distance, and the number of candidates tied at
    # the selection boundary grows with the number of scanned lists —
    # at GloVe scale a fixed 4k sliver tracks the probe-coverage
    # ceiling at P=1 but loses ~0.9pp of recall at P=3, and a 12k cap
    # loses 0.3pp again at P=4. Measured (docs/PERFORMANCE.md): 4kP
    # recovers the ceiling exactly at every probed P, so the default is
    # linear in P, uncapped — the same scaling the reference gives its
    # pass-1 pool ((P+1)k+1, reference ivf.py:135) — and the f32
    # rescore cost is linear in it.
    base = max(pass_1 if pass_1 is not None else 4 * k * max(n_probes, 1),
               k)
    w0 = max(min(max_tiles, b0_tiles),
             -(-mult * max(4 * k, 32) // LANE_TILE))
    wt = max(min(max_tiles, bt_tiles,
                 -(-mult * max(base, 2 * k) // LANE_TILE)),
             -(-mult * 16 // LANE_TILE))
    return (-(-w0 * LANE_TILE // mult), -(-wt * LANE_TILE // mult),
            base)


def _query_params(self, Q, k, n_probes, pass_1, qc_min=0, qc0_min=0,
                  n_active=None, n_probes_max=None):
    """Shared query-shape parameter derivation — the ONE source of
    truth for qc/qc0/r/r_tail/pass_1 sizing, used by IVF.query,
    IVF.query_stream, ShardedIVF.query and ShardedIVF.query_stream
    (the sharded paths inject their per-shard view instead of
    re-implementing the arithmetic).

    ``qc_min``/``qc0_min``: capacity floors from a measured per-cluster
    load (the adaptive stream pre-pass) — they raise the mean-load
    heuristic, never lower it, and an explicit ``queries_per_cluster``
    pin still overrides both. ``n_active``: cluster count the bucket
    capacities and fold budgets are sized against (a shard passes its
    LOCAL cluster count; Q is then the local query count). ``n_probes_
    max``: probe clamp (a shard passes the GLOBAL active count — probes
    select globally even though capacity is local)."""
    if n_active is None:
        n_active = self.active_centers.shape[0]
    n_probes = min(n_probes, n_probes_max if n_probes_max is not None
                   else self.active_centers.shape[0])
    k = min(k, int(self.data.shape[0]))
    cap = self.max_tiles * LANE_TILE
    qc = self.queries_per_cluster or max(
        8, round_up(5 * Q * n_probes // (2 * max(n_active, 1)) + 1, 8),
        qc_min)
    qc0 = self.queries_per_cluster or max(default_qc0(Q, n_active),
                                          qc0_min)
    if self.scan_impl == "exact":
        # Exact distances need no estimate-noise depth: selection
        # keeps only ~k candidates. What matters is FOLD WIDTH — two
        # top-k ids of one list landing in the same position class
        # lose one of them unrecoverably (round-3 sweep: recall
        # saturated at 0.949 with a 384-slot round-0 fold because the
        # nearest list holds ~93% of true neighbors). Round 0 therefore
        # folds over the WHOLE longest list (zero collisions) whenever
        # the (C, qc0, S) fold grid stays under a ~512 MB HBM budget;
        # tail lists hold few true neighbors each, so they get a
        # narrower budgeted fold that a user pass_1 can widen. r and
        # r_tail only drive _fold_tiles here (W = ceil(mult*r/128)),
        # so they are derived from the target widths in tiles. The
        # returned pass_1 (~4k) sizes the thin exact f32 rescore that
        # fixes bf16 near-tie swaps (see _ivf_query step 5).
        mult = getattr(self, "fold_mult", FOLD_MULT) or FOLD_MULT
        r, r_tail, pass_1 = _exact_widths(
            mult, self.max_tiles, n_active, qc, qc0, k, pass_1,
            n_probes=n_probes)
    else:
        if pass_1 is None:
            pass_1 = (n_probes + 1) * k + 1
        pass_1 = max(pass_1, k)  # p1 feeds a final top_k(k)
        r = min(pass_1, cap)
        r_tail = min(pass_1, cap, max(3 * k, 16))
        pass_1 = min(pass_1, r + (n_probes - 1) * r_tail)
    return k, n_probes, pass_1, r, r_tail, qc, qc0


def _qc_caps(self, Q, n_probes, r, r_tail, qc, qc0, fold_mult,
             n_active=None):
    """Can't-drop bucket-capacity caps for the drop-retry escalation,
    bounded by a ~2 GB scan-grid budget: unbounded qc_full = Q*P would
    size the (C, qc, S) fold/bucket grids in the hundreds of GB at
    10k-query batches. Shared by IVF.query and ShardedIVF.query (which
    passes its local query/cluster counts)."""
    if n_active is None:
        n_active = self.active_centers.shape[0]
    s0_w = _fold_tiles(r, self.max_tiles, fold_mult) * LANE_TILE
    st_w = _fold_tiles(r_tail, self.max_tiles, fold_mult) * LANE_TILE
    budget = getattr(self, "scan_budget_bytes", 2 << 30)
    qc_cap = max(qc, budget // max(1, 4 * n_active * st_w))
    qc0_cap = max(qc0, budget // max(1, 4 * n_active * s0_w))
    qc_full = min(round_up(Q * n_probes, 8), round_up(qc_cap, 8))
    qc0_full = min(round_up(Q, 8), round_up(qc0_cap, 8))
    return qc_full, qc0_full


def _stream_adaptive_params(self, batches, k_arg, p_arg, p1_arg, params,
                            fold_mult, Q=None, n_active=None,
                            n_probes_max=None):
    """Adaptive stream bucket capacities (shared by the single-chip and
    sharded query_stream): measure the stream's peak per-cluster load
    once per (Q, n_probes) shape (cached floor), clamp the floor by the
    same scan-grid budget as the drop-retry caps, and re-derive the
    query parameters with the floors injected. Returns
    ``(params, floors, cache_key, measured_now)``; if the (free,
    piggybacked) drop
    counter fires anyway the caller re-measures the floor on the
    dropping stream (_refresh_stream_floors — drift handling that
    converges, unlike blind escalation); ``measured_now`` in the return
    tells that caller the floors were measured on THIS stream, so a
    drop can only be the budget clamp (skip the redundant re-measure).

    ``Q``/``n_active``/``n_probes_max`` parameterize _query_params for
    the sharded view (local query count / local clusters / global probe
    clamp); the floors are also clamped by ``Q`` (a cluster cannot
    receive more pairs than local queries in either round). The peak
    load is measured GLOBALLY (probe selection is replicated), which
    for a query-sharded mesh upper-bounds every device's local load —
    conservative, never lossy."""
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    if Q is None:
        Q = batches.shape[1]
    cache = getattr(self, "_stream_qc_floors", None)
    if cache is None:
        cache = self._stream_qc_floors = {}
    key = (Q, n_probes)
    measured_now = key not in cache
    if measured_now:
        m0, mt = jax.device_get(_stream_peak_loads(
            batches, self.active_centers, n_probes=n_probes,
            metric=self.metric))
        cache[key] = (_qc_bucket(int(m0)), _qc_bucket(int(mt)))
    floors = cache[key]
    if floors[0] > qc0 or floors[1] > qc:
        # clamp the floors by the scan-grid budget (the same bound
        # query()'s can't-drop retry uses, via _qc_caps — one source
        # of truth), then re-derive: in exact mode the fold widths
        # adapt to the new capacity
        qc_full, qc0_full = _qc_caps(self, Q, 1, r, r_tail, qc,
                                     qc0, fold_mult, n_active=n_active)
        f0 = min(floors[0], qc0_full)
        ft = min(floors[1], qc_full)
        params = _query_params(self, Q, k_arg, p_arg, p1_arg,
                               qc_min=ft, qc0_min=f0, n_active=n_active,
                               n_probes_max=n_probes_max)
        # report the APPLIED floors: when the budget clamp bites, the
        # raw measured floors would claim the peak was covered while
        # the scan runs at the clamped capacity (auditability of
        # scan_budget_bytes — advisor r5)
        floors = (f0, ft)
    return params, floors, key, measured_now


def _refresh_stream_floors(self, key, batches, n_probes,
                           just_measured=False):
    """A stream dropped pairs despite adaptive capacities. Two causes:

    * query drift — the cached floor was measured on an earlier
      same-shape stream with hotter-or-colder data. Response:
      RE-MEASURE the pre-pass on THIS stream (one small dispatch) and
      cache the exact floor, so the next same-shape stream is clean
      after at most one recompile.
    * the scan-grid budget clamp — the measured floor exceeds what the
      ~2 GB budget admits, so capacity is (correctly) pinned below the
      true peak and drops are the budget's price. Re-measuring returns
      the same floor, the cache does NOT change, and subsequent calls
      keep the compiled shape. (The previous blind-4x escalation kept
      inflating the cached floors past the clamp — including round
      0's, which wasn't even dropping — which changed qc0 every call
      and forced a RECOMPILE PER CALL: the round-5 euclid-at-scale
      P=3/4 '3k QPS' collapse, examples/r5_euclid_stream_diag.py.)
    """
    final = getattr(self, "_stream_floor_final", None)
    if final is None:
        final = self._stream_floor_final = set()
    # budget-keyed: raising scan_budget_bytes can unclamp a floor, so
    # the converged marker must not survive a budget change
    fkey = (key, getattr(self, "scan_budget_bytes", 2 << 30))
    if fkey in final:
        return  # budget-clamped steady state: re-measuring can't help
    if just_measured:
        # the floor was measured on THIS stream in this very call, so
        # a drop can only be the budget clamp — re-measuring the same
        # batches would return the same floor; mark final immediately
        # and save the extra pre-pass dispatch
        final.add(fkey)
        return
    m0, mt = jax.device_get(_stream_peak_loads(
        batches, self.active_centers, n_probes=n_probes,
        metric=self.metric))
    floors = (_qc_bucket(int(m0)), _qc_bucket(int(mt)))
    if floors == self._stream_qc_floors.get(key):
        # the cached floor already covers the true peak but the budget
        # clamp keeps capacity below it — drops are the budget's price;
        # stop paying a pre-pass dispatch on every future call
        final.add(fkey)
    self._stream_qc_floors[key] = floors


def _qc_bucket(n: int) -> int:
    """Round a measured per-cluster load up to a power-of-two capacity
    (>= 8): adapted capacities move in coarse steps so distinct stream
    executables stay few (qc is a static shape parameter)."""
    if n <= 0:
        return 0
    return max(8, 1 << (int(n) - 1).bit_length())


@partial(jax.jit, static_argnames=("n_probes", "metric"))
def _stream_peak_loads(batches, active_centers, *, n_probes, metric):
    """Max per-cluster (query, probe)-pair load across a stream,
    split round 0 (each query's nearest cluster) vs tail probes —
    exactly the loads the bucket capacities qc0/qc must cover for a
    drop-free scan. Mirrors _ivf_query's probe selection arithmetic
    bit-for-bit (same normalize / qn + cn - 2qc / top_k) so the
    measured loads are the loads the scan will see."""
    cn = jnp.einsum("cd,cd->c", active_centers, active_centers,
                    precision=jax.lax.Precision.HIGHEST)
    C = active_centers.shape[0]

    def body(q):
        if metric == "angular":
            q = q / jnp.maximum(
                jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        qn = jnp.einsum("qd,qd->q", q, q,
                    precision=jax.lax.Precision.HIGHEST)
        d2c = qn[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
            q, active_centers, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        _, sel = jax.lax.top_k(-d2c, n_probes)
        load0 = jnp.zeros((C,), jnp.int32).at[sel[:, 0]].add(1)
        if n_probes > 1:
            loadt = jnp.zeros((C,), jnp.int32).at[
                sel[:, 1:].reshape(-1)].add(1)
        else:
            loadt = jnp.zeros((C,), jnp.int32)
        return jnp.max(load0), jnp.max(loadt)

    m0, mt = jax.lax.map(body, batches)
    return jnp.max(m0), jnp.max(mt)


class _StreamMixin:
    """query_stream: many batches per device dispatch (the serving
    shape — a stream pays the per-call dispatch and host sync once)."""

    def query_stream(self, batches, k, n_probes=1, pass_1=None,
                     with_stats=False, adaptive_qc=True,
                     device_out=False):
        """Top-k ids for a (R, Q, d) stream of query batches.

        Runs all R batches inside ONE jitted computation (lax.map), so
        per-call dispatch/readback latency is amortized across the
        stream; returns (R, Q, k) int32.

        ``device_out=True`` returns ``(out, dropped)`` as DEVICE arrays
        (positional int32 ids — no label mapping, no host transfer):
        the pipelined-serving form, where results feed the next
        on-device stage and the host never pays the (R, Q, k)
        download. The adaptive drop-refresh check is skipped (it needs
        the drop counter on the host) — materialize ``dropped`` and
        consult ``with_stats`` on a host-path call to audit drops.

        Unlike ``query`` there is no drop-RETRY escalation (a retry
        would have to re-run the whole stream). Instead, with
        ``adaptive_qc=True`` (the default) the stream self-tunes its
        bucket capacities: the first call at a given (Q, n_probes)
        shape runs a tiny pre-pass (probe selection + per-cluster load
        count — one extra small dispatch, amortized to zero across the
        stream's life) and raises the capacities to cover the measured
        peak load, so skewed batches scan drop-free; the floors are
        cached per shape and later calls skip the pre-pass but check
        the (free, piggybacked) drop counter and escalate the cached
        floor if query drift ever overflows it — that one stream's
        drops are visible via ``with_stats``. Floors are clamped by
        the same ~2 GB scan-grid budget as ``query``'s escalation, so
        pathological skew (every query in one cluster at huge Q)
        degrades to bounded, auditable drops rather than OOM. Pinning
        ``queries_per_cluster`` disables all of it.

        ``with_stats=True`` additionally returns a stats dict with the
        total (query, probe) pairs dropped by bucket-capacity overflow
        across the stream.
        """
        assert self.csr_codes is not None, (
            "IVF index is empty: call fit(X) and build(X) before query")
        if device_out and with_stats:
            raise ValueError(
                "device_out=True returns device arrays and cannot build "
                "the host-side stats dict; audit drops on a host-path "
                "call (with_stats=True, device_out=False)")
        batches = jnp.asarray(batches, jnp.float32)
        R, Q, d = batches.shape
        method = _resolve_method(self.pass1_method)
        fold_mult = getattr(self, "fold_mult", FOLD_MULT)
        adaptive = bool(adaptive_qc) and not self.queries_per_cluster
        k_arg, p_arg, p1_arg = k, n_probes, pass_1
        params = _query_params(self, Q, k, n_probes, pass_1)
        floors, key, fresh = (0, 0), None, False
        if adaptive:
            params, floors, key, fresh = _stream_adaptive_params(
                self, batches, k_arg, p_arg, p1_arg, params, fold_mult)
        k, n_probes, pass_1, r, r_tail, qc, qc0 = params
        scan_impl = _resolve_scan_impl(self)
        if scan_impl in ("exact", "exact_xla"):
            assert self.csr_vecs is not None, (
                "exact mode requires an index built with "
                "scan_impl='exact' (raw vector tiles)")
        codes_arg = (self.csr_vecs if self.scan_impl == "exact"
                     else self.csr_codes)
        out, dropped = _ivf_query_stream(
            batches, self.pq.center_blocks, self.pq.R,
            self.active_centers, codes_arg, self.csr_ids,
            self.tile_offsets, self.list_counts,
            self.data, self.csr_raw,
            dpb=self.pq.dims_per_block, metric=self.metric,
            k=k, n_probes=n_probes, pass_1=pass_1, r=r, r_tail=r_tail,
            qc=qc, qc0=qc0, method=method, scan_impl=scan_impl,
            max_tiles=self.max_tiles,
            build_probes=getattr(self, "build_probes", 2),
            table_dtype=self.pq.table_dtype, fold_mult=fold_mult,
            scan_budget_bytes=self.scan_budget_bytes)
        if device_out:
            return out, dropped
        # one transfer for both (the caller consumes out on the host
        # anyway): the drop check is free per clean call, like query()'s
        out, dropped = jax.device_get((out, dropped))
        if adaptive and int(dropped):
            _refresh_stream_floors(self, key, batches, n_probes,
                                   just_measured=fresh)
        out = _map_labels(self.labels, out)
        if with_stats:
            return out, {
                "dropped_probe_pairs": int(dropped),
                "total_probe_pairs": R * Q * n_probes,
                "queries_per_cluster_cap": qc,
                "queries_per_cluster_cap_round0": qc0,
                "adaptive_qc_floors": floors if adaptive else None,
                "pass_1": pass_1,
            }
        return out


IVF.query_stream = _StreamMixin.query_stream


@partial(jax.jit, static_argnames=("dpb", "metric", "k", "n_probes",
                                   "pass_1", "r", "r_tail", "qc", "qc0",
                                   "method", "scan_impl", "max_tiles",
                                   "build_probes", "table_dtype",
                                   "fold_mult", "scan_budget_bytes"))
def _ivf_query_stream(batches, center_blocks, R, active_centers,
                      csr_codes, csr_ids, tile_offsets, list_counts,
                      data, csr_raw=None, **kw):
    def body(q):
        return _ivf_query.__wrapped__(
            q, center_blocks, R, active_centers, csr_codes, csr_ids,
            tile_offsets, list_counts, data, csr_raw, **kw)

    out, dropped = jax.lax.map(body, batches)
    return out, jnp.sum(dropped)


def _bucket_scan_round(probe_sub, tables_flat, csr_codes, csr_ids,
                       tile_offsets, list_counts, qc: int,
                       r: int, method: str, scan_impl: str,
                       max_tiles: int, fold_mult: int = FOLD_MULT,
                       scan_budget_bytes: int = 2 << 30):
    """One bucketed scan round over a probe subset.

    probe_sub: (Q, Ps) cluster ids. Buckets the (query, probe) pairs by
    cluster (sort + run-position, static capacity ``qc``), scans each
    cluster once for all the queries probing it, and gathers each
    pair's candidate pool back per query.

    scan_impl 'fused' / 'exact' run the CSR kernel (ops/kernels.py):
    only actual list tiles are scanned, and the pool is the kernel's
    fold buffer (W = fold width >= r). Returns the pool *in the encoded
    int32 domain*: ``(enc int32[Q, Ps, S], rowbase int32[Q, Ps],
    dropped)`` with S = fold width; global selection runs on the
    encoding directly and only the survivors are decoded
    (_select_pool_enc). 'xla' / 'exact_xla' are the plain XLA scans
    and the kernel's oracle: they densify each list to ``max_tiles``
    tiles per cluster chunk, contract it with the bucketed PQ tables
    (one-hot int8 codes) or augmented queries (bf16 vector tiles) and
    extract top-``r`` per pair, returning decoded ``(vals f32[Q, Ps,
    r], rows int32[Q, Ps, r], dropped)`` — scanned distances (+inf = no
    candidate) and flat csr row indices.
    """
    Q, Ps = probe_sub.shape
    C = tile_offsets.shape[0]
    n_rows = csr_ids.shape[0]
    cap = max_tiles * LANE_TILE
    M = tables_flat.shape[1]                          # 16 * B

    pairs = probe_sub.reshape(-1)                     # (Q*Ps,)
    q_of_pair = jnp.arange(Q * Ps, dtype=jnp.int32) // Ps
    order = jnp.argsort(pairs, stable=True)
    sorted_c = pairs[order]
    sorted_q = q_of_pair[order]
    pos = jnp.arange(Q * Ps, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_c[1:] != sorted_c[:-1]])
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0), axis=0)
    slot = pos - run_start                            # position within run
    in_cap = slot < qc
    # scatter query ids into the (C, qc) grid; overflow pairs fall out
    # of bounds and are dropped (qc is sized so this is rare; raise
    # queries_per_cluster to eliminate it)
    qgrid = jnp.full((C, qc), -1, jnp.int32)
    qgrid = qgrid.at[jnp.where(in_cap, sorted_c, C),
                     jnp.minimum(slot, qc - 1)].set(sorted_q, mode="drop")
    slot_orig = jnp.zeros((Q * Ps,), jnp.int32).at[order].set(slot)
    slot_orig = slot_orig.reshape(Q, Ps)

    if scan_impl in ("fused", "exact"):
        # tables_flat is already in the kernel's layout (see _ivf_query);
        # in exact mode it is the augmented bf16 queries and csr_codes
        # the bf16 vector tiles
        t_sel = tables_flat[jnp.maximum(qgrid, 0)]    # (C, qc, M)
        budget_tiles = scan_budget_bytes // (4 * C * qc * LANE_TILE)
        enc = csr_fold_scan(
            t_sel, csr_codes, tile_offsets, list_counts,
            fold_tiles=_fold_tiles(r, max_tiles, fold_mult, budget_tiles),
            max_tiles=max_tiles,
            interpret=platform.interpret())           # (C, qc, S)
        S = enc.shape[2]
        enc_flat = enc.reshape(C * qc, S)
    else:
        exact = scan_impl == "exact_xla"
        row_bytes = 2 * M if exact else M             # bf16 vs int8 rows
        chunk = _cluster_chunk(C, cap, qc, row_bytes, scan_budget_bytes)
        n_chunks = -(-C // chunk)
        C_pad = n_chunks * chunk
        toff_g = jnp.pad(tile_offsets, (0, C_pad - C))
        counts_g = jnp.pad(list_counts, (0, C_pad - C))
        qgrid_g = jnp.pad(qgrid, ((0, C_pad - C), (0, 0)),
                          constant_values=-1)
        toff_g = toff_g.reshape(n_chunks, chunk)
        counts_g = counts_g.reshape(n_chunks, chunk)
        qgrid_g = qgrid_g.reshape(n_chunks, chunk, qc)

        def scan_chunk(args):
            toff_k, counts_k, qgrid_k = args
            tiles_k = _tiles_to_dense(csr_codes, toff_k, max_tiles)
            rows_k = _rows_of(toff_k, cap, n_rows)    # (CH, cap)
            in_list = (jnp.arange(cap, dtype=jnp.int32)[None, :]
                       < counts_k[:, None])
            t_sel = tables_flat[jnp.maximum(qgrid_k, 0)]
            floating = jnp.issubdtype(tables_flat.dtype, jnp.floating)
            if exact:
                # augmented bf16 vectors x augmented queries: the true
                # squared distance (up to bf16 input rounding)
                rhs = tiles_k                         # (CH, cap, d_aug)
            else:
                # storage pads the packed width to 8 bytes; phantom
                # blocks beyond the logical M // 16 are sliced off
                onehot = jax.nn.one_hot(
                    unpack_codes(tiles_k)[..., :M // 16], 16,
                    dtype=tables_flat.dtype if floating else jnp.int8)
                rhs = onehot.reshape(chunk, cap, M)
            est = jax.lax.dot_general(
                t_sel, rhs, (((2,), (2,)), ((0,), (0,))),
                preferred_element_type=(jnp.float32 if floating
                                        else jnp.int32))  # (CH, qc, cap)
            est = est.astype(jnp.float32)
            est = jnp.where(in_list[:, None, :], est, jnp.inf)
            vals, idx = pass1_topk(-est, r, method)   # (CH, qc, r)
            flat_pos = jnp.take_along_axis(
                jnp.broadcast_to(rows_k[:, None, :], est.shape), idx,
                axis=2)
            return -vals, flat_pos

        cand_vals, cand_pos = jax.lax.map(
            scan_chunk, (toff_g, counts_g, qgrid_g))
        cand_vals = cand_vals.reshape(C_pad * qc, r)
        cand_pos = cand_pos.reshape(C_pad * qc, r)

    sl = jnp.minimum(slot_orig, qc - 1)
    valid_pair = slot_orig < qc
    # one flat row index per pair: a single-index row gather
    pair_idx = probe_sub * qc + sl                    # (Q, Ps)
    dropped = jnp.sum((slot >= qc) & (sorted_c < C))
    if scan_impl in ("fused", "exact"):
        my_enc = enc_flat[pair_idx]                   # (Q, Ps, S)
        my_enc = jnp.where(valid_pair[:, :, None], my_enc,
                           jnp.int32(ENC_INVALID))
        rowbase = (tile_offsets.astype(jnp.int32) * LANE_TILE)[
            jnp.minimum(probe_sub, C - 1)]            # (Q, Ps)
        return my_enc, rowbase, dropped
    my_vals = cand_vals[pair_idx]                     # (Q, Ps, r)
    my_rows = cand_pos[pair_idx]
    my_vals = jnp.where(valid_pair[:, :, None], my_vals, jnp.inf)
    my_rows = jnp.where(valid_pair[:, :, None], my_rows, 0)
    return my_vals, my_rows, dropped


def _select_pool_enc(pools, bases, p1: int, method: str, col_bits: int,
                     csr_ids, decode_ids: bool = True):
    """Global candidate selection in the encoded int32 domain.

    pools: per-round encoded fold buffers [(Q, Ps_i, S_i) int32];
    bases: matching flat-row bases [(Q, Ps_i) int32]. Selects the p1
    smallest encodings per query and decodes ONLY the survivors to
    (ids, flat rows) — the encoding (est + bias) << col_bits | pos is
    monotone in the estimate (position bits break ties), so selecting
    on it is selecting on the estimate, and the full-width pool never
    materializes decoded values or row indices.

    ``method='approx'`` selects with approx_max_k on the BITCAST pool:
    encodings are non-negative, so the IEEE-f32 view of the int32 bits
    is order-identical to the ints, and the returned values bitcast
    straight back to exact encodings (no survivor re-gather). On the
    GPU and the CPU approx_max_k has no approximate lowering, so this
    is an exact selection too. The pool is materialized through an
    optimization_barrier first, so that XLA does not fuse the
    (C, qc, S) -> (Q, P, S) per-pair fold-row gather into the
    selection and re-read it on every sort pass.

    Returns (cand ids int32[Q, p1] (-1 = invalid), rows int32[Q, p1],
    enc_sel int32[Q, p1] — the survivors' exact encodings, so exact
    mode can decode distances without re-touching the pool).
    """
    Q = pools[0].shape[0]
    pool = jnp.concatenate([p.reshape(Q, -1) for p in pools], axis=1)
    pool = jax.lax.optimization_barrier(pool)
    base = jnp.concatenate(bases, axis=1)             # (Q, P)
    if method == "approx":
        f = jax.lax.bitcast_convert_type(pool, jnp.float32)
        # bits >= 0x7F800000 view as inf/NaN and would break the sort
        # order; clamp them to +inf. Only the invalid sentinel and the
        # top ~0.4% of the encoding range (est within 2^-8 of the
        # headroom guard's ceiling — unreachable for mean-normalized
        # int8 tables) land here.
        f = jnp.where(pool >= jnp.int32(0x7F800000), jnp.inf, f)
        negv, top_pos = jax.lax.approx_max_k(-f, p1)
        enc_sel = jax.lax.bitcast_convert_type(-negv, jnp.int32)
        # selected empties come back as +inf bits; restore the sentinel
        enc_sel = jnp.where(enc_sel >= jnp.int32(0x7F800000),
                            jnp.int32(ENC_INVALID), enc_sel)
    else:
        _, top_pos = jax.lax.top_k(-pool, p1)
        enc_sel = jnp.take_along_axis(pool, top_pos, axis=1)  # (Q, p1)
    pos = enc_sel & jnp.int32((1 << col_bits) - 1)
    S0 = pools[0].shape[1] * pools[0].shape[2]
    if len(pools) > 1:
        St = pools[1].shape[2]
        probe_of = jnp.where(
            top_pos < S0, 0,
            1 + (top_pos - S0) // St).astype(jnp.int32)
    else:
        probe_of = jnp.zeros_like(top_pos)
    rowbase = jnp.take_along_axis(base, probe_of, axis=1)
    n_rows = csr_ids.shape[0]
    rows = jnp.minimum(rowbase + pos, n_rows - 1)
    valid = enc_sel < jnp.int32(ENC_INVALID)
    rows = jnp.where(valid, rows, 0)
    if not decode_ids:
        # deferred-id mode (rescore_rows): skip the (Q, p1) csr_ids
        # gather entirely — the caller decodes ids for winners only
        return None, rows, enc_sel
    cand = jnp.where(valid, csr_ids[rows], -1)
    return cand, rows, enc_sel


def default_qc0(Q: int, C: int) -> int:
    """Round-0 bucket capacity: ~2.5x the mean per-cluster load.

    Round 0 scans each query's *nearest* cluster, so its load profile
    differs from the tail rounds (exactly one pair per query).
    """
    return max(32, -(-5 * Q // (2 * C)) // 8 * 8 + 8)


@partial(jax.jit, static_argnames=("dpb", "metric", "k", "n_probes",
                                   "pass_1", "r", "r_tail", "qc", "qc0",
                                   "method", "scan_impl", "max_tiles",
                                   "build_probes", "table_dtype",
                                   "fold_mult", "scan_budget_bytes"))
def _ivf_query(q, center_blocks, R, active_centers, csr_codes, csr_ids,
               tile_offsets, list_counts, data, csr_raw=None,
               *, dpb: int,
               metric: str,
               k: int, n_probes: int, pass_1: int, r: int, r_tail: int,
               qc: int, qc0: int, method: str = "exact",
               scan_impl: str = "xla", max_tiles: int = 1,
               build_probes: int = 2, table_dtype: str = "int8",
               fold_mult: int = FOLD_MULT,
               scan_budget_bytes: int = 2 << 30):
    """The full batched IVF query step — one jitted computation.

    Stages (Q queries, C clusters, cap list capacity, P probes):
      1. probe selection: exact distances to active centers, top-P.
      2-3. bucketed list scans in two rounds: the *nearest* cluster of
         each query is scanned with a deep per-pair candidate budget
         (r = pass_1: most true neighbors live there, and estimate
         noise means depth matters), remaining probes with a shallow
         budget (r_tail ~ 3k: only a distant cluster's best few can
         make the final top-k). This keeps the reference's shared-
         candidate-pool semantics where it counts at a fraction of the
         top-r selection cost.
      4. dedup spilled ids, global top-pass_1.
      5. exact fp32 rescore of the survivors, final top-k.
    """
    Q, d = q.shape
    P = n_probes

    if metric == "angular":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    f = min(build_probes, n_probes)
    if scan_impl in ("exact", "exact_xla"):
        # no PQ tables: the scan consumes augmented raw queries
        tables_flat = _augment_queries(q)
        if scan_impl == "exact_xla":
            # per-pair top-r only has to cover the global selection of
            # f * pass_1 (r and r_tail size the kernel's fold widths)
            cap = max_tiles * LANE_TILE
            r = min(r, f * pass_1, cap)
            r_tail = min(r_tail, f * pass_1, cap)
    else:
        # distance tables fused into the query step (one dispatch
        # end-to-end)
        tables = _build_tables(q, center_blocks, R, dpb, True,
                               table_dtype).tables
        B = tables.shape[1]
        tables_flat = tables.reshape(Q, B * 16)
        if scan_impl == "fused":
            tables_flat = kernel_tables(tables_flat, B)

    # -- 1. probe selection (exact distances to the active centers)
    qn = jnp.einsum("qd,qd->q", q, q,
                    precision=jax.lax.Precision.HIGHEST)
    cn = jnp.einsum("cd,cd->c", active_centers, active_centers,
                    precision=jax.lax.Precision.HIGHEST)
    d2c = qn[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
        q, active_centers, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    _, probe_sel = jax.lax.top_k(-d2c, P)            # (Q, P) int32

    # -- 2-3. scan rounds
    # qc/qc0 are static capacities sized for ~2.5x the mean per-cluster
    # load; heavily skewed query batches (everyone near one cluster) can
    # exceed them — dropped pairs (both rounds) feed the caller's retry
    # escalation, and queries_per_cluster overrides the capacity.
    scan = partial(_bucket_scan_round, tables_flat=tables_flat,
                   csr_codes=csr_codes, csr_ids=csr_ids,
                   tile_offsets=tile_offsets, list_counts=list_counts,
                   method=method, scan_impl=scan_impl,
                   max_tiles=max_tiles, fold_mult=fold_mult,
                   scan_budget_bytes=scan_budget_bytes)
    v0, rows0, drop0 = scan(probe_sel[:, :1], qc=qc0, r=r)
    if P > 1:
        v1, rows1, drop1 = scan(probe_sel[:, 1:], qc=qc, r=r_tail)
        dropped = drop0 + drop1
    else:
        dropped = drop0

    # -- 4. global top candidate pool. No duplicate handling here: a
    # sort-based dedup of the full (Q, width) pool costs ~half the whole
    # query at GloVe scale. A point spilled by build_probes appears in
    # at most f = min(build_probes, n_probes) probed lists (with equal
    # estimates), so selecting f * pass_1 slots guarantees >= pass_1
    # unique candidates; duplicates ride into the rescore and are
    # removed there on a k*f-wide sliver (the reference dedups inside
    # its heap, tinyknn/_fast_pq.pyx:285-287).
    if scan_impl in ("fused", "exact"):
        # selection runs directly on the encoded int32 fold buffers;
        # only the p1 survivors are ever decoded (see _select_pool_enc)
        pools = [v0] + ([v1] if P > 1 else [])
        bases = [rows0] + ([rows1] if P > 1 else [])
        width = sum(p.shape[1] * p.shape[2] for p in pools)
        p1 = min(f * pass_1, width)
        col_bits = (16 if scan_impl == "exact"
                    or tables_flat.dtype != jnp.int8 else
                    max(1, (max_tiles * LANE_TILE - 1).bit_length()))
        cand, rows_sel, enc_sel = _select_pool_enc(
            pools, bases, p1, method, col_bits, csr_ids,
            decode_ids=csr_raw is None)
        if csr_raw is not None:
            # deferred-id mode: rescore by flat row from the
            # CSR-ordered raw copy; ids decode only for winners below
            valid_sel = enc_sel < jnp.int32(ENC_INVALID)
            gathered = csr_raw[rows_sel]              # (Q, p1, d)
            diff = gathered - q[:, None, :]
            d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
            d2 = jnp.where(valid_sel, d2, jnp.inf)
            if f > 1:
                k2 = min(k * f, p1)
                _, best = jax.lax.top_k(-d2, k2)
                rows_b = jnp.take_along_axis(rows_sel, best, axis=1)
                d2 = jnp.take_along_axis(d2, best, axis=1)
                cand = jnp.where(jnp.isfinite(d2), csr_ids[rows_b], -1)
                cand, d2 = dedup_candidates(cand, d2)
                _, best = jax.lax.top_k(-d2, k)
                out = jnp.take_along_axis(cand, best, axis=1)
                out_d2 = jnp.take_along_axis(d2, best, axis=1)
            else:
                _, best = jax.lax.top_k(-d2, k)
                rows_b = jnp.take_along_axis(rows_sel, best, axis=1)
                out_d2 = jnp.take_along_axis(d2, best, axis=1)
                out = csr_ids[rows_b]                 # (Q, k) gather
            return (jnp.where(jnp.isfinite(out_d2), out, -1), dropped)
    else:
        flat_vals = jnp.concatenate(
            [v0.reshape(Q, -1)] + ([v1.reshape(Q, -1)] if P > 1 else []),
            axis=1)
        flat_rows = jnp.concatenate(
            [rows0.reshape(Q, -1)]
            + ([rows1.reshape(Q, -1)] if P > 1 else []), axis=1)
        p1 = min(f * pass_1, flat_vals.shape[1])
        vsel, top_pos = pass1_topk(-flat_vals, p1, method)
        rows_sel = jnp.take_along_axis(flat_rows, top_pos, axis=1)
        cand = jnp.where(jnp.isfinite(vsel), csr_ids[rows_sel], -1)

    # -- 5. exact f32 rescore (+ tiny post-rescore dedup when f > 1).
    # Exact mode rescores too: its bf16 scan is a near-perfect pruner,
    # but bf16 rounding (~0.4% relative) swaps near-tie neighbors at
    # the top-k boundary — a round-3 GloVe sweep saturated at recall
    # 0.950 decoding scan distances directly, vs 0.97+ with this
    # pass. Its sliver is ~10x narrower than the PQ path's (pass-1
    # collapses to ~4k), so the gather stays cheap.
    gathered = data[jnp.maximum(cand, 0)]             # (Q, p1, d)
    diff = gathered - q[:, None, :]
    d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.where(cand >= 0, d2, jnp.inf)
    if f > 1:
        k2 = min(k * f, p1)
        _, best = jax.lax.top_k(-d2, k2)
        cand = jnp.take_along_axis(cand, best, axis=1)
        d2 = jnp.take_along_axis(d2, best, axis=1)
        cand, d2 = dedup_candidates(cand, d2)
    _, best = jax.lax.top_k(-d2, k)
    out = jnp.take_along_axis(cand, best, axis=1)
    out_d2 = jnp.take_along_axis(d2, best, axis=1)
    return jnp.where(jnp.isfinite(out_d2), out, -1), dropped


class TuneResult(NamedTuple):
    """Result of ``tune_n_probes`` (a NamedTuple so adding fields never
    breaks tuple unpacking again — the round-2 3->4-arity change did)."""
    n_probes: int
    pass_1: int
    recall: float
    recalls: dict   # {(n_probes, pass_1): measured recall}


def tune_n_probes(ivf, queries, true_neighbours, k=10, target_recall=0.9,
                  max_probes=None, pass1_mults=(2.0, 4.0, 8.0),
                  verbose=False):
    """Cheapest (n_probes, pass_1) reaching ``target_recall`` on a
    validation set.

    The reference leaves this sweep to its benchmark script
    (reference: examples/bench.py:116-139); serving deployments need it
    as an API. Both knobs are searched empirically: n_probes grows
    until the target is reachable, and within the smallest sufficient
    n_probes the pass-1 pool multiplier is searched downward through
    ``pass1_mults`` (multiples of the reference's (P+1)k+1 sizing;
    the pool is one exact-rescore gather, and the measured frontier
    sits at x2-x8 depending on the target — docs/PERFORMANCE.md). Probing order exploits monotonicity in
    pass_1: the widest pool is tried first per n_probes, and only if
    it reaches the target are cheaper pools examined. Returns a
    ``TuneResult(n_probes, pass_1, recall, recalls)`` NamedTuple.

    Exact-mode indexes (``scan_impl='exact'``) have different pass_1
    semantics — it is the f32 rescore-sliver width, engine default
    ``4*k*n_probes`` (see IVF.query) — so there the searched pools are
    ``mult * k * n_probes``: the default ``pass1_mults`` probe the
    engine's own sliver at 2x/4x(=default)/8x, same monotone
    widest-first order.
    """
    import numpy as np
    queries = np.asarray(queries, dtype=np.float32)
    trus = [set(np.asarray(t).tolist()) for t in true_neighbours]
    max_probes = max_probes or ivf.active_centers.shape[0]
    mults = sorted(pass1_mults)
    recalls = {}

    exact = getattr(ivf, "scan_impl", None) == "exact"

    def measure(n_probes, mult):
        if exact:  # pass_1 = rescore-sliver width (default 4*k*P)
            p1 = max(int(mult * k * max(n_probes, 1)), k)
        else:
            p1 = int(mult * ((n_probes + 1) * k + 1))
        if (n_probes, p1) in recalls:
            return p1, recalls[(n_probes, p1)]
        guesses = np.asarray(ivf.query(queries, k=k, n_probes=n_probes,
                                       pass_1=p1))
        recall = float(np.mean(
            [len(trus[i] & set(g.tolist())) / max(len(trus[i]), 1)
             for i, g in enumerate(guesses)]))
        recalls[(n_probes, p1)] = recall
        if verbose:
            print(f"tune: n_probes={n_probes} pass_1={p1} "
                  f"recall={recall:.4f}")
        return p1, recall

    n_probes = 1
    while n_probes <= max_probes:
        p1, recall = measure(n_probes, mults[-1])
        if recall >= target_recall:
            # cheapest sufficient pool within this n_probes
            for mult in mults[:-1]:
                p1_lo, recall_lo = measure(n_probes, mult)
                if recall_lo >= target_recall:
                    return TuneResult(n_probes, p1_lo, recall_lo, recalls)
            return TuneResult(n_probes, p1, recall, recalls)
        n_probes += max(int(n_probes ** 0.5), 1)
    best = max(recalls, key=recalls.get)
    return TuneResult(best[0], best[1], recalls[best], recalls)


@partial(jax.jit, static_argnames=("dpb", "metric", "k", "n_probes",
                                   "pass_1", "max_tiles", "table_dtype",
                                   "exact"))
def _ivf_query_gather(q, center_blocks, R, active_centers, csr_codes,
                      csr_ids, tile_offsets, list_counts, data, *,
                      dpb: int, metric: str, k: int, n_probes: int,
                      pass_1: int, max_tiles: int,
                      table_dtype: str = "int8", exact: bool = False):
    """Latency-mode query: gather each query's probed lists directly.

    For small batches the bucketed scan wastes work on the (C, qc) grid;
    here we gather each probed list's (max_tiles) code tiles into dense
    (Q, P, cap) blocks and contract per query. The einsum is a batched
    matrix-vector product, fine at small Q*P — this is the shape of the
    reference's per-query loop (tinyknn/ivf.py:140-150), kept for
    single-query latency parity.

    ``exact=True``: csr_codes holds the exact engine's augmented bf16
    vector tiles (see _augment_data_csr) instead of PQ codes — the
    per-list contraction then yields TRUE (bf16-rounded) squared
    distances and the thin f32 rescore finishes the job, so the
    0.95-recall engine has a small-batch serving path too.
    """
    Q, d = q.shape
    cap = max_tiles * LANE_TILE
    n_rows = csr_ids.shape[0]
    P = n_probes
    if metric == "angular":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    if not exact:
        tables = _build_tables(q, center_blocks, R, dpb, True,
                               table_dtype).tables

    qn = jnp.einsum("qd,qd->q", q, q,
                    precision=jax.lax.Precision.HIGHEST)
    cn = jnp.einsum("cd,cd->c", active_centers, active_centers,
                    precision=jax.lax.Precision.HIGHEST)
    d2c = qn[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
        q, active_centers, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    _, probe_sel = jax.lax.top_k(-d2c, P)             # (Q, P)

    toff_p = tile_offsets[probe_sel]                  # (Q, P)
    rows_p = _rows_of(toff_p, cap, n_rows)            # (Q, P, cap)
    in_list = (jnp.arange(cap, dtype=jnp.int32)[None, None, :]
               < list_counts[probe_sel][:, :, None])
    ids_p = jnp.where(in_list, csr_ids[rows_p], -1)   # (Q, P, cap)
    if exact:
        # augmented bf16 vector tiles: one contraction with the
        # augmented query = true squared distance (>= 0 by construction)
        vec_p = _tiles_to_dense(csr_codes, toff_p, max_tiles)
        qa = _augment_queries(q)                      # (Q, d_aug) bf16
        est = jnp.einsum("qpcd,qd->qpc", vec_p, qa[:, :vec_p.shape[-1]],
                         preferred_element_type=jnp.float32)
    else:
        B = tables.shape[1]
        codes_p = unpack_codes(
            _tiles_to_dense(csr_codes, toff_p, max_tiles))[..., :B]
        # (Q, P, cap, B); phantom storage-pad blocks sliced off
        floating = jnp.issubdtype(tables.dtype, jnp.floating)
        onehot = jax.nn.one_hot(
            codes_p, 16, dtype=tables.dtype if floating else jnp.int8)
        est = jnp.einsum(
            "qpcbv,qbv->qpc", onehot, tables,
            preferred_element_type=(jnp.float32 if floating
                                    else jnp.int32)
        ).astype(jnp.float32)
    est = jnp.where(ids_p >= 0, est, jnp.inf)
    flat_vals = est.reshape(Q, P * cap)
    flat_ids = ids_p.reshape(Q, P * cap)
    flat_ids, flat_vals = dedup_candidates(flat_ids, flat_vals)
    p1 = min(pass_1, P * cap)
    _, top_pos = jax.lax.top_k(-flat_vals, p1)
    cand = jnp.take_along_axis(flat_ids, top_pos, axis=1)

    gathered = data[jnp.maximum(cand, 0)]
    diff = gathered - q[:, None, :]
    d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.where(cand >= 0, d2, jnp.inf)
    _, best = jax.lax.top_k(-d2, k)
    out = jnp.take_along_axis(cand, best, axis=1)
    out_d2 = jnp.take_along_axis(d2, best, axis=1)
    return jnp.where(jnp.isfinite(out_d2), out, -1)
