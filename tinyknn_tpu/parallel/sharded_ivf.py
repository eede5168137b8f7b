"""Cluster-sharded IVF over a device mesh.

The reference is strictly single-process (SURVEY.md §2.13); scaling the
corpus beyond one device's memory is this build's analogue of model
parallelism. Design (BASELINE config 5):

  * the CSR tile arrays — codes (T, B/2, 128), flat ids (T * 128,) and
    flat raw vectors (T * 128, d) for rescore — are split into
    contiguous per-shard cluster ranges (each padded to the largest
    shard's tile count) and sharded over the mesh on the cluster axis;
    PQ codebooks, coarse centers and the query batch are replicated
    (KB-scale);
  * each device runs the same bucketed scan as the single-chip path,
    but only over the probed clusters it owns; probe selection is
    computed redundantly on every device (tiny) so no communication is
    needed until the end;
  * rescore is local too (each device holds its lists' raw vectors), so
    the only collective is an ``all_gather`` of per-device (Q, k)
    results, followed by a replicated merge —
    k * n_devices * 12 bytes per query on the wire;
  * a second mesh axis can shard the query batch (pure data
    parallelism) — compose by sharding ``q`` on dim 0; the collectives
    ride the cluster axis only.

Also here: ``lloyd_step_dp``, a data-parallel KMeans step (local
accumulation + psum) — the index-build "training step" sharded over the
mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.ivf import (IVF, _bucket_scan_round, _qc_caps,
                          _query_params, _refresh_stream_floors,
                          _resolve_scan_impl, _stream_adaptive_params)
from ..models.fast_pq import _resolve_method
from ..ops.kernels import kernel_tables
from ..ops.topk import dedup_candidates
from .mesh import make_mesh, replicate, shard_on_axis0


class ShardedIVF(IVF):
    """IVF with its inverted lists sharded over a 1-D device mesh.

    fit/build run like the base class (single host), then ``shard()``
    places the grids over the mesh; ``query`` runs the shard_map step.
    """

    # _place() derives per-shard raw/augmented arrays itself; the base
    # build skips the single-device csr_vecs/csr_raw versions. The
    # sharded rescore always gathers by row from its per-shard vecs_l
    # with deferred id decode, so rescore_rows is inherently on.
    _sharded = True

    def __init__(self, metric, n_clusters, pq=None, mesh=None, axis="shards",
                 query_axis=None, **kw):
        """``axis`` names the mesh axis sharding the inverted lists.
        ``query_axis`` (2-D mesh, see make_mesh_2d) additionally shards
        the query batch — pure data parallelism composed on top of the
        cluster sharding; collectives still ride only ``axis``."""
        super().__init__(metric, n_clusters, pq, **kw)
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.query_axis = query_axis
        if query_axis is not None:
            assert query_axis in self.mesh.axis_names, (query_axis,
                                                        self.mesh.axis_names)
        self.list_vecs = None

    def build(self, X, n_probes=2, labels=None, verbose=False):
        super().build(X, n_probes, labels=labels, verbose=verbose)
        self._place()
        return self

    def _place(self):
        """Split the CSR tile arrays into contiguous per-shard cluster
        ranges (each padded to the largest shard's tile count), derive
        the per-shard flat raw-vector array for local rescore, and shard
        everything over the cluster axis — slicing happens on device (no
        host readback of codes/vectors; only the small offset/count
        vectors are host-side, and they were built on host anyway)."""
        n_dev = self.mesh.shape[self.axis]
        toff = np.asarray(self.tile_offsets)
        counts = np.asarray(self.list_counts)
        C = toff.shape[0]
        C_pad = C + (-C) % n_dev
        Cl = C_pad // n_dev
        ntiles = -(-counts.astype(np.int64) // 128)
        ends = toff.astype(np.int64) + ntiles          # end tile per list
        toff_p = np.concatenate(
            [toff, np.zeros(C_pad - C, np.int32)])
        counts_p = np.concatenate(
            [counts, np.zeros(C_pad - C, np.int32)])
        # shard s owns clusters [s*Cl, (s+1)*Cl): tiles [start_s, end_s)
        starts = np.array([toff_p[s * Cl] if s * Cl < C else 0
                           for s in range(n_dev)], np.int64)
        stops = np.array(
            [ends[min((s + 1) * Cl, C) - 1] if s * Cl < C else 0
             for s in range(n_dev)], np.int64)
        T_l = int(max(1, (stops - starts).max())) + 1  # +1 guard tile
        guard = self.csr_codes.shape[0] - 1            # global guard tile

        codes_parts, ids_parts, toffs, cnts = [], [], [], []
        for s in range(n_dev):
            n_t = int(stops[s] - starts[s])
            idx = np.concatenate([
                np.arange(starts[s], stops[s]),
                np.full(T_l - n_t, guard, np.int64)]).astype(np.int32)
            codes_parts.append(self.csr_codes[jnp.asarray(idx)])
            ids_parts.append(jnp.asarray(self.csr_ids).reshape(-1, 128)[
                jnp.asarray(idx)].reshape(-1))
            toffs.append(toff_p[s * Cl:(s + 1) * Cl]
                         - (starts[s] if s * Cl < C else 0))
            cnts.append(counts_p[s * Cl:(s + 1) * Cl])
        codes_st = jnp.concatenate(codes_parts)        # (n_dev*T_l,Bs,128)
        ids_st = jnp.concatenate(ids_parts)            # (n_dev*T_l*128,)
        from ..models.ivf import _csr_raw_rows
        vecs_st = _csr_raw_rows(self.data, ids_st)     # flat local rescore
        toff_st = jnp.asarray(np.concatenate(toffs).astype(np.int32))
        cnts_st = jnp.asarray(np.concatenate(cnts).astype(np.int32))
        centers = jnp.pad(self.active_centers, ((0, C_pad - C), (0, 0)),
                          # padding centers sit far away: never probed
                          constant_values=1e9)
        (self.csr_codes, self.csr_ids, self.tile_offsets,
         self.list_counts, self.list_vecs) = shard_on_axis0(
            self.mesh, codes_st, ids_st, toff_st, cnts_st, vecs_st,
            axis=self.axis)
        if self.scan_impl == "exact":
            # per-shard augmented bf16 vector tiles, rebuilt from the
            # assembled flat ids (derived state, like io.load does)
            from ..models.ivf import _augment_data_csr
            self.csr_vecs = shard_on_axis0(
                self.mesh, _augment_data_csr(self.data, ids_st),
                axis=self.axis)
        self.active_centers = replicate(self.mesh, centers)
        self._n_active_real = C
        self._shard_tiles = T_l
        self._shard_meta = (starts, stops, Cl, C)  # for save_ivf

    def set_scan_impl(self, scan_impl):
        """Switch the list-scan engine on a (possibly placed) sharded
        index. On a placed index the exact engine's bf16 vector tiles
        must be derived from the per-shard stacked ids and sharded like
        ``_place()`` does — the base-class derivation would leave an
        array whose placement doesn't match the mesh layout the sharded
        query expects."""
        assert scan_impl in ("auto", "fused", "xla", "exact")
        self.scan_impl = scan_impl
        if scan_impl != "exact":
            self.csr_vecs = None
            return self
        if self.csr_vecs is None and self.csr_ids is not None:
            assert self.max_tiles * 128 <= 1 << 16, (
                "exact mode: longest list exceeds the 16-bit fold "
                "position field; raise n_clusters")
            from ..models.ivf import _augment_data_csr
            vecs = _augment_data_csr(self.data, self.csr_ids)
            if self.list_vecs is not None:  # placed: shard like _place
                vecs = shard_on_axis0(self.mesh, vecs, axis=self.axis)
            self.csr_vecs = vecs
        return self

    def set_rescore_rows(self, enabled=True):
        """No-op allocation-wise: the sharded rescore always gathers
        raw rows from the per-shard ``list_vecs`` with deferred id
        decode, so a CSR-ordered global raw copy is never read (and
        its placement would not match the mesh)."""
        self.rescore_rows = enabled
        self.csr_raw = None
        return self

    def query(self, q, k, n_probes=1, pass_1=None, with_stats=False):
        q = np.asarray(q, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        from ..utils.padding import round_up
        c_dev = self.mesh.shape[self.axis]
        q_dev = self.mesh.shape[self.query_axis] if self.query_axis else 1
        C_pad = self.tile_offsets.shape[0]
        true_q = q.shape[0]
        if true_q % q_dev:  # query-axis sharding needs equal slices
            q = np.pad(q, ((0, q_dev - true_q % q_dev), (0, 0)))
        q_local = q.shape[0] // q_dev
        # One source of truth for the sizing arithmetic (_query_params,
        # models/ivf.py): capacities are per (query-shard,
        # cluster-shard) pair — each device buckets its q_local queries
        # over its C_pad/c_dev local lists — so the shard view is
        # injected as (Q=q_local, n_active=c_local); probes clamp to
        # the GLOBAL active count (selection is global).
        c_local = max(C_pad // c_dev, 1)
        k, n_probes, pass_1, r, r_tail, qc, qc0 = _query_params(
            self, q_local, k, n_probes, pass_1, n_active=c_local,
            n_probes_max=self._n_active_real)
        method = _resolve_method(self.pass1_method)
        fold_mult = getattr(self, "fold_mult", 8)
        scan_impl = _resolve_scan_impl(self)

        if self.metric == "angular":
            # tables must come from the normalized query: PQ codes
            # encode normalized data, and ||q - c||^2 rankings are not
            # scale-invariant in q (the shard body re-normalizes for
            # probe selection/rescore, which is idempotent)
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        qspec = P(self.query_axis) if self.query_axis else P()
        qj = jax.device_put(jnp.asarray(q),
                            NamedSharding(self.mesh, qspec))
        if self.scan_impl == "exact":
            # no PQ tables: the scan consumes augmented bf16 queries
            from ..models.ivf import _augment_queries
            tables = jax.device_put(_augment_queries(jnp.asarray(q)),
                                    NamedSharding(self.mesh, qspec))
        else:
            dtable = self.pq._table(q, signed=True)
            tables = jax.device_put(dtable.qt.tables,
                                    NamedSharding(self.mesh, qspec))
        # Same skew-driven drop escalation as the single-chip path
        # (models/ivf.py IVF.query); drops are psum'd across shards and
        # the check is free per clean call ((out, dropped) come back in
        # one device_get), so it runs at every batch size.
        check_drops = not self.queries_per_cluster
        attempts = 3 if check_drops else 1
        # can't-drop caps bounded by the per-shard fold-grid budget
        # (shared with IVF.query: models/ivf.py _qc_caps)
        qc_full, qc0_full = _qc_caps(self, q_local, n_probes, r, r_tail,
                                     qc, qc0, fold_mult,
                                     n_active=c_local)
        codes_arg = (self.csr_vecs if self.scan_impl == "exact"
                     else self.csr_codes)
        for _attempt in range(attempts):
            out, dropped = _sharded_query(
                qj, tables, self.active_centers, codes_arg,
                self.csr_ids, self.tile_offsets, self.list_counts,
                self.list_vecs,
                mesh=self.mesh, axis=self.axis, query_axis=self.query_axis,
                metric=self.metric, k=k, n_probes=n_probes, pass_1=pass_1,
                r=r, r_tail=r_tail, qc=qc, qc0=qc0, method=method,
                scan_impl=scan_impl, max_tiles=self.max_tiles,
                build_probes=getattr(self, "build_probes", 2),
                fold_mult=fold_mult,
                scan_budget_bytes=self.scan_budget_bytes)
            out, dropped = jax.device_get((out, dropped))
            if _attempt + 1 == attempts or int(dropped) == 0:
                break
            if _attempt + 2 == attempts:  # last try: can't-drop caps
                qc, qc0 = qc_full, qc0_full
            else:
                qc = min(round_up(4 * qc, 8), qc_full)
                qc0 = min(round_up(4 * qc0, 8), qc0_full)
        out = out[:true_q]
        out = out[0] if single else out
        from ..models.ivf import _map_labels
        out = _map_labels(self.labels, out)
        if with_stats:
            return out, {
                "dropped_probe_pairs": int(dropped),
                "total_probe_pairs": true_q * n_probes,
                "queries_per_cluster_cap": qc,
                "queries_per_cluster_cap_round0": qc0,
                "pass_1": pass_1,
                "per_pair_candidates": (r, r_tail),
            }
        return out


def _sharded_stream_method(self, batches, k, n_probes=1, pass_1=None,
                           with_stats=False, adaptive_qc=True,
                           device_out=False):
    """(R, Q, d) stream of batches in ONE dispatch over the mesh —
    the multi-chip serving shape (see IVF.query_stream). Tables are
    built per batch on each device's local query slice.

    ``device_out=True``: return ``(out, dropped)`` as device arrays
    (positional ids, no label mapping, no host transfer, no adaptive
    drop-refresh) — see IVF.query_stream.

    Like the single-chip stream there is no drop-RETRY (a retry would
    re-run the whole stream); instead ``adaptive_qc=True`` (default)
    self-tunes the per-shard bucket capacities exactly like
    IVF.query_stream: a cached pre-pass measures the stream's peak
    per-cluster load (globally — probe selection is replicated, so the
    global peak upper-bounds every shard's local load) and raises the
    capacity floors so skewed batches scan drop-free; the psum'd
    drop counter (free — it rides the output transfer) escalates the
    cached floor if query drift ever overflows it. Floors are clamped
    by the per-shard scan-grid budget; ``with_stats=True`` returns the
    dropped-pair total across the stream and all shards; pinning
    ``queries_per_cluster`` disables the adaptation."""
    if device_out and with_stats:
        raise ValueError(
            "device_out=True returns device arrays and cannot build "
            "the host-side stats dict; audit drops on a host-path "
            "call (with_stats=True, device_out=False)")
    batches = np.asarray(batches, dtype=np.float32)
    _, Qb, _ = batches.shape
    c_dev = self.mesh.shape[self.axis]
    q_dev = self.mesh.shape[self.query_axis] if self.query_axis else 1
    C_pad = self.tile_offsets.shape[0]
    assert Qb % q_dev == 0, "stream batch size must divide the query axis"
    q_local = Qb // q_dev
    c_local = max(C_pad // c_dev, 1)
    method = _resolve_method(self.pass1_method)
    fold_mult = getattr(self, "fold_mult", 8)
    adaptive = bool(adaptive_qc) and not self.queries_per_cluster
    k_arg, p_arg, p1_arg = k, n_probes, pass_1
    # one source of truth for the sizing (see ShardedIVF.query)
    params = _query_params(self, q_local, k, n_probes, pass_1,
                           n_active=c_local,
                           n_probes_max=self._n_active_real)
    floors, key, fresh = (0, 0), None, False
    if adaptive:
        params, floors, key, fresh = _stream_adaptive_params(
            self, batches, k_arg, p_arg, p1_arg, params, fold_mult,
            Q=q_local, n_active=c_local,
            n_probes_max=self._n_active_real)
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    scan_impl = _resolve_scan_impl(self)
    if self.metric == "angular":
        batches = batches / np.maximum(
            np.linalg.norm(batches, axis=2, keepdims=True), 1e-12)
    qspec = P(None, self.query_axis) if self.query_axis else P()
    qb = jax.device_put(jnp.asarray(batches),
                        NamedSharding(self.mesh, qspec))
    out, dropped = _sharded_query_stream(
        qb, self.pq.center_blocks, self.pq.R, self.active_centers,
        self.csr_vecs if self.scan_impl == "exact" else self.csr_codes,
        self.csr_ids, self.tile_offsets,
        self.list_counts, self.list_vecs,
        mesh=self.mesh, axis=self.axis, query_axis=self.query_axis,
        metric=self.metric, k=k, n_probes=n_probes, pass_1=pass_1,
        r=r, r_tail=r_tail, qc=qc, qc0=qc0, method=method,
        scan_impl=scan_impl, max_tiles=self.max_tiles,
        build_probes=getattr(self, "build_probes", 2),
        dpb=self.pq.dims_per_block,
        table_dtype=self.pq.table_dtype, fold_mult=fold_mult,
        scan_budget_bytes=self.scan_budget_bytes)
    if device_out:
        return out, dropped
    # one transfer for both: the drop check is free per clean call
    out, dropped = jax.device_get((out, dropped))
    if adaptive and int(dropped):
        # peak re-measured globally (selection is replicated), the
        # same upper bound the pre-pass uses for every shard
        _refresh_stream_floors(self, key, jnp.asarray(batches),
                               n_probes, just_measured=fresh)
    from ..models.ivf import _map_labels
    out = _map_labels(self.labels, out)
    if with_stats:
        return out, {
            "dropped_probe_pairs": int(dropped),
            "total_probe_pairs": int(np.prod(batches.shape[:2]))
            * n_probes,
            "queries_per_cluster_cap": qc,
            "queries_per_cluster_cap_round0": qc0,
            "adaptive_qc_floors": floors if adaptive else None,
            "pass_1": pass_1,
        }
    return out


ShardedIVF.query_stream = _sharded_stream_method


@partial(jax.jit,
         static_argnames=("mesh", "axis", "query_axis", "metric", "k",
                          "n_probes", "pass_1", "r", "r_tail", "qc",
                          "qc0", "method", "scan_impl", "max_tiles",
                          "build_probes", "dpb", "table_dtype",
                          "fold_mult", "scan_budget_bytes"))
def _sharded_query_stream(qb, center_blocks, Rm, centers, csr_codes,
                          csr_ids, tile_offsets, list_counts,
                          list_vecs, *, mesh, axis, query_axis, metric,
                          k, n_probes, pass_1, r, r_tail, qc, qc0,
                          method, scan_impl, max_tiles, build_probes,
                          dpb, table_dtype="int8", fold_mult=8,
                          scan_budget_bytes=2 << 30):
    from ..models.fast_pq import _build_tables
    spec_s = P(axis)
    spec_q = P(None, query_axis) if query_axis else P()
    psum_axes = (axis,) if query_axis is None else (axis, query_axis)
    step = partial(_shard_local_query, axis=axis, psum_axes=psum_axes,
                   metric=metric, k=k, n_probes=n_probes, pass_1=pass_1,
                   r=r, r_tail=r_tail, qc=qc, qc0=qc0, method=method,
                   scan_impl=scan_impl, max_tiles=max_tiles,
                   build_probes=build_probes, fold_mult=fold_mult,
                   scan_budget_bytes=scan_budget_bytes)

    def stream(qb, centers, codes_l, ids_l, toff_l, counts_l, vecs_l):
        def body(q):
            if scan_impl in ("exact", "exact_xla"):
                # batches were normalized before the dispatch (angular)
                from ..models.ivf import _augment_queries
                tables = _augment_queries(q)
            else:
                tables = _build_tables(q, center_blocks, Rm, dpb,
                                       True, table_dtype).tables
            ids, _, dropped = step(q, tables, centers, codes_l, ids_l,
                                   toff_l, counts_l, vecs_l)
            return ids, dropped
        ids, dropped = jax.lax.map(body, qb)
        return ids, jnp.sum(dropped)

    return jax.shard_map(
        stream, mesh=mesh,
        in_specs=(spec_q, P(), spec_s, spec_s, spec_s, spec_s, spec_s),
        out_specs=(spec_q, P()), check_vma=False,
    )(qb, centers, csr_codes, csr_ids, tile_offsets, list_counts,
      list_vecs)


@partial(jax.jit,
         static_argnames=("mesh", "axis", "query_axis", "metric", "k",
                          "n_probes", "pass_1", "r", "r_tail", "qc", "qc0",
                          "method", "scan_impl", "max_tiles",
                          "build_probes", "fold_mult",
                          "scan_budget_bytes"))
def _sharded_query(q, tables, centers, csr_codes, csr_ids, tile_offsets,
                   list_counts, list_vecs, *, mesh, axis,
                   query_axis, metric, k, n_probes, pass_1, r, r_tail,
                   qc, qc0, method, scan_impl, max_tiles, build_probes,
                   fold_mult=8, scan_budget_bytes=2 << 30):
    spec_s = P(axis)
    spec_q = P(query_axis) if query_axis else P()
    spec_r = P()
    psum_axes = (axis,) if query_axis is None else (axis, query_axis)

    step = partial(_shard_local_query, axis=axis, psum_axes=psum_axes,
                   metric=metric, k=k,
                   n_probes=n_probes, pass_1=pass_1, r=r, r_tail=r_tail,
                   qc=qc, qc0=qc0, method=method, scan_impl=scan_impl,
                   max_tiles=max_tiles, build_probes=build_probes,
                   fold_mult=fold_mult, scan_budget_bytes=scan_budget_bytes)
    # check_vma=False: outputs are replicated along the cluster axis by
    # construction (they come out of an all_gather/psum + identical
    # replicated math), which the varying-axes checker cannot infer
    # statically. Along a query axis each device owns its query slice.
    ids, d2, dropped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec_q, spec_q, spec_r, spec_s, spec_s, spec_s, spec_s,
                  spec_s),
        out_specs=(spec_q, spec_q, spec_r), check_vma=False,
    )(q, tables, centers, csr_codes, csr_ids, tile_offsets, list_counts,
      list_vecs)
    return ids, dropped


def _shard_local_query(q, tables, centers, codes_l, ids_l, toff_l,
                       counts_l, vecs_l, *, axis, psum_axes,
                       metric, k, n_probes, pass_1, r, r_tail, qc, qc0,
                       method, scan_impl, max_tiles, build_probes,
                       fold_mult=8, scan_budget_bytes=2 << 30):
    """Per-shard body: local two-round bucketed scan (shared with the
    single-chip path, models/ivf.py) + local rescore + gather-merge.
    codes_l/ids_l/toff_l/counts_l are the shard's local CSR tile arrays;
    vecs_l is the matching flat raw-vector array."""
    Q, d = q.shape
    Cl = toff_l.shape[0]
    B = tables.shape[1]
    P_ = n_probes
    me = jax.lax.axis_index(axis)

    if metric == "angular":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)

    # ---- global probe selection (replicated compute, no comm)
    qn = jnp.einsum("qd,qd->q", q, q,
                    precision=jax.lax.Precision.HIGHEST)
    cn = jnp.einsum("cd,cd->c", centers, centers,
                    precision=jax.lax.Precision.HIGHEST)
    d2c = qn[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
        q, centers, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    _, probe_sel = jax.lax.top_k(-d2c, P_)           # (Q, P) global ids

    # ---- map to local cluster index; non-local pairs -> sentinel Cl
    # (the scan round drops sentinel pairs; their gathered rows are
    # masked below via is_local)
    local_c = probe_sel - me * Cl
    is_local = (local_c >= 0) & (local_c < Cl)
    probes_local = jnp.where(is_local, local_c, Cl)

    f = min(build_probes, n_probes)
    if scan_impl in ("exact", "exact_xla"):
        tables_flat = tables          # (Q, d_aug) augmented bf16
        if scan_impl == "exact_xla":  # see models/ivf.py _ivf_query
            cap = max_tiles * 128
            r = min(r, f * pass_1, cap)
            r_tail = min(r_tail, f * pass_1, cap)
    else:
        tables_flat = tables.reshape(Q, B * 16)
        if scan_impl == "fused":
            tables_flat = kernel_tables(tables_flat, B)

    scan = partial(_bucket_scan_round, tables_flat=tables_flat,
                   csr_codes=codes_l, csr_ids=ids_l, tile_offsets=toff_l,
                   list_counts=counts_l, method=method,
                   scan_impl=scan_impl, max_tiles=max_tiles,
                   fold_mult=fold_mult,
                   scan_budget_bytes=scan_budget_bytes)
    v0, rows0, drop0 = scan(probes_local[:, :1], qc=qc0, r=r)
    dropped = drop0
    if P_ > 1:
        v1, rows1, drop1 = scan(probes_local[:, 1:], qc=qc, r=r_tail)
        dropped = dropped + drop1

    # No big-pool dedup (costs ~half the query at scale): duplicates
    # are bounded by f = min(build_probes, n_probes); select f * pass_1
    # slots so >= pass_1 unique candidates reach the rescore, then
    # dedup post-rescore on a k*f sliver (see models/ivf.py).
    from ..models.fast_pq import pass1_topk
    from ..models.ivf import ENC_INVALID, _select_pool_enc
    if scan_impl in ("fused", "exact"):
        # non-local probe pairs are invalidated in the encoded domain;
        # selection + survivor-only decode shared with the single-chip
        # path (models/ivf.py _select_pool_enc)
        pools = [jnp.where(is_local[:, :1, None], v0,
                           jnp.int32(ENC_INVALID))]
        bases = [rows0]
        if P_ > 1:
            pools.append(jnp.where(is_local[:, 1:, None], v1,
                                   jnp.int32(ENC_INVALID)))
            bases.append(rows1)
        width = sum(p.shape[1] * p.shape[2] for p in pools)
        p1_eff = min(f * pass_1, width)
        col_bits = (16 if scan_impl == "exact"
                    or tables_flat.dtype != jnp.int8 else
                    max(1, (max_tiles * 128 - 1).bit_length()))
        # deferred-id decode: rescore gathers by flat row from vecs_l,
        # so the full-width (Q, p1) ids_l gather never happens — ids
        # decode only for the post-rescore sliver/winners below
        _, cand_p, enc_sel = _select_pool_enc(
            pools, bases, p1_eff, method, col_bits, ids_l,
            decode_ids=False)
        valid_sel = enc_sel < jnp.int32(ENC_INVALID)
        cand = None
    else:
        ok0 = is_local[:, :1, None]
        flat_vals = jnp.where(ok0, v0, jnp.inf).reshape(Q, -1)
        flat_rows = jnp.where(ok0, rows0, 0).reshape(Q, -1)
        if P_ > 1:
            ok1 = is_local[:, 1:, None]
            flat_vals = jnp.concatenate(
                [flat_vals, jnp.where(ok1, v1, jnp.inf).reshape(Q, -1)],
                axis=1)
            flat_rows = jnp.concatenate(
                [flat_rows, jnp.where(ok1, rows1, 0).reshape(Q, -1)],
                axis=1)
        p1_eff = min(f * pass_1, flat_vals.shape[1])
        vsel, top_pos = pass1_topk(-flat_vals, p1_eff, method)
        cand_p = jnp.take_along_axis(flat_rows, top_pos, axis=1)
        cand = jnp.where(jnp.isfinite(vsel), ids_l[cand_p], -1)

    # ---- local exact rescore from the shard's flat vector array
    gathered = vecs_l[jnp.clip(cand_p, 0, vecs_l.shape[0] - 1)]
    diff = gathered - q[:, None, :]
    d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.where(valid_sel if cand is None else (cand >= 0),
                   d2, jnp.inf)
    if f > 1:
        k2 = min(k * f, p1_eff)
        _, best = jax.lax.top_k(-d2, k2)
        d2 = jnp.take_along_axis(d2, best, axis=1)
        if cand is None:                     # decode ids on the sliver
            rows_b = jnp.take_along_axis(cand_p, best, axis=1)
            cand = jnp.where(jnp.isfinite(d2), ids_l[rows_b], -1)
        else:
            cand = jnp.take_along_axis(cand, best, axis=1)
        cand, d2 = dedup_candidates(cand, d2)
        _, best = jax.lax.top_k(-d2, k)
        loc_ids = jnp.take_along_axis(cand, best, axis=1)
        loc_d2 = jnp.take_along_axis(d2, best, axis=1)
    else:
        _, best = jax.lax.top_k(-d2, k)
        loc_d2 = jnp.take_along_axis(d2, best, axis=1)
        if cand is None:                     # decode ids for winners
            rows_b = jnp.take_along_axis(cand_p, best, axis=1)
            loc_ids = jnp.where(jnp.isfinite(loc_d2),
                                ids_l[rows_b], -1)
        else:
            loc_ids = jnp.take_along_axis(cand, best, axis=1)

    # ---- merge across shards: the only collective
    all_ids = jax.lax.all_gather(loc_ids, axis)         # (S, Q, k)
    all_d2 = jax.lax.all_gather(loc_d2, axis)
    all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(Q, -1)
    all_d2 = jnp.moveaxis(all_d2, 0, 1).reshape(Q, -1)
    # cross-shard dedup (a spilled point can surface on two shards)
    all_ids, all_d2 = dedup_candidates(all_ids, all_d2)
    _, best = jax.lax.top_k(-all_d2, k)
    out_ids = jnp.take_along_axis(all_ids, best, axis=1)
    out_d2 = jnp.take_along_axis(all_d2, best, axis=1)
    out_ids = jnp.where(jnp.isfinite(out_d2), out_ids, -1)
    return out_ids, out_d2, jax.lax.psum(dropped, psum_axes)


def lloyd_step_dp(X, centers, mesh, axis: str = "shards"):
    """One data-parallel Lloyd iteration over the mesh.

    ``X`` sharded on dim 0, ``centers`` replicated; local partial
    sums/counts are combined with psum — the canonical data-parallel
    training-step shape (local compute + collective).
    """
    def step(Xl, C):
        d2 = (jnp.einsum("nd,nd->n", Xl, Xl)[:, None]
              + jnp.einsum("kd,kd->k", C, C)[None, :]
              - 2.0 * jax.lax.dot_general(
                  Xl, C, (((1,), (1,)), ((), ())),
                  preferred_element_type=jnp.float32))
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, C.shape[0], dtype=jnp.float32)
        sums = jax.lax.dot_general(
            onehot, Xl, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        counts = jnp.sum(onehot, axis=0)
        inertia = jnp.sum(jnp.min(d2, axis=1))
        sums = jax.lax.psum(sums, axis)
        counts = jax.lax.psum(counts, axis)
        inertia = jax.lax.psum(inertia, axis)
        newC = jnp.where(counts[:, None] > 0,
                         sums / jnp.maximum(counts[:, None], 1.0), C)
        return newC, inertia

    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(axis), P()), out_specs=(P(), P())))(
            X, centers)
