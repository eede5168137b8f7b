"""Index persistence: save/load FastPQ and IVF as npz archives.

The reference's only persistence is an ad-hoc pickle in its benchmark
script (reference: examples/bench.py:88-103). Here it is a first-class
API: after padding, a whole index is a handful of dense arrays, so a
single compressed npz (portable, mmap-able, no code execution on load)
is the right format.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from .models.fast_pq import FastPQ
from .models.ivf import IVF

# v3: inverted lists stored CSR-tiled (csr_codes uint8[T, Bs, 128] +
#     flat csr_ids + tile_offsets) — reference-equal memory, no
#     pad-to-max-length grid.
# v2: dense (C, cap) grid, codes nibble-packed (two 4-bit codes/byte).
# v1: dense grid, one code per byte.
# v1/v2 archives are converted to CSR on load.
_FORMAT_VERSION = 3


def _pq_state(pq: FastPQ) -> dict:
    state = {
        "pq_center_blocks": np.asarray(pq.center_blocks),
        "pq_meta": np.frombuffer(json.dumps({
            "dims_per_block": pq.dims_per_block,
            "use_kmeans": pq.use_kmeans,
            "rotate_dim": pq.rotate_dim,
            "seed": pq.seed,
            "kmeans_iters": pq.kmeans_iters,
            "kmeans_n_init": pq.kmeans_n_init,
            "table_dtype": pq.table_dtype,
        }).encode(), dtype=np.uint8),
    }
    if pq.R is not None:
        state["pq_R"] = np.asarray(pq.R)
    return state


def _pq_restore(data) -> FastPQ:
    meta = json.loads(bytes(data["pq_meta"]).decode())
    pq = FastPQ(dims_per_block=meta["dims_per_block"],
                use_kmeans=meta["use_kmeans"],
                rotate_dim=meta["rotate_dim"], seed=meta["seed"],
                kmeans_iters=meta.get("kmeans_iters", 25),
                kmeans_n_init=meta.get("kmeans_n_init", 2),
                table_dtype=meta.get("table_dtype", "int8"))
    cb = jnp.asarray(data["pq_center_blocks"])
    pq.center_blocks = cb
    B, _, dpb = cb.shape
    pq.centers = jnp.asarray(
        np.asarray(cb).transpose(1, 0, 2).reshape(16, B * dpb))
    pq.sqrt_n_blocks = float(np.sqrt(B))
    if "pq_R" in data:
        pq.R = jnp.asarray(data["pq_R"])
    return pq


def save_pq(path, pq: FastPQ, compress: bool = False):
    assert pq.centers is not None, "save_pq: PQ not fitted"
    saver = np.savez_compressed if compress else np.savez
    saver(path, format=np.int32(_FORMAT_VERSION),
          kind=np.frombuffer(b"fastpq", np.uint8),
          **_pq_state(pq))


def load_pq(path) -> FastPQ:
    with np.load(path) as data:
        return _pq_restore(data)


def _unshard_csr(ivf):
    """Reassemble the global CSR arrays from a ShardedIVF's per-shard
    stacked form (see ShardedIVF._place): strip each shard's tile
    padding and re-base the offsets."""
    starts, stops, Cl, C = ivf._shard_meta
    n_dev = len(starts)
    T_l = ivf._shard_tiles
    codes_st = np.asarray(ivf.csr_codes).reshape(
        n_dev, T_l, *np.asarray(ivf.csr_codes).shape[1:])
    ids_st = np.asarray(ivf.csr_ids).reshape(n_dev, T_l * 128)
    toff_st = np.asarray(ivf.tile_offsets).reshape(n_dev, Cl)
    counts_st = np.asarray(ivf.list_counts).reshape(n_dev, Cl)
    codes_parts, ids_parts, toffs, counts = [], [], [], []
    base = 0
    for s in range(n_dev):
        n_t = int(stops[s] - starts[s])
        codes_parts.append(codes_st[s, :n_t])
        ids_parts.append(ids_st[s, :n_t * 128])
        toffs.append(toff_st[s] + base)
        counts.append(counts_st[s])
        base += n_t
    guard = np.zeros_like(codes_st[0, :1])
    csr_codes = np.concatenate(codes_parts + [guard])
    csr_ids = np.concatenate(
        ids_parts + [np.full(128, -1, np.int32)])
    tile_offsets = np.concatenate(toffs)[:C].astype(np.int32)
    list_counts = np.concatenate(counts)[:C].astype(np.int32)
    return csr_codes, csr_ids, tile_offsets, list_counts


def save_ivf(path, ivf: IVF, compress: bool = False):
    """Persist a built IVF (or ShardedIVF: per-shard padding is
    stripped and offsets re-based, so the archive is
    mesh-shape-independent and can be re-sharded on load).

    ``compress`` is off by default: the bulk is quantized codes and
    float vectors that barely compress, and zip-deflate costs minutes
    at GloVe scale (~3.5 min vs ~5 s for a 1.2M-point index)."""
    assert ivf.csr_codes is not None, "save_ivf: index not built"
    if getattr(ivf, "_n_active_real", None) is not None:  # sharded
        csr_codes, csr_ids, tile_offsets, list_counts = _unshard_csr(ivf)
        active_centers = np.asarray(ivf.active_centers)[
            :ivf._n_active_real]
    else:
        csr_codes = np.asarray(ivf.csr_codes)
        csr_ids = np.asarray(ivf.csr_ids)
        tile_offsets = np.asarray(ivf.tile_offsets)
        list_counts = np.asarray(ivf.list_counts)
        active_centers = np.asarray(ivf.active_centers)
    state = _pq_state(ivf.pq)
    saver = np.savez_compressed if compress else np.savez
    saver(
        path, format=np.int32(_FORMAT_VERSION),
        kind=np.frombuffer(b"ivf", np.uint8),
        ivf_meta=np.frombuffer(json.dumps({
            "metric": ivf.metric,
            "n_clusters": ivf.n_clusters,
            "seed": ivf.seed,
            "kmeans_iters": ivf.kmeans_iters,
            "queries_per_cluster": ivf.queries_per_cluster,
            "pass1_method": ivf.pass1_method,
            "scan_impl": ivf.scan_impl,
            "build_probes": getattr(ivf, "build_probes", 2),
            "fold_mult": getattr(ivf, "fold_mult", 8),
            "rescore_rows": bool(getattr(ivf, "rescore_rows", False)),
            "scan_budget_bytes": int(getattr(ivf, "scan_budget_bytes",
                                             2 << 30)),
        }).encode(), dtype=np.uint8),
        all_centers=np.asarray(ivf.all_centers),
        active_centers=active_centers,
        csr_codes=csr_codes,
        csr_ids=csr_ids,
        tile_offsets=tile_offsets,
        list_counts=list_counts,
        data=np.asarray(ivf.data),
        **({"labels": np.asarray(ivf.labels)}
           if getattr(ivf, "labels", None) is not None else {}),
        **state)


def _dense_grid_to_csr(list_codes, list_ids, counts):
    """Convert a v1/v2 dense (C, cap, ...) list grid to the CSR tile
    layout (host-side; load path only; mirrors pack_codes_tiled)."""
    from .utils.padding import round_up
    C, cap, Bs = list_codes.shape
    counts = np.asarray(counts).astype(np.int64)
    ntiles = -(-counts // 128)
    toff = np.zeros(C, np.int64)
    np.cumsum(ntiles[:-1], out=toff[1:])
    total = int(ntiles.sum()) + 1
    flat_ids = np.full(total * 128, -1, np.int32)
    flat_codes = np.zeros((total * 128, Bs), np.uint8)
    for c in range(C):
        L = int(counts[c])
        s = int(toff[c]) * 128
        flat_ids[s:s + L] = list_ids[c, :L]
        flat_codes[s:s + L] = list_codes[c, :L]
    rows = np.pad(flat_codes,
                  ((0, 0), (0, round_up(Bs, 8) - Bs)))
    csr_codes = rows.reshape(total, 128, -1).transpose(0, 2, 1)
    return (csr_codes, flat_ids, toff.astype(np.int32),
            counts.astype(np.int32))


def load_ivf(path, skip_derived: bool = False) -> IVF:
    """Restore an IVF from an archive. ``skip_derived=True`` skips
    building the single-device derived arrays (exact mode's bf16 tiles,
    rescore_rows' raw-row copy) — used by ``load_sharded_ivf``, whose
    ``_place()`` derives per-shard versions itself and never reads the
    single-device ones."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["ivf_meta"]).decode())
        pq = _pq_restore(data)
        ivf = IVF.__new__(IVF)
        ivf.metric = meta["metric"]
        ivf.n_clusters = meta["n_clusters"]
        ivf.seed = meta["seed"]
        ivf.kmeans_iters = meta.get("kmeans_iters", 30)
        ivf.queries_per_cluster = meta.get("queries_per_cluster")
        ivf.pass1_method = meta.get("pass1_method", "auto")
        ivf.scan_impl = meta.get("scan_impl", "auto")
        ivf.fold_mult = meta.get("fold_mult", 8)
        ivf.rescore_rows = meta.get("rescore_rows", False)
        ivf.scan_budget_bytes = meta.get("scan_budget_bytes", 2 << 30)
        ivf.build_probes = meta.get("build_probes")
        ivf.pq = pq
        ivf.labels = (np.asarray(data["labels"])
                      if "labels" in data else None)
        ivf.all_centers = np.asarray(data["all_centers"])
        ivf.active_centers = jnp.asarray(data["active_centers"])
        if int(data["format"]) >= 3:
            csr_codes = np.asarray(data["csr_codes"])
            csr_ids = np.asarray(data["csr_ids"])
            tile_offsets = np.asarray(data["tile_offsets"])
            list_counts = np.asarray(data["list_counts"])
        else:  # v1/v2 dense grids
            codes = np.asarray(data["list_codes"])
            if int(data["format"]) < 2:  # v1: one code per byte
                from .ops.packing import pack_codes
                codes = np.asarray(pack_codes(codes))
            list_ids = np.asarray(data["list_ids"])
            if "list_counts" in data:
                counts = np.asarray(data["list_counts"])
            else:
                counts = np.sum(list_ids >= 0, axis=1).astype(np.int32)
            csr_codes, csr_ids, tile_offsets, list_counts = (
                _dense_grid_to_csr(codes, list_ids, counts))
        ivf.csr_codes = jnp.asarray(csr_codes)
        ivf.csr_ids = jnp.asarray(csr_ids)
        ivf.tile_offsets = jnp.asarray(tile_offsets)
        ivf.list_counts = jnp.asarray(list_counts)
        ivf.max_tiles = max(
            1, int(-(-int(list_counts.max(initial=0)) // 128)))
        ivf.data = jnp.asarray(data["data"])
        if ivf.build_probes is None:
            # pre-v3 archives carry no build_probes; an under-estimate
            # would under-size the duplicate-aware f*pass_1 selection
            # (models/ivf.py stage 4). build() places every point in
            # exactly build_probes lists, so the spill bound is simply
            # sum(list_counts) / n_rows — O(C), with no O(n) bincount
            # transient at load time.
            n_rows = max(1, int(ivf.data.shape[0]))
            total = int(np.asarray(list_counts, np.int64).sum())
            ivf.build_probes = max(1, int(round(total / n_rows)))
        # exact mode's raw bf16 tiles are derived state — rebuild from
        # (data, csr_ids) rather than doubling the archive size
        ivf.csr_vecs = None
        if ivf.scan_impl == "exact" and not skip_derived:
            from .models.ivf import _augment_data_csr
            ivf.csr_vecs = _augment_data_csr(ivf.data, ivf.csr_ids)
        # CSR-ordered raw rows (rescore_rows) are derived state too
        ivf.csr_raw = None
        if getattr(ivf, "rescore_rows", False) and not skip_derived:
            from .models.ivf import _csr_raw_rows
            ivf.csr_raw = _csr_raw_rows(ivf.data, ivf.csr_ids)
        return ivf


def load_sharded_ivf(path, mesh=None, axis="shards", query_axis=None,
                     **kw):
    """Load an IVF archive (sharded or single-device) as a ShardedIVF
    placed over ``mesh`` — the mesh shape need not match the one the
    index was saved from (the archive stores the unsharded CSR)."""
    from .parallel.sharded_ivf import ShardedIVF

    # skip_derived: _place() derives per-shard exact tiles itself, and
    # the sharded rescore never reads csr_raw (it gathers from its
    # per-shard list_vecs) — don't build or retain the single-device
    # versions (advisor r3).
    base = load_ivf(path, skip_derived=True)
    sivf = ShardedIVF.__new__(ShardedIVF)
    sivf.__dict__.update(base.__dict__)
    from .parallel.mesh import make_mesh
    sivf.mesh = mesh if mesh is not None else make_mesh(axis=axis)
    sivf.axis = axis
    sivf.query_axis = query_axis
    sivf.list_vecs = None
    sivf._place()
    return sivf
