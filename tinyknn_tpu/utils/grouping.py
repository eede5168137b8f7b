"""Inverted-list construction.

The reference builds its IVF lists as Python lists-of-arrays with an
argsort/run-length sweep (reference: tinyknn/utils.py:95-162). A jitted
index needs *dense, static-shape* structures instead, so the primary
product here is a padded id grid:

    ids:    (n_lists, cap) int32, entries < 0 are padding
    counts: (n_lists,)     int32, true length of each list

plus a CSR view (flat ids + offsets) for ragged kernels. Everything is
host-side NumPy — index build is a one-off — with a C++ counting-sort
fast path (native/tinyknn_native.cpp) used when available for both the
dense grid and the production tiled CSR builder; the NumPy paths
are bit-identical fallbacks (tests/test_native.py).
"""

from __future__ import annotations

import numpy as np

from .padding import round_up


def invert_assignments(assignments, n_lists: int, pad_to: int = 8,
                       use_native: bool = True):
    """Build padded inverted lists from a (N, p) assignment matrix.

    Each point ``i`` appears in lists ``assignments[i, :]`` (build-probes
    spill, reference: tinyknn/ivf.py:85). Returns ``(ids, counts)`` where
    ``ids`` is (n_lists, cap) int32 padded with -1 and ``cap`` is the max
    list length rounded up to a multiple of ``pad_to``.

    Uses the C++ counting-sort builder (native/tinyknn_native.cpp) when
    available; the NumPy path below produces bit-identical output.
    """
    if use_native:
        from ..native import invert_assignments_native
        out = invert_assignments_native(assignments, n_lists, pad_to)
        if out is not None:
            return out
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    n, p = assignments.shape
    flat = assignments.reshape(-1).astype(np.int64)
    assert n_lists > 0
    assert flat.size == 0 or (flat.min() >= 0 and flat.max() < n_lists), \
        "assignments out of range"

    counts = np.bincount(flat, minlength=n_lists).astype(np.int32)
    cap = max(round_up(int(counts.max()) if counts.size else 0, pad_to), pad_to)

    order = np.argsort(flat, kind="stable")
    sorted_lists = flat[order]
    point_ids = (order // p).astype(np.int32)

    starts = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[sorted_lists]

    ids = np.full((n_lists, cap), -1, dtype=np.int32)
    ids[sorted_lists, pos] = point_ids
    return ids, counts


def invert_assignments_csr_tiled(assignments, n_lists: int,
                                 tile: int = 128, align_tiles: int = 1,
                                 use_native: bool = True):
    """Tiled CSR inverted lists for the ragged list scan.

    Each list's member ids are laid out contiguously and padded with -1
    to a multiple of ``tile``, so a list is a whole number of
    (tile,)-wide code tiles.

    Returns ``(flat_ids, tile_offsets, counts)``:
      flat_ids:     (N_pad,) int32, -1 padding; N_pad is a multiple of
                    ``tile`` (one extra all-padding tile is appended so
                    a trailing over-read by the kernel stays in bounds).
      tile_offsets: (n_lists,) int32 — list i starts at flat index
                    ``tile_offsets[i] * tile``.
      counts:       (n_lists,) int32 true list lengths.

    Replaces the dense grid's pad-to-max-length waste (the reference
    sidesteps ragged lists with Python lists, tinyknn/ivf.py:100-102;
    a jitted index needs static shapes — this is the static-shape
    ragged encoding).

    Uses the C++ counting-sort scatter (native/tinyknn_native.cpp
    fill_csr_tiled) when available — O(N*p) with no comparison sort;
    the NumPy argsort path below produces bit-identical output.
    """
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    n, p = assignments.shape
    flat = assignments.reshape(-1).astype(np.int64)
    assert n_lists > 0
    assert flat.size == 0 or (flat.min() >= 0 and flat.max() < n_lists), \
        "assignments out of range"
    if use_native:
        from ..native import invert_assignments_csr_tiled_native
        out = invert_assignments_csr_tiled_native(
            assignments, n_lists, tile, align_tiles)
        if out is not None:
            return out
    counts = np.bincount(flat, minlength=n_lists).astype(np.int32)
    ntiles = -(-counts.astype(np.int64) // tile)
    if align_tiles > 1:  # lists start on multi-tile bounds
        ntiles = -(-ntiles // align_tiles) * align_tiles
    tile_offsets64 = np.zeros(n_lists, dtype=np.int64)
    np.cumsum(ntiles[:-1], out=tile_offsets64[1:])
    total = int(ntiles.sum()) + max(1, align_tiles)  # + guard tile(s)
    flat_ids = np.full(total * tile, -1, dtype=np.int32)

    order = np.argsort(flat, kind="stable")
    sorted_lists = flat[order]
    point_ids = (order // p).astype(np.int32)
    starts = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[sorted_lists]
    flat_ids[tile_offsets64[sorted_lists] * tile + pos] = point_ids
    return flat_ids, tile_offsets64.astype(np.int32), counts


def invert_assignments_csr(assignments, n_lists: int):
    """CSR form: (flat_ids, offsets) with offsets shape (n_lists + 1,)."""
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    n, p = assignments.shape
    flat = assignments.reshape(-1).astype(np.int64)
    counts = np.bincount(flat, minlength=n_lists).astype(np.int64)
    offsets = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(flat, kind="stable")
    flat_ids = (order // p).astype(np.int32)
    return flat_ids, offsets


def group_data_by_indices(X, indices, k: int):
    """API-parity port of the reference grouping helper.

    Given data ``X`` (N, d) and ``indices`` (N, c) with values in
    [0, k), return ``(parts, ids)``: k arrays of grouped rows and the
    matching original row ids (reference: tinyknn/utils.py:95-162).
    Unlike the reference, rows within a group arrive ordered by
    (probe-column, row-id) — the contract (set of rows per group) is the
    same.
    """
    X = np.asarray(X)
    indices = np.asarray(indices)
    assert indices.size == 0 or (0 <= indices.min() and indices.max() < k)
    n, c = indices.shape
    # Column-major flatten so probe-column 0 of every point comes first,
    # matching the reference's per-column iteration order.
    flat = indices.T.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    point_ids = order % n
    counts = np.bincount(flat, minlength=k)
    bounds = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    parts, ids = [], []
    for g in range(k):
        sel = point_ids[bounds[g]:bounds[g + 1]]
        if sel.size == 0:
            parts.append(np.empty((0, X.shape[1])))
            ids.append(np.empty(0))
        else:
            parts.append(X[sel])
            ids.append(sel)
    return parts, ids
