"""Top-k selection ops — the batched replacement for the reference's heap.

The reference collects candidates with a nogil binary max-heap plus a
linear duplicate check (reference: tinyknn/_fast_pq.pyx:240-307). On an
accelerator there is no scalar heap: batched ``jax.lax.top_k`` over estimated
distances plays that role, a *merge* op plays the role of heap insertion
across successive scans (clusters probed one at a time), and a sort-based
dedup handles labels spilled into several lists by build_probes > 1
(reference dedups inside the heap, tinyknn/_fast_pq.pyx:285-287).

The production query pipeline uses ``smallest_k`` and
``dedup_candidates``; ``streaming_topk_init`` / ``merge_topk`` /
``masked_smallest_k`` are the public API-parity analogue of the
reference's *exported* heap kernels (``init_heap`` / ``insert``,
re-exported at tinyknn/__init__.py:1-6 and exercised by its
tests/test_heap.py) — user code that drove the reference's heap
directly ports to these; tests/test_topk.py mirrors the reference's
heap test family (SURVEY.md §4.3).

Everything here uses smaller-is-better semantics (distances) and static
shapes. Invalid slots carry value ``INF_SCORE`` and index ``-1``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Plain Python float, NOT jnp.float32(...): calling a jnp scalar type
# materializes a device array at import time, which makes
# `import tinyknn_tpu` touch (and fail without) a device
# (tests/test_import.py). Weak-typed inf promotes to f32 at every use
# site.
INF_SCORE = float("inf")


@partial(jax.jit, static_argnames=("k",))
def smallest_k(vals, k: int):
    """(values, indices) of the k smallest entries along the last axis."""
    neg_vals, idx = jax.lax.top_k(-jnp.asarray(vals, jnp.float32), k)
    return -neg_vals, idx


@partial(jax.jit, static_argnames=("k",))
def masked_smallest_k(vals, mask, k: int):
    """k smallest entries where ``mask`` is True.

    Masked-out entries come back (if at all) with value +inf and index -1,
    always sorted to the tail.
    """
    vals = jnp.where(mask, jnp.asarray(vals, jnp.float32), INF_SCORE)
    best, idx = smallest_k(vals, k)
    idx = jnp.where(jnp.isfinite(best), idx, -1)
    return best, idx


@jax.jit
def merge_topk(vals_a, idx_a, vals_b, idx_b):
    """Merge two sorted-or-not candidate sets, keeping the best |a| entries.

    The streaming analogue of heap insertion: ``(vals_a, idx_a)`` is the
    running state, ``(vals_b, idx_b)`` the new candidates. Returns state
    of the same shape as the inputs' concatenation truncated to len(a).
    """
    k = vals_a.shape[-1]
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    best, pos = smallest_k(vals, k)
    return best, jnp.take_along_axis(idx, pos, axis=-1)


@jax.jit
def dedup_candidates(ids, vals):
    """Invalidate duplicate ids, keeping the best-valued occurrence.

    ``ids``/``vals`` have matching shape (..., m). For every group of
    equal non-negative ids, all but the smallest-value occurrence get
    value +inf and id -1. No data-dependent shapes: output shape equals
    input shape. Replaces the reference heap's duplicate check
    (tinyknn/_fast_pq.pyx:285-287).
    """
    ids = jnp.asarray(ids)
    vals = jnp.asarray(vals, jnp.float32)
    # Sort by (id, val): equal ids adjacent, best value first within a run.
    m = ids.shape[-1]
    order = jnp.lexsort((vals, ids), axis=-1)
    s_ids = jnp.take_along_axis(ids, order, axis=-1)
    s_vals = jnp.take_along_axis(vals, order, axis=-1)
    prev = jnp.concatenate(
        [jnp.full(s_ids.shape[:-1] + (1,), -1, s_ids.dtype), s_ids[..., :-1]],
        axis=-1,
    )
    dup = (s_ids == prev) & (s_ids >= 0)
    s_vals = jnp.where(dup, INF_SCORE, s_vals)
    s_ids = jnp.where(dup, -1, s_ids)
    # Scatter back to the original positions.
    out_ids = jnp.zeros_like(ids)
    out_vals = jnp.zeros_like(vals)
    out_ids = _scatter_last(out_ids, order, s_ids)
    out_vals = _scatter_last(out_vals, order, s_vals)
    return out_ids, out_vals


def _scatter_last(dst, idx, src):
    """dst[..., idx[..., j]] = src[..., j] along the last axis."""
    inv = jnp.argsort(idx, axis=-1)
    return jnp.take_along_axis(src, inv, axis=-1)


def streaming_topk_init(batch_shape, k: int, id_dtype=jnp.int32):
    """Initial (vals, ids) state for merge_topk accumulation.

    Mirrors the reference's ``init_heap`` (tinyknn/_fast_pq.pyx:240-252):
    all slots empty (+inf / -1).
    """
    vals = jnp.full(tuple(batch_shape) + (k,), INF_SCORE, jnp.float32)
    ids = jnp.full(tuple(batch_shape) + (k,), -1, id_dtype)
    return vals, ids
