"""Distance-table construction and int8 quantization.

A PQ distance table holds, for one query, the squared distance from the
query's block to each of the 16 codebook centers of that block:
``dists[b, c] = ||q_b - center[b, c]||^2`` — shape (n_blocks, 16).

The reference quantizes tables to int8 with a shift/scale chosen so the
*saturating int8* accumulation of ~n_blocks entries rarely overflows
(reference: tinyknn/fast_pq.py:206-222). Here the scan accumulates in
int32, so overflow is gone, but we keep the same int8 table format and
heuristics: equal memory, comparable recall, and int8 operands for the
one-hot matrix product. Everything is batched over queries.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

LN2 = 0.6931471805599453


class QuantizedTables(NamedTuple):
    """Batched quantized distance tables.

    tables: int8[(Q, n_blocks, 16)] — for 'unsigned' mode the stored
        value is (true - 128) so both modes fit int8.
    shift:  f32[(Q,)] — per-query additive de-quantization shift.
    scale:  f32[(Q,)] — per-query multiplicative de-quantization scale.
    signed: bool — which reference quantization scheme produced this.
    """
    tables: jax.Array
    shift: jax.Array
    scale: jax.Array
    signed: bool

    @property
    def n_blocks(self):
        return self.tables.shape[1]


def block_dists_blocked(q_blocks, center_blocks):
    """q_blocks: (Q, B, dpb); center_blocks: (B, 16, dpb) -> (Q, B, 16).

    Expanded form ||q||^2 + ||c||^2 - 2 q.c: the cross term is a
    batched matmul and nothing materializes the (Q, B, 16, dpb)
    difference tensor (~140 MB at 10k GloVe queries) the naive
    broadcast-subtract form writes and re-reads.
    """
    qn = jnp.einsum("qbd,qbd->qb", q_blocks, q_blocks)
    cn = jnp.einsum("bkd,bkd->bk", center_blocks, center_blocks)
    cross = jnp.einsum("qbd,bkd->qbk", q_blocks, center_blocks,
                       preferred_element_type=jnp.float32)
    # The expanded form can go slightly negative by cancellation when a
    # query block sits on a center; the float-tables fold encoding
    # (bf16 bits << 16, ops/kernels.py) needs non-negative estimates
    # for IEEE-bit order preservation, so clamp by construction.
    return jnp.maximum(qn[:, :, None] + cn[None, :, :] - 2.0 * cross, 0.0)


@jax.jit
def quantize_tables_signed(dists):
    """Reference 'signed' scheme (tinyknn/fast_pq.py:209-222), batched.

    shift = mean * ln2 (~= median of the exponentially-distributed
    squared distances), scale = 128 / (max * sqrt(n_blocks)). The
    reference then wraps to uint8 (relying on saturating adds); we clip
    to [-128, 127], which can only improve the estimate under int32
    accumulation.
    """
    Q, B, _ = dists.shape
    sqrt_b = jnp.sqrt(jnp.float32(B))
    shift = jnp.mean(dists, axis=(1, 2)) * LN2
    shifted = dists - shift[:, None, None]
    scale = 128.0 / (jnp.max(shifted, axis=(1, 2)) * sqrt_b)
    t = jnp.round(shifted * scale[:, None, None])
    t = jnp.clip(t, -128, 127).astype(jnp.int8)
    return QuantizedTables(t, shift, scale, True)


@jax.jit
def quantize_tables_unsigned(dists):
    """Reference 'unsigned' scheme (tinyknn/fast_pq.py:239-252), batched.

    shift = min, scale = 255 / (max * ln(B) * sqrt(B)); true table values
    live in [0, 255] — stored biased by -128 so the int8 path applies;
    estimates get the constant 128 * B added back at de-quantization.
    """
    Q, B, _ = dists.shape
    sqrt_b = jnp.sqrt(jnp.float32(B))
    log_b = jnp.log(jnp.float32(max(B, 2)))
    shift = jnp.min(dists, axis=(1, 2))
    shifted = dists - shift[:, None, None]
    scale = 255.0 / (jnp.max(shifted, axis=(1, 2)) * log_b * sqrt_b)
    t = jnp.round(shifted * scale[:, None, None])
    t = jnp.clip(t, 0, 255)
    t = (t - 128).astype(jnp.int8)
    return QuantizedTables(t, shift, scale, False)


@jax.jit
def tables_bf16(dists):
    """Unquantized bf16 tables — a beyond-reference quality mode.

    int32 accumulation frees us from the reference's overflow-driven
    int8 quantization, so the ~2-3 rank positions the int8 rounding
    costs at the 90% quantile (docs/PERFORMANCE.md) can be bought back
    with bf16 tables: they are per-query temporaries, so index memory
    is unchanged. Identity shift/scale keeps the QuantizedTables
    contract (dequantize is a no-op plus casts).
    """
    Q = dists.shape[0]
    return QuantizedTables(dists.astype(jnp.bfloat16),
                           jnp.zeros((Q,), jnp.float32),
                           jnp.ones((Q,), jnp.float32), True)


def dequantize_estimates(est_i32, qt: QuantizedTables):
    """Turn int32 accumulated table sums into approximate squared distances.

    Table entry b holds (||q_b - center_b||^2 - shift) * scale, so the
    accumulated sum de-quantizes to est / scale + B * shift — the full
    approximate squared distance (per-block terms already include the
    query-block norms). The reference's rescale path adds q.q and only
    one shift (tinyknn/fast_pq.py:280-282), a per-query constant offset
    that cannot change rankings; we return the unbiased estimate instead.
    """
    B = qt.n_blocks
    est = est_i32.astype(jnp.float32)
    if not qt.signed:
        est = est + 128.0 * B
    return est / qt.scale[..., None] + B * qt.shift[..., None]
