"""PQ distance-estimate scan: the replacement for the SIMD kernels.

The reference's hot op sums, for each point, one 4-bit-indexed table
entry per block, 16 points at a time with pshufb + saturating int8 adds
(reference: tinyknn/_fast_pq.pyx:209-236, _fast_pq_256.pyx:126-156).

The accelerator statement of that math: the lookup is a contraction of
a one-hot expansion of the codes with the tables —

    est[q, i] = sum_b tables[q, b, codes[i, b]]
             = sum_{b,c} one_hot(codes)[i, b, c] * tables[q, b, c]

i.e. an (n, 16B) x (16B, Q) int8 matrix product with int32
accumulation, batched over queries: no saturation, no overflow tuning.
XLA compiles it; a slow emulation of the reference's sequential
saturating-int8 semantics is kept for parity experiments and tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

@partial(jax.jit, static_argnames=("packed",))
def estimate_scan(codes, tables, packed: bool = False):
    """codes: uint8[n, B] (0..15), or uint8[n, B/2] nibble-packed when
    ``packed``; tables: int8[Q, B, 16] -> int32[Q, n].

    The 4-bit unpack fuses into the one-hot expansion, so device memory
    holds only the packed bytes (half the reference-equal code memory).
    Float tables contract a bf16 one-hot into f32.
    """
    if packed:
        from .packing import unpack_codes
        codes = unpack_codes(codes)
    floating = jnp.issubdtype(tables.dtype, jnp.floating)
    onehot = jax.nn.one_hot(
        codes, 16, dtype=jnp.bfloat16 if floating else jnp.int8)
    n = codes.shape[0]
    q = tables.shape[0]
    a = onehot.reshape(n, -1)
    b = tables.reshape(q, -1)
    return jax.lax.dot_general(
        b, a, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32 if floating else jnp.int32)


@partial(jax.jit, static_argnames=("signed", "lanes"))
def estimate_scan_saturating(codes, tables_u8, signed: bool, lanes: int = 1):
    """Slow emulation of the reference's saturating-int8 accumulation.

    Matches the SSE semantics (sequential saturate per block,
    tests/test_pq.py:33-37 oracle) for lanes=1, and the AVX two-lane
    quirk — blocks split by bit 1 of the block index into two lanes that
    saturate independently and combine at the end
    (reference: _fast_pq_256.pyx:126-156, tests/test_pq.py:39-49) — for
    lanes=2. Tables arrive as the *raw uint8 bytes* like the reference
    kernels see them; ``signed`` picks the int8/uint8 view. Returns
    int32[Q, n] with values in the int8/uint8 range.
    """
    lo, hi = (-128, 127) if signed else (0, 255)
    view = jnp.int8 if signed else jnp.uint8
    t = tables_u8.astype(jnp.uint8).view(view).astype(jnp.int32)  # (Q, B, 16)
    n, B = codes.shape
    gathered = jnp.take_along_axis(
        t[:, None, :, :].repeat(n, axis=1),
        codes.astype(jnp.int32)[None, :, :, None], axis=3,
    )[..., 0]  # (Q, n, B)

    def lane_sum(vals):  # vals: (Q, n, B_lane)
        def step(acc, v):
            acc = jnp.clip(acc + v, lo, hi)
            return acc, None
        acc0 = jnp.zeros(vals.shape[:2], jnp.int32)
        acc, _ = jax.lax.scan(step, acc0, jnp.moveaxis(vals, 2, 0))
        return acc

    if lanes == 1:
        return lane_sum(gathered)
    assert lanes == 2
    idx = np.arange(B)
    lane0 = lane_sum(gathered[:, :, idx % 4 < 2])
    lane1 = lane_sum(gathered[:, :, idx % 4 >= 2])
    return jnp.clip(lane0 + lane1, lo, hi)
