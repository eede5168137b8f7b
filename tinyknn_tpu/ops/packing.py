"""4-bit code packing.

The reference stores PQ codes in the Quick-ADC pshufb layout — 16-row
transposed chunks interleaved 2-by-2 into uint64 words (reference:
tinyknn/_transform.py:4-77). That layout is an x86 artifact; matrix
products want plain row-major tiles. The format here is simply:

    codes:  uint8[n, n_blocks], values 0..15      (compute format)
    packed: uint8[n, n_blocks // 2]               (device storage format)

with two 4-bit codes per byte (low nibble = even block). Pack/unpack are
exact inverses; the round-trip property test mirrors the reference's
transform/unpack tests (tests/test_transform.py:71-101).

Inverted lists keep the packed codes CSR-tiled (``pack_codes_tiled``):
``uint8[T, Bs_pad, 128]`` tiles with points on the last axis, a list
owning ``ceil(len / 128)`` consecutive tiles. It is what index archives
hold, and what both the XLA list scan and the CSR kernel read.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.padding import round_up

LANE_TILE = 128  # points per CSR tile


@jax.jit
def pack_codes(codes):
    """uint8[..., B] (values 0..15) -> uint8[..., B/2]; B must be even."""
    codes = jnp.asarray(codes, jnp.uint8)
    assert codes.shape[-1] % 2 == 0, "n_blocks must be even to nibble-pack"
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).astype(jnp.uint8)


@jax.jit
def unpack_codes(packed):
    """uint8[..., B/2] -> uint8[..., B] (values 0..15)."""
    packed = jnp.asarray(packed, jnp.uint8)
    lo = packed & 0xF
    hi = packed >> 4
    return jnp.stack([lo, hi], axis=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))


@jax.jit
def pack_codes_tiled(codes_packed, flat_ids):
    """Gather nibble-packed codes into the CSR tile layout.

    codes_packed: uint8[n, Bs]; flat_ids: int32[T * 128] from
    invert_assignments_csr_tiled (-1 padding reuses row 0, masked at
    query time by counts). Returns uint8[T, Bs_pad, 128] with Bs padded
    to a multiple of 8; the phantom packed bytes are zero and their
    table entries are zero too, so they never contribute to estimates.
    """
    rows = codes_packed[jnp.maximum(flat_ids, 0)]     # (T*128, Bs)
    Bs = rows.shape[1]
    rows = jnp.pad(rows, ((0, 0), (0, round_up(Bs, 8) - Bs)))
    T = flat_ids.shape[0] // LANE_TILE
    return rows.reshape(T, LANE_TILE, -1).transpose(0, 2, 1)
