"""The CSR list-scan kernel: Pallas through Triton, for Hopper.

The reference's native layer is two Cython/SIMD modules doing the
Quick-ADC pshufb scan (reference: tinyknn/_fast_pq.pyx,
_fast_pq_256.pyx). Here the IVF inner loop is one kernel,
``csr_fold_scan``, that walks each inverted list's CSR tiles
(``ops/packing.py``) and emits, per (list, query slot), an encoded
min-fold of the scanned distances. It has two tile bodies:

  * PQ codes: a ``(Bs, 128)`` tile of nibble-packed 4-bit codes is
    expanded in registers to one-hot rows and contracted with the
    query's distance tables (int8 -> int32, or bf16 -> f32 for float
    tables). Nothing but the packed codes is read from device memory;
    the XLA path writes a 16x larger one-hot and a full estimate matrix.
  * exact: a ``(d_aug, 128)`` tile of bf16 vectors augmented with their
    norms is contracted with the augmented queries, giving true squared
    distances rounded to bf16 (``models/ivf.py`` ``_augment_data_csr``).

Grid: (list, block of query slots). Each program loads its list's tile
offset and length, loops over the list's tiles inside the kernel and
min-folds them into the output rows it owns: fold segment ``w`` (128
slots) takes the tiles ``w, w + W, w + 2W, ...``. The result is the
``(C, qc, W * 128)`` int32 fold buffer; ``models/ivf.py``
``_select_pool_enc`` selects on it and decodes only the survivors.

Encoding (monotone in the distance, position bits break ties):
``(est + bias) << col_bits | position`` for int8 tables, and
``bf16_bits(dist) << 16 | position`` for float tables and the exact
body. ``ENC_INVALID`` marks an empty slot.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..utils.padding import round_up
from .packing import LANE_TILE

ENC_INVALID = 2**31 - 1  # empty-slot sentinel of the encoded fold domain
CODE_ROWS = 32           # packed-code rows per contraction (int8 dot K)


def code_rows(B: int) -> int:
    """Packed-code rows the kernel reads per tile for B logical blocks:
    the storage rows (B/2 padded to 8) rounded up to CODE_ROWS."""
    return round_up(max(B // 2, 1), CODE_ROWS)


def int8_col_bits(cap: int, B: int):
    """Position bits of the int8 encoding for lists of up to ``cap``
    points, or None when the value bits would overflow int32."""
    col_bits = max(1, (cap - 1).bit_length())
    if (255 * 2 * code_rows(B) + 1) << col_bits > ENC_INVALID:
        return None
    return col_bits


def kernel_tables(tables_flat, B: int):
    """(..., 16B) block-major distance tables -> the kernel's layout
    (..., 2 * 16 * R), R = code_rows(B): entry [p, v, s] is the table
    value of center v in block 2s + p (the low nibble of packed byte s
    holds block 2s, the high nibble block 2s + 1); phantom blocks are
    zero."""
    R = code_rows(B)
    shape = tables_flat.shape[:-1]
    t = tables_flat.reshape(shape + (B, 16))
    t = jnp.pad(t, [(0, 0)] * len(shape) + [(0, 2 * R - B), (0, 0)])
    t = t.reshape(shape + (R, 2, 16))
    t = jnp.moveaxis(t, -3, -1)                       # (..., 2, 16, R)
    return t.reshape(shape + (32 * R,))


def _pow2_pieces(n: int):
    """Split n (a multiple of 16) into power-of-two (offset, size)
    pieces, largest first: Triton blocks are powers of two."""
    pieces, off = [], 0
    for bit in reversed(range(n.bit_length())):
        size = 1 << bit
        if n - off >= size:
            pieces.append((off, size))
            off += size
    return tuple(pieces)


def _fold_scan_kernel(toff_ref, counts_ref, q_ref, tiles_ref, out_ref, *,
                      W: int, body: str, pieces, col_bits: int,
                      bias: int):
    c = pl.program_id(0)
    toff = toff_ref[c]
    count = counts_ref[c]
    n_tiles = (count + LANE_TILE - 1) // LANE_TILE
    qb = q_ref.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (qb, LANE_TILE), 1)
    dims = (((1,), (0,)), ((), ()))

    if body == "exact":
        qs = [q_ref[:, pl.ds(off, size)] for off, size in pieces]

        def estimate(t):
            acc = jnp.zeros((qb, LANE_TILE), jnp.float32)
            for (off, size), q in zip(pieces, qs):
                vecs = tiles_ref[t, pl.ds(off, size), :]
                acc += jax.lax.dot_general(
                    q, vecs, dims, preferred_element_type=jnp.float32)
            # bf16 input rounding can push a ~0 distance slightly
            # negative; the IEEE-bit encoding needs >= 0
            return jnp.maximum(acc, 0.0)
    else:
        R = tiles_ref.shape[1]
        floating = body == "pq_float"
        acc_t = jnp.float32 if floating else jnp.int32
        hot_t = jnp.bfloat16 if floating else jnp.int8
        ts = [[q_ref[:, pl.ds((p * 16 + v) * R + off, CODE_ROWS)]
               for p in range(2) for v in range(16)]
              for off in range(0, R, CODE_ROWS)]

        def estimate(t):
            acc = jnp.zeros((qb, LANE_TILE), acc_t)
            for piece, off in zip(ts, range(0, R, CODE_ROWS)):
                codes = tiles_ref[t, pl.ds(off, CODE_ROWS), :].astype(
                    jnp.int32)
                nibbles = (jnp.bitwise_and(codes, 15),
                           jax.lax.shift_right_logical(codes, 4))
                for p in range(2):
                    for v in range(16):
                        hot = (nibbles[p] == v).astype(hot_t)
                        acc += jax.lax.dot_general(
                            piece[p * 16 + v], hot, dims,
                            preferred_element_type=acc_t)
            return acc

    def encode(est):
        if body == "pq_int8":
            return jax.lax.shift_left(est + bias, col_bits)
        bits = jax.lax.bitcast_convert_type(
            est.astype(jnp.bfloat16).astype(jnp.float32), jnp.int32)
        return jnp.bitwise_and(bits, jnp.int32(-65536))  # bf16 bits << 16

    def segment(w, carry):
        def tile(i, acc):
            ti = w + i * W
            pos = ti * LANE_TILE + lane
            enc = jnp.bitwise_or(encode(estimate(toff + ti)), pos)
            return jnp.minimum(acc, jnp.where(pos < count, enc,
                                              ENC_INVALID))
        acc = jax.lax.fori_loop(
            0, (n_tiles - w + W - 1) // W, tile,
            jnp.full((qb, LANE_TILE), ENC_INVALID, jnp.int32))
        out_ref[:, pl.ds(pl.multiple_of(w * LANE_TILE, LANE_TILE),
                         LANE_TILE)] = acc
        return carry

    jax.lax.fori_loop(0, W, segment, 0)


@partial(jax.jit, static_argnames=("fold_tiles", "max_tiles", "interpret"))
def csr_fold_scan(q_sel, tiles, tile_offsets, list_counts, *,
                  fold_tiles: int, max_tiles: int,
                  interpret: bool = False):
    """Ragged scan of every list for its bucket of query slots.

    q_sel: per-list query slots — int8/bf16[C, qc, 32 * R]
        (``kernel_tables`` layout) over PQ code tiles, or
        bf16[C, qc, d_aug] augmented queries over exact vector tiles;
    tiles: uint8[T, Bs_pad, 128] packed code tiles, or
        bf16[T, d_aug, 128] augmented vector tiles;
    tile_offsets / list_counts: int32[C] — list c owns
        ``ceil(list_counts[c] / 128)`` tiles from ``tile_offsets[c]``.

    Returns enc int32[C, qc, S], S = fold_tiles * 128: entry [c, s, j]
    is the minimum encoding over the positions p of list c with
    ``(p // 128) % fold_tiles * 128 + p % 128 == j`` for slot s, or
    ENC_INVALID where that class is empty. ``max_tiles`` (longest list)
    sizes the int8 encoding's position field.
    """
    C, qc, K = q_sel.shape
    cap = max_tiles * LANE_TILE
    if tiles.dtype == jnp.uint8:
        R = K // 32
        assert R % CODE_ROWS == 0 and R >= tiles.shape[1], (
            "q_sel must be in the kernel_tables layout")
        if tiles.shape[1] != R:   # storage rows not a multiple of 32
            tiles = jnp.pad(tiles, ((0, 0), (0, R - tiles.shape[1]),
                                    (0, 0)))
        pieces = None
        if q_sel.dtype == jnp.int8:
            body, bias = "pq_int8", 128 * 2 * R
            col_bits = int8_col_bits(cap, 2 * R)
            assert col_bits is not None, (
                f"list of {cap} points overflows the int32 encoding; "
                "use scan_impl='xla'")
        else:
            body, bias, col_bits = "pq_float", 0, 16
            q_sel = q_sel.astype(jnp.bfloat16)
    else:
        assert tiles.shape[1] == K and K % 16 == 0, (tiles.shape, K)
        body, bias, col_bits = "exact", 0, 16
        pieces = _pow2_pieces(K)
    if col_bits == 16:
        assert cap <= 1 << 16, (
            "list too long for 16-bit fold positions; raise n_clusters")
    qb = 32 if qc % 32 == 0 else 16
    qc_pad = round_up(qc, qb)
    if qc_pad != qc:
        q_sel = jnp.pad(q_sel, ((0, 0), (0, qc_pad - qc), (0, 0)))
    S = fold_tiles * LANE_TILE
    enc = pl.pallas_call(
        partial(_fold_scan_kernel, W=fold_tiles, body=body,
                pieces=pieces, col_bits=col_bits, bias=bias),
        grid=(C, qc_pad // qb),
        in_specs=[
            pl.BlockSpec((C,), lambda c, j: (0,)),
            pl.BlockSpec((C,), lambda c, j: (0,)),
            pl.BlockSpec((None, qb, K), lambda c, j: (c, j, 0)),
            pl.BlockSpec(tiles.shape, lambda c, j: (0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, qb, S), lambda c, j: (c, j, 0)),
        out_shape=jax.ShapeDtypeStruct((C, qc_pad, S), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4,
                                                num_stages=2),
        interpret=interpret,
        name="csr_fold_scan",
    )(tile_offsets.astype(jnp.int32), list_counts.astype(jnp.int32),
      q_sel, tiles)
    return enc[:, :qc] if qc_pad != qc else enc
