"""The CSR list-scan kernel vs NumPy oracles, in Pallas interpret mode.

On the card the kernel is compiled through Triton; the tests marked
``gpu`` (run by ``python chip_smoke.py``) compare it there with the XLA
list scan at GloVe widths. Here its arithmetic, encoding and ragged walk
are pinned against oracles on the CPU, including empty lists, a list of
exactly one tile and fold wrap-around.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tinyknn_tpu.ops.kernels import (ENC_INVALID, code_rows,
                                     csr_fold_scan, kernel_tables)
from tinyknn_tpu.ops.packing import pack_codes, pack_codes_tiled
from tinyknn_tpu.utils.grouping import invert_assignments_csr_tiled

# list lengths per case: an empty list, exactly one tile (128), a list
# that wraps a 1-tile fold (300 points = 3 tiles), a short one
LENGTHS = [0, 128, 300, 45]


@pytest.fixture(params=["interpret",
                        pytest.param("compiled", marks=pytest.mark.gpu)])
def interpret(request):
    """Each oracle test runs the kernel in interpret mode, and compiled
    through Triton where a GPU is present."""
    if request.param == "compiled":
        request.getfixturevalue("gpu")
        return False
    return True


def _assign(lengths, rng):
    a = np.concatenate([np.full(L, c) for c, L in enumerate(lengths)])
    return rng.permutation(a)[:, None]


def _fold_min(enc_vals, L, W):
    """Per position class j: min of enc_vals[p] over p < L with
    (p // 128) % W * 128 + p % 128 == j (int64; ENC_INVALID if none)."""
    S = W * 128
    out = np.full(enc_vals.shape[:-1] + (S,), ENC_INVALID, np.int64)
    for p in range(L):
        j = (p // 128 % W) * 128 + p % 128
        out[..., j] = np.minimum(out[..., j], enc_vals[..., p])
    return out


def _pq_case(seed, B, qc, lengths):
    rng = np.random.default_rng(seed)
    n = sum(lengths)
    C = len(lengths)
    assign = _assign(lengths, rng)
    codes = rng.integers(0, 16, size=(n, B), dtype=np.uint8)
    flat_ids, toff, counts = invert_assignments_csr_tiled(assign, C)
    tiles = pack_codes_tiled(pack_codes(codes), jnp.asarray(flat_ids))
    max_tiles = max(1, int(-(-counts.max() // 128)))
    return codes, flat_ids, toff, counts, tiles, max_tiles


def _pq_estimates(tables, codes, flat_ids, toff, L):
    """est[s, p] = sum_b tables[s, b, code of list point p in block b]."""
    ids = flat_ids[toff * 128:toff * 128 + L]
    B = codes.shape[1]
    return np.stack([
        np.array([sum(int(t[b, codes[i, b]]) for b in range(B))
                  for i in ids], np.int64).reshape(L)
        for t in tables])                              # (qc, L)


@pytest.mark.parametrize("W, B, qc", [(1, 8, 16), (2, 8, 8), (3, 64, 32),
                                      (1, 112, 16)])
def test_csr_fold_scan_int8_matches_oracle(W, B, qc, interpret):
    """int8 tables: the fold holds exactly the per-class minimum of
    ``(est + bias) << col_bits | position``."""
    codes, flat_ids, toff, counts, tiles, max_tiles = _pq_case(
        3, B, qc, LENGTHS)
    rng = np.random.default_rng(4)
    C = len(LENGTHS)
    tables = rng.integers(-128, 128, size=(C, qc, B, 16)).astype(np.int8)
    q_sel = kernel_tables(jnp.asarray(tables.reshape(C, qc, 16 * B)), B)
    enc = np.asarray(csr_fold_scan(
        q_sel, tiles, jnp.asarray(toff), jnp.asarray(counts),
        fold_tiles=W, max_tiles=max_tiles, interpret=interpret))
    assert enc.shape == (C, qc, W * 128)
    R = code_rows(B)
    col_bits = max(1, (max_tiles * 128 - 1).bit_length())
    for c, L in enumerate(LENGTHS):
        est = _pq_estimates(tables[c], codes, flat_ids, int(toff[c]), L)
        vals = ((est + 128 * 2 * R) << col_bits) | np.arange(L)
        np.testing.assert_array_equal(enc[c], _fold_min(vals, L, W))


def test_csr_fold_scan_float_tables_exact(interpret):
    """bf16 tables: with integer tables whose sums are exact in bf16,
    values and positions decode to the int8 path's bit for bit."""
    _, _, toff, counts, tiles, max_tiles = _pq_case(9, 8, 16, LENGTHS)
    rng = np.random.default_rng(9)
    C, qc, B = len(LENGTHS), 16, 8
    # sums <= 8 * 31 = 248 < 256: exactly representable in bf16
    tables = rng.integers(0, 32, size=(C, qc, 16 * B)).astype(np.int8)
    args = (tiles, jnp.asarray(toff), jnp.asarray(counts))
    kw = dict(fold_tiles=2, max_tiles=max_tiles, interpret=interpret)
    enc_i8 = np.asarray(csr_fold_scan(
        kernel_tables(jnp.asarray(tables), B), *args, **kw))
    enc_bf = np.asarray(csr_fold_scan(
        kernel_tables(jnp.asarray(tables, jnp.bfloat16), B), *args, **kw))
    bits = max(1, (max_tiles * 128 - 1).bit_length())
    ok = enc_i8 < ENC_INVALID
    np.testing.assert_array_equal(ok, enc_bf < ENC_INVALID)
    vi = (enc_i8 >> bits) - 128 * 2 * code_rows(B)
    pi = enc_i8 & ((1 << bits) - 1)
    vb = ((enc_bf >> 16).astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(pi[ok], (enc_bf & 0xFFFF)[ok])
    np.testing.assert_array_equal(vi[ok], vb[ok].astype(np.int64))


@pytest.mark.parametrize("d, W", [(12, 2), (100, 1), (29, 3)])
def test_csr_fold_scan_exact_matches_oracle(d, W, interpret):
    """Exact tiles: each slot holds the bf16-rounded true squared
    distance of the best point in its position class."""
    from tinyknn_tpu.models.ivf import _augment_data_csr, _augment_queries
    rng = np.random.default_rng(5)
    n, C, qc = sum(LENGTHS), len(LENGTHS), 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((qc, d)).astype(np.float32)
    flat_ids, toff, counts = invert_assignments_csr_tiled(
        _assign(LENGTHS, rng), C)
    max_tiles = max(1, int(-(-counts.max() // 128)))
    vecs = _augment_data_csr(jnp.asarray(X), jnp.asarray(flat_ids))
    q_aug = _augment_queries(jnp.asarray(qs))
    enc = np.asarray(csr_fold_scan(
        jnp.broadcast_to(q_aug[None], (C,) + q_aug.shape), vecs,
        jnp.asarray(toff), jnp.asarray(counts), fold_tiles=W,
        max_tiles=max_tiles, interpret=interpret))
    S = W * 128
    for c, L in enumerate(LENGTHS):
        rows = flat_ids[int(toff[c]) * 128:int(toff[c]) * 128 + L]
        if L == 0:
            assert (enc[c] == ENC_INVALID).all()
            continue
        d2 = ((qs[:, None, :] - X[rows][None]) ** 2).sum(-1)  # (qc, L)
        cls = (np.arange(L) // 128 % W) * 128 + np.arange(L) % 128
        for j in range(S):
            members = np.flatnonzero(cls == j)
            e = enc[c, :, j]
            if members.size == 0:
                assert (e == ENC_INVALID).all()
                continue
            pos = e & 0xFFFF
            val = ((e >> 16).astype(np.uint32) << 16).view(np.float32)
            assert np.isin(pos, members).all()
            want = d2[:, members].min(axis=1)
            # bf16 inputs and output: ~2^-8 relative per rounding
            np.testing.assert_allclose(val, want, rtol=0.02, atol=0.02)
            got = d2[np.arange(qc), pos]
            assert (got <= want * 1.02 + 1e-3).all()


def test_kernel_tables_layout():
    """kernel_tables puts block 2s + p, center v at [p, v, s] and zeros
    the phantom blocks."""
    B = 10
    t = np.arange(3 * B * 16, dtype=np.int32).reshape(3, B * 16)
    k = np.asarray(kernel_tables(jnp.asarray(t), B))
    R = code_rows(B)
    assert k.shape == (3, 32 * R)
    k = k.reshape(3, 2, 16, R)
    for s in range(R):
        for p in range(2):
            b = 2 * s + p
            want = t[:, b * 16:(b + 1) * 16] if b < B else 0
            np.testing.assert_array_equal(k[:, p, :, s], want)


def test_csr_tiled_builder():
    from tinyknn_tpu.utils.grouping import invert_assignments_csr
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 7, size=(300, 2))
    flat, toff, counts = invert_assignments_csr_tiled(assign, 7)
    ref_flat, ref_off = invert_assignments_csr(assign, 7)
    assert flat.shape[0] % 128 == 0
    assert np.all(flat[-128:] == -1)              # guard tile
    for c in range(7):
        got = flat[toff[c] * 128:toff[c] * 128 + counts[c]]
        want = ref_flat[ref_off[c]:ref_off[c + 1]]
        np.testing.assert_array_equal(got, want)
        pad = flat[toff[c] * 128 + counts[c]:
                   (toff[c] + -(-counts[c] // 128)) * 128]
        assert np.all(pad == -1)
