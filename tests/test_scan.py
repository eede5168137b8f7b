"""Scan-kernel-vs-oracle equivalence (reference family 1, tests/test_pq.py:12-53).

The scan here is XLA's one-hot matrix product; the oracle is a slow
NumPy loop with plain int32 accumulation. The reference's saturating
int8 semantics (SSE sequential / AVX two-lane) are preserved in a
dedicated emulation op and tested against the reference's own oracle
definitions.
"""

import numpy as np
import pytest
from itertools import product

from tinyknn_tpu.ops import estimate_scan, estimate_scan_saturating
from tinyknn_tpu.ops.packing import pack_codes

np.random.seed(10)


def numpy_oracle(codes, tables_i8):
    """int32 accumulation oracle: est[q, i] = sum_b t[q, b, codes[i, b]]."""
    Q = tables_i8.shape[0]
    n, B = codes.shape
    out = np.zeros((Q, n), np.int32)
    for q in range(Q):
        for i in range(n):
            out[q, i] = sum(int(tables_i8[q, b, codes[i, b]])
                            for b in range(B))
    return out


def saturating_oracle(codes, tables_u8, signed, lanes):
    """The reference's test oracle (tests/test_pq.py:30-51), vectorized
    over queries."""
    lo, hi = (-128, 127) if signed else (0, 255)
    t = tables_u8.view(np.int8 if signed else np.uint8)
    Q = t.shape[0]
    n, B = codes.shape
    out = np.zeros((Q, n), np.int32)
    for q in range(Q):
        for i in range(n):
            if lanes == 1:
                acc = 0
                for b in range(B):
                    acc = np.clip(acc + int(t[q, b, codes[i, b]]), lo, hi)
            else:
                acc0 = acc1 = 0
                for b in range(B):
                    v = int(t[q, b, codes[i, b]])
                    if b & 2 == 0:
                        acc0 = np.clip(acc0 + v, lo, hi)
                    else:
                        acc1 = np.clip(acc1 + v, lo, hi)
                acc = np.clip(acc0 + acc1, lo, hi)
            out[q, i] = acc
    return out


@pytest.mark.parametrize("n, b, q", product([16, 33], [4, 8], [1, 3]))
def test_estimate_vs_oracle(n, b, q):
    codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(q, b, 16)).astype(np.int8)
    est = np.asarray(estimate_scan(codes, tables))
    np.testing.assert_array_equal(est, numpy_oracle(codes, tables))


def test_xla_backend_explicit():
    codes = np.random.randint(0, 16, size=(24, 8), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(2, 8, 16)).astype(np.int8)
    est = np.asarray(estimate_scan(codes, tables))
    np.testing.assert_array_equal(est, numpy_oracle(codes, tables))


@pytest.mark.parametrize("n, b, q", product([16, 100, 300], [8, 56], [1, 5]))
def test_estimate_shapes_vs_oracle(n, b, q):
    """Row counts off the 8/128 grid and block counts off 16 must not
    change a single estimate."""
    codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(q, b, 16)).astype(np.int8)
    est = np.asarray(estimate_scan(codes, tables))
    assert est.shape == (q, n) and est.dtype == np.int32
    np.testing.assert_array_equal(est, numpy_oracle(codes, tables))


@pytest.mark.parametrize("n, b, q", product([16, 100], [8, 56], [1, 5]))
def test_estimate_packed_vs_oracle(n, b, q):
    """The fused 4-bit unpack (low nibble = even block) must agree with
    the oracle on the unpacked codes."""
    codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(q, b, 16)).astype(np.int8)
    est = np.asarray(estimate_scan(pack_codes(codes), tables, packed=True))
    np.testing.assert_array_equal(est, numpy_oracle(codes, tables))


@pytest.mark.parametrize("n, b, q", product([16, 200], [8, 56], [1, 9]))
def test_estimate_float_tables_vs_oracle(n, b, q):
    """Float tables take the bf16 one-hot into f32: integer tables with
    bf16-exact entries reproduce the int32 oracle exactly."""
    codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(q, b, 16)).astype(np.int8)
    est = np.asarray(estimate_scan(codes, tables.astype(np.float32)))
    assert est.dtype == np.float32
    np.testing.assert_array_equal(est, numpy_oracle(codes, tables))


def test_estimate_packed_matches_unpacked():
    codes = np.random.randint(0, 16, size=(40, 8), dtype=np.uint8)
    tables = np.random.randint(-128, 128, size=(2, 8, 16)).astype(np.int8)
    a = np.asarray(estimate_scan(pack_codes(codes), tables, packed=True))
    np.testing.assert_array_equal(a, np.asarray(estimate_scan(codes,
                                                              tables)))


@pytest.mark.parametrize(
    "n, b, signed, lanes", product([16, 32], [4, 8], [True, False], [1, 2]))
def test_saturating_parity(n, b, signed, lanes):
    """Mirror of the reference SIMD oracle tests (tests/test_pq.py:12-53)."""
    codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
    tables = np.random.randint(0, 256, size=(2, b, 16), dtype=np.uint8)
    est = np.asarray(estimate_scan_saturating(codes, tables, signed, lanes))
    np.testing.assert_array_equal(
        est, saturating_oracle(codes, tables, signed, lanes))
