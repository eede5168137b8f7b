"""Code-layout round-trip tests (reference family: tests/test_transform.py).

The reference pins its Quick-ADC nibble interleave; the format here is a
plain 2-codes-per-byte pack, so the contract is the round-trip plus
direct nibble-position assertions.
"""

import numpy as np

from tinyknn_tpu.ops import pack_codes, unpack_codes

np.random.seed(10)


def test_roundtrip():
    for n, b in [(8, 2), (16, 8), (32, 56), (1, 4)]:
        codes = np.random.randint(0, 16, size=(n, b), dtype=np.uint8)
        packed = np.asarray(pack_codes(codes))
        assert packed.shape == (n, b // 2)
        out = np.asarray(unpack_codes(packed))
        np.testing.assert_array_equal(out, codes)


def test_nibble_positions():
    codes = np.array([[0x3, 0xA, 0xF, 0x0]], dtype=np.uint8)
    packed = np.asarray(pack_codes(codes))
    # low nibble = even block, high nibble = odd block
    np.testing.assert_array_equal(packed, [[0xA3, 0x0F]])
