"""ctypes loader for the native runtime library (native/tinyknn_native.cpp).

Build-on-demand with the system compiler; every entry point has a pure
NumPy fallback so the package works without a toolchain. The compute
path never comes through here — this is host-side index-build and IO
machinery (the reference's equivalents: the grouping loop at
tinyknn/utils.py:95-162 and examples/sift/convert.py:10-58).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_SRC = Path(__file__).resolve().parent.parent / "native" / "tinyknn_native.cpp"


def _so_path() -> Path:
    """Shared-object path keyed by a content hash of the source.

    An mtime comparison can tie on a fresh clone (both files get
    checkout time), silently keeping a stale or foreign binary; hashing
    the source into the filename makes staleness impossible — a changed
    source simply builds to a new path.
    """
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return Path(__file__).resolve().parent / f"_tinyknn_native-{h}.so"


def _build(so: Path):
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O3", "-march=native", "-shared", "-fPIC",
                 str(_SRC), "-o", str(so)],
                check=True, capture_output=True, timeout=120)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    return False


def get_lib():
    """The loaded native library, or None (NumPy fallback)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TINYKNN_NO_NATIVE"):
        return None
    try:
        if not _SRC.exists():
            return None
        so = _so_path()
        if not so.exists() and not _build(so):
            return None
        lib = ctypes.CDLL(str(so))
        lib.count_list_sizes.restype = ctypes.c_int32
        lib.count_list_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p]
        lib.fill_inverted_lists.restype = None
        lib.fill_inverted_lists.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.fill_csr_tiled.restype = None
        lib.fill_csr_tiled.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.read_fvecs.restype = ctypes.c_int32
        lib.read_fvecs.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _LIB = lib
    except OSError as e:
        print(f"tinyknn_tpu: native lib unavailable ({e}); using NumPy "
              "fallbacks", file=sys.stderr)
    return _LIB


def invert_assignments_native(assignments, n_lists: int, pad_to: int = 8):
    """Native counting-sort inverted-list build; returns (ids, counts)
    with the same contract as utils.grouping.invert_assignments, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(assignments, dtype=np.int32)
    if a.ndim == 1:
        a = a[:, None]
    n, p = a.shape
    counts = np.zeros(n_lists, dtype=np.int32)
    mx = lib.count_list_sizes(a.ctypes.data, n, p, n_lists,
                              counts.ctypes.data)
    cap = max(int(mx) + (-int(mx)) % pad_to, pad_to)
    ids = np.full((n_lists, cap), -1, dtype=np.int32)
    cursors = np.zeros(n_lists, dtype=np.int32)
    lib.fill_inverted_lists(a.ctypes.data, n, p, n_lists, cap,
                            ids.ctypes.data, cursors.ctypes.data)
    return ids, counts


def invert_assignments_csr_tiled_native(assignments, n_lists: int,
                                        tile: int = 128,
                                        align_tiles: int = 1):
    """Native counting-sort build of the tiled CSR inverted lists
    (same contract as utils.grouping.invert_assignments_csr_tiled,
    bit-identical output), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(assignments, dtype=np.int32)
    if a.ndim == 1:
        a = a[:, None]
    n, p = a.shape
    counts = np.zeros(n_lists, dtype=np.int32)
    lib.count_list_sizes(a.ctypes.data, n, p, n_lists, counts.ctypes.data)
    ntiles = -(-counts.astype(np.int64) // tile)
    if align_tiles > 1:
        ntiles = -(-ntiles // align_tiles) * align_tiles
    tile_offsets64 = np.zeros(n_lists, dtype=np.int64)
    np.cumsum(ntiles[:-1], out=tile_offsets64[1:])
    total = int(ntiles.sum()) + max(1, align_tiles)  # + guard tile(s)
    flat_ids = np.full(total * tile, -1, dtype=np.int32)
    toff32 = tile_offsets64.astype(np.int32)
    cursors = np.zeros(n_lists, dtype=np.int32)
    lib.fill_csr_tiled(a.ctypes.data, n, p, n_lists, toff32.ctypes.data,
                       tile, flat_ids.ctypes.data, cursors.ctypes.data)
    return flat_ids, toff32, counts


def read_fvecs(path):
    """Read an .fvecs file to (n, d) float32 (native or NumPy)."""
    lib = get_lib()
    path = str(path)
    if lib is not None:
        n = ctypes.c_int64()
        d = ctypes.c_int64()
        rc = lib.read_fvecs(path.encode(), None,
                            ctypes.byref(n), ctypes.byref(d))
        if rc == 0:
            out = np.empty((n.value, d.value), dtype=np.float32)
            rc = lib.read_fvecs(path.encode(), out.ctypes.data,
                                ctypes.byref(n), ctypes.byref(d))
            if rc == 0:
                return out
    # NumPy fallback
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    assert raw.size % (d + 1) == 0, "corrupt .fvecs file"
    recs = raw.reshape(-1, d + 1)
    assert np.all(recs[:, 0] == d), "ragged .fvecs file"
    return recs[:, 1:].view(np.float32).copy()
