"""Shape-padding helpers.

The PQ code layout wants row/column counts that are multiples of the
block tiling. These helpers mirror the reference's zero-padding utilities
(reference: tinyknn/utils.py:6-19) but operate on either NumPy or JAX
arrays and always return the input dtype.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return x + (-x) % m


def pad1(arr, m: int):
    """Zero-pad a 1-D array so its length is a multiple of ``m``."""
    (s,) = arr.shape
    extra = (-s) % m
    if extra == 0:
        return arr
    xp = jnp if isinstance(arr, jnp.ndarray) else np
    return xp.concatenate([arr, xp.zeros((extra,), dtype=arr.dtype)])


def pad2(arr, m1: int, m2: int):
    """Zero-pad a 2-D array so shape[0] % m1 == 0 and shape[1] % m2 == 0."""
    s1, s2 = arr.shape
    e1, e2 = (-s1) % m1, (-s2) % m2
    if e1 == 0 and e2 == 0:
        return arr
    xp = jnp if isinstance(arr, jnp.ndarray) else np
    return xp.pad(arr, ((0, e1), (0, e2)))
