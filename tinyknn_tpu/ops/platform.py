"""The one place that reads which platform JAX runs on.

Every choice that depends on the machine asks this module:

  * ``'gpu'``: kernels are compiled for the card (Pallas through Triton)
    and the defaults pick them wherever they fit;
  * ``'cpu'`` (tests): defaults go to plain XLA, and a kernel engine that
    was asked for explicitly runs in Pallas interpret mode;
  * any other platform is refused with an error that names it.
"""

from __future__ import annotations

import jax

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """JAX's default platform, checked against the supported ones."""
    name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(
            f"tinyknn_tpu runs on {' or '.join(SUPPORTED)}; JAX's "
            f"default platform is {name!r}")
    return name


def use_kernels() -> bool:
    """Whether default engines pick the Pallas kernels (GPU only)."""
    return platform() == "gpu"


def interpret() -> bool:
    """Whether a Pallas kernel runs in interpret mode (CPU only)."""
    return platform() == "cpu"
