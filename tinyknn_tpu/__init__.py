"""tinyknn_tpu — an accelerator-native approximate nearest-neighbor framework.

Same capabilities as thomasahle/tinyknn (4-bit product quantization +
inverted-file search with exact rescore), re-designed for the GPU:
JAX/XLA compute with one Pallas (Triton) list-scan kernel, batched
queries, int8 matrix-product scans, mesh-sharded indexes. See tinyknn_tpu/models for the index classes, tinyknn_tpu/ops
for the kernels, tinyknn_tpu/parallel for multi-chip sharding.
"""

from . import ops, utils
from .models import IVF, FastPQ, Flat, TransformedData
from .utils import (
    bottom_k,
    bottom_k_2d,
    cdist,
    group_data_by_indices,
    knn_brute,
    knn_brute1,
    pad1,
    pad2,
)

__version__ = "0.1.0"

__all__ = [
    "IVF", "FastPQ", "Flat", "TransformedData",
    "bottom_k", "bottom_k_2d", "cdist", "group_data_by_indices",
    "knn_brute", "knn_brute1", "pad1", "pad2",
    "ops", "utils",
]
