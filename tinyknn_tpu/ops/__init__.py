from .kmeans import blockwise_kmeans, kmeans_fit
from .packing import pack_codes, unpack_codes
from .quantization import (
    QuantizedTables,
    block_dists_blocked,
    dequantize_estimates,
    quantize_tables_signed,
    quantize_tables_unsigned,
)
from .scan import estimate_scan, estimate_scan_saturating
from .topk import (
    dedup_candidates,
    masked_smallest_k,
    merge_topk,
    smallest_k,
    streaming_topk_init,
)

__all__ = [
    "blockwise_kmeans", "kmeans_fit",
    "pack_codes", "unpack_codes",
    "QuantizedTables", "block_dists_blocked", "dequantize_estimates",
    "quantize_tables_signed", "quantize_tables_unsigned",
    "estimate_scan", "estimate_scan_saturating",
    "dedup_candidates", "masked_smallest_k", "merge_topk", "smallest_k",
    "streaming_topk_init",
]
