"""Device ops: the exact oracle scan, the fused int8 scans, the merge and
the float32 rerank.

The CUDA kernels behind them (csrc/) are built and loaded on first use by
`_build`; importing these modules needs neither nvcc nor a GPU."""

from ._build import LAUNCHES, reset_launches
from .merge import merge_supported, merge_topk
from .scan import masked_scan_topk
from .rerank import rebuild_query, rerank_topk
from .scan_int8 import (int8_group_minima, int8_group_minima_wide,
                        int8_masked_topk, pack_results_device,
                        unpack_results_host)

__all__ = [
    "LAUNCHES", "reset_launches", "merge_supported", "merge_topk",
    "masked_scan_topk", "rebuild_query", "rerank_topk",
    "int8_group_minima", "int8_group_minima_wide", "int8_masked_topk",
    "pack_results_device", "unpack_results_host",
]
