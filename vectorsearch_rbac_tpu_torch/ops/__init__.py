"""Device ops: the flat scans (exact, approx and augmented; the oracle's
engine), the fused int8 scans, the merge, the float32 rerank, the HNSW
graph search with its step's kernels, the IVF path's k-means and probed
scan, and the binary and sparse scans.

The CUDA kernels behind them (csrc/) are built and loaded on first use by
`_build`; importing these modules needs neither nvcc nor a GPU."""

from ._build import LAUNCHES, reset_launches
from .graph_search import (graph_beam_search, graph_beam_search_filtered,
                           graph_beam_search_iterative)
from .graph_step import graph_merge_step, graph_score_packed
from .binary_scan import masked_binary_topk, pack_bits
from .ivf_scan import ivf_search_fn, probed_topk
from .kmeans import assign_clusters, kmeans_fit, kmeans_init
from .merge import merge_supported, merge_topk
from .scan import masked_scan_topk, masked_scan_topk_aug
from .sparse_scan import masked_sparse_topk
from .rerank import rebuild_query, rerank_topk
from .scan_int8 import (int8_group_minima, int8_group_minima_wide,
                        int8_masked_topk, pack_results_device,
                        unpack_results_host)

__all__ = [
    "LAUNCHES", "reset_launches", "graph_beam_search",
    "graph_beam_search_filtered", "graph_beam_search_iterative", "graph_merge_step", "graph_score_packed",
    "ivf_search_fn", "probed_topk", "assign_clusters", "kmeans_fit",
    "kmeans_init",
    "merge_supported", "merge_topk",
    "masked_binary_topk", "pack_bits", "masked_scan_topk",
    "masked_scan_topk_aug", "masked_sparse_topk", "rebuild_query",
    "rerank_topk",
    "int8_group_minima", "int8_group_minima_wide", "int8_masked_topk",
    "pack_results_device", "unpack_results_host",
]
