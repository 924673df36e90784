"""A cell of the benchmark cut to a size the CPU runs in seconds: the
committed cell's configuration, traffic and limits, with fewer rows,
smaller calls and the plain versions of the program's kernels."""

import copy

import torch

from rbacbench.manifest import load_cell

ROWS = 40_066     # the last document short, as in the committed cell


def tiny_cell(name: str = "sift10m-rls-bulk", rows: int = ROWS):
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["corpus"].update(num_vectors=rows, query_pool=2000)
    cell.config["world"].update(num_users=1000)
    cell.config["port"]["arena"]["block_rows"] = 4096
    cell.mix = dict(cell.mix, queries_per_call=512, k=10, distinct_calls=2)
    return cell


def run_tiny(cell, seed=2**31 + 77, seconds=0.3, traced=False, **kw):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        from rbacbench import harness
        import time
        return harness.run_cell(cell, seed, seconds, traced,
                                torch.device("cpu"), time.perf_counter(),
                                **kw)
    finally:
        torch.set_num_threads(prev)
