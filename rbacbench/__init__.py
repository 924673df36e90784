"""The benchmark of the PyTorch and CUDA port (vectorsearch_rbac_tpu_torch).

`python3 rbacbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell; BENCHMARK.json at the checkout's root lists
the cells, configurations and metrics, and the files here are found by
those names (manifest.py).
"""
