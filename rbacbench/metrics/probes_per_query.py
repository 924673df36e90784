"""probes_per_query: the partitions a query is routed to, on average:
tiled.probes / tiled.queries, from the program's counters
(vectorsearch_rbac_tpu_torch/utils/tracing.py COUNTS) over every call of
the run, warm-up included. The run sends the same distinct calls over and
over, so the run's ratio is the window's."""


def read(trace):
    from vectorsearch_rbac_tpu_torch.utils import tracing

    counts = getattr(tracing, "COUNTS", None)
    if not counts:
        return None
    queries = counts.get("tiled.queries")
    probes = counts.get("tiled.probes")
    if not queries or probes is None:
        return None
    return probes / queries
