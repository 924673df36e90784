"""scan_pad_pct: the scan's query positions beyond the caller's queries,
as a share of the queries: 100 * (flat_int8.positions - flat_int8.queries)
/ flat_int8.queries, from the program's counters (vectorsearch_rbac_tpu_
torch/utils/tracing.py COUNTS) over every pass of the run, warm-up
included. Admit-dedup's slot pads and the last batch's tail are the
difference. The run sends the same distinct calls over and over, so the
run's share is the window's."""


def read(trace):
    from vectorsearch_rbac_tpu_torch.utils import tracing

    counts = getattr(tracing, "COUNTS", None)
    if not counts:
        return None
    queries = counts.get("flat_int8.queries")
    positions = counts.get("flat_int8.positions")
    if not queries or positions is None:
        return None
    return 100.0 * (positions - queries) / queries
