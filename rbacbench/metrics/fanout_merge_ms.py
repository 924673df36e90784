"""fanout_merge_ms: host time of the program's span tiled.merge (each
query's top-k from the partitions it was routed to), per traced call."""


def read(trace):
    sec = trace.span_host_s.get("tiled.merge")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
