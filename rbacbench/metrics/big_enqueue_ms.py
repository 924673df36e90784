"""big_enqueue_ms: host time of the program's span tiled.big_enqueue (for
each big-tier partition a query is routed to: its mask rows, the host
quantizer, the uploads and the launches of its scan and merges), per
traced call."""


def read(trace):
    sec = trace.span_host_s.get("tiled.big_enqueue")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
