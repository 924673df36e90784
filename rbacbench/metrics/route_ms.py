"""route_ms: host time of the program's span tiled.route (each query's
partitions from its user's roles, grouped by partition), per traced
call."""


def read(trace):
    sec = trace.span_host_s.get("tiled.route")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
