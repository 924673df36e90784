"""unpack_ms: host time of the program's span flat_int8.unpack (the host
unpack of the result wire's rows and the casts of the returned arrays,
inside flat_int8.fetch_unpack), per traced call."""


def read(trace):
    sec = trace.span_host_s.get("flat_int8.unpack")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
