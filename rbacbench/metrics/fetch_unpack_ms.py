"""fetch_unpack_ms: host time of the program's span flat_int8.fetch_unpack
(the wait for the device, the copy of the result wire and its unpacking),
per traced call."""


def read(trace):
    sec = trace.span_host_s.get("flat_int8.fetch_unpack")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
