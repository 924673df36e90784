"""quantize_ms: host time of the program's span flat_int8.quantize (the
host quantizer of the call's queries, inside flat_int8.quantize_upload),
per traced call."""


def read(trace):
    sec = trace.span_host_s.get("flat_int8.quantize")
    if sec is None or not trace.calls:
        return None
    return sec * 1000.0 / trace.calls
