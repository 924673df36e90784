"""host_serial_ms: the program's own host work a traced call while the
device has nothing of the call queued: host time of the span
partitioned.search_batch (the whole call) less that of flat_int8.enqueue
(the launches, which the device overlaps) and flat_int8.fetch (the wait
for the device and the copy back), per traced call. What is left is the
user table's digest, the masks, admit-dedup, the quantizer, the uploads
and the unpack."""


def read(trace):
    spans = ("partitioned.search_batch", "flat_int8.enqueue",
             "flat_int8.fetch")
    secs = [trace.span_host_s.get(name) for name in spans]
    if None in secs or not trace.calls:
        return None
    call, enqueue, fetch = secs
    return (call - enqueue - fetch) * 1000.0 / trace.calls
