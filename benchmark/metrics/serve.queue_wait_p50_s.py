"""Median wait of a request between its enqueue and its group's dispatch, from
the service's batcher counters at the window's close."""


def read(r):
    return None if r.counters is None else r.counters["queue_wait"]["p50_s"]
