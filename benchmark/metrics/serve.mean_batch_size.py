"""Mean real rows a dispatched group carried (before bucket padding), from the
service's batcher counters at the window's close."""


def read(r):
    return None if r.counters is None else r.counters["mean_batch_size"]
