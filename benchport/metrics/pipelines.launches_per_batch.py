"""pipelines.launches_per_batch: device kernel launches in the traced
window over its whole batches."""


def read(r):
    t = r.trace
    if t is None or not t.kernels or not t.batches:
        return None
    return len(t.kernels) / t.batches
