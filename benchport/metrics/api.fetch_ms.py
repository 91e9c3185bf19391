"""api.fetch_ms: the mean, over the window's batches, of the host time of
``DevLimbs.fetch`` (the wait for the batch's stream, the download and the
codec to host ints)."""


def read(r):
    s = r.spans.get("fetch")
    return sum(s) / len(s) * 1e3 if s else None
