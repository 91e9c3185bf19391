"""api.submit_ms: the mean, over the window's batches, of the host time of
the program's ``*_dev`` call (codec, upload, enqueue of every launch)."""


def read(r):
    s = r.spans.get("submit")
    return sum(s) / len(s) * 1e3 if s else None
