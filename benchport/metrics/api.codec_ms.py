"""api.codec_ms: milliseconds a batch of the program's host codec in the
traced window: its ``api.codec_in`` spans (host ints -> packed limbs) and
``api.codec_out`` spans (packed words -> host ints), read from the
recorder (``spans.split_ms``)."""


def read(r):
    p = r.program
    if p is None or "api.submit" not in p["split_ms"]:
        return None
    return p["split_ms"].get("api.codec_in", 0.0) + p["split_ms"].get("api.codec_out", 0.0)
