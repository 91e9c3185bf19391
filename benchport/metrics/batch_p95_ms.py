"""batch_p95_ms: the 95th percentile, over every batch answered in the
window, of the time from the batch's submission to its host ints (host
clock; statistics.quantiles, exclusive method)."""

import statistics


def read(r):
    lat = r.latencies_s
    if not lat:
        return None
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100)[94] * 1e3
