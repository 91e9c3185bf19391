"""kernels.k5_roofline: K5's least time (roofline.k5_least_s: |n| squarings
at 2|n| bits a row, for the traced rows) over the device time of K5
(``rns_modexp2_tc_kernel``) in the traced window, in %."""

from benchport import roofline

NAME = "rns_modexp2_tc_kernel"


def read(r):
    t, peak = r.trace, roofline.peak_of(r.device_kind)
    if t is None or peak is None:
        return None
    secs = t.kernel_seconds(NAME)
    if secs <= 0:
        return None
    nbits = r.config["key_bits"]
    return 100.0 * roofline.k5_least_s(2 * nbits, nbits, t.rows, peak) / secs
