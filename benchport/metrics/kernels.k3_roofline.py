"""kernels.k3_roofline: K3's least time (roofline.k3_least_s: 2 x |p|
squarings at 2|p| bits a row, for the traced rows) over the device time of
K3 (``rns_modexp2f_tc_kernel``) in the traced window, in %."""

from benchport import roofline

NAME = "rns_modexp2f_tc_kernel"


def read(r):
    t, peak = r.trace, roofline.peak_of(r.device_kind)
    if t is None or peak is None:
        return None
    secs = t.kernel_seconds(NAME)
    if secs <= 0:
        return None
    pbits = r.config["key_bits"] // 2
    return 100.0 * roofline.k3_least_s(2 * pbits, pbits, t.rows, peak) / secs
