"""kernels.k5_grouped_roofline: the CRT decrypt's least time
(roofline.k3_least_s: 2 x |p| squarings at 2|p| bits a row, for the traced
rows; the work of the mathematics, whatever kernel does it) over the device
time of K5 (``rns_modexp2_tc_kernel``, which keys above 2048 bits run in its
grouped form, one residue system of p^2 / q^2 a group) in the traced window,
in %.  The name does not match K3's ``rns_modexp2f_tc_kernel``.  Where two
streams' kernels overlap, each is timed whole, as for K3 and K5."""

from benchport import roofline

NAME = "rns_modexp2_tc_kernel"


def read(r):
    t, peak = r.trace, roofline.peak_of(r.device_kind)
    if t is None or peak is None:
        return None
    secs = t.kernel_seconds(NAME)
    if secs <= 0:
        return None
    pbits = r.config["key_bits"] // 2
    return 100.0 * roofline.k3_least_s(2 * pbits, pbits, t.rows, peak) / secs
