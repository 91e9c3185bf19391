"""The least time a kernel's work can take on a device: the benchmark's
yardstick for a kernel's share of its roofline.

A count reads the work of the mathematics, whatever implements it: it is a
function of the modulus width ``w`` (bits), the exponent bits ``e`` and the
rows ``B`` only, never of a kernel's form, layout, lanes or select.

* A w-bit modular product counts as two schoolbook w x w products of 8-bit
  digits: 2 * 2 * (w / 8)^2 int8 operations (a multiply and an add a digit
  pair), at the device's int8 tensor-core peak.
* Bytes count each input and output once, at the device's memory peak.
* The least time is the larger of the two.

Kernels (rows B, w-bit operands):

* K5, the generic RNS modexp (normal-mode encrypt r^n mod n^2): e squarings
  at w = 2|n|, e = |n|.
* K3, the CRT-folded modexp (decrypt c^(p-1) mod p^2 and c^(q-1) mod q^2):
  2 x e squarings at w = 2|p|, e = |p|.
* K2, the fixed-base modexp (DJN obfuscator hs^r from the key's table): one
  product a byte of r, e / 8 products at w = 2|n|, e = randbits.
"""

from __future__ import annotations

#: Published dense peaks at the full power limit (NVIDIA H100 SXM data
#: sheet): int8 tensor-core operations a second and HBM bytes a second, by
#: the name torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "bytes_per_s": 3.35e12},
}


def product_ops(w: int) -> float:
    """int8 operations of one w-bit modular product."""
    return 4.0 * (w / 8) ** 2


def _least_s(products: float, w: int, rows: int, row_bytes: float, peak) -> float:
    ops = products * product_ops(w) * rows
    return max(ops / peak["int8_ops_per_s"], row_bytes * rows / peak["bytes_per_s"])


def k5_least_s(w: int, e: int, rows: int, peak) -> float:
    """K5: e squarings; a base of w bits in, a result of w bits out."""
    return _least_s(e, w, rows, 2 * w / 8, peak)


def k3_least_s(w: int, e: int, rows: int, peak) -> float:
    """K3: 2 x e squarings (the p^2 and q^2 halves); a 2w-bit ciphertext in,
    two w-bit results out."""
    return _least_s(2 * e, w, rows, 4 * w / 8, peak)


def k2_least_s(w: int, e: int, rows: int, peak) -> float:
    """K2: e / 8 products; e / 8 exponent bytes in, a w-bit result out."""
    return _least_s(e / 8, w, rows, e / 8 + w / 8, peak)


def peak_of(device_kind: str):
    """The peaks of a device by name, or None for a device not in the
    table (a share of its roofline is then not reported)."""
    return PEAKS.get(device_kind)
