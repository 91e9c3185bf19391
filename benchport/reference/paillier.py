"""Plain Paillier on Python ints: the reference the benchmark holds the
program to.

Paillier (1999) with g = n + 1: a ciphertext of m under obfuscator obf is
(n m + 1) obf mod n^2.  Normal mode draws obf = r^n for r of Z*_n; DJN
(Damgard-Jurik-Nielsen) mode draws obf = hs^r for the key's hs = (-x^2)^n
mod n^2 and an exponent r of ``randbits`` bits.  Decryption runs by the
Chinese remainder theorem over p^2 and q^2 (Paillier 1999, section 7).
Every function works from p, q or n alone: nothing here comes from the
program.

Each ``*_row`` function takes one answer's inputs as plain values, so the
harness can hand them to worker processes; the ``control_*`` functions are
the same computations with one guarantee of the configuration broken.
"""

from __future__ import annotations

import math

from . import chacha20


def djn_hs(n: int, x: int) -> int:
    """The DJN base hs = (-x^2)^n mod n^2 for a unit x of Z_n."""
    x %= n
    if math.gcd(x, n) != 1:
        raise ValueError("the DJN base needs a unit of Z_n")
    return pow(-(x * x) % n, n, n * n)


def encrypt(n: int, m: int, obf: int) -> int:
    n2 = n * n
    return (n * (m % n) + 1) * obf % n2


def encrypt_djn_row(n: int, hs: int, randbits: int, seed_words, row: int, m: int) -> int:
    """Row ``row`` of a DJN batch encrypted with seed ``seed_words``."""
    (r,) = chacha20.djn_exponents(seed_words, [row], randbits)
    return encrypt(n, m, pow(hs, r, n * n))


def encrypt_normal_row(n: int, seed_words, row: int, m: int) -> int:
    """Row ``row`` of a normal-mode batch encrypted with seed ``seed_words``."""
    (r,) = chacha20.normal_bases(seed_words, [row], n.bit_length())
    return encrypt(n, m, pow(r, n, n * n))


def _hfun(h: int, n: int) -> int:
    """(L_h((n + 1)^(h - 1) mod h^2))^-1 mod h, L_h(u) = (u - 1) / h."""
    h2 = h * h
    return pow((pow(n + 1, h - 1, h2) - 1) // h, -1, h)


def decrypt_crt_row(p: int, q: int, c: int) -> int:
    """m of ciphertext c, by the CRT over p^2 and q^2."""
    n = p * q
    mp = (pow(c, p - 1, p * p) - 1) // p * _hfun(p, n) % p
    mq = (pow(c, q - 1, q * q) - 1) // q * _hfun(q, n) % q
    return (mp + (mq - mp) * pow(p, -1, q) % q * p) % n


# -- controls: the reference with one stated guarantee broken ---------------


def control_encrypt_djn_row(n, hs, randbits, seed_words, row, m):
    """DJN encryption with the exponent cut to half its stated bits, the
    step that would halve the fixed-base modexp."""
    (r,) = chacha20.djn_exponents(seed_words, [row], randbits)
    r &= (1 << (randbits // 2)) - 1
    return encrypt(n, m, pow(hs, r, n * n))


def control_encrypt_normal_row(n, seed_words, row, m):
    """Normal-mode encryption with the obfuscation left out (obf = 1), the
    step that would drop the modexp r^n."""
    return encrypt(n, m, 1)


def control_decrypt_crt_row(p, q, c):
    """Decryption from the p half alone (m mod p), the step that would
    halve the CRT modexps."""
    n = p * q
    return (pow(c, p - 1, p * p) - 1) // p * _hfun(p, n) % p
