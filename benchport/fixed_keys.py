"""A fixed key pair made from a seed by the rules of IPCL's key generation:
the primes of a configuration whose key is not one of the published
ISO/IEC 18033-6 pair.

    python3 -m benchport.fixed_keys --bits 4096 --djn 1 --key-seed <n>

prints ``p`` and ``q`` in hex.  A configuration file commits them with
``"key_seed": <n>`` and ``"key_maker": "benchport/fixed_keys.py"``, so that
the key is data anyone can make again; the benchmark's tests check that it
is (:func:`faults`).

The rules (IPCL v2.0.0, ``ipcl/keygen.cpp:43-117``):

* ``bits`` divisible by 4 and in [200, 4096] (IPCL stops at 2048; the
  port takes keys up to 4096 bits);
* |p| = |q| = bits / 2, and n = p q has exactly ``bits`` bits;
* |p - q| > 2^(bits/2 - 100);
* DJN: p = q = 3 (mod 4) and gcd(p - 1, q - 1) = 2.

Primality is Miller-Rabin, :data:`ROUNDS` rounds after trial division.
Candidates and bases are the raw 64-bit words of the benchmark's own seeded
generator (``generator._rng``: NumPy's PCG64 under a SeedSequence, whose raw
output NumPy keeps the same across its versions), on streams apart from the
traffic's.  Plain ints and NumPy: nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from . import generator

ROOT = Path(__file__).resolve().parent
#: The name a configuration gives under ``key_maker``
MAKER = "benchport/fixed_keys.py"
MIN_BITS, MAX_BITS = 200, 4096
#: Miller-Rabin rounds a number passes to count as prime
ROUNDS = 40
#: Streams of ``generator._rng`` (the traffic's are 0-5)
CANDIDATES, BASES = 16, 17
#: The primes below 2^12, and the odd ones multiplied: a larger number that
#: shares a factor with the product is composite
_SMALL_PRIMES = frozenset(k for k in range(2, 1 << 12)
                          if all(k % d for d in range(2, math.isqrt(k) + 1)))
_SMALL = math.prod(_SMALL_PRIMES - {2})


def _draw(bitgen, bits: int) -> int:
    """A uniform int of ``bits`` bits from raw 64-bit words."""
    words = bitgen.random_raw(-(-bits // 64))
    return int.from_bytes(words.astype("<u8").tobytes(), "little") & ((1 << bits) - 1)


def is_prime(n: int, seed: int = 0, rounds: int = ROUNDS) -> bool:
    """Miller-Rabin with ``rounds`` bases drawn from (``seed``, n), after
    trial division by the odd primes below 2^12."""
    if n < 1 << 12:
        return n in _SMALL_PRIMES
    if n % 2 == 0 or math.gcd(n, _SMALL) != 1:
        return False
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    bitgen = generator._rng(seed, BASES, n).bit_generator
    for _ in range(rounds):
        x = pow(2 + _draw(bitgen, n.bit_length() + 64) % (n - 3), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _rules(p: int, q: int, bits: int, djn: bool) -> list:
    """The departures of :func:`departures` but primality's."""
    half, n = bits // 2, p * q
    out = [f"|{name}| = {v.bit_length()} bits, not {half}" for name, v in (("p", p), ("q", q))
           if v.bit_length() != half]
    if n.bit_length() != bits:
        out.append(f"n = p q has {n.bit_length()} bits, not {bits}")
    if abs(p - q) <= 1 << (half - 100):
        out.append(f"|p - q| <= 2^{half - 100}")
    if djn:
        out += [f"{name} = {v % 4} (mod 4)" for name, v in (("p", p), ("q", q)) if v % 4 != 3]
        g = math.gcd(p - 1, q - 1)
        if g != 2:
            out.append(f"gcd(p-1, q-1) = {g}")
    return out


def departures(p: int, q: int, bits: int, djn: bool) -> list:
    """Each rule of key generation that (p, q) breaks, as a reading of the
    key; [] for a key that keeps them all."""
    out = [f"{name} is not prime" for name, v in (("p", p), ("q", q)) if not is_prime(v)]
    return out + _rules(p, q, bits, djn)


def _prime(bitgen, half: int, djn: bool, seed: int, keeps=None) -> int:
    """The first prime among candidates of ``half`` bits with the two top
    bits set (so that a product of two has exactly 2 ``half`` bits), odd,
    3 (mod 4) for DJN, and kept by ``keeps``, which is asked first, as it
    costs less than Miller-Rabin."""
    low = 3 if djn else 1
    while True:
        v = _draw(bitgen, half) | (3 << (half - 2)) | low
        if (keeps is None or keeps(v)) and is_prime(v, seed):
            return v


def make(bits: int, djn: bool, key_seed: int):
    """(p, q) of a ``bits``-bit key (DJN or normal mode), the same for the
    same arguments: p is the first prime the seed's candidates give, q the
    first after it with which the pair keeps every rule."""
    if not (MIN_BITS <= bits <= MAX_BITS and bits % 4 == 0):
        raise ValueError(f"a key of {bits} bits: the width must be divisible by 4 and lie "
                         f"in [{MIN_BITS}, {MAX_BITS}]")
    half = bits // 2
    bitgen = generator._rng(key_seed, CANDIDATES).bit_generator
    p = _prime(bitgen, half, djn, key_seed)
    q = _prime(bitgen, half, djn, key_seed, lambda v: v != p and not _rules(p, v, bits, djn))
    return p, q


def faults(config: dict) -> list:
    """What keeps a configuration's key out of the benchmark; [] where it is
    admitted.  A configuration without ``key_seed`` holds the ISO/IEC
    18033-6 primes exactly; one with ``key_seed`` holds what :func:`make`
    gives and names this maker.  Every key keeps each rule of key
    generation, or lists the departure, as :func:`departures` reads it, in
    an entry of its ``assumed``."""
    p, q = int(config["p"], 16), int(config["q"], 16)
    bits, djn = int(config["key_bits"]), bool(config["djn"])
    out = []
    if "key_seed" in config:
        if config.get("key_maker") != MAKER:
            out.append(f"key_maker is {config.get('key_maker')!r}, not {MAKER!r}")
        if (p, q) != make(bits, djn, int(config["key_seed"])):
            out.append(f"p, q are not make({bits}, {djn}, {config['key_seed']})")
    else:
        iso = json.loads((ROOT / "reference" / "iso_vectors.json").read_text())
        if (p, q) != (int(iso["p"], 16), int(iso["q"], 16)):
            out.append("no key_seed, and p, q are not the ISO/IEC 18033-6 primes")
    assumed = config.get("assumed", [])
    out += [f"{d}, not listed under assumed" for d in departures(p, q, bits, djn)
            if not any(d in a for a in assumed)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, required=True)
    ap.add_argument("--djn", type=int, choices=(0, 1), required=True)
    ap.add_argument("--key-seed", type=int, required=True)
    args = ap.parse_args(argv)
    p, q = make(args.bits, bool(args.djn), args.key_seed)
    print(json.dumps({"key_bits": args.bits, "djn": bool(args.djn), "key_seed": args.key_seed,
                      "key_maker": MAKER, "p": hex(p), "q": hex(q)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
