"""Key generation: host-side prime generation + keypair assembly.

Counterpart of the JAX package's ``models/keygen.py``.  Replaces the
reference's ipp-crypto prime generator (``ippsPrimeGen_BN`` with
10 Miller-Rabin trials, ipcl/keygen.cpp:13-41) with a pure-Python
Miller-Rabin over the OS CSPRNG.  Keygen is a one-time host operation — the
reference never offloads it either (SURVEY.md §3.1) — so there is no device
path here.  Conditions enforced (ipcl/keygen.cpp:43-117):

* key size in [200, 4096], divisible by 4;
* |p - q| > 2^(keysize/2 - 100);
* DJN variant: p = q = 3 (mod 4) and gcd(p-1, q-1) == 2;
* n = p*q has exactly ``n_length`` bits.
"""

from __future__ import annotations

import math

from ..utils import rng as _rng
from .engine import resolve_device
from .keys import KeyPair, PrivateKey, PublicKey

N_BIT_SIZE_MAX = 4096
N_BIT_SIZE_MIN = 200

def _sieve_small_primes(limit: int = 4096):
    sieve = bytearray([1]) * limit
    sieve[0:2] = b"\x00\x00"
    for i in range(2, int(limit**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = b"\x00" * len(sieve[i * i :: i])
    return [i for i in range(3, limit) if sieve[i]]


_SMALL_PRIMES = _sieve_small_primes()


def miller_rabin(n: int, rounds: int = 10) -> bool:
    """Probabilistic primality test.  Trial division by all primes < 4096
    rejects ~83% of odd composites before any modexp; the first MR base is
    fixed to 2 (cheapest, catches almost everything the sieve missed), then
    ``rounds`` random bases — nTrials=10 as the reference's
    ippsPrimeGen_BN configuration (ipcl/keygen.cpp:34)."""
    if n < 4:
        return n in (2, 3)  # the sieve below starts at 3; 2 needs a guard
    if n % 2 == 0:
        return False
    for sp in _SMALL_PRIMES:
        if n == sp:
            return True
        if n % sp == 0:
            return False
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1

    def witness(a: int) -> bool:
        x = pow(a, d, n)
        if x in (1, n - 1):
            return False
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                return False
        return True

    if witness(2):
        return False
    for _ in range(rounds):
        a = 3 + _rng.random_bits(64) % (n - 4)
        if witness(a):
            return False
    return True


def get_prime(bits: int, mod4_is_3: bool = False) -> int:
    """Random ``bits``-bit probable prime; optionally p = 3 (mod 4)."""
    while True:
        cand = _rng.random_bits(bits) | (1 << (bits - 1)) | 1
        if mod4_is_3:
            cand |= 2  # low bits 11 -> cand = 3 (mod 4)
        if miller_rabin(cand):
            return cand


def _primes_too_close(p: int, q: int, n_length: int) -> bool:
    """|p - q| must exceed 2^(keysize/2 - 100) (ipcl/keygen.cpp:43-58)."""
    return abs(p - q) <= (1 << (n_length // 2 - 100))


def generate_keypair(
    n_length: int = 2048, enable_DJN: bool = True, device="cuda"
) -> KeyPair:
    """Generate a Paillier keypair (reference: ipcl/keygen.cpp:92-117) whose
    engines run on ``device``."""
    resolve_device(device)  # a missing GPU fails here, before the prime search
    if n_length > N_BIT_SIZE_MAX:
        raise ValueError("generateKeypair: key size exceeds supported range")
    if n_length < N_BIT_SIZE_MIN or n_length % 4 != 0:
        raise ValueError("generateKeypair: key size should >=200 and divisible by 4")

    half = n_length // 2
    while True:
        p = get_prime(half, mod4_is_3=enable_DJN)
        q = get_prime(half, mod4_is_3=enable_DJN)
        if p == q:
            continue
        n = p * q
        if n.bit_length() != n_length:
            continue
        if _primes_too_close(p, q, n_length):
            continue
        if enable_DJN and math.gcd(p - 1, q - 1) != 2:
            continue
        break

    pk = PublicKey(n, n_length, enable_DJN, device=device)
    sk = PrivateKey(pk, p, q, device=device)
    return KeyPair(pk, sk)
