"""Key material of a configuration: fixed primes from the configuration's
file, and for DJN a base hs drawn from the seed.  Plain ints, made by the
benchmark and handed to the program and the reference alike."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import generator
from .reference import paillier


@dataclass(frozen=True)
class Key:
    p: int
    q: int
    n: int
    nbits: int
    djn: bool
    randbits: int
    hs: Optional[int]


def key_of(config: dict, seed: int) -> Key:
    p, q = sorted((int(config["p"], 16), int(config["q"], 16)))
    n = p * q
    if n.bit_length() != config["key_bits"]:
        raise ValueError(f"p * q has {n.bit_length()} bits, the file says {config['key_bits']}")
    hs = None
    if config["djn"]:
        hs = paillier.djn_hs(n, generator.key_int(seed, n.bit_length() + 128))
    return Key(p, q, n, n.bit_length(), bool(config["djn"]), int(config["randbits"]), hs)
