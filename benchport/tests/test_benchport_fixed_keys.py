"""The fixed-key maker (benchport/fixed_keys.py) and the admission rule that
every configuration's key meets: the maker keeps IPCL's rules of key
generation and gives the same key for the same seed, the rule refuses a
tampered key, and a cell on a maker-made key runs correct on the CPU."""

from __future__ import annotations

import copy
import hashlib
import json
import math

import pytest

from kit import REPO, copy_with_cells, run_cpu, small_traffic

from benchport import fixed_keys

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]}
#: make(bits, djn, key_seed) as first made: a later NumPy or edit that draws
#: other words would make a committed key unreproducible
PINNED = [
    (256, True, 2**31 + 1, "0xc10fb15a4c778c7f053dbc0f5fed2e17",
     "0xd9dd006ed13ab9d9fecafb628d47040b"),
    (512, False, 2**40 + 3,
     "0xc30a8354d2aef80ca33e81ac670cfe5e4a286ac6df288c94b921224fe9c0d60f",
     "0xfb3b3a5245141ec2b6bb9df4120bf3856c68529934ae096f0b2b1a8792983ead"),
    (1024, True, 1,
     "0xc78f803f49e7ae826f2f45434c5a4707506fe23f2b472d944f359eec5dd05efcf8cb2752df9850cbad2"
     "37cef25418d496b7cabc916a920fa387cc228a926888f",
     "0xeb4a66b3b7e4f3730c33b25d8170f8b1aaebfa204f38f2ff879d1daff2e89370e34f58702f8772279f6"
     "3803c885b0e3bba7dbd3537415f42286e5b562570cecb"),
]

#: sha256 of "<p hex>.<q hex>" of make(4096, True, 1)
DJN4096_SHA256 = "d4325c7cfbea39ef82254eceeacd299601ce96daa73ab856cfa3eb75c015fba0"


def _seeded(bits, djn, key_seed):
    p, q = fixed_keys.make(bits, djn, key_seed)
    return {"name": f"k{bits}", "key_bits": bits, "djn": djn, "randbits": bits // 2 if djn else 0,
            "backend": "rns", "key_seed": key_seed, "key_maker": fixed_keys.MAKER,
            "p": hex(p), "q": hex(q)}


def test_is_prime():
    primes = [2, 3, 5, 4093, 4099, 2**61 - 1, 2**127 - 1, 2**521 - 1]
    # Carmichael numbers, a strong pseudoprime to base 2, products of primes
    composites = [1, 4, 561, 41041, 2047, 3215031751, (2**61 - 1) * (2**89 - 1),
                  (2**127 - 1) ** 2, 4093 * 4099]
    assert all(fixed_keys.is_prime(n) for n in primes)
    assert not any(fixed_keys.is_prime(n) for n in composites)


@pytest.mark.parametrize("bits, djn, key_seed, p, q", PINNED)
def test_make_reproduces_pinned_keys(bits, djn, key_seed, p, q):
    assert fixed_keys.make(bits, djn, key_seed) == (int(p, 16), int(q, 16))


@pytest.mark.parametrize("bits", [256, 512, 1024])
@pytest.mark.parametrize("djn", [True, False])
def test_make_keeps_the_rules(bits, djn):
    seed = 2**33 + 7 * bits + djn
    p, q = fixed_keys.make(bits, djn, seed)
    assert (p, q) == fixed_keys.make(bits, djn, seed)
    assert fixed_keys.make(bits, djn, seed + 1) != (p, q)
    assert fixed_keys.departures(p, q, bits, djn) == []
    # the rules, read here without the maker's help
    half = bits // 2
    assert p.bit_length() == q.bit_length() == half and (p * q).bit_length() == bits
    assert abs(p - q) > 2 ** (half - 100)
    assert fixed_keys.is_prime(p, seed=5) and fixed_keys.is_prime(q, seed=5)
    if djn:
        assert p % 4 == q % 4 == 3 and math.gcd(p - 1, q - 1) == 2


@pytest.mark.parametrize("bits", [199, 196, 258, 1026, 4100, 8192])
def test_make_refuses_widths(bits):
    with pytest.raises(ValueError):
        fixed_keys.make(bits, True, 1)


def test_departures_read_each_broken_rule():
    p, q = fixed_keys.make(256, True, 3)
    composite = next(v for v in range(q + 4, q + 4000, 4) if not fixed_keys.is_prime(v))
    assert "q is not prime" in fixed_keys.departures(p, composite, 256, True)
    assert "|p - q| <= 2^28" in fixed_keys.departures(p, p, 256, True)
    wide = fixed_keys.departures(p, q, 260, True)
    assert "n = p q has 256 bits, not 260" in wide and "|p| = 128 bits, not 130" in wide
    pn, qn = next(k for k in (fixed_keys.make(256, False, s) for s in range(64)) if k[0] % 4 == 1)
    assert "p = 1 (mod 4)" in fixed_keys.departures(pn, qn, 256, True)
    assert fixed_keys.departures(pn, qn, 256, False) == []
    g = math.gcd(pn - 1, qn - 1)
    if g != 2:
        assert f"gcd(p-1, q-1) = {g}" in fixed_keys.departures(pn, qn, 256, True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_admission_refuses_a_flipped_bit_of_p(name):
    config = copy.deepcopy(CONFIGS[name])
    assert fixed_keys.faults(config) == []
    config["p"] = hex(int(config["p"], 16) ^ (1 << 500))
    assert fixed_keys.faults(config)


def test_admission_of_seeded_keys():
    good = _seeded(256, True, 11)
    assert fixed_keys.faults(good) == []
    other = _seeded(256, True, 12)  # sound primes, but not this seed's
    assert fixed_keys.faults(dict(good, p=other["p"], q=other["q"]))
    assert fixed_keys.faults(dict(good, key_maker="elsewhere.py"))
    flipped = dict(good, q=hex(int(good["q"], 16) ^ 4))
    assert fixed_keys.faults(flipped)


def test_admission_of_a_4096_bit_seeded_key():
    """The widest key the port takes is made again whole, not held to the
    rules alone: key_seed 1 gives the same DJN primes as when first made."""
    good = _seeded(4096, True, 1)
    digest = hashlib.sha256(f"{int(good['p'], 16):x}.{int(good['q'], 16):x}".encode())
    assert digest.hexdigest() == DJN4096_SHA256
    assert fixed_keys.faults(good) == []


def test_admission_reads_departures_from_assumed():
    djn = copy.deepcopy(CONFIGS["djn2048"])
    assert "gcd(p-1, q-1) = 6" in " ".join(djn["assumed"])
    djn["assumed"] = [a for a in djn["assumed"] if "gcd(p-1, q-1) = 6" not in a]
    assert fixed_keys.faults(djn) == ["gcd(p-1, q-1) = 6, not listed under assumed"]


DJN256 = _seeded(256, True, 2**31 + 101)
CELLS = [
    (DJN256, "fdec16", small_traffic("decrypt")),
    (DJN256, "fenc16", small_traffic("encrypt")),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_cells(tmp_path_factory.mktemp("bench"), CELLS)


@pytest.mark.parametrize("traffic", ["fdec16", "fenc16"])
def test_cell_on_a_maker_made_key(root, traffic):
    pytest.importorskip("torch")
    res, _, _ = run_cpu(root, f"{DJN256['name']}.{traffic}")
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["mismatched_answers"]["value"] == 0
