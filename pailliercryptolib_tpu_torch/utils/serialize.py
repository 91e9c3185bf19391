"""Key / text persistence in a cereal-PortableBinary-compatible layout.

The reference serializes with cereal 1.3.2 PortableBinaryArchives
(ipcl/include/ipcl/utils/serialize.hpp:25-57).  This module re-implements
that wire format in Python so keys and ciphertext batches persist in the
same byte layout the reference produces:

  archive   := 0x01 (little-endian flag byte) , payload
  primitive := raw little-endian bytes (bool: 1 byte, int32: 4, uint64: 8)
  vector<T> := uint64 count , elements
  versioned := uint32 class version (0) emitted once per type per archive,
               immediately before the first object of that type
  BigNumber := vector<uint32> words (minimal length, little-endian)
               , int32 sign (1 = positive, 0 = negative)   [bignum.h:133-150]
  PublicKey := bits:int32 , enable_DJN:bool , randbits:int32
               , n:BigNumber , hs:BigNumber                [pub_key.hpp:133-147]
  PrivateKey:= bits:int32 , p:BigNumber , q:BigNumber      [pri_key.hpp:93-99]
  BaseText  := size:uint64 , texts:vector<BigNumber>       [base_text.hpp:108-114]
  CipherText:= BaseText , pk:PublicKey                     [ciphertext.hpp:70-74]

Like the reference, PrivateKey persists only {bits, p, q} and recomputes the
full CRT table on load (pri_key.hpp:101-133), and PublicKey's loader derives
n^2/g from n.  Byte-level parity with cereal is by-construction from the
format above.

Counterpart of the JAX package's ``utils/serialize.py``: the same bytes, on
this package's key and text classes.  It is host code: a device-resident
ciphertext batch is written through its lazy download (``.texts``), and the
loaders take the ``device`` the loaded keys' engines will run on (default
``"cuda"``, which raises without a GPU; loaded texts are host integers until
an operation uploads them).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, List, Union

from ..models.keys import PrivateKey, PublicKey
from ..models.texts import BaseText, CipherText, PlainText


class _Writer:
    def __init__(self, stream: BinaryIO):
        self.stream = stream
        self._versioned: set = set()
        self.stream.write(b"\x01")  # little-endian flag

    def class_version(self, name: str, version: int = 0) -> None:
        if name not in self._versioned:
            self._versioned.add(name)
            self.u32(version)

    def u8(self, v: int) -> None:
        self.stream.write(struct.pack("<B", v))

    def i32(self, v: int) -> None:
        self.stream.write(struct.pack("<i", v))

    def u32(self, v: int) -> None:
        self.stream.write(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self.stream.write(struct.pack("<Q", v))

    def bignum(self, x: int) -> None:
        self.class_version("BigNumber")
        sign = 1 if x >= 0 else 0
        x = abs(x)
        words: List[int] = []
        while x:
            words.append(x & 0xFFFFFFFF)
            x >>= 32
        if not words:
            words = [0]
        self.u64(len(words))
        for w in words:
            self.u32(w)
        self.i32(sign)


class _Reader:
    def __init__(self, stream: BinaryIO):
        self.stream = stream
        self._versioned: set = set()
        flag = self.stream.read(1)
        if flag != b"\x01":
            raise ValueError("unsupported archive endianness/format")

    def class_version(self, name: str) -> int:
        if name not in self._versioned:
            self._versioned.add(name)
            return self.u32()
        return 0

    def _read(self, n: int) -> bytes:
        data = self.stream.read(n)
        if len(data) != n:
            raise EOFError("truncated archive")
        return data

    def u8(self) -> int:
        return struct.unpack("<B", self._read(1))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def bignum(self) -> int:
        self.class_version("BigNumber")
        count = self.u64()
        x = 0
        for i in range(count):
            x |= self.u32() << (32 * i)
        sign = self.i32()
        return x if sign == 1 else -x


# ---------------------------------------------------------------------------
# object serializers
# ---------------------------------------------------------------------------


def _save_public_key(w: _Writer, pk: PublicKey) -> None:
    w.class_version("PublicKey")
    w.i32(pk.bits)
    w.u8(1 if pk.enable_djn_flag else 0)
    w.i32(pk.randbits)
    w.bignum(pk.n)
    w.bignum(pk.hs)


def _load_public_key(r: _Reader, device) -> PublicKey:
    r.class_version("PublicKey")
    bits = r.i32()
    enable_djn = r.u8() != 0
    randbits = r.i32()
    n = r.bignum()
    hs = r.bignum()
    if enable_djn:
        return PublicKey(n, bits, hs=hs, randbits=randbits, device=device)
    return PublicKey(n, bits, device=device)


def _save_private_key(w: _Writer, sk: PrivateKey) -> None:
    w.class_version("PrivateKey")
    w.i32(sk.p.bit_length())
    w.bignum(sk.p)
    w.bignum(sk.q)


def _load_private_key(r: _Reader, device) -> PrivateKey:
    r.class_version("PrivateKey")
    _bits = r.i32()
    p = r.bignum()
    q = r.bignum()
    # full CRT recompute, as the reference
    return PrivateKey(p * q, p, q, device=device)


def _save_base_text(w: _Writer, t: BaseText, name: str) -> None:
    # cereal emits the derived class's version, then the base's: both
    # PlainText and CipherText serialize via base_class<BaseText>
    # (plaintext.hpp:93-97, ciphertext.hpp:70-74), and base_class recurses
    # through the versioned machinery.
    w.class_version(name)
    w.class_version("BaseText")
    w.u64(len(t.texts))
    w.u64(len(t.texts))  # vector<BigNumber> count
    for x in t.texts:
        w.bignum(x)


def _load_base_text(r: _Reader, name: str) -> List[int]:
    r.class_version(name)
    r.class_version("BaseText")
    size = r.u64()
    count = r.u64()
    if size != count:
        raise ValueError("corrupt text container: size/count mismatch")
    return [r.bignum() for _ in range(count)]


# ---------------------------------------------------------------------------
# public API (mirrors ipcl::serializer, serialize.hpp:25-57)
# ---------------------------------------------------------------------------

Serializable = Union[PublicKey, PrivateKey, PlainText, CipherText]


def serialize(stream: BinaryIO, obj: Serializable) -> None:
    w = _Writer(stream)
    if isinstance(obj, PublicKey):
        _save_public_key(w, obj)
    elif isinstance(obj, PrivateKey):
        _save_private_key(w, obj)
    elif isinstance(obj, CipherText):
        _save_base_text(w, obj, "CipherText")
        _save_public_key(w, obj.public_key)
    elif isinstance(obj, PlainText):
        _save_base_text(w, obj, "PlainText")
    else:
        raise TypeError(f"cannot serialize {type(obj)!r}")


def deserialize(stream: BinaryIO, cls, device="cuda") -> Serializable:
    """Read one ``cls`` object; keys (and a ciphertext's public key) get
    engines on ``device``."""
    r = _Reader(stream)
    if cls is PublicKey:
        return _load_public_key(r, device)
    if cls is PrivateKey:
        return _load_private_key(r, device)
    if cls is CipherText:
        texts = _load_base_text(r, "CipherText")
        pk = _load_public_key(r, device)
        return CipherText(pk, texts)
    if cls is PlainText:
        return PlainText(_load_base_text(r, "PlainText"))
    raise TypeError(f"cannot deserialize {cls!r}")


def dumps(obj: Serializable) -> bytes:
    buf = io.BytesIO()
    serialize(buf, obj)
    return buf.getvalue()


def loads(data: bytes, cls, device="cuda") -> Serializable:
    return deserialize(io.BytesIO(data), cls, device=device)


def serialize_to_file(path: str, obj: Serializable) -> bool:
    try:
        with open(path, "wb") as f:
            serialize(f, obj)
        return True
    except OSError:
        return False


def deserialize_from_file(path: str, cls, device="cuda") -> Serializable:
    with open(path, "rb") as f:
        return deserialize(f, cls, device=device)
