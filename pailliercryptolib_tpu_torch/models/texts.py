"""Value containers: BaseText, PlainText, CipherText.

Host-side containers of arbitrary-precision Python ints (the natural
replacement for the reference's vector<BigNumber>, ipcl/base_text.cpp:1-106);
all heavy math dispatches to the batched device pipelines.  Counterpart of
the JAX package's ``models/texts.py``; semantics mirror the reference,
including:

* scalar broadcast when one operand has size 1 (ipcl/ciphertext.cpp:37-38),
* CT+PT encrypting the plaintext *without* obfuscation first
  (ipcl/ciphertext.cpp:75-80),
* ``rotate`` circular shifts (ipcl/ciphertext.cpp:117-133),
* lowercase ``0x``-prefixed hex output matching BigNumber::num2hex
  (ipcl/bignum.cpp:470-494) and 32-bit little-endian word vectors matching
  ``num2vec`` (ipcl/bignum.cpp:460-467).
"""

from __future__ import annotations

from typing import List, Sequence, Union


def _to_int_list(value) -> List[int]:
    if isinstance(value, BaseText):
        return list(value.texts)
    if isinstance(value, int):
        return [value]
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    raise TypeError(f"cannot build text container from {type(value)!r}")


def _is_dev(value) -> bool:
    from .engine import DevLimbs

    return isinstance(value, DevLimbs)


def int_to_hex(x: int) -> str:
    """Lowercase 0x-prefixed hex, no leading zeros (num2hex format)."""
    if x < 0:
        return "-0x" + format(-x, "x")
    return "0x" + format(x, "x")


def int_to_u32_vec(x: int) -> List[int]:
    """Little-endian 32-bit word vector, minimal length >= 1 (num2vec)."""
    if x == 0:
        return [0]
    words = []
    while x:
        words.append(x & 0xFFFFFFFF)
        x >>= 32
    return words


class BaseText:
    """Vector-of-bignum container (reference: ipcl/base_text.hpp:14-118).

    May be backed by a device-resident limb batch (engine.DevLimbs) instead
    of host ints: chained pipelines then stay on the device, and the
    host list materializes lazily — one packed download — on first access
    to ``.texts``.  All semantics (element access, mutation, equality,
    serialization) are unchanged; mutation drops the device backing.
    """

    __slots__ = ("_texts", "_dev")

    def __init__(self, value: Union[int, Sequence[int], "BaseText"] = ()):
        if _is_dev(value):
            self._texts: List[int] = None
            self._dev = value
        elif isinstance(value, BaseText):
            self._texts = list(value._texts) if value._texts is not None else None
            self._dev = value._dev
        else:
            self._texts = _to_int_list(value)
            self._dev = None

    @property
    def texts(self) -> List[int]:
        if self._texts is None:
            self._texts = self._dev.fetch()
        return self._texts

    @texts.setter
    def texts(self, value) -> None:
        self._texts = [int(v) for v in value]
        self._dev = None

    def device_payload(self):
        """The DevLimbs backing if still valid, else the host int list."""
        return self._dev if self._dev is not None else self.texts

    def block_until_ready(self) -> None:
        """Wait for the producing device computation (throughput timing
        hook; does NOT download the batch)."""
        if self._dev is not None:
            self._dev.sync()

    def _mutate(self) -> List[int]:
        t = self.texts  # materialize first
        self._dev = None  # host edit diverges from the device copy
        return t

    # --- container protocol -------------------------------------------------
    def __len__(self) -> int:
        if self._texts is None:
            return self._dev.size
        return len(self._texts)

    def get_size(self) -> int:
        return len(self)

    def __getitem__(self, idx):
        return self.texts[idx]

    def get_element(self, idx: int) -> int:
        if not 0 <= idx < len(self.texts):
            raise IndexError("getElement index is out of range")
        return self.texts[idx]

    def get_element_vec(self, idx: int) -> List[int]:
        return int_to_u32_vec(self.get_element(idx))

    def get_element_hex(self, idx: int) -> str:
        return int_to_hex(self.get_element(idx))

    def get_chunk(self, start: int, size: int) -> List[int]:
        if not (0 <= start and start + size <= len(self.texts)):
            raise IndexError("getChunk parameter is incorrect")
        return self.texts[start : start + size]

    def get_texts(self) -> List[int]:
        return list(self.texts)

    def insert(self, pos: int, value: int) -> None:
        if not 0 <= pos <= len(self.texts):
            raise IndexError("insert position is out of range")
        self._mutate().insert(pos, int(value))

    def remove(self, pos: int, length: int = 1) -> None:
        # mirrors the reference's strict bound (ipcl/base_text.cpp:57-66)
        if not (0 <= pos and pos + length < len(self.texts)):
            raise IndexError("remove position is out of range")
        del self._mutate()[pos : pos + length]

    def clear(self) -> None:
        self._mutate().clear()

    def _rotated(self, shift: int) -> List[int]:
        size = len(self.texts)
        if size == 1:
            raise ValueError("rotate: Cannot rotate single element")
        if not -size <= shift <= size:
            raise ValueError("rotate: Cannot shift more than the size")
        if shift % size == 0:
            return list(self.texts)
        shift = (size - shift) % size  # reference rotates left by (size-shift)
        return self.texts[shift:] + self.texts[:shift]

    def __eq__(self, other) -> bool:
        return isinstance(other, type(self)) and self.texts == other.texts

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={len(self.texts)})"


class PlainText(BaseText):
    """Plaintext vector (reference: ipcl/plaintext.cpp:1-75)."""

    def rotate(self, shift: int) -> "PlainText":
        return PlainText(self._rotated(shift))

    def __add__(self, other):
        if isinstance(other, CipherText):
            return other + self  # commutative PT+CT (ipcl/plaintext.cpp:29-31)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, CipherText):
            return other * self  # commutative PT*CT (ipcl/plaintext.cpp:33-35)
        return NotImplemented


class CipherText(BaseText):
    """Ciphertext vector bound to a public key (ipcl/ciphertext.cpp)."""

    __slots__ = ("public_key",)

    def __init__(self, public_key, value: Union[int, Sequence[int], BaseText] = ()):
        super().__init__(value)
        self.public_key = public_key

    def get_ciphertext(self, idx: int) -> "CipherText":
        return CipherText(self.public_key, self.get_element(idx))

    def rotate(self, shift: int) -> "CipherText":
        return CipherText(self.public_key, self._rotated(shift))

    def __add__(self, other) -> "CipherText":
        if isinstance(other, CipherText):
            if not (len(self) == len(other) or len(other) == 1):
                raise ValueError("CT + CT error: Size mismatch!")
            if self.public_key.n != other.public_key.n:
                raise ValueError("CT + CT error: 2 different public keys detected!")
            out = self.public_key._engine.add_ctct_dev(
                self.device_payload(), other.device_payload()
            )
            return CipherText(self.public_key, out)
        if isinstance(other, PlainText):
            # encrypt the plaintext WITHOUT obfuscation, then CT+CT
            # (ipcl/ciphertext.cpp:75-80)
            b = self.public_key.encrypt(other, make_secure=False)
            return self + b
        return NotImplemented

    def __mul__(self, other) -> "CipherText":
        if isinstance(other, PlainText):
            b = other.texts
            if not (len(self) == len(b) or len(b) == 1):
                raise ValueError("CT * PT error: Size mismatch!")
            # scalar PT stays size-1: the engine routes it to the
            # shared-exponent kernel (no host-side replication)
            out = self.public_key._engine.mul_ctpt_dev(self.device_payload(), b)
            return CipherText(self.public_key, out)
        return NotImplemented

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CipherText)
            and self.texts == other.texts
            and self.public_key.n == other.public_key.n
        )
