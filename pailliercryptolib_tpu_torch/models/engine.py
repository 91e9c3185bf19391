"""Per-key device engines: codec + pipeline dispatch on one torch device.

Counterpart of the JAX package's ``models/engine.py``, for keys up to 4096
bits: DJN and normal-mode encrypt, apply_obfuscator, encrypt without
obfuscation, CT+CT, CT*PT, CRT and RAW decrypt, each on three backends
(ops/dispatch.py): ``"rns"`` (the default: the residue-number-system
kernels), ``"cios"`` (the 15-bit-limb Montgomery kernels, a complete second
implementation) and ``"plain"`` (plain PyTorch on the engine's device, only
when asked for by name or for the tail of a hybrid batch split).  The
backend of an engine is its ``backend=`` argument, else the runtime config /
``PAILLIER_TORCH_BACKEND``, else ``"rns"``; the attribute ``backend`` may be
set later.  The engine owns the precomputed device constants of one key (the analog of the per-key
state the reference precomputes in its PublicKey/PrivateKey constructors,
ipcl/pub_key.cpp:18-49 and ipcl/pri_key.cpp:13-37) and converts between host
Python ints and fixed-shape limb tensors around every batched call.

Every engine takes an explicit ``device`` (default ``"cuda"``).  With the
default and no GPU the constructor raises; nothing carries on on the CPU
unless the caller asked for ``device="cpu"`` (as the tests do), where the
kernels' plain versions run.  Batches are not padded: the kernels mask
their ragged last row tile themselves, so the reference's ``_pad_batch`` and
the re-padding of a hybrid split's result have no counterpart here.

The hybrid batch split (ops/dispatch.py: ``set_hybrid_mode`` /
``set_hybrid_ratio``) runs the head rows of a host-side batch on the
engine's own backend and the tail rows on a ``"plain"`` twin engine, and
concatenates on the device.  Under the defaults nothing is split and the
twin is never built.

Keys wider than 2048 bits run through the same entry points: their n^2
allocates moduli below 2^13, so its constant sets take the f32-reciprocal
reduction with the full fold on up to 640 lanes, and their CRT decrypt takes
the grouped layout (one residue system a group of the generic modexp kernel)
where narrower keys take the folded one — the reference's rule.  Keys above
4096 bits raise ``ValueError``, as in the reference's key generator.  The
runtime context and the multi-device mesh of the reference have no
counterpart here yet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import paillier_ops as pops
from ..ops.cuda_rns2 import (
    FB_WINDOW_BITS,
    fold_group_consts2,
    stack_group_consts2,
)
from ..ops.dispatch import check_backend, default_backend, hybrid_head_count
from ..ops.limbs import (
    LIMB_BITS,
    ints_to_bytes_le,
    ints_to_limbs,
    ints_to_windows,
    limbs_for_bits,
    limbs_to_ints,
    max_bitlength,
    num_windows,
    pack_pairs_np,
    unpack_pairs_np,
)
from ..ops.montgomery import MontConstants, to_i32
from ..ops.rns import RNSContext, rns_supported
from ..utils import rng as _rng
from ..utils.config import perf_timer
from ..utils.rng import DeviceSeed

#: Widest key (the reference's N_BIT_SIZE_MAX): one residue system of its n^2
#: is 640 lanes, a thread block of the wide kernel instances; its n^2 is 547
#: limbs, the widest operand of the CIOS kernels.
MAX_KEY_BITS = 4096
#: Lanes up to which the (p^2, q^2) pair of a CRT decrypt lies folded side by
#: side (2k + 2 of them); wider pairs run grouped.  The reference's rule, kept
#: so that outputs and launch counts are the reference's.
FOLDED_MAX_LANES = 384


def resolve_device(device) -> torch.device:
    """The device an engine runs on.  A CUDA device that is not there is an
    error, never a reason to carry on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class DevLimbs:
    """A device-resident batch of canonical 15-bit limbs [B, L] (int32) plus
    the live batch size.

    Every engine op accepts and returns DevLimbs, so chained pipelines stay
    on the device; the host list-of-ints view materializes lazily (one
    packed download) only when ``.texts`` is read."""

    __slots__ = ("arr", "size")

    def __init__(self, arr: torch.Tensor, size: int):
        self.arr = arr
        self.size = size

    def fetch(self) -> List[int]:
        with perf_timer(f"download[B={self.size}]"):
            packed = pops.pack_out_op(self.arr[: self.size])
            packed_np = packed.cpu().numpy().astype(np.uint32)
            return limbs_to_ints(unpack_pairs_np(packed_np, self.arr.shape[-1]))

    def sync(self) -> None:
        """Block until the producing computation completed on the device."""
        if self.arr.device.type == "cuda":
            torch.cuda.synchronize(self.arr.device)


def _ct_operand(ct, width: int, device):
    """CipherText operand (DevLimbs or int list) -> ([B, width] int32
    tensor on ``device``, size)."""
    if isinstance(ct, DevLimbs):
        arr, size = ct.arr, ct.size
        if arr.device != device:
            raise ValueError(
                f"ciphertext lies on {arr.device}, the key's engine on {device}"
            )
        pad = width - arr.shape[-1]
        if pad < 0:
            raise ValueError("ciphertext limbs wider than the operation expects")
        if pad > 0:
            zeros = torch.zeros(
                arr.shape[:-1] + (pad,), dtype=arr.dtype, device=arr.device
            )
            arr = torch.cat([arr, zeros], dim=-1)
        return arr[:size].contiguous(), size
    # host ints -> device canonical limbs via a packed upload
    packed = pack_pairs_np(ints_to_limbs(list(ct), width))
    return pops.unpack_in_op(to_i32(packed, device), width), len(ct)


def _payload_size(ct) -> int:
    return ct.size if isinstance(ct, DevLimbs) else len(ct)


def _round_windows(nw: int) -> int:
    """Round a window count up to a multiple of 8 (as the reference does,
    so window arrays of the two packages have the same shape)."""
    return max(8, -(-nw // 8) * 8)


def _check_key_bits(nbits: int) -> None:
    if nbits > MAX_KEY_BITS:
        raise ValueError(
            f"{nbits}-bit key: key size exceeds supported range "
            f"({MAX_KEY_BITS} bits)"
        )


def _resolve_backend(backend: Optional[str]) -> str:
    """Explicit choice > runtime config / environment > ``"rns"``."""
    return check_backend(backend) if backend else default_backend()


def _width_backend(backend: str, mod_bits: int) -> str:
    """Downgrade the RNS backend to the width-generic CIOS kernels when the
    modulus exceeds the prime pool's reach (ops/rns.rns_supported).  Every
    key size the engines accept stays on RNS; this gate protects wider
    moduli."""
    if backend != "rns" or rns_supported(mod_bits):
        return backend
    return "cios"


def _decode_bytes(r):
    """A [B, nbytes] uint8 exponent matrix (least significant byte first)
    -> ints, for the backends that take window-encoded exponents; anything
    else -> a list of ints."""
    if isinstance(r, np.ndarray) and r.dtype == np.uint8:
        return [int.from_bytes(row.tobytes(), "little") for row in r]
    return [int(v) for v in r]


class _EngineCommon:
    """The hybrid batch split shared by the public and private engines
    (ipcl/mod_exp.cpp:688-732)."""

    @property
    def secondary(self):
        """The plain-PyTorch twin engine for hybrid batch splits (the
        reference's IPP-path analog, ipcl/mod_exp.cpp:727-728)."""
        if self.backend == "plain":
            return self
        if self._secondary is None:
            self._secondary = self._make_secondary()
        return self._secondary

    def _cios(self) -> str:
        """The backend of a limb product outside the RNS kernels."""
        return "cios" if self.backend == "rns" else self.backend

    def _hybrid(self, op: str, method: str, size: int, operands):
        """Run pipeline ``method`` on a batch, split at the hybrid ratio:
        head rows on this engine's kernel backend, tail rows on the plain
        twin, concatenated on the device.  The whole batch stays on this
        engine when no split applies: full-primary policy, a plain engine,
        or device-resident operands (which cannot be resliced on the host)."""
        if self.backend == "plain" or any(
            isinstance(o, DevLimbs) for o in operands
        ):
            return getattr(self, method)(*operands)
        nh = hybrid_head_count(op, size, self.backend)
        if nh >= size:
            return getattr(self, method)(*operands)

        def part(o, sl):
            if isinstance(o, np.ndarray):
                return o[sl]
            o = list(o)
            return o if len(o) == 1 and size > 1 else o[sl]  # shared scalar

        tail = getattr(self.secondary, method)(
            *[part(o, slice(nh, size)) for o in operands]
        )
        if nh == 0:
            return DevLimbs(tail.arr[: tail.size], size)
        head = getattr(self, method)(*[part(o, slice(0, nh)) for o in operands])
        return DevLimbs(
            torch.cat([head.arr[: head.size], tail.arr[: tail.size]]), size
        )


class PublicEngine(_EngineCommon):
    """Device pipelines for one public key."""

    def __init__(
        self,
        n: int,
        bits: int,
        hs: Optional[int],
        randbits: int,
        backend: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
        self.backend = _width_backend(_resolve_backend(backend), 2 * self.nbits)
        self._secondary: Optional["PublicEngine"] = None
        self.n = n
        self.nsquare = n * n
        self.Ln = limbs_for_bits(self.nbits)
        self.mont_n2 = MontConstants.create(self.nsquare, 2 * self.nbits)
        self.L2 = self.mont_n2.num_limbs
        self.n_limbs = to_i32(ints_to_limbs([n], self.Ln)[0], self.device)
        self.n2_args = self.mont_n2.as_device_args(self.device)  # n, n0inv, r2, one
        self.n2_n = self.n2_args[0]
        # shared exponent n as windows for the normal obfuscator r^n mod n^2
        self.n_wins = to_i32(ints_to_windows([n], self.nbits), self.device)
        self.randbits = randbits
        self.hs_int = hs
        self.hs_limbs = self._hs_limbs()
        self._rns = None
        self._fb = None
        self._fb_mask = None
        #: seconds the last fixed-base table build took (host square chain
        #: + device table kernel), for the caller's set-up accounting
        self.fb_build_seconds = 0.0

    def _hs_limbs(self) -> Optional[torch.Tensor]:
        if self.hs_int is None:
            return None
        return to_i32(ints_to_limbs([self.hs_int], self.L2)[0], self.device)

    def _make_secondary(self) -> "PublicEngine":
        return PublicEngine(
            self.n, self.nbits, self.hs_int, self.randbits, backend="plain",
            device=self.device,
        )

    def set_hs(self, hs: int, randbits: Optional[int] = None) -> None:
        """Install new DJN parameters (ipcl/pub_key.cpp:131-137); the
        fixed-base table is sized from ``randbits`` and built from hs."""
        self.hs_int = hs
        self.hs_limbs = self._hs_limbs()
        if randbits is not None:
            self.randbits = randbits
        self._fb = None
        self._fb_mask = None
        self._secondary = None  # the plain twin re-derives hs on next use

    @property
    def rns(self):
        """Lazy RNS machinery for n^2: (context, kernel consts, conversion
        consts)."""
        if self._rns is None:
            ctx = RNSContext.create(self.nsquare, in_limbs=self.L2)
            kc = stack_group_consts2([ctx], device=self.device)
            conv = ctx.device_consts(self.device)
            self._rns = (ctx, kc, conv)
        return self._rns

    @property
    def fixedbase(self):
        """Lazy per-key fixed-base table for hs^r: (table, NP).  Built once
        per key: a host square chain g_i = hs^(2^(8 i)) mod n^2 feeds the
        device table kernel."""
        if self._fb is None:
            if self.hs_int is None:
                raise ValueError("fixed-base table needs the DJN base hs")
            t0 = time.perf_counter()
            nbytes = -(-self.randbits // FB_WINDOW_BITS)
            NP = max(8, -(-nbytes // 8) * 8)
            _, kc, conv = self.rns
            g = [self.hs_int % self.nsquare]
            for _ in range(NP - 1):
                g.append(pow(g[-1], 256, self.nsquare))
            g_limbs = to_i32(ints_to_limbs(g, self.L2), self.device)
            tab = pops.fb_table_stage(g_limbs, kc, conv)
            self._fb = (tab, NP)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.fb_build_seconds = time.perf_counter() - t0
        return self._fb

    @property
    def fb_mask(self):
        """[NP] uint8 byte mask for device-generated obfuscator exponents
        (0xFF for full randbits bytes, a partial top byte, 0 beyond)."""
        if self._fb_mask is None:
            _, NP = self.fixedbase
            nbytes = -(-self.randbits // 8)
            mask = np.zeros((NP,), np.uint8)
            mask[:nbytes] = 0xFF
            top = self.randbits % 8
            if top:
                mask[nbytes - 1] = (1 << top) - 1
            self._fb_mask = torch.from_numpy(mask).to(self.device)
        return self._fb_mask

    def _upload_narrow(self, xs: List[int]) -> torch.Tensor:
        """Upload a batch using only the limbs that cover its widest value
        (rounded to 8, as the reference does)."""
        lm = -(-max_bitlength(xs) // LIMB_BITS)
        Lm = min(self.Ln, max(8, -(-lm // 8) * 8))
        return to_i32(ints_to_limbs(xs, Lm), self.device)

    def _seed_rows(self, r: DeviceSeed) -> torch.Tensor:
        """[1, 11] int64 seed row of 32-bit words on the device."""
        return torch.from_numpy(r.data.astype(np.int64)[None]).to(self.device)

    def _obf_bytes(self, r, size: int, NP: int) -> Optional[torch.Tensor]:
        """Injected or host-drawn DJN exponents (a [B, nbytes] uint8 array or
        ints) -> [size, NP] uint8 tensor of exponent bytes, or None when an
        injected exponent is wider than the fixed-base table."""
        if isinstance(r, np.ndarray) and r.dtype == np.uint8:
            if r.shape[0] != size or r.shape[1] > NP:
                raise ValueError("obfuscator byte matrix does not fit the batch/table")
            rb = np.zeros((size, NP), np.uint8)
            rb[:, : r.shape[1]] = r
        else:
            if len(r) != size:
                raise ValueError("one obfuscator exponent per row expected")
            if -(-max(self.randbits, max_bitlength(r)) // 8) > NP:
                return None
            rb = ints_to_bytes_le(r, NP)
        return torch.from_numpy(np.array(rb)).to(self.device)

    def _hs_pow_var(self, r: List[int], kc) -> torch.Tensor:
        """hs^r for injected exponents wider than the fixed-base table: the
        generic modexp kernel with per-row windows on a broadcast base.
        Residues of a value <= 2N, not in Montgomery form."""
        ebits = max(self.randbits, max_bitlength(r))
        nw = _round_windows(num_windows(ebits))
        r_w = to_i32(ints_to_windows(r, nw * 4), self.device)
        return pops.rns_modexp_stage(self.hs_limbs.expand(len(r), -1), r_w, kc)

    def _host_rows(self, r, size: int, what: str) -> torch.Tensor:
        """Per-row host ints -> [size, L2] limbs on the device."""
        r = [int(v) for v in r]
        if len(r) != size:
            raise ValueError(f"one {what} per row expected")
        return to_i32(ints_to_limbs(r, self.L2), self.device)

    def _exp_windows(self, r: List[int], floor_bits: int) -> torch.Tensor:
        """Per-row exponents -> [B, NW] windows on the device, NW rounded
        to a multiple of 8 and covering at least ``floor_bits``."""
        nw = _round_windows(num_windows(max(floor_bits, max_bitlength(r))))
        return to_i32(ints_to_windows(r, nw * 4), self.device)

    def _seed_fallback(self, r, size: int, op: str, normal: bool = False):
        """Materialize a DeviceSeed into a host draw for the paths that
        cannot expand it on the device: hybrid batch splits (a seed cannot
        be row-sliced) and the backends other than ``"rns"``.  ``normal``
        draws normal-mode obfuscator bases r in [1, n-1] instead of DJN
        exponent bytes."""
        if not isinstance(r, DeviceSeed):
            return r
        if (
            self.backend != "rns"
            or hybrid_head_count(op, size, self.backend) < size
        ):
            if normal:
                return [
                    v % (self.n - 1) + 1
                    for v in _rng.batch_random_bits(size, self.nbits)
                ]
            return r.materialize(size, self.randbits)
        return r

    # -- pipelines ------------------------------------------------------------
    #
    # Every pipeline returns DevLimbs (device-resident canonical limbs).  The
    # *_dev entry points run the _impl pipelines through the hybrid split.

    def encrypt_djn_dev(self, m: Sequence[int], r) -> DevLimbs:
        with perf_timer(f"encrypt_djn[B={len(m)}]"):
            r = self._seed_fallback(r, len(m), "encrypt")
            return self._hybrid("encrypt", "_encrypt_djn_impl", len(m), (m, r))

    def _encrypt_djn_impl(self, m: Sequence[int], r) -> DevLimbs:
        """``r`` is a list of ints (injected test randoms), a [B, nbytes]
        uint8 array from the OS CSPRNG (utils/rng.batch_random_bytes), or
        a utils/rng.DeviceSeed, which is expanded on the device."""
        size = len(m)
        m_a = self._upload_narrow(list(m))
        if self.backend != "rns":  # window-encoded exponents, shared base hs
            r = _decode_bytes(r)
            if len(r) != size:
                raise ValueError("one obfuscator exponent per row expected")
            out = pops.encrypt_djn_op(
                m_a, self._exp_windows(r, self.randbits), self.n_limbs,
                *self.n2_args, self.hs_limbs, backend=self.backend,
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        tab, NP = self.fixedbase
        if isinstance(r, DeviceSeed):
            out = pops.encrypt_fb_fused_rng_stage(
                tab, self._seed_rows(r), self.fb_mask, m_a, self.n_limbs, kc,
                conv, self.n2_n,
            )
            return DevLimbs(out, size)
        if not isinstance(r, np.ndarray):
            r = [int(v) for v in r]
        r_b = self._obf_bytes(r, size, NP)
        if r_b is not None:  # exponents fit the table
            out = pops.encrypt_fb_fused_stage(
                tab, r_b, m_a, self.n_limbs, kc, conv, self.n2_n
            )
        else:  # injected oversized exponents: variable-base fallback
            res = self._hs_pow_var(r, kc)
            out = pops.encrypt_post_stage(
                res, m_a, self.n_limbs, conv, self.n2_n, res_mont=False
            )
        return DevLimbs(out, size)

    def encrypt_normal_dev(self, m: Sequence[int], r) -> DevLimbs:
        with perf_timer(f"encrypt_normal[B={len(m)}]"):
            r = self._seed_fallback(r, len(m), "encrypt", normal=True)
            return self._hybrid("encrypt", "_encrypt_normal_impl", len(m), (m, r))

    def _encrypt_normal_impl(self, m: Sequence[int], r) -> DevLimbs:
        """ct = (n*m+1) * r^n mod n^2.  ``r`` is a utils/rng.DeviceSeed (the
        base is then drawn on the device, unreduced) or a list of ints."""
        size = len(m)
        m_a = self._upload_narrow(list(m))
        if self.backend != "rns":  # the seed fallback left a host list
            r_a = self._host_rows(r, size, "obfuscator base")
            out = pops.encrypt_normal_op(
                m_a, r_a, self.n_wins, self.n_limbs, *self.n2_args,
                backend=self.backend,
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if isinstance(r, DeviceSeed):
            out = pops.encrypt_normal_rng_stage(
                self._seed_rows(r), m_a, self.n_wins, self.n_limbs, kc, conv,
                self.n2_n, ebits=2 * self.nbits + 3,
            )
            return DevLimbs(out, size)
        r_a = self._host_rows(r, size, "obfuscator base")
        # the exponent (n) is shared by every row: shared-window kernel
        res = pops.rns_modexp_shared_stage(r_a, self.n_wins, kc)
        out = pops.encrypt_post_stage(res, m_a, self.n_limbs, conv, self.n2_n)
        return DevLimbs(out, size)

    def obfuscate_dev(self, ct, r) -> DevLimbs:
        size = _payload_size(ct)
        with perf_timer(f"obfuscate[B={size}]"):
            r = self._seed_fallback(r, size, "encrypt")
            return self._hybrid("encrypt", "_obfuscate_impl", size, (ct, r))

    def _obfuscate_impl(self, ct, r) -> DevLimbs:
        """Standalone re-obfuscation: ct * hs^r (DJN, ipcl/pub_key.cpp:51-64)
        or ct * r^n (normal, :66-80) mod n^2.  ``ct`` is DevLimbs or a host
        int list; ``r`` follows encrypt_djn_dev's conventions."""
        ct_a, size = _ct_operand(ct, self.L2, self.device)
        if self.backend != "rns":
            if self.hs_int is None:  # normal mode: per-row bases, exponent n
                base = self._host_rows(r, size, "obfuscator base")
                wins = self.n_wins
            else:  # DJN: the shared base hs, per-row exponents
                r = _decode_bytes(r)
                if len(r) != size:
                    raise ValueError("one obfuscator exponent per row expected")
                base, wins = self.hs_limbs, self._exp_windows(r, self.randbits)
            out = pops.obfuscate_op(
                ct_a, base, wins, *self.n2_args, backend=self.backend
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if self.hs_int is None:  # normal mode: obf = r^n, shared exponent n
            r_a = self._host_rows(r, size, "obfuscator base")
            res = pops.rns_modexp_shared_stage(r_a, self.n_wins, kc)
            out = pops.mul_res_post_stage(ct_a, res, conv, self.n2_n)
            return DevLimbs(out, size)
        tab, NP = self.fixedbase  # DJN: obf = hs^r
        if isinstance(r, DeviceSeed):
            out = pops.obfuscate_fb_fused_rng_stage(
                tab, self._seed_rows(r), self.fb_mask, ct_a, kc, conv, self.n2_n
            )
            return DevLimbs(out, size)
        if not isinstance(r, np.ndarray):
            r = [int(v) for v in r]
        r_b = self._obf_bytes(r, size, NP)
        if r_b is not None:
            res = pops.rns_fb_modexp_stage(tab, r_b, kc, mont_out=True)
        else:
            res = self._hs_pow_var(r, kc)
        out = pops.mul_res_post_stage(
            ct_a, res, conv, self.n2_n, res_mont=r_b is not None
        )
        return DevLimbs(out, size)

    def encrypt_noobf_dev(self, m: Sequence[int]) -> DevLimbs:
        with perf_timer(f"encrypt_noobf[B={len(m)}]"):
            m_a = self._upload_narrow(list(m))
            out = pops.encrypt_noobf_op(m_a, self.n_limbs, self.n2_n)
            return DevLimbs(out, len(m))

    def add_ctct_dev(self, a, b) -> DevLimbs:
        with perf_timer(f"add_ctct[B={_payload_size(a)}]"):
            a_a, size = _ct_operand(a, self.L2, self.device)
            b_a, b_size = _ct_operand(b, self.L2, self.device)
            if b_size == 1 and size != 1:
                b_a = b_a.expand_as(a_a)
            elif b_size != size:
                raise ValueError("CT + CT: operands of one size (or a size-1 b)")
            if self.backend != "rns":
                n2_n, n2_n0inv, n2_r2, _ = self.n2_args
                out = pops.add_ctct_op(
                    a_a, b_a, n2_n, n2_n0inv, n2_r2, backend=self._cios()
                )
                return DevLimbs(out, size)
            _, _, conv = self.rns
            return DevLimbs(pops.add_ctct_rns_op(a_a, b_a, conv, self.n2_n), size)

    def mul_ctpt_dev(self, ct, pt: Sequence[int]) -> DevLimbs:
        size = _payload_size(ct)
        with perf_timer(f"mul_ctpt[B={size}]"):
            return self._hybrid("multiply", "_mul_ctpt_impl", size, (ct, pt))

    def _mul_ctpt_impl(self, ct, pt: Sequence[int]) -> DevLimbs:
        ct_a, size = _ct_operand(ct, self.L2, self.device)
        pt = [int(v) for v in pt]
        # a scalar PT keeps its size-1 row: the shared-exponent kernel path
        shared_pt = len(pt) == 1 and size != 1
        if not shared_pt and len(pt) != size:
            raise ValueError("CT * PT: one plaintext per row, or one scalar")
        nw = _round_windows(num_windows(max_bitlength(pt)))
        pt_w = to_i32(ints_to_windows(pt, nw * 4), self.device)
        if self.backend != "rns":  # a [1, NW] scalar is read by every row
            out = pops.mul_ctpt_op(ct_a, pt_w, *self.n2_args, backend=self.backend)
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if shared_pt:
            res = pops.rns_modexp_shared_stage(ct_a, pt_w, kc)
        else:
            res = pops.rns_modexp_stage(ct_a, pt_w, kc)
        out = pops.rns_finalize_stage(res, conv, self.n2_n, self.L2)
        return DevLimbs(out, size)

    def encrypt_djn(self, m, r) -> List[int]:
        return self.encrypt_djn_dev(m, r).fetch()


class PrivateEngine(_EngineCommon):
    """Device pipelines for one private key (CRT + RAW decrypt)."""

    def __init__(
        self,
        n: int,
        p: int,
        q: int,
        lam: int,
        x: int,
        hp: int,
        hq: int,
        backend: Optional[str] = None,
        device="cuda",
    ):
        assert p < q
        self.device = resolve_device(device)
        dev = self.device
        pbits = max(p.bit_length(), q.bit_length())
        self.n = n
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
        # CRT decrypt runs at p^2 / q^2 width; the RAW path gates on the
        # width of n^2 per call
        self.backend = _width_backend(_resolve_backend(backend), 2 * pbits)
        self._secondary: Optional["PrivateEngine"] = None
        self.Lp = limbs_for_bits(pbits)
        self.mont_p2 = MontConstants.create(p * p, 2 * pbits)
        self.mont_q2 = MontConstants.create(q * q, 2 * pbits)
        self.Lp2 = self.mont_p2.num_limbs
        assert self.mont_q2.num_limbs == self.Lp2
        self.mont_p = MontConstants.create(p, pbits)
        self.mont_q = MontConstants.create(q, pbits)
        assert self.mont_q.num_limbs == self.Lp

        def stack(a_p, a_q):
            return to_i32(np.stack([a_p, a_q]), dev)

        self.sq_n = stack(self.mont_p2.n_limbs, self.mont_q2.n_limbs)
        self.sq_n0inv = to_i32(
            np.array([self.mont_p2.n0inv, self.mont_q2.n0inv], np.uint32), dev
        )
        self.sq_r2 = stack(self.mont_p2.r2_limbs, self.mont_q2.r2_limbs)
        self.sq_one = stack(self.mont_p2.one_limbs, self.mont_q2.one_limbs)
        ewbits = _round_windows(num_windows(pbits)) * 4
        self.exp_wins = to_i32(
            np.stack(
                [ints_to_windows([p - 1], ewbits), ints_to_windows([q - 1], ewbits)]
            ),
            dev,
        )  # [2, 1, NW]
        R_lp = 1 << (LIMB_BITS * self.Lp)
        self.hensel = stack(
            ints_to_limbs([pow(p, -1, R_lp)], self.Lp)[0],
            ints_to_limbs([pow(q, -1, R_lp)], self.Lp)[0],
        )
        self.hfun = stack(
            ints_to_limbs([hp], self.Lp)[0], ints_to_limbs([hq], self.Lp)[0]
        )
        self.pq_n = stack(self.mont_p.n_limbs, self.mont_q.n_limbs)
        self.pq_n0inv = to_i32(
            np.array([self.mont_p.n0inv, self.mont_q.n0inv], np.uint32), dev
        )
        self.pq_r2 = stack(self.mont_p.r2_limbs, self.mont_q.r2_limbs)
        self.pinv_q = to_i32(ints_to_limbs([pow(p, -1, q)], self.Lp)[0], dev)
        self.p_limbs = to_i32(ints_to_limbs([p], self.Lp)[0], dev)
        # RAW-mode constants (lambda exponent over n^2, then L-function by n)
        self.mont_n2 = MontConstants.create(n * n, 2 * self.nbits)
        self.mont_n = MontConstants.create(n, self.nbits)
        self.Ln = self.mont_n.num_limbs
        self.n2_args = self.mont_n2.as_device_args(dev)  # n, n0inv, r2, one
        self.n2_n = self.n2_args[0]
        lam_bits = _round_windows(num_windows(self.nbits)) * 4
        self.lam_wins = to_i32(ints_to_windows([lam], lam_bits), dev)
        R_ln = 1 << (LIMB_BITS * self.Ln)
        self.hensel_n = to_i32(ints_to_limbs([pow(n, -1, R_ln)], self.Ln)[0], dev)
        self.x_limbs = to_i32(ints_to_limbs([x], self.Ln)[0], dev)
        self.n_n = to_i32(self.mont_n.n_limbs, dev)
        self.n_n0inv = to_i32(np.array([self.mont_n.n0inv], np.uint32), dev)
        self.n_r2 = to_i32(self.mont_n.r2_limbs, dev)
        self._p, self._q, self._pbits = p, q, pbits
        self._lam, self._x, self._hp, self._hq = lam, x, hp, hq
        self._rns_crt = None
        self._rns_crt_stacked = None
        self._rns_crt_ctx_pair = None
        self._rns_crt_conv = None
        self._rns_raw = None

    def _make_secondary(self) -> "PrivateEngine":
        return PrivateEngine(
            self.n, self._p, self._q, self._lam, self._x, self._hp, self._hq,
            backend="plain", device=self.device,
        )

    def _rns_crt_ctxs(self):
        """The (p^2, q^2) RNSContext pair.

        in_limbs spans the FULL n^2-width ciphertext (2*Lp2): the Cin
        weights (2^(15 l) mod h^2) mod m fold ct into each residue system
        inside the kernel's input conversion, so decrypt has no separate
        "ct mod p^2" stage.  The represented value is
        V < 2*Lp2 * 2^15 * N; product_bits sizes M_A >= 2^26 * N above it
        so the first to-Montgomery multiply contracts V*N/M_A + 2N < 3N."""
        if self._rns_crt_ctx_pair is None:
            in_limbs = 2 * self.Lp2
            bits = 2 * self._pbits + LIMB_BITS + in_limbs.bit_length() + 1
            cp = RNSContext.create(
                self._p * self._p, in_limbs=in_limbs, product_bits=bits
            )
            cq = RNSContext.create(
                self._q * self._q, in_limbs=in_limbs, product_bits=bits
            )
            self._rns_crt_ctx_pair = (cp, cq)
        return self._rns_crt_ctx_pair

    @property
    def crt_folded(self) -> bool:
        """Whether this key's CRT decrypt takes the folded lane layout: both
        residue systems fit ``FOLDED_MAX_LANES`` side by side (keys up to 2048
        bits).  Wider keys (2k + 2 = 452 / 612 lanes at 3072 / 4096 bits) take
        the grouped layout, whose per-group k stays within 320 lanes
        and eligible for the lean fold."""
        cp, _ = self._rns_crt_ctxs()
        return 2 * cp.k + 2 <= FOLDED_MAX_LANES

    def _crt_conv(self):
        """(conv_p, conv_q): the pair's conversion constants on the device."""
        if self._rns_crt_conv is None:
            cp, cq = self._rns_crt_ctxs()
            self._rns_crt_conv = (
                cp.device_consts(self.device), cq.device_consts(self.device)
            )
        return self._rns_crt_conv

    @property
    def rns_crt(self):
        """(p^2, q^2) RNS machinery for CRT decrypt: (kernel consts, conv
        consts), f32-reciprocal reduction.  Folded layout
        (fold_group_consts2 shared_input: both residue systems side by side
        in one thread block, so every squaring serves both CRT halves) when
        :attr:`crt_folded`, else the grouped one of :attr:`rns_crt_stacked`."""
        if self._rns_crt is None:
            if not self.crt_folded:
                self._rns_crt = self.rns_crt_stacked
            else:
                kc2 = fold_group_consts2(
                    list(self._rns_crt_ctxs()), f32_mu=True, shared_input=True,
                    device=self.device,
                )
                self._rns_crt = (kc2, self._crt_conv())
        return self._rns_crt

    @property
    def rns_crt_stacked(self):
        """The same (p^2, q^2) pair in the GROUPED layout (stack_group_consts2
        with the f32-reciprocal reduction): one residue system per group of
        the generic modexp kernel.  :func:`decrypt_crt_rns_op` takes either;
        the results agree."""
        if self._rns_crt_stacked is None:
            kc2 = stack_group_consts2(
                list(self._rns_crt_ctxs()), f32_mu=True, device=self.device
            )
            self._rns_crt_stacked = (kc2, self._crt_conv())
        return self._rns_crt_stacked

    @property
    def rns_raw(self):
        """RNS machinery for the RAW path (modulus n^2): (kernel consts,
        conversion consts)."""
        if self._rns_raw is None:
            ctx = RNSContext.create(self.n * self.n, in_limbs=self.mont_n2.num_limbs)
            self._rns_raw = (
                stack_group_consts2([ctx], device=self.device),
                ctx.device_consts(self.device),
            )
        return self._rns_raw

    def decrypt_crt_dev(self, ct) -> DevLimbs:
        size = _payload_size(ct)
        with perf_timer(f"decrypt_crt[B={size}]"):
            return self._hybrid("decrypt", "_decrypt_crt_impl", size, (ct,))

    def _decrypt_crt_impl(self, ct, grouped: bool = False) -> DevLimbs:
        """``grouped`` runs the stacked constants through the generic modexp
        kernel instead of the folded ones (same result)."""
        ct_a, size = _ct_operand(ct, 2 * self.Lp2, self.device)
        if self.backend != "rns":
            out = pops.decrypt_crt_op(
                ct_a,
                self.sq_n, self.sq_n0inv, self.sq_r2, self.sq_one,
                self.exp_wins, self.hensel, self.hfun,
                self.pq_n, self.pq_n0inv, self.pq_r2,
                self.pinv_q, self.p_limbs,
                backend=self.backend,
            )
            return DevLimbs(out, size)
        kc2, conv2 = self.rns_crt_stacked if grouped else self.rns_crt
        out = pops.decrypt_crt_rns_op(
            ct_a,
            self.sq_n,
            self.exp_wins, self.hensel, self.hfun,
            self.pq_n, self.pq_n0inv, self.pq_r2,
            self.pinv_q, self.p_limbs,
            kc2, conv2,
        )
        return DevLimbs(out, size)

    def decrypt_raw_dev(self, ct) -> DevLimbs:
        size = _payload_size(ct)
        with perf_timer(f"decrypt_raw[B={size}]"):
            return self._hybrid("decrypt", "_decrypt_raw_impl", size, (ct,))

    def _decrypt_raw_impl(self, ct) -> DevLimbs:
        """m = L(c^lambda mod n^2) * x mod n (ipcl/pri_key.cpp:92-111)."""
        L2 = self.mont_n2.num_limbs
        ct_a, size = _ct_operand(ct, L2, self.device)
        # RAW runs at n^2 width, wider than the CRT path's p^2
        raw_backend = _width_backend(self.backend, 2 * self.nbits)
        if raw_backend != "rns":
            out = pops.decrypt_raw_op(
                ct_a, self.lam_wins, *self.n2_args, self.hensel_n, self.x_limbs,
                self.n_n, self.mont_n.n0inv, self.n_r2, backend=raw_backend,
            )
            return DevLimbs(out, size)
        kc, conv = self.rns_raw
        res_r = pops.rns_modexp_shared_stage(ct_a, self.lam_wins, kc)
        res = pops.rns_finalize_stage(res_r, conv, self.n2_n, L2)
        out = pops.hensel_post_stage(
            res, self.hensel_n, self.x_limbs, self.n_n, self.n_n0inv, self.n_r2
        )
        return DevLimbs(out, size)
