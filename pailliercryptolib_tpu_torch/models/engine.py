"""Per-key device engines: codec + pipeline dispatch on one torch device.

Counterpart of the JAX package's ``models/engine.py`` for DJN encrypt and
CRT decrypt with keys up to 2048 bits.  The engine owns the precomputed
device constants of one key (the analog of the per-key state the reference
precomputes in its PublicKey/PrivateKey constructors, ipcl/pub_key.cpp:18-49
and ipcl/pri_key.cpp:13-37) and converts between host Python ints and
fixed-shape limb tensors around every batched call.

Every engine takes an explicit ``device`` (default ``"cuda"``).  With the
default and no GPU the constructor raises; nothing carries on on the CPU
unless the caller asked for ``device="cpu"`` (as the tests do), where the
kernels' plain versions run.  Batches are not padded: the kernels mask
their ragged last row tile themselves.

Entry points that are not ported yet raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import paillier_ops as pops
from ..ops.cuda_rns2 import (
    FB_WINDOW_BITS,
    fold_group_consts2,
    stack_group_consts2,
)
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
from ..ops.rns import RNSContext
from ..utils.config import perf_timer
from ..utils.rng import DeviceSeed

#: Widest key ported so far: the kernels as compiled hold one residue system
#: of a 2048-bit key's n^2 (or both of its p^2, q^2) in one thread block.
MAX_KEY_BITS = 2048


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


def _round_windows(nw: int) -> int:
    """Round a window count up to a multiple of 8 (as the reference does,
    so window arrays of the two packages have the same shape)."""
    return max(8, -(-nw // 8) * 8)


def _check_key_bits(nbits: int) -> None:
    if nbits > MAX_KEY_BITS:
        raise NotImplementedError(
            f"{nbits}-bit keys: keys wider than {MAX_KEY_BITS} bits need the "
            "generic grouped RNS modexp kernel (ROADMAP Queue 2, K5)"
        )


class PublicEngine:
    """Device pipelines for one public key."""

    def __init__(
        self,
        n: int,
        bits: int,
        hs: Optional[int],
        randbits: int,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
        self.n = n
        self.nsquare = n * n
        self.Ln = limbs_for_bits(self.nbits)
        self.mont_n2 = MontConstants.create(self.nsquare, 2 * self.nbits)
        self.L2 = self.mont_n2.num_limbs
        self.n_limbs = to_i32(ints_to_limbs([n], self.Ln)[0], self.device)
        self.n2_n = to_i32(self.mont_n2.n_limbs, self.device)
        self.randbits = randbits
        self.hs_int = hs
        self._rns = None
        self._fb = None
        self._fb_mask = None
        #: seconds the last fixed-base table build took (host square chain
        #: + device table kernel), for the caller's set-up accounting
        self.fb_build_seconds = 0.0

    def set_hs(self, hs: int, randbits: Optional[int] = None) -> None:
        """Install new DJN parameters (ipcl/pub_key.cpp:131-137); the
        fixed-base table is sized from ``randbits`` and built from hs."""
        self.hs_int = hs
        if randbits is not None:
            self.randbits = randbits
        self._fb = None
        self._fb_mask = None

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
            import time

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

    # -- pipelines ------------------------------------------------------------

    def encrypt_djn_dev(self, m: Sequence[int], r) -> DevLimbs:
        with perf_timer(f"encrypt_djn[B={len(m)}]"):
            return self._encrypt_djn_impl(m, r)

    def _encrypt_djn_impl(self, m: Sequence[int], r) -> DevLimbs:
        """``r`` is a list of ints (injected test randoms), a [B, nbytes]
        uint8 array from the OS CSPRNG (utils/rng.batch_random_bytes), or
        a utils/rng.DeviceSeed, which is expanded on the device."""
        size = len(m)
        m = list(m)
        m_a = self._upload_narrow(m)
        _, kc, conv = self.rns
        tab, NP = self.fixedbase
        if isinstance(r, DeviceSeed):
            seed = torch.from_numpy(r.data.astype(np.int64)[None]).to(self.device)
            out = pops.encrypt_fb_fused_rng_stage(
                tab, seed, self.fb_mask, m_a, self.n_limbs, kc, conv, self.n2_n
            )
            return DevLimbs(out, size)
        if isinstance(r, np.ndarray) and r.dtype == np.uint8:
            if r.shape[0] != size or r.shape[1] > NP:
                raise ValueError("obfuscator byte matrix does not fit the batch/table")
            rb = np.zeros((size, NP), np.uint8)
            rb[:, : r.shape[1]] = r
        else:
            r = [int(v) for v in r]
            if len(r) != size:
                raise ValueError("one obfuscator exponent per plaintext expected")
            ebits = max(self.randbits, max_bitlength(r))
            if -(-ebits // 8) > NP:
                raise NotImplementedError(
                    "injected obfuscator exponents wider than the fixed-base "
                    "table need the variable-base RNS modexp kernel "
                    "(ROADMAP Queue 2, K5)"
                )
            rb = ints_to_bytes_le(r, NP)
        r_b = torch.from_numpy(np.array(rb)).to(self.device)
        out = pops.encrypt_fb_fused_stage(
            tab, r_b, m_a, self.n_limbs, kc, conv, self.n2_n
        )
        return DevLimbs(out, size)

    def encrypt_djn(self, m, r) -> List[int]:
        return self.encrypt_djn_dev(m, r).fetch()

    # -- not ported yet ---------------------------------------------------------

    def encrypt_normal_dev(self, m, r):
        raise NotImplementedError(
            "normal-mode (non-DJN) encrypt needs the shared-exponent RNS "
            "modexp kernel (ROADMAP Queue 1 item 10, Queue 2 K5)"
        )

    def obfuscate_dev(self, ct, r):
        raise NotImplementedError(
            "apply_obfuscator is not ported yet (ROADMAP Queue 1 item 10)"
        )

    def encrypt_noobf_dev(self, m):
        raise NotImplementedError(
            "encrypt without obfuscation is not ported yet (ROADMAP Queue 1 item 11)"
        )

    def add_ctct_dev(self, a, b):
        raise NotImplementedError(
            "CT+CT is not ported yet (ROADMAP Queue 1 item 11)"
        )

    def mul_ctpt_dev(self, ct, pt):
        raise NotImplementedError(
            "CT*PT needs the variable-exponent RNS modexp kernel "
            "(ROADMAP Queue 1 item 10, Queue 2 K5)"
        )


class PrivateEngine:
    """Device pipelines for one private key (CRT decrypt)."""

    def __init__(
        self,
        n: int,
        p: int,
        q: int,
        lam: int,
        x: int,
        hp: int,
        hq: int,
        device="cuda",
    ):
        assert p < q
        self.device = resolve_device(device)
        dev = self.device
        pbits = max(p.bit_length(), q.bit_length())
        self.n = n
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
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
        self._p, self._q, self._pbits = p, q, pbits
        self._rns_crt = None
        self._rns_crt_ctx_pair = None

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
    def rns_crt(self):
        """(p^2, q^2) RNS machinery for CRT decrypt: (kernel consts, conv
        consts) in the CRT-folded lane layout with the f32-reciprocal
        reduction (fold_group_consts2 shared_input) — both residue systems
        side by side in one thread block, so every squaring serves both
        CRT halves."""
        if self._rns_crt is None:
            cp, cq = self._rns_crt_ctxs()
            kc2 = fold_group_consts2(
                [cp, cq], f32_mu=True, shared_input=True, device=self.device
            )
            conv2 = (cp.device_consts(self.device), cq.device_consts(self.device))
            self._rns_crt = (kc2, conv2)
        return self._rns_crt

    def _ct_operand(self, ct, width: int):
        """Decrypt input (DevLimbs or int list) -> ([B, width] tensor, size)."""
        if isinstance(ct, DevLimbs):
            arr, size = ct.arr, ct.size
            if arr.device != self.device:
                raise ValueError(
                    f"ciphertext lies on {arr.device}, the key's engine on {self.device}"
                )
            pad = width - arr.shape[-1]
            if pad < 0:
                raise ValueError("ciphertext limbs wider than decrypt expects")
            if pad > 0:
                arr = torch.cat(
                    [arr, torch.zeros(arr.shape[:-1] + (pad,), dtype=arr.dtype, device=arr.device)],
                    dim=-1,
                )
            return arr[:size].contiguous(), size
        # host ints -> device canonical limbs via a packed upload
        packed = pack_pairs_np(ints_to_limbs(list(ct), width))
        return pops.unpack_in_op(to_i32(packed, self.device), width), len(ct)

    def decrypt_crt_dev(self, ct) -> DevLimbs:
        size = ct.size if isinstance(ct, DevLimbs) else len(ct)
        with perf_timer(f"decrypt_crt[B={size}]"):
            return self._decrypt_crt_impl(ct)

    def _decrypt_crt_impl(self, ct) -> DevLimbs:
        ct_a, size = self._ct_operand(ct, 2 * self.Lp2)
        kc2, conv2 = self.rns_crt
        out = pops.decrypt_crt_rns_op(
            ct_a,
            self.sq_n,
            self.exp_wins, self.hensel, self.hfun,
            self.pq_n, self.pq_n0inv, self.pq_r2,
            self.pinv_q, self.p_limbs,
            kc2, conv2,
        )
        return DevLimbs(out, size)

    def decrypt_raw_dev(self, ct):
        raise NotImplementedError(
            "RAW (non-CRT) decrypt needs the shared-exponent RNS modexp "
            "kernel (ROADMAP Queue 1 item 10, Queue 2 K5)"
        )
