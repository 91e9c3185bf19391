"""Device pipelines of the Paillier scheme: DJN encrypt and CRT decrypt.

Counterpart of the JAX package's ``ops/paillier_ops.py`` for the path
``encrypt_fb_fused_rng_stage`` -> ``decrypt_crt_rns_op``.  Each function
is a plain batched program over int32 limb / residue tensors that lives on
the device of its inputs; the modular exponentiations run in the kernels of
ops/cuda_rns2.py and the limb products of the decrypt tail in
ops/cuda_modexp.py.  There is no staging or jit: PyTorch runs eagerly.

* ``encrypt_fb_fused_stage``   <- ipcl/pub_key.cpp:51-64,99-110
* ``decrypt_crt_rns_op``       <- ipcl/pri_key.cpp:114-152
"""

from __future__ import annotations

import torch

from .bigint import mul_low, mul_shared, sub_mod, sub_scalar
from .cuda_modexp import mod_mul
from .cuda_rns2 import (
    fb_gather_table,
    fb_modexp2,
    fb_table2,
    rns_modexp2f,
    unfold_rns_out,
)
from .montgomery import canonicalize, cond_sub_n
from .rns import limbs_to_rns, mulmod, rns_mont_mul, rns_to_limbs

_I64 = torch.int64
_I32 = torch.int32
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# encryption
# ---------------------------------------------------------------------------


def _raw_encrypt(m, n_limbs, L2):
    """ct = n*m + 1 (no reduction needed: m < n  =>  n*m+1 < n^2).

    Exploits g = n+1 as the reference does (ipcl/pub_key.cpp:99-110):
    (n+1)^m = 1 + n*m mod n^2, so plaintext embedding costs one
    shared-operand product instead of a modexp.  ``m`` may arrive narrower
    than n."""
    raw = mul_shared(n_limbs, m)  # [B, Ln+Lm]; value < n^2
    pad = L2 - raw.shape[-1]
    if pad > 0:
        raw = torch.cat(
            [raw, torch.zeros(raw.shape[:-1] + (pad,), dtype=_I32, device=raw.device)],
            dim=-1,
        )
    else:
        raw = raw[..., :L2]
    raw = raw.clone()
    # +1 keeps digit 0 <= 2**15: safe redundant input for limbs_to_rns
    raw[..., 0] += 1
    return raw


def _rns_finalize(res, conv, n_limbs, out_limbs):
    """RNS residues of a value <= 2N -> canonical fully-reduced limbs."""
    limbs = rns_to_limbs(res, conv)  # [B, Lout], canonical, value <= 2N
    Lout = limbs.shape[-1]
    n_ext = torch.zeros((Lout,), dtype=_I32, device=limbs.device)
    n_ext[: n_limbs.shape[-1]] = n_limbs
    limbs = cond_sub_n(cond_sub_n(limbs, n_ext), n_ext)
    return limbs[..., :out_limbs]


def fb_table_stage(g_limbs, kc, conv):
    """Build the fixed-base table from g_limbs [NP, L]: canonical limbs of
    g_i = base^(2^(8 i)) mod N (host-computed square chain).  Returns the
    gather table [NP, 256, 2k+1] int32 of ops/cuda_rns2.fb_modexp2."""
    k = kc["sig0"].shape[-1]
    res = limbs_to_rns(g_limbs, conv)  # [NP, K], values < N
    gm = rns_mont_mul(res, conv["mont_sq"][None, :], conv)  # Montgomery form
    # the kernel carries the B lanes in the scaled domain (z = r * w)
    gB = mulmod(
        gm[:, k:], kc["wvec"][0][None, :], conv["mods"][k:], conv["barrett"][k:]
    )
    tabA, tabB = fb_table2(
        gm[None, :, :k].contiguous(), gB[None].contiguous(), kc
    )
    return fb_gather_table(tabA, tabB)


def _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont):
    """The shared encrypt tail: plaintext embedding (n*m+1) and the
    obfuscation multiply, entirely in RNS.  With ``res_mont`` the kernel
    left the obfuscator in Montgomery form, so the obfuscation multiply
    doubles as the leave-Montgomery multiply: ONE product."""
    L2 = n2_n.shape[-1]
    raw = _raw_encrypt(m_a, n_limbs, L2)  # < n^2 = N, digits <= 2^15
    raw_res = limbs_to_rns(raw, conv)
    if res_mont:
        ct_res = rns_mont_mul(raw_res, res, conv)  # raw*obf, value < 3N
    else:
        t = rns_mont_mul(raw_res, conv["mont_sq"][None, :], conv)  # raw*MA
        ct_res = rns_mont_mul(t, res, conv)  # raw*obf, value < 3N
    return _rns_finalize(ct_res, conv, n2_n, L2)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _chacha20_blocks(key8, nonce3, nblocks):
    """RFC 8439 ChaCha20 keystream: ``nblocks`` 64-byte blocks as a
    [nblocks, 64] uint8 tensor (counter starts at 0).

    A vetted CSPRNG construction, not ``torch.Generator``.  The 16-word
    state lives as 16 [nblocks] vectors of 32-bit words held in int64
    (PyTorch has no unsigned 32-bit arithmetic; every add is masked back
    to 32 bits), so every quarter-round is elementwise across blocks.
    ``key8`` [8] and ``nonce3`` [3] are int64 tensors of 32-bit words."""
    dev = key8.device
    consts = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    ctr = torch.arange(nblocks, dtype=_I64, device=dev)
    ones = torch.ones((nblocks,), dtype=_I64, device=dev)
    init = (
        [ones * c for c in consts]
        + [ones * key8[i] for i in range(8)]
        + [ctr]
        + [ones * nonce3[i] for i in range(3)]
    )
    x = list(init)

    def qr(a, b, c, d):
        a = (a + b) & _M32
        d = _rotl(d ^ a, 16)
        c = (c + d) & _M32
        b = _rotl(b ^ c, 12)
        a = (a + b) & _M32
        d = _rotl(d ^ a, 8)
        c = (c + d) & _M32
        b = _rotl(b ^ c, 7)
        return a, b, c, d

    for _ in range(10):  # 10 double-rounds = 20 rounds
        x[0], x[4], x[8], x[12] = qr(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = qr(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = qr(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = qr(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = qr(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = qr(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = qr(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = qr(x[3], x[4], x[9], x[14])

    words = torch.stack(
        [(xi + ii) & _M32 for xi, ii in zip(x, init)], dim=1
    )  # [nblocks, 16], little-endian word order
    by = torch.stack(
        [((words >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(4)], dim=-1
    )  # [nblocks, 16, 4]
    return by.reshape(nblocks, 64)


def _chacha_bytes(seed, B, nbytes):
    """[B, nbytes] uint8 from the ChaCha20 keystream keyed by seed row 0.
    Row i's bytes depend only on i and nbytes, not on B."""
    total = B * nbytes
    ks = _chacha20_blocks(seed[0, :8], seed[0, 8:11], -(-total // 64))
    return ks.reshape(-1)[:total].reshape(B, nbytes)


def _device_obf_bytes(seed, mask, B):
    """Expand a per-call OS-CSPRNG seed into [B, NP] obfuscator exponent
    bytes with an on-device ChaCha20 keystream (RFC 8439) — a
    cryptographic DRBG in the reference's seeded-DRBG role
    (ipcl/utils/common.cpp:52-77), evaluated on the accelerator so the
    host uploads 44 bytes instead of the full exponent matrix.

    ``seed``: [S, 11] int64 rows of 32-bit words (256-bit key, 96-bit
    nonce; utils/rng.DeviceSeed); row 0 keys this expansion.  ``mask``
    [NP] uint8 zeroes bytes beyond randbits and trims the top byte."""
    NP = mask.shape[-1]
    return _chacha_bytes(seed, B, NP) & mask[None, :]


def encrypt_fb_fused_stage(tab, win_bytes, m_a, n_limbs, kc, conv, n2_n):
    """DJN encrypt: fixed-base modexp kernel (mont_out) + plaintext
    embedding + obfuscation multiply + finalize.  ``tab`` is the gather
    table of :func:`fb_table_stage`, ``win_bytes`` [B, NP] uint8."""
    res = fb_modexp2(tab, win_bytes[None].contiguous(), kc, mont_out=True)[0]
    return _encrypt_post(res, m_a, n_limbs, conv, n2_n, res_mont=True)


def encrypt_fb_fused_rng_stage(tab, seed, mask, m_a, n_limbs, kc, conv, n2_n):
    """encrypt_fb_fused_stage with the obfuscator exponents generated ON
    DEVICE from a 44-byte seed row (utils/rng.DeviceSeed)."""
    wb = _device_obf_bytes(seed, mask, m_a.shape[0])
    return encrypt_fb_fused_stage(tab, wb, m_a, n_limbs, kc, conv, n2_n)


# ---------------------------------------------------------------------------
# decryption
# ---------------------------------------------------------------------------


def decrypt_crt_rns_op(
    ct,
    sq_n,  # [2, Lp2]   p^2 / q^2 limbs (finalize conditional subtracts)
    exp_wins,  # [2, 1, NW]
    hensel, hfun,
    pq_n, pq_n0inv, pq_r2,
    pinv_q, p_limbs,
    kc2,  # folded RNS kernel consts for p^2 / q^2
    conv2,  # (conv_p, conv_q) conversion consts
):
    """CRT decrypt with both half-width modexp batches on the RNS kernel.

    The kernel consumes the FULL n^2-width ciphertext: each group's Cin
    weights are (2^(15 l) mod h^2) mod m (ops/rns.py RNSContext.Cin), so
    the reference's per-element "ct mod p^2 / q^2" loop
    (ipcl/pri_key.cpp:122-130) IS the input conversion.  Both residue
    systems ride the lane axis of one kernel (folded constants), so every
    squaring serves both CRT halves.  Then, per half h in {p, q}:
    m_h = L_h(c^{h-1} mod h^2) * hh mod h, and
    m = m_p + ((m_q - m_p) * p^{-1} mod q) * p."""
    if "maskB" not in kc2:
        raise NotImplementedError(
            "CRT decrypt with grouped constants (keys wider than 2048 bits) "
            "needs the generic RNS modexp kernel (ROADMAP K5)"
        )
    Lp = pq_n.shape[-1]
    Lp2 = sq_n.shape[-1]
    k = kc2["sig0"].shape[-1] // 2
    res_f = rns_modexp2f(ct, exp_wins[:, 0].contiguous(), kc2)
    res_rns = unfold_rns_out(res_f, k)  # [2, B, 2k+1]
    ts = []
    for g in range(2):
        res = _rns_finalize(res_rns[g], conv2[g], sq_n[g], Lp2)  # < h^2
        # L-function: exact division (res - 1) / h via the Hensel inverse
        ts.append(mul_low(hensel[g], sub_scalar(res, 1), Lp))
    ts = torch.stack(ts)  # [2, B, Lp]
    dphalves = mod_mul(ts, hfun[:, None, :], pq_n, pq_n0inv, pq_r2)
    dp, dq = dphalves[0], dphalves[1]
    u = sub_mod(dq, dp, pq_n[1])
    u2 = mod_mul(
        u[None], pinv_q, pq_n[1:2], pq_n0inv[1:2], pq_r2[1:2]
    )[0]
    prod = mul_shared(p_limbs, u2).to(_I64)
    prod[..., :Lp] += dp
    m_out = canonicalize(prod)
    return m_out[..., : 2 * Lp]


# ---------------------------------------------------------------------------
# packed-transfer helpers (two 15-bit limbs per 32-bit word on the wire)
# ---------------------------------------------------------------------------


def pack_out_op(x):
    """[B, L] canonical limbs -> [B, ceil(L/2)] packed 30-bit words."""
    L = x.shape[-1]
    if L % 2:
        x = torch.cat(
            [x, torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], -1
        )
    return x[..., 0::2] | (x[..., 1::2] << 15)


def unpack_in_op(packed, num_limbs):
    """Inverse of pack_out_op (device side)."""
    lo = packed & 0x7FFF
    hi = packed >> 15
    out = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],)
    )
    return out[..., :num_limbs].contiguous()
