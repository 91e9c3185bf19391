"""Device pipelines of the Paillier scheme.

Counterpart of the JAX package's ``ops/paillier_ops.py``.  Each function is
a plain batched program over int32 limb / residue tensors that lives on the
device of its inputs.  There is no staging or jit: PyTorch runs eagerly.

The RNS pipelines (the default backend): the modular exponentiations run in
the kernels of ops/cuda_rns2.py and the limb products of the decrypt tails
in ops/cuda_modexp.py.

* ``encrypt_fb_fused_stage``    <- ipcl/pub_key.cpp:51-64,99-110  (DJN)
* ``encrypt_normal_rng_stage``  <- ipcl/pub_key.cpp:66-80,99-110
* ``encrypt_noobf_op``          <- ipcl/pub_key.cpp:105-107
* ``obfuscate_fb_fused_rng_stage`` / ``mul_res_post_stage``
                                <- ipcl/pub_key.cpp:82-90
* ``add_ctct_rns_op``           <- ipcl/ciphertext.cpp:135-141
* ``rns_modexp_stage`` / ``rns_modexp_shared_stage`` + ``rns_finalize_stage``
                                <- ipcl/ciphertext.cpp:143-162  (CT*PT)
* ``decrypt_crt_rns_op``        <- ipcl/pri_key.cpp:114-152
* ``hensel_post_stage``         <- ipcl/pri_key.cpp:92-111  (RAW tail)

The CIOS pipelines (``backend="cios"`` on the kernels of ops/cuda_modexp.py,
``backend="plain"`` on ops/montgomery.py, routed by ops/dispatch.py), a
complete second implementation on 15-bit limbs:

* ``encrypt_djn_op`` / ``encrypt_normal_op``  <- ipcl/pub_key.cpp:51-110
* ``obfuscate_op``                            <- ipcl/pub_key.cpp:82-90
* ``decrypt_crt_op``                          <- ipcl/pri_key.cpp:114-152
* ``decrypt_raw_op``                          <- ipcl/pri_key.cpp:92-111
* ``add_ctct_op``                             <- ipcl/ciphertext.cpp:135-141
* ``mul_ctpt_op``                             <- ipcl/ciphertext.cpp:143-162
* ``mod_mul_stage``   one product a*b mod n (K4 on ``"rns"`` and ``"cios"`` alike)
"""

from __future__ import annotations

import torch

from ..utils import trace
from .bigint import mod_fold_combine, mul_low, mul_shared, sub_mod, sub_scalar
from .cuda_modexp import mod_mul
from .cuda_rns2 import (
    fb_gather_table,
    fb_modexp2,
    fb_table2,
    rns_modexp2,
    rns_modexp2f,
    unfold_rns_out,
)
from .dispatch import (
    check_backend,
    default_backend,
    mod_mul_backend,
    mod_mul_backend_grouped,
    modexp_backend,
    modexp_backend_grouped,
    mont_raw_backend_grouped,
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


def encrypt_noobf_op(m, n_limbs, n2_n):
    """Encrypt without obfuscation (make_secure=false path,
    ipcl/pub_key.cpp:105-107): ct = n*m + 1 exactly."""
    return canonicalize(_raw_encrypt(m, n_limbs, n2_n.shape[-1]))


def rns_finalize_stage(res, conv, n_limbs, out_limbs):
    """RNS residues of a value <= 2N -> canonical fully-reduced limbs."""
    with trace.span("pipelines.finalize"):
        limbs = rns_to_limbs(res, conv)  # [B, Lout], canonical, value <= 2N
        Lout = limbs.shape[-1]
        n_ext = torch.zeros((Lout,), dtype=_I32, device=limbs.device)
        n_ext[: n_limbs.shape[-1]] = n_limbs
        limbs = cond_sub_n(cond_sub_n(limbs, n_ext), n_ext)
        return limbs[..., :out_limbs]


def rns_modexp_stage(base, wins, kc):
    """Single-group RNS modexp, per-row windows: limbs [B, L], windows
    [B, NW] -> residues [B, K]."""
    return rns_modexp2(base[None].contiguous(), wins[None].contiguous(), kc)[0]


def rns_modexp_shared_stage(base, wins, kc):
    """Single-group RNS modexp with ONE exponent for every row: base [B, L],
    wins [1, NW] -> residues [B, K]."""
    return rns_modexp2(
        base[None].contiguous(), wins.contiguous(), kc, shared=True
    )[0]


def rns_fb_modexp_stage(tab, win_bytes, kc, mont_out=False):
    """Fixed-base modexp: exponent bytes [B, NP] (LS first) -> residues
    [B, K] of a representative <= 2N of base^e mod N (or of base^e * M_A
    <= 3N when ``mont_out``)."""
    return fb_modexp2(tab, win_bytes[None].contiguous(), kc, mont_out=mont_out)[0]


def fb_table_stage(g_limbs, kc, conv):
    """Build the fixed-base table from g_limbs [NP, L]: canonical limbs of
    g_i = base^(2^(8 i)) mod N (host-computed square chain).  Returns the
    table of ops/cuda_rns2.fb_modexp2: the digit planes of every entry as the
    B fragments of its one-hot gather, [NP, 2, 8, W / 4, 32, 2] int32
    (cuda_rns2.fb_gather_table)."""
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


def encrypt_post_stage(res, m_a, n_limbs, conv, n2_n, res_mont=False):
    """The shared encrypt tail: plaintext embedding (n*m+1) and the
    obfuscation multiply, entirely in RNS.  With ``res_mont`` the kernel
    left the obfuscator in Montgomery form, so the obfuscation multiply
    doubles as the leave-Montgomery multiply: ONE product."""
    with trace.span("pipelines.post"):
        L2 = n2_n.shape[-1]
        raw = _raw_encrypt(m_a, n_limbs, L2)  # < n^2 = N, digits <= 2^15
        raw_res = limbs_to_rns(raw, conv)
        if res_mont:
            ct_res = rns_mont_mul(raw_res, res, conv)  # raw*obf, value < 3N
        else:
            t = rns_mont_mul(raw_res, conv["mont_sq"][None, :], conv)  # raw*MA
            ct_res = rns_mont_mul(t, res, conv)  # raw*obf, value < 3N
        return rns_finalize_stage(ct_res, conv, n2_n, L2)


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
    with trace.span("pipelines.chacha20"):
        return _chacha_bytes(seed, B, NP) & mask[None, :]


def _bytes_to_limbs_dev(by, L):
    """[B, nbytes] uint8 -> [B, L] canonical 15-bit limbs on the device.

    Limb l covers bits [15l, 15l+15): three source bytes gathered by
    per-limb column indices, combined with the per-limb shift."""
    nbytes = by.shape[-1]
    dev = by.device
    ll = torch.arange(L, dtype=_I64, device=dev)
    i0 = (15 * ll) // 8
    sh = (15 * ll) % 8
    bp = torch.cat(
        [by, torch.zeros(by.shape[:-1] + (2,), dtype=by.dtype, device=dev)], dim=-1
    ).to(_I64)
    last = nbytes + 1  # a zero pad byte: limbs beyond the bytes read 0
    b0 = bp[..., torch.clamp(i0, max=last)]
    b1 = bp[..., torch.clamp(i0 + 1, max=last)]
    b2 = bp[..., torch.clamp(i0 + 2, max=last)]
    word = b0 | (b1 << 8) | (b2 << 16)
    return ((word >> sh[None, :]) & 0x7FFF).to(_I32)


def encrypt_fb_fused_stage(tab, win_bytes, m_a, n_limbs, kc, conv, n2_n):
    """DJN encrypt: fixed-base modexp kernel (mont_out) + plaintext
    embedding + obfuscation multiply + finalize.  ``tab`` is the gather
    table of :func:`fb_table_stage`, ``win_bytes`` [B, NP] uint8."""
    res = rns_fb_modexp_stage(tab, win_bytes, kc, mont_out=True)
    return encrypt_post_stage(res, m_a, n_limbs, conv, n2_n, res_mont=True)


def encrypt_fb_fused_rng_stage(tab, seed, mask, m_a, n_limbs, kc, conv, n2_n):
    """encrypt_fb_fused_stage with the obfuscator exponents generated ON
    DEVICE from a 44-byte seed row (utils/rng.DeviceSeed)."""
    wb = _device_obf_bytes(seed, mask, m_a.shape[0])
    return encrypt_fb_fused_stage(tab, wb, m_a, n_limbs, kc, conv, n2_n)


def encrypt_normal_rng_stage(seed, m_a, n_wins, n_limbs, kc, conv, n2_n, ebits):
    """Normal-mode (non-DJN) encrypt with the obfuscator base generated ON
    DEVICE: ct = (n*m+1) * r^n mod n^2 (ipcl/pub_key.cpp:66-80,99-110).

    The base is an UNREDUCED uniform r'' of ``ebits`` = 2*|n|+3 bits from
    the ChaCha20 keystream: (r + k*n)^n = r^n (mod n^2) for any k (the
    j >= 1 binomial terms carry n^2), so r'' acts exactly as r'' mod n drawn
    uniformly (bias ~2^-(|n|+3)) — no modular reduction and no host upload
    of base limbs.  r'' < 2^(2|n|+3) < M_A/2 (the quantized target gives
    M_A >= 2^(2|n|+4)), so the kernel's first to-Montgomery multiply absorbs
    it: out < N/2 + 2N < 3N."""
    B = m_a.shape[0]
    L2 = n2_n.shape[-1]
    nbytes = -(-ebits // 8)
    with trace.span("pipelines.chacha20"):
        by = _chacha_bytes(seed, B, nbytes)
        top = ebits % 8
        if top:
            mask = torch.full((nbytes,), 0xFF, dtype=torch.uint8, device=by.device)
            mask[-1] = (1 << top) - 1
            by = by & mask[None, :]
        r_a = _bytes_to_limbs_dev(by, L2)
    res = rns_modexp_shared_stage(r_a, n_wins, kc)
    return encrypt_post_stage(res, m_a, n_limbs, conv, n2_n, res_mont=False)


# ---------------------------------------------------------------------------
# homomorphic ops and re-obfuscation
# ---------------------------------------------------------------------------


def mul_res_post_stage(ct, res, conv, n2_n, res_mont=False):
    """ct (limbs) * res (RNS residues straight from a modexp kernel) mod
    n^2 — the obfuscation multiply of apply_obfuscator.  ``res_mont`` as in
    :func:`encrypt_post_stage`."""
    with trace.span("pipelines.post"):
        L2 = n2_n.shape[-1]
        ra = limbs_to_rns(ct, conv)
        if res_mont:
            out = rns_mont_mul(ra, res, conv)  # ct*obf, value < 3N
        else:
            t = rns_mont_mul(ra, conv["mont_sq"][None, :], conv)  # ct*MA
            out = rns_mont_mul(t, res, conv)  # ct*obf, value < 3N
        return rns_finalize_stage(out, conv, n2_n, L2)


def obfuscate_fb_fused_rng_stage(tab, seed, mask, ct, kc, conv, n2_n):
    """apply_obfuscator on a DJN key: on-device exponent expansion +
    fixed-base kernel (mont_out) + the obfuscation multiply + finalize
    (ipcl/pub_key.cpp:82-90)."""
    wb = _device_obf_bytes(seed, mask, ct.shape[0])
    res = rns_fb_modexp_stage(tab, wb, kc, mont_out=True)
    return mul_res_post_stage(ct, res, conv, n2_n, res_mont=True)


def add_ctct_rns_op(a, b, conv, n2_n):
    """CT+CT = a*b mod n^2 in RNS: two exact conversions + two Montgomery
    products.  Broadcast semantics handled by callers."""
    L2 = n2_n.shape[-1]
    ra = limbs_to_rns(a, conv)
    rb = limbs_to_rns(b, conv)
    t = rns_mont_mul(ra, conv["mont_sq"][None, :], conv)  # a*MA
    out = rns_mont_mul(t, rb, conv)  # a*b, value < 3N
    return rns_finalize_stage(out, conv, n2_n, L2)


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
    kc2,  # RNS kernel consts for p^2 / q^2 (folded or grouped layout)
    conv2,  # (conv_p, conv_q) conversion consts
):
    """CRT decrypt with both half-width modexp batches on the RNS kernel.

    The kernel consumes the FULL n^2-width ciphertext: each group's Cin
    weights are (2^(15 l) mod h^2) mod m (ops/rns.py RNSContext.Cin), so
    the reference's per-element "ct mod p^2 / q^2" loop
    (ipcl/pri_key.cpp:122-130) IS the input conversion.  Both residue
    systems ride the lane axis of one kernel with FOLDED constants
    (fold_group_consts2 shared_input, the engine's default), so every
    squaring serves both CRT halves; GROUPED constants (stack_group_consts2
    of the pair) run the generic kernel with one group per residue system,
    both reading the one ciphertext copy.  Then, per half h in {p, q}:
    m_h = L_h(c^{h-1} mod h^2) * hh mod h, and
    m = m_p + ((m_q - m_p) * p^{-1} mod q) * p."""
    Lp = pq_n.shape[-1]
    Lp2 = sq_n.shape[-1]
    wins = exp_wins[:, 0].contiguous()
    folded = "maskB" in kc2  # folded lane layout, shared full-width input
    if folded:
        res_rns = rns_modexp2f(ct, wins, kc2)
    else:
        res_rns = rns_modexp2(ct[None], wins, kc2, shared=True)
    with trace.span("pipelines.crt_tail"):
        if folded:
            res_rns = unfold_rns_out(res_rns, kc2["sig0"].shape[-1] // 2)  # [2, B, 2k+1]
        ts = []
        for g in range(2):
            res = rns_finalize_stage(res_rns[g], conv2[g], sq_n[g], Lp2)  # < h^2
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


def mod_mul_stage(a, b, n, n0inv, r2, backend=None):
    """One canonical product a*b mod n (the JAX package's ``mod_mul_stage``,
    ops/paillier_ops.py:672-674).  a: [B, L], b: [B, L] or a shared [L];
    n / r2: [L]; n0inv an int or a [1] tensor.  ``backend`` defaults to
    ``dispatch.default_backend()``: ``"rns"`` and ``"cios"`` run K4
    (cuda_modexp.mod_mul; its plain version on a CPU tensor), ``"plain"``
    the plain PyTorch product."""
    backend = check_backend(backend or default_backend())
    route = "plain" if backend == "plain" else "cios"
    return mod_mul_backend(a, b, n, n0inv, r2, route)


def hensel_post_stage(res, hensel_n, x_limbs, n_n, n_n0inv, n_r2):
    """L-function + x multiplier tail of RAW decryption
    (ipcl/pri_key.cpp:92-111): m = ((res - 1) / n) * x mod n, the exact
    division by the Hensel inverse of n.  ``n_n0inv`` is a [1] tensor."""
    Ln = n_n.shape[-1]
    t = mul_low(hensel_n, sub_scalar(res, 1), Ln)  # (res-1)/n < n
    return mod_mul(t[None], x_limbs, n_n[None], n_n0inv, n_r2[None])[0]


# ---------------------------------------------------------------------------
# the CIOS pipelines (backend "cios" or "plain")
# ---------------------------------------------------------------------------


def encrypt_djn_op(m, r_wins, n_limbs, n2_n, n2_n0inv, n2_r2, n2_one, hs, backend):
    """DJN encrypt: ct = (n*m+1) * hs^r mod n^2.

    m:      [B, Ln]  plaintext (already reduced mod n)
    r_wins: [B, NW]  obfuscator exponent windows
    hs:     [L2]     shared DJN base (read by every row, not copied)
    """
    raw = _raw_encrypt(m, n_limbs, n2_n.shape[-1])
    obf = modexp_backend(hs, r_wins, n2_n, n2_n0inv, n2_r2, n2_one, backend)
    return mod_mul_backend(raw, obf, n2_n, n2_n0inv, n2_r2, backend)


def encrypt_normal_op(m, r, n_wins, n_limbs, n2_n, n2_n0inv, n2_r2, n2_one, backend):
    """Normal (non-DJN) encrypt: ct = (n*m+1) * r^n mod n^2.

    r:      [B, L2]  per-element obfuscator bases
    n_wins: [1, NW]  shared exponent n as windows
    """
    raw = _raw_encrypt(m, n_limbs, n2_n.shape[-1])
    obf = modexp_backend(r, n_wins, n2_n, n2_n0inv, n2_r2, n2_one, backend)
    return mod_mul_backend(raw, obf, n2_n, n2_n0inv, n2_r2, backend)


def obfuscate_op(ct, base, wins, n2_n, n2_n0inv, n2_r2, n2_one, backend):
    """Standalone re-obfuscation (ipcl/pub_key.cpp:82-90):
    ct * base^wins mod n^2.  base is the shared DJN hs [L2] with per-row
    windows, or per-row r bases [B, L2] with the shared exponent n."""
    obf = modexp_backend(base, wins, n2_n, n2_n0inv, n2_r2, n2_one, backend)
    return mod_mul_backend(ct, obf, n2_n, n2_n0inv, n2_r2, backend)


def decrypt_crt_op(
    ct,
    sq_n,  # [2, Lp2]   p^2 / q^2 limbs
    sq_n0inv,  # [2]
    sq_r2,  # [2, Lp2]
    sq_one,  # [2, Lp2]
    exp_wins,  # [2, 1, NW]  windows of p-1 / q-1
    hensel,  # [2, Lp]     p^{-1} / q^{-1} mod 2^(15*Lp)
    hfun,  # [2, Lp]     hp / hq
    pq_n,  # [2, Lp]     p / q limbs
    pq_n0inv,  # [2]
    pq_r2,  # [2, Lp]
    pinv_q,  # [Lq]        p^{-1} mod q
    p_limbs,  # [Lp]
    backend,
):
    """CRT decrypt (ipcl/pri_key.cpp:114-152), both halves as groups 0 / 1
    of every launch:  m_h = L_h(c^{h-1} mod h^2) * hh mod h  for h in {p, q},
    then  m = m_p + ((m_q - m_p) * p^{-1} mod q) * p."""
    Lp = pq_n.shape[-1]
    Lp2 = sq_n.shape[-1]
    # stage 1: fold ct into both residue systems (ct mod p^2 / q^2):
    # x_hi * R mod h^2 via one grouped raw Montgomery product, then combine.
    # Both groups read the one ciphertext (an expanded view, no copy).
    B = ct.shape[0]
    x_hi = ct[:, Lp2:].contiguous()[None].expand(2, B, Lp2)
    x_lo = ct[None, :, :Lp2]
    folded = mont_raw_backend_grouped(
        x_hi, sq_r2[:, None, :], sq_n, sq_n0inv, backend
    )  # [2, B, Lp2]
    bases = mod_fold_combine(folded, x_lo, sq_n[:, None, :])
    # stage 2: both half-width modexp batches in ONE grouped launch
    res = modexp_backend_grouped(
        bases, exp_wins, sq_n, sq_n0inv, sq_r2, sq_one, backend
    )  # [2, B, Lp2]
    # stage 3: L-function (Hensel exact division) + h multiplier
    ts = torch.stack(
        [mul_low(hensel[g], sub_scalar(res[g], 1), Lp) for g in range(2)]
    )  # [2, B, Lp]
    dphalves = mod_mul_backend_grouped(
        ts, hfun[:, None, :], pq_n, pq_n0inv, pq_r2, backend
    )
    dp, dq = dphalves[0], dphalves[1]
    u = sub_mod(dq, dp, pq_n[1])  # (dq - dp) mod q
    u2 = mod_mul_backend(u, pinv_q, pq_n[1], pq_n0inv[1], pq_r2[1], backend)
    prod = mul_shared(p_limbs, u2).to(_I64)  # [B, Lp+Lq]
    prod[..., :Lp] += dp
    return canonicalize(prod)[..., : 2 * Lp]


def decrypt_raw_op(
    ct, lam_wins, n2_n, n2_n0inv, n2_r2, n2_one, hensel_n, x_limbs, n_n, n_n0inv,
    n_r2, backend,
):
    """RAW decrypt (ipcl/pri_key.cpp:92-111):
    m = L(c^lambda mod n^2) * x mod n, L(y) = (y-1)/n via Hensel division."""
    Ln = n_n.shape[-1]
    res = modexp_backend(ct, lam_wins, n2_n, n2_n0inv, n2_r2, n2_one, backend)
    t = mul_low(hensel_n, sub_scalar(res, 1), Ln)  # (res-1)/n < n
    return mod_mul_backend(t, x_limbs, n_n, n_n0inv, n_r2, backend)


def add_ctct_op(a, b, n2_n, n2_n0inv, n2_r2, backend):
    """CT+CT: elementwise a*b mod n^2 (ipcl/ciphertext.cpp:135-141)."""
    return mod_mul_backend(a, b, n2_n, n2_n0inv, n2_r2, backend)


def mul_ctpt_op(ct, pt_wins, n2_n, n2_n0inv, n2_r2, n2_one, backend):
    """CT*PT: ct^pt mod n^2 (ipcl/ciphertext.cpp:143-162).  ``pt_wins`` is
    [B, NW], or [1, NW] for one scalar shared by every row."""
    return modexp_backend(ct, pt_wins, n2_n, n2_n0inv, n2_r2, n2_one, backend)


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
