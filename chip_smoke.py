#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 2048-bit keys, batch 2048
    python3 chip_smoke.py --profile  # also trace one warm call of each path

Builds the CUDA kernels from ``pailliercryptolib_tpu_torch/csrc`` and drives
the port's paths through its public API: the DJN round trip
``generate_keypair(2048, enable_DJN=True)`` -> ``pub_key.encrypt`` (obfuscators
expanded on the device from a fresh seed) -> ``priv_key.decrypt``, and the
homomorphic chain on a non-DJN key.  Phases, one JSON line each:

1. ``device``    card name and power limit (nvidia-smi), torch / CUDA versions
2. ``build``     nvcc build of the kernel library: seconds, and per kernel
                 the registers, shared memory and spill bytes ptxas reports
3. ``kernel_checks``  every kernel against its plain PyTorch version on the
                 same CUDA inputs (numpy seed) at the 2048-bit shapes —
                 tolerance: none, the integers must be equal — with times
4. ``main_path`` round trip of 2048 random 64-bit plaintexts, the injected-r
                 oracle ``ct == (n*m+1) * pow(hs, r, n^2) % n^2`` in Python
                 ints, launch counts of every kernel, warm encrypt/decrypt ms
5. ``homomorphic_path``  2048-bit non-DJN keys, batch 2048: normal-mode
                 ``encrypt`` (bases drawn on the device) -> ``ct + ct`` ->
                 ``ct + PlainText`` -> ``ct * PlainText`` (per-row 64-bit
                 scalars, then one shared scalar) -> ``apply_obfuscator`` ->
                 CRT and RAW ``decrypt``, every value against Python ints;
                 the normal-mode injected-r oracle
                 ``ct == (n*m+1) * pow(r, n, n^2) % n^2``; grouped CRT decrypt
                 (stacked constants) against folded; on the DJN key of phase 4
                 ``apply_obfuscator`` and an injected oversized r; the
                 ISO/IEC 18033-6 known-answer vectors; launch counts per call
6. ``second_size``  1024-bit keys, batch 300 (ragged against the row tile)

Then one line ``{"kernels": [...]}`` (per kernel: launches on the main path,
error against the plain version, kernel / plain / bound times), the card's
name and power limit, and the result line.  Exits non-zero without a result
line when there is no GPU, when the build fails or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
# 32-bit integer multiply-adds have no entry in the data sheet; the float32
# (non tensor core) rate is the nearest one and keeps the bound a lower bound.
PEAK_32BIT_OPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a device synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_call(op: str, fn) -> dict:
    """Trace one warm call: wall time, the device's busy time (sum of kernel
    and copy durations; one stream, so no overlap), launches, and the
    kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
            by_name[ev.name] = by_name.get(ev.name, 0.0) + dur / 1e3
            launches += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "profile", "op": op, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy_ms, "device_launches": launches,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "top_device_ms": [[n[:60], round(t, 3)] for n, t in top]}


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_o = ops / peak_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm encrypt, decrypt, normal-mode "
                         "encrypt and ct * pt with torch.profiler (device "
                         "busy share, time by kernel)")
    ap.add_argument("--seed", type=int, default=20240917)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    import pailliercryptolib_tpu_torch as ptorch
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp, cuda_rns2
    from pailliercryptolib_tpu_torch.ops.montgomery import to_i32
    from pailliercryptolib_tpu_torch.utils.iso_vectors import check_iso_vectors

    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda", 0)
    card = smi_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    library = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(_build.last_build_seconds, 3),
          "library": str(library), "ptxas": _build.kernel_stats()})

    key_bits = 2048
    B = 2048
    reps = 3
    rng = random.Random(args.seed)
    nprng = np.random.default_rng(args.seed)

    # -- kernels against their plain versions ----------------------------------
    # constants of a real key of the main path's size (its own key: the main
    # path below generates another, so that its table build is counted there)
    t0 = time.perf_counter()
    ckey = ptorch.generate_keypair(key_bits, enable_DJN=True)
    check_keygen_s = time.perf_counter() - t0
    pub, prv = ckey.pub_key._engine, ckey.priv_key._engine
    _, kc, conv = pub.rns
    kc2, _ = prv.rns_crt
    k = kc["sig0"].shape[-1]
    ka, kb = kc2["sig0"].shape[-1], kc2["modsBx"].shape[-1]
    nbytes_r = -(-pub.randbits // 8)
    NP = max(8, -(-nbytes_r // 8) * 8)
    NW = prv.exp_wins.shape[-1]
    L2in = kc2["CinA"].shape[-2]
    Lp = prv.Lp

    def residues(mods, rows):
        m = mods.cpu().numpy().astype(np.int64)
        return to_i32((nprng.integers(0, 1 << 30, (rows, m.shape[0])) % m), dev)

    checks = []

    def check(name, source, replaces, shape, kernel, plain, bytes_moved, ops,
              peak, launches_key):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        gs = got if isinstance(got, tuple) else (got,)
        ws = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(gs, ws):
            assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, name
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        kernel()  # warm
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, 1)
        bms, by = bound(bytes_moved, ops, peak)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "equal": err == 0, "ms": ms, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "library_ms": None, "shape": shape, "_count": launches_key}
        checks.append(rec)
        if err != 0:  # reported after all kernels have been looked at
            for g, w in zip(gs, ws):
                bad = (g != w).nonzero()
                print(f"{name}: {bad.shape[0]} of {g.numel()} values differ, "
                      f"first at {bad[:1].tolist()}", file=sys.stderr)
        return got

    # one Montgomery product: two base extensions of four int8 plane products
    def mm_ops(kk, cols1, cols2):
        return 2.0 * 4 * kk * (cols1 + cols2)

    src = "pailliercryptolib_tpu_torch/csrc/"
    # K1
    gA = residues(kc["modsA"][0], NP)
    gB = residues(kc["modsBx"][0], NP)
    tabs = check(
        "fb_table2", src + "fb_table2.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:1066",
        f"gA[1,{NP},{k}] gB[1,{NP},{k + 1}] -> [1,256,{NP},{k}],[1,256,{NP},{k + 1}]",
        lambda: cuda_rns2.fb_table2(gA[None], gB[None], kc),
        lambda: cuda_rns2.fb_table2_plain(gA[None], gB[None], kc),
        nbytes(gA, gB) + 256 * NP * (2 * k + 1) * 4,
        255.0 * NP * mm_ops(k, k + 2, k + 1), PEAK_INT8_OPS,
        ("rns", "fb_table2"),
    )
    # K2 (both output forms checked; the main path's mont_out form is timed)
    tab = cuda_rns2.fb_gather_table(*tabs)
    wins = torch.from_numpy(
        nprng.integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=False)
    want = cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=False)
    plain_out_equal = torch.equal(got, want)
    gathered = min(nbytes(tab), B * NP * (2 * k + 1) * 4)
    check(
        "fb_modexp2", src + "fb_modexp2.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:1197",
        f"tab[{NP},256,{2 * k + 1}] bytes[1,{B},{NP}] -> [1,{B},{2 * k + 1}]",
        lambda: cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=True),
        lambda: cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=True),
        gathered + nbytes(wins) + B * (2 * k + 1) * 4,
        (NP - 1.0) * B * mm_ops(k, k + 2, k + 1), PEAK_INT8_OPS,
        ("rns", "fb_modexp2"),
    )
    # K3
    ct_l = to_i32(nprng.integers(0, 1 << 15, (B, L2in)), dev)
    ewins = prv.exp_wins[:, 0].contiguous()
    check(
        "rns_modexp2f", src + "rns_modexp2f.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:959",
        f"ct[{B},{L2in}] wins[2,{NW}] -> [{B},{ka + kb}]",
        lambda: cuda_rns2.rns_modexp2f(ct_l, ewins, kc2),
        lambda: cuda_rns2.rns_modexp2f_plain(ct_l, ewins, kc2),
        nbytes(ct_l, ewins, kc2["CinA"], kc2["CinB"]) + B * (ka + kb) * 4,
        (15 + 5.0 * NW + 1) * B * mm_ops(ka, kb + 2, ka + 2)
        + 2.0 * 3 * B * L2in * (ka + kb),
        PEAK_INT8_OPS,
        ("rns", "rns_modexp2f"),
    )
    # K4: grouped [2, B, Lp] with a shared multiplier, then single [1, B, Lp]
    def limbs_below(rows):
        x = nprng.integers(0, 1 << 15, (rows, Lp))
        x[:, -2:] = 0  # below p and q
        return to_i32(x, dev)

    a2 = torch.stack([limbs_below(B), limbs_below(B)])
    check(
        "mod_mul", src + "mod_mul.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:295",
        f"a[2,{B},{Lp}] b[2,1,{Lp}] -> [2,{B},{Lp}] (and [1,{B},{Lp}])",
        lambda: cuda_modexp.mod_mul(a2, prv.hfun[:, None, :], prv.pq_n,
                                    prv.pq_n0inv, prv.pq_r2),
        lambda: cuda_modexp.mod_mul_plain(a2, prv.hfun[:, None, :], prv.pq_n,
                                          prv.pq_n0inv, prv.pq_r2),
        nbytes(a2) * 2 + nbytes(prv.hfun),
        2.0 * B * 2 * (2.0 * 2 * Lp * Lp), PEAK_32BIT_OPS,
        ("cios", "mod_mul"),
    )
    a1 = limbs_below(B)[None]
    got = cuda_modexp.mod_mul(a1, prv.pinv_q, prv.pq_n[1:2], prv.pq_n0inv[1:2],
                              prv.pq_r2[1:2])
    want = cuda_modexp.mod_mul_plain(a1, prv.pinv_q, prv.pq_n[1:2],
                                     prv.pq_n0inv[1:2], prv.pq_r2[1:2])
    single_equal = torch.equal(got, want)
    # K5 in its three forms.  One modexp is 15 + 5*NW + 1 Montgomery products
    # a row and group, plus the limbs -> residues conversion.
    def k5_check(form, base, wins5, consts, shared):
        G5 = consts["sig0"].shape[0]
        k5 = consts["sig0"].shape[-1]
        NW5, L5 = wins5.shape[-1], base.shape[-1]
        return check(
            f"rns_modexp2[{form}]", src + "rns_modexp2.cu",
            "pailliercryptolib_tpu/ops/pallas_rns2.py:883",
            f"base{list(base.shape)} wins{list(wins5.shape)} -> [{G5},{B},{2 * k5 + 1}]",
            lambda: cuda_rns2.rns_modexp2(base, wins5, consts, shared=shared),
            lambda: cuda_rns2.rns_modexp2_plain(base, wins5, consts, shared=shared),
            nbytes(base, wins5, consts["CinA"], consts["CinB"])
            + G5 * B * (2 * k5 + 1) * 4,
            G5 * ((15 + 5.0 * NW5 + 1) * B * mm_ops(k5, k5 + 2, k5 + 1)
                  + 2.0 * 3 * B * L5 * (2 * k5 + 1)),
            PEAK_INT8_OPS,
            ("k5", form),
        )

    base5 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    k5_check("shared", base5, pub.n_wins, kc, True)  # normal encrypt's shape
    pt_wins = to_i32(nprng.integers(0, 16, (1, B, 16)), dev)  # 64-bit scalars
    k5_check("var", base5, pt_wins, kc, False)
    kc_st, _ = prv.rns_crt_stacked
    k5_check("grouped", ct_l[None], ewins, kc_st, True)
    emit({"phase": "kernel_checks", "key_bits": key_bits, "rows": B,
          "keygen_seconds": round(check_keygen_s, 3),
          "fb_modexp2_plain_out_equal": plain_out_equal,
          "mod_mul_single_group_equal": single_equal,
          "checks": [{kk: v for kk, v in c.items()
                      if kk in ("name", "equal", "kernel_ms", "plain_ms", "shape")}
                     for c in checks]})
    if not (plain_out_equal and single_equal and all(c["equal"] for c in checks)):
        raise AssertionError("a kernel differs from its plain version: "
                             + str([c["name"] for c in checks if not c["equal"]]))
    del tab, tabs, ct_l, a2, a1, got, want, ckey, pub, prv, kc, kc2, conv
    del base5, pt_wins, kc_st
    torch.cuda.empty_cache()

    # -- main path -----------------------------------------------------------------
    counters = {"rns": cuda_rns2.LAUNCHES, "cios": cuda_modexp.LAUNCHES,
                "k5": cuda_rns2.MODEXP2_FORMS}

    def reset_counts():
        for d in counters.values():
            for name in d:
                d[name] = 0

    def read_counts():
        return {grp: dict(d) for grp, d in counters.items()}

    reset_counts()
    t0 = time.perf_counter()
    key = ptorch.generate_keypair(key_bits, enable_DJN=True)
    keygen_s = time.perf_counter() - t0
    pk, sk = key.pub_key, key.priv_key
    vals = [rng.getrandbits(64) for _ in range(B)]
    t0 = time.perf_counter()
    ct = pk.encrypt(ptorch.PlainText(vals))  # fresh DeviceSeed
    ct.block_until_ready()
    first_encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = sk.decrypt(ct)
    dec.block_until_ready()
    first_decrypt_s = time.perf_counter() - t0
    assert ct.device_payload().arr.is_cuda and dec.device_payload().arr.is_cuda
    if dec.texts != vals:
        raise AssertionError("main path: decrypt(encrypt(m)) != m")
    # injected-r oracle against Python ints
    rs = [rng.getrandbits(pk.randbits) for _ in range(4)]
    pk.set_random(rs)
    ct4 = pk.encrypt(ptorch.PlainText(vals[:4]))
    n, n2 = pk.n, pk.nsquare
    want4 = [(n * m + 1) * pow(pk.hs, r, n2) % n2 for m, r in zip(vals[:4], rs)]
    if ct4.texts != want4:
        raise AssertionError("main path: injected-r ciphertexts differ from pow()")
    torch.cuda.synchronize()
    main_counts = read_counts()
    launches = {**main_counts["rns"], **main_counts["cios"]}
    expected = {"fb_table2": 1, "fb_modexp2": 2, "rns_modexp2f": 1, "mod_mul": 2,
                "rns_modexp2": 0}
    for name, want_n in expected.items():
        if launches[name] != want_n:
            raise AssertionError(
                f"main path launched {name} {launches[name]} times, expected {want_n}")
    # warm timings (outside the counted window)
    wreps = 5
    pt_vals = ptorch.PlainText(vals)
    encrypt_ms = host_ms(lambda: pk.encrypt(pt_vals), wreps)
    decrypt_ms = host_ms(lambda: sk.decrypt(ct), wreps)
    emit({"phase": "main_path", "key_bits": key_bits, "batch": B,
          "roundtrip_ok": True, "oracle_ok": True, "launches": launches,
          "keygen_seconds": round(keygen_s, 3),
          "table_build_seconds": round(pk._engine.fb_build_seconds, 3),
          "first_encrypt_seconds": round(first_encrypt_s, 3),
          "first_decrypt_seconds": round(first_decrypt_s, 3),
          "encrypt_ms": encrypt_ms, "decrypt_ms": decrypt_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("encrypt", lambda: pk.encrypt(pt_vals)),
                       ("decrypt", lambda: sk.decrypt(ct))):
            emit(profile_call(op, fn))
    del dec, ct4
    torch.cuda.empty_cache()

    # -- homomorphic path ------------------------------------------------------------
    reset_counts()

    def counted(what, fn, **expect):
        """Run ``fn``; the launches it made must be exactly ``expect``
        (kernel or K5 form -> count; anything not named: none)."""
        before = read_counts()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        made = {}
        for grp in after:
            for name in after[grp]:
                dn = after[grp][name] - before[grp][name]
                if dn:
                    made[name] = dn
        if made != expect:
            raise AssertionError(f"{what}: launched {made}, expected {expect}")
        return out

    t0 = time.perf_counter()
    hkey = ptorch.generate_keypair(key_bits, enable_DJN=False)
    h_keygen_s = time.perf_counter() - t0
    hpk, hsk = hkey.pub_key, hkey.priv_key
    hn, hn2 = hpk.n, hpk.nsquare
    va = [rng.getrandbits(64) for _ in range(B)]
    vb = [rng.getrandbits(64) for _ in range(B)]
    vc = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]  # per-row scalars
    vs = rng.getrandbits(64)  # one shared scalar
    pt_a, pt_b, pt_c = (ptorch.PlainText(v) for v in (va, vb, vc))
    pt_e, pt_s = ptorch.PlainText(ve), ptorch.PlainText([vs])
    t0 = time.perf_counter()
    ca = counted("normal encrypt", lambda: hpk.encrypt(pt_a),
                 rns_modexp2=1, shared=1)
    first_normal_encrypt_s = time.perf_counter() - t0
    cb = counted("normal encrypt", lambda: hpk.encrypt(pt_b),
                 rns_modexp2=1, shared=1)
    s1 = counted("ct + ct", lambda: ca + cb)
    s2 = counted("ct + pt", lambda: s1 + pt_c)
    m1 = counted("ct * pt (per-row)", lambda: s2 * pt_e, rns_modexp2=1, var=1)
    m2 = counted("ct * pt (scalar)", lambda: m1 * pt_s, rns_modexp2=1, shared=1)
    ob = counted("apply_obfuscator (normal)", lambda: hpk.apply_obfuscator(m2),
                 rns_modexp2=1, shared=1)
    for t in (ca, s1, s2, m1, m2, ob):
        assert t.device_payload().arr.is_cuda and t._texts is None
    want_h = [((x + y + z) * e * vs) % hn for x, y, z, e in zip(va, vb, vc, ve)]
    dec_crt = counted("CRT decrypt", lambda: hsk.decrypt(ob),
                      rns_modexp2f=1, mod_mul=2)
    hsk.enable_crt = False
    dec_raw = counted("RAW decrypt", lambda: hsk.decrypt(ob),
                      rns_modexp2=1, shared=1, mod_mul=1)
    hsk.enable_crt = True
    if dec_crt.texts != want_h or dec_raw.texts != want_h:
        raise AssertionError("homomorphic path: decrypted values differ from "
                             "((a + b + c) * e * s) mod n")
    if ob.texts == m2.texts:
        raise AssertionError("apply_obfuscator left the ciphertexts unchanged")
    # grouped CRT decrypt (stacked constants through the generic kernel)
    grouped = counted(
        "grouped CRT decrypt",
        lambda: hsk._engine._decrypt_crt_impl(ob.device_payload(), grouped=True),
        rns_modexp2=1, grouped=1, mod_mul=2)
    if not torch.equal(grouped.arr, dec_crt.device_payload().arr):
        raise AssertionError("grouped CRT decrypt differs from folded")
    # normal-mode injected-r oracle against Python ints
    rs8 = [rng.randrange(1, hn) for _ in range(8)]
    hpk.set_random(rs8)
    ct8 = counted("normal encrypt (injected r)",
                  lambda: hpk.encrypt(ptorch.PlainText(va[:8])),
                  rns_modexp2=1, shared=1)
    if ct8.texts != [(hn * m + 1) * pow(r, hn, hn2) % hn2 for m, r in zip(va, rs8)]:
        raise AssertionError("normal-mode injected-r ciphertexts differ from pow()")
    # the DJN-only pieces, on the DJN key of the main path
    od = counted("apply_obfuscator (DJN)", lambda: pk.apply_obfuscator(ct),
                 fb_modexp2=1)
    if od.texts == ct.texts:
        raise AssertionError("DJN apply_obfuscator left the ciphertexts unchanged")
    dd = counted("CRT decrypt (DJN)", lambda: sk.decrypt(od),
                 rns_modexp2f=1, mod_mul=2)
    if dd.texts != vals:
        raise AssertionError("DJN apply_obfuscator changed the plaintexts")
    r_big = [rng.getrandbits(pk.randbits + 64) | (1 << (pk.randbits + 63))
             for _ in range(8)]
    pk.set_random(r_big)
    cbig = counted("DJN encrypt (oversized r)",
                   lambda: pk.encrypt(ptorch.PlainText(vals[:8])),
                   rns_modexp2=1, var=1)
    if cbig.texts != [(n * m + 1) * pow(pk.hs, r, n2) % n2
                      for m, r in zip(vals, r_big)]:
        raise AssertionError("oversized injected-r ciphertexts differ from pow()")
    # ISO/IEC 18033-6 known-answer vectors (c1, c2, c1*c2, decrypted sum)
    counted("ISO/IEC 18033-6 vectors", lambda: check_iso_vectors(dev),
            rns_modexp2=1, shared=1, rns_modexp2f=2, mod_mul=4)
    homo_counts = read_counts()
    h_launches = {**homo_counts["rns"], **homo_counts["cios"]}
    for form, cnt in homo_counts["k5"].items():
        if cnt < 1:
            raise AssertionError(f"homomorphic path never ran rns_modexp2[{form}]")
    for c in checks:
        grp, name = c.pop("_count")
        c["launches"] = (homo_counts if grp == "k5" else main_counts)[grp][name]
        if c["launches"] < 1:
            raise AssertionError(f"{c['name']} was launched no time on its path")
    # warm timings (outside the counted window)
    h_ms = {
        "encrypt_normal": host_ms(lambda: hpk.encrypt(pt_a), wreps),
        "add_ctct": host_ms(lambda: ca + cb, wreps),
        "add_ctpt": host_ms(lambda: s1 + pt_c, wreps),
        "mul_ctpt_per_row": host_ms(lambda: s2 * pt_e, wreps),
        "mul_ctpt_scalar": host_ms(lambda: m1 * pt_s, wreps),
        "apply_obfuscator_normal": host_ms(lambda: hpk.apply_obfuscator(m2), wreps),
        "apply_obfuscator_djn": host_ms(lambda: pk.apply_obfuscator(ct), wreps),
        "decrypt_crt": host_ms(lambda: hsk.decrypt(ob), wreps),
    }
    hsk.enable_crt = False
    h_ms["decrypt_raw"] = host_ms(lambda: hsk.decrypt(ob), wreps)
    hsk.enable_crt = True
    emit({"phase": "homomorphic_path", "key_bits": key_bits, "batch": B,
          "values_ok": True, "normal_oracle_ok": True, "grouped_equals_folded": True,
          "djn_obfuscator_ok": True, "oversized_r_ok": True, "iso_18033_6_ok": True,
          "launches": h_launches, "rns_modexp2_forms": homo_counts["k5"],
          "keygen_seconds": round(h_keygen_s, 3),
          "first_normal_encrypt_seconds": round(first_normal_encrypt_s, 3),
          "host_ms": h_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("encrypt_normal", lambda: hpk.encrypt(pt_a)),
                       ("mul_ctpt_per_row", lambda: s2 * pt_e)):
            emit(profile_call(op, fn))
    del ca, cb, s1, s2, m1, m2, ob, dec_crt, dec_raw, grouped, ct8, od, dd, cbig
    del ct, key, pk, sk, hkey, hpk, hsk
    torch.cuda.empty_cache()

    # -- second size -----------------------------------------------------------------
    bits2, B2 = 1024, 300
    key2 = ptorch.generate_keypair(bits2, enable_DJN=True)
    vals2 = [rng.getrandbits(64) for _ in range(B2)]
    ct2 = key2.pub_key.encrypt(ptorch.PlainText(vals2))
    if key2.priv_key.decrypt(ct2).texts != vals2:
        raise AssertionError("second size: decrypt(encrypt(m)) != m")
    emit({"phase": "second_size", "key_bits": bits2, "batch": B2,
          "roundtrip_ok": True})

    emit({"kernels": checks})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
