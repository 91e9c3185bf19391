#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 2048-bit keys, batch 2048
    python3 chip_smoke.py --profile  # also trace one warm encrypt and decrypt

Builds the CUDA kernels from ``pailliercryptolib_tpu_torch/csrc`` and drives
the port's main path through its public API:
``generate_keypair(2048, enable_DJN=True)`` -> ``pub_key.encrypt`` (obfuscators
expanded on the device from a fresh seed) -> ``priv_key.decrypt``.  Phases,
one JSON line each:

1. ``device``    card name and power limit (nvidia-smi), torch / CUDA versions
2. ``build``     nvcc build of the kernel library: seconds, and per kernel
                 the registers, shared memory and spill bytes ptxas reports
3. ``kernel_checks``  every kernel against its plain PyTorch version on the
                 same CUDA inputs (numpy seed) at the 2048-bit shapes —
                 tolerance: none, the integers must be equal — with times
4. ``main_path`` round trip of 2048 random 64-bit plaintexts, the injected-r
                 oracle ``ct == (n*m+1) * pow(hs, r, n^2) % n^2`` in Python
                 ints, launch counts of every kernel, warm encrypt/decrypt ms
5. ``second_size``  1024-bit keys, batch 300 (ragged against the row tile)

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
                    help="also trace one warm encrypt and decrypt with "
                         "torch.profiler (device busy share, time by kernel)")
    ap.add_argument("--seed", type=int, default=20240917)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    import pailliercryptolib_tpu_torch as ptorch
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp, cuda_rns2
    from pailliercryptolib_tpu_torch.ops.montgomery import to_i32

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
    torch.cuda.empty_cache()

    # -- main path -----------------------------------------------------------------
    counters = {"rns": cuda_rns2.LAUNCHES, "cios": cuda_modexp.LAUNCHES}
    for d in counters.values():
        for name in d:
            d[name] = 0
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
    launches = {name: d[name] for d in counters.values() for name in d}
    expected = {"fb_table2": 1, "fb_modexp2": 2, "rns_modexp2f": 1, "mod_mul": 2}
    for name, want_n in expected.items():
        if launches[name] != want_n:
            raise AssertionError(
                f"main path launched {name} {launches[name]} times, expected {want_n}")
    for c in checks:
        grp, name = c.pop("_count")
        c["launches"] = launches[name]
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
    del ct, dec, ct4, key, pk, sk
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
