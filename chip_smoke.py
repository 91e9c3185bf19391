#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 2048- and 4096-bit keys, batch 2048
    python3 chip_smoke.py --profile  # also trace one warm call of each path
    python3 chip_smoke.py --kernels-only  # build, phases 3-4, the kernels' times

Builds the CUDA kernels from ``pailliercryptolib_tpu_torch/csrc`` and drives
the port's paths through its public API: the DJN round trip
``generate_keypair(2048, enable_DJN=True)`` -> ``pub_key.encrypt`` (obfuscators
expanded on the device from a fresh seed) -> ``priv_key.decrypt``, the
homomorphic chain on a non-DJN key, the same operations on the ``"cios"``
backend, the ``modexp`` API, the hybrid batch split, the same operations at
4096- and 3072-bit keys, the instruction-rate probes and serialization.
Phases, one JSON line each:

1. ``device``    card name and power limit (nvidia-smi), torch / CUDA versions
2. ``build``     nvcc build of the kernel library: seconds, and per kernel
                 the registers, shared memory and spill bytes ptxas reports
                 (and the dynamic shared memory of the tensor-core kernels)
3. ``product_probe``  P5: one RNS Montgomery product at K3's shape (the
                 folded set of a 2048-bit key, batch 2048) in the CUDA-core
                 and the tensor-core form, with and without its base
                 extensions, each against its plain version; us a product
4. ``kernel_checks``  every kernel against its plain PyTorch version on the
                 same CUDA inputs (numpy seed) at the 2048-bit shapes —
                 tolerance: none, the integers must be equal — with times;
                 K2 and K3 also in their earlier CUDA-core form, checked the same
                 way and timed in turns with the tensor-core form (``ms_before``)
5. ``main_path`` round trip of 2048 random 64-bit plaintexts, the injected-r
                 oracle ``ct == (n*m+1) * pow(hs, r, n^2) % n^2`` in Python
                 ints, launch counts of every kernel and the form K2 / K3 ran
                 in (tensor cores), warm encrypt/decrypt ms
6. ``homomorphic_path``  2048-bit non-DJN keys, batch 2048: normal-mode
                 ``encrypt`` (bases drawn on the device) -> ``ct + ct`` ->
                 ``ct + PlainText`` -> ``ct * PlainText`` (per-row 64-bit
                 scalars, then one shared scalar) -> ``apply_obfuscator`` ->
                 CRT and RAW ``decrypt``, every value against Python ints;
                 the normal-mode injected-r oracle
                 ``ct == (n*m+1) * pow(r, n, n^2) % n^2``; grouped CRT decrypt
                 (stacked constants) against folded; on the DJN key of phase 5
                 ``apply_obfuscator`` and an injected oversized r; the
                 ISO/IEC 18033-6 known-answer vectors; launch counts per call
7. ``second_size``  1024-bit keys, batch 300 (ragged against the row tile)
8. ``cios_path`` 2048-bit DJN key, batch 2048, engines on the ``"cios"``
                 backend: encrypt with injected r (against ``pow()`` and
                 against the ``"rns"`` backend's ciphertexts) -> ``ct + ct`` ->
                 ``ct * PlainText`` -> ``apply_obfuscator`` -> CRT and RAW
                 decrypt against Python ints; launch counts per call
9. ``modexp_api``  ``modexp`` on 2048 rows under one 4096-bit modulus, on a
                 vector of three moduli, on scalars, against ``pow()``
10. ``hybrid``    ``set_hybrid_mode`` / ``set_hybrid_ratio`` / ``set_hybrid_off``
                 at a small key width (the plain tail is thousands of small
                 launches a product): where the batch splits, what the plain
                 twin engine gets, results against Python ints

11. ``wide_kernel_checks``  K1, K2 and K5 (shared, per-row) on the n^2 constant
                 set of a 4096-bit key (640 lanes, f32-reciprocal reduction with
                 the full fold), K5 grouped on its p^2 / q^2 pair (548 input
                 limbs), K5 shared on a 3072-bit key's n^2 (480 lanes); K6
                 (shared base, 512 windows a row; grouped), K7 and K4 at the
                 shapes the ``"cios"`` calls of phase 12 give them; the long
                 modexps are compared at a reduced window count (the plain
                 version is tens to thousands of launches a product) and timed
                 at the path's
12. ``wide_path``  4096-bit DJN key, batch 2048: ``encrypt`` (fresh
                 device-expanded obfuscators) -> ``decrypt``; the injected-r
                 oracle on 64 rows; ``ct + ct`` -> ``ct * PlainText`` (per-row,
                 scalar) -> ``apply_obfuscator`` -> CRT (grouped) and RAW decrypt
                 against Python ints; normal-mode encrypt on the same modulus;
                 the same key on ``"cios"``: equal ciphertexts for equal r, it
                 decrypts the ``"rns"`` ones, and a round trip of the whole
                 batch; launch counts per call; ``host_ms``
                 per operation (median of 3); peak device memory
13. ``wide_3072``  3072-bit DJN key, batch 300 (ragged): round trip through
                 the grouped CRT decrypt and the RAW one
14. ``probes``   P1-P4 (``ops/cuda_probes.py``) at the reference probes' shapes
                 and the three lagged chains, each equal to its plain version;
                 G element-ops/s per chain (marked where they exceed what the
                 card can start: folded by ptxas) and TOP/s of the ``dp4a`` and
                 ``mma.sync`` product bodies
15. ``serialize``  a 2048-bit key pair and a device-resident ciphertext batch
                 through ``dumps`` / ``loads``, then decrypt

Then one line ``{"kernels": [...]}`` (per kernel: launches on the main path,
error against the plain version, kernel / plain / bound times; K2 / K3 also
``ms_before``, the CUDA-core form in the same call), the card's
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


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase kernel_checks (the 2048-bit shapes) "
                         "with one line of the kernels' times and no result "
                         "line: for comparing two builds of the kernels")
    ap.add_argument("--seed", type=int, default=20240917)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    import pailliercryptolib_tpu_torch as ptorch
    from pailliercryptolib_tpu_torch.convert import keys_from_ints
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp, cuda_probes, cuda_rns2
    from pailliercryptolib_tpu_torch.ops import limbs as lb
    from pailliercryptolib_tpu_torch.ops.montgomery import MontConstants, to_i32
    from pailliercryptolib_tpu_torch.utils.config import Config, set_config
    from pailliercryptolib_tpu_torch.utils import serialize as ser
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
    lib = _build.load()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(_build.last_build_seconds, 3),
          "library": str(library), "ptxas": _build.kernel_stats(),
          # ptxas reports static shared memory; the tensor-core kernels of K2
          # and K3 take theirs dynamically, a CTA's the same for every set
          "tc_dynamic_smem_bytes": lib.rns_tc_smem_bytes()})

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
              peak, launches_key, timed=None, extra=None, library=None, before=None):
        """``kernel`` against ``plain`` on the same inputs; ``timed`` (default:
        ``kernel``) is the call whose time is ``ms`` and whose work
        ``bytes_moved`` / ``ops`` count; ``library`` is one PyTorch call that
        computes the same function on the same inputs as ``timed``, timed
        beside it and used nowhere else; ``before`` is the earlier form of the
        kernel on the same inputs as ``timed``: held against ``plain`` too and
        timed in turns with the kernel (before, kernel, kernel, before), its
        time ``ms_before``."""
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
        timed = timed or kernel
        timed()  # warm
        turns = {}
        if before is None:
            ms = cuda_ms(timed, reps)
        else:
            got_b = before()
            torch.cuda.synchronize()
            gb = got_b if isinstance(got_b, tuple) else (got_b,)
            turns["max_abs_err_before"] = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(gb, ws)) if timed is kernel else None
            t = [cuda_ms(before, reps), cuda_ms(timed, reps), cuda_ms(timed, reps),
                 cuda_ms(before, reps)]
            ms = (t[1] + t[2]) / 2
            turns.update(ms_before=(t[0] + t[3]) / 2, turns_ms=t)
        plain_ms = cuda_ms(plain, 1)
        library_ms = None
        if library is not None:
            library()  # warm
            library_ms = cuda_ms(library, reps)
        bms, by = bound(bytes_moved, ops, peak)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "equal": err == 0 and not turns.get("max_abs_err_before"),
               "ms": ms, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "library_ms": library_ms, "shape": shape, "_count": launches_key,
               **turns, **(extra or {})}
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
    psrc = src + "probes.cu"

    # P5: one RNS Montgomery product at K3's shape (the folded set of this key,
    # batch B) in both forms, with and without its base extensions: without
    # them what is left is the part linear in k (three fused reductions, the
    # digit scatter, the barriers).  Compared with the plain version on
    # P5_PLAIN_ITERS products, timed on P5_ITERS.  The linear part is counted
    # as P5_LINEAR_OPS 32-bit operations a (row, lane) and product (the
    # integer and float instructions of the three reductions, the two folds
    # and the two digit splits in csrc/rns_mont_mul.cuh).
    P5_ITERS, P5_PLAIN_ITERS, P5_LINEAR_OPS = 64, 2, 60
    tcp3 = cuda_rns2._tc_pack(kc2)
    if (tcp3["W"], tcp3["KC"]) != (320, 10) or cuda_rns2._tc_pack(kc)["W"] != 320:
        raise AssertionError("the 2048-bit sets are not the 320-lane tensor-core shape")
    x5 = torch.cat([residues(kc2["modsA"][0], B), residues(kc2["modsBx"][0], B)], dim=1)
    p5_runs, p5_split = [], {}
    for form in ("dp4a", "tc"):
        for ext in (True, False):
            name = f"probe_p5[{form}{'' if ext else ', no extensions'}]"
            ops5 = (P5_ITERS * B * mm_ops(ka, kb + 2, ka + 2) if ext
                    else P5_ITERS * B * (ka + kb) * P5_LINEAR_OPS)
            check(name, psrc, "pailliercryptolib_tpu/ops/pallas_rns2.py:552",
                  f"x[{B},{ka + kb}] {P5_ITERS} products x <- x * x (folded, G 2)",
                  lambda form=form, ext=ext: cuda_probes.mont_chain(
                      x5, kc2, P5_PLAIN_ITERS, form, ext),
                  lambda ext=ext: cuda_probes.mont_chain_plain(x5, kc2, P5_PLAIN_ITERS, ext),
                  2 * nbytes(x5), ops5, PEAK_INT8_OPS if ext else PEAK_32BIT_OPS,
                  ("probes", "probe_runs", name),
                  timed=lambda form=form, ext=ext: cuda_probes.mont_chain(
                      x5, kc2, P5_ITERS, form, ext),
                  extra={"form": form, "extensions": ext, "iters": P5_ITERS,
                         "plain_iters": P5_PLAIN_ITERS,
                         "note": "a product of the K0 device function; "
                                 "no TPU kernel of its own"})
            rec = checks[-1]
            rec["us_per_product"] = rec["ms"] / P5_ITERS * 1e3
            p5_split[name] = rec["us_per_product"]
            # the probes phase runs it again, after kc2 is deleted here
            p5_runs.append((rec, lambda form=form, ext=ext, x5=x5, kc2=kc2:
                            cuda_probes.mont_chain(x5, kc2, P5_ITERS, form, ext)))
    emit({"phase": "product_probe", "rows": B, "k": ka, "kb": kb, "W": tcp3["W"],
          "iters": P5_ITERS, "us_per_product": p5_split,
          "equal_plain": all(c["equal"] for c in checks),
          "max_active_clusters_k3_tc": lib.rns_modexp2f_tc_max_clusters(ka, kb, tcp3["W"]),
          "linear_share": {
              f: p5_split[f"probe_p5[{f}, no extensions]"] / p5_split[f"probe_p5[{f}]"]
              for f in ("dp4a", "tc")}})
    if not all(c["equal"] for c in checks):
        raise AssertionError("a product probe differs from its plain version: "
                             + str([c["name"] for c in checks if not c["equal"]]))
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
        ("main", "rns", "fb_table2"),
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
        ("main", "rns", "fb_modexp2"),
        before=lambda: cuda_rns2.fb_modexp2_dp4a(tab, wins, kc, mont_out=True),
        extra={"form": "tensor cores (mma.sync m16n8k32 s8)",
               "form_before": "CUDA cores (dp4a)"},
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
        ("main", "rns", "rns_modexp2f"),
        before=lambda: cuda_rns2.rns_modexp2f_dp4a(ct_l, ewins, kc2),
        extra={"form": "tensor cores (mma.sync m16n8k32 s8)",
               "form_before": "CUDA cores (dp4a)"},
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
        ("main", "cios", "mod_mul"),
    )
    a1 = limbs_below(B)[None]
    got = cuda_modexp.mod_mul(a1, prv.pinv_q, prv.pq_n[1:2], prv.pq_n0inv[1:2],
                              prv.pq_r2[1:2])
    want = cuda_modexp.mod_mul_plain(a1, prv.pinv_q, prv.pq_n[1:2],
                                     prv.pq_n0inv[1:2], prv.pq_r2[1:2])
    single_equal = torch.equal(got, want)
    # K5 in its three forms.  One modexp is 15 + 5*NW + 1 Montgomery products
    # a row and group, plus the limbs -> residues conversion.
    def k5_check(form, base, wins5, consts, shared, path="homo", plain_nw=None):
        """``plain_nw``: compare kernel and plain version on the first
        ``plain_nw`` windows only; the time is the kernel's at all of them."""
        G5 = consts["sig0"].shape[0]
        k5 = consts["sig0"].shape[-1]
        NW5, L5 = wins5.shape[-1], base.shape[-1]
        w_cmp = wins5 if plain_nw is None else wins5[..., :plain_nw].contiguous()
        extra = None
        if plain_nw is not None:
            t_cmp = cuda_ms(
                lambda: cuda_rns2.rns_modexp2(base, w_cmp, consts, shared=shared), 1)
            extra = {"nw": NW5, "plain_nw": plain_nw, "ms_at_plain_nw": t_cmp}
        return check(
            f"rns_modexp2[{form}]", src + "rns_modexp2.cu",
            "pailliercryptolib_tpu/ops/pallas_rns2.py:883",
            f"base{list(base.shape)} wins{list(wins5.shape)} -> [{G5},{B},{2 * k5 + 1}]",
            lambda: cuda_rns2.rns_modexp2(base, w_cmp, consts, shared=shared),
            lambda: cuda_rns2.rns_modexp2_plain(base, w_cmp, consts, shared=shared),
            nbytes(base, wins5, consts["CinA"], consts["CinB"])
            + G5 * B * (2 * k5 + 1) * 4,
            G5 * ((15 + 5.0 * NW5 + 1) * B * mm_ops(k5, k5 + 2, k5 + 1)
                  + 2.0 * 3 * B * L5 * (2 * k5 + 1)),
            PEAK_INT8_OPS,
            (path, "k5", form.split("@")[0]),
            timed=lambda: cuda_rns2.rns_modexp2(base, wins5, consts, shared=shared),
            extra=extra,
        )

    base5 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    k5_check("shared", base5, pub.n_wins, kc, True)  # normal encrypt's shape
    pt_wins = to_i32(nprng.integers(0, 16, (1, B, 16)), dev)  # 64-bit scalars
    k5_check("var", base5, pt_wins, kc, False)
    kc_st, _ = prv.rns_crt_stacked
    k5_check("grouped", ct_l[None], ewins, kc_st, True)

    # K6, K7 and K4 at the CIOS backend's shapes.  A modexp is 15 + 5*NW + 1
    # Montgomery products a row, a product L^2 limb steps of two multiply-adds.
    # The plain modexp is thousands of small launches a product, so kernel and
    # plain version are compared bit for bit at the same L and B with
    # PLAIN_NW windows; the time is the kernel's at the path's NW.
    PLAIN_NW = 32
    cios_src = src + "modexp.cu"

    def k6_check(form, base, wins6, consts, plain_nw, path="cios"):
        n6, n06, r26, one6 = consts
        G6, L6 = n6.shape
        B6 = max(base.shape[1], wins6.shape[1])
        NW6 = wins6.shape[-1]
        w_cmp = wins6[..., :plain_nw].contiguous()
        t_cmp = cuda_ms(lambda: cuda_modexp.modexp(base, w_cmp, *consts), 1)
        return check(
            f"modexp[{form}]", cios_src,
            "pailliercryptolib_tpu/ops/pallas_modexp.py:175",
            f"base{list(base.shape)} wins{list(wins6.shape)} -> [{G6},{B6},{L6}]",
            lambda: cuda_modexp.modexp(base, w_cmp, *consts),
            lambda: cuda_modexp.modexp_plain(base, w_cmp, *consts),
            nbytes(base, wins6, n6, n06, r26, one6) + G6 * B6 * L6 * 4,
            G6 * B6 * (15 + 5.0 * NW6 + 1) * (2.0 * 2 * L6 * L6), PEAK_32BIT_OPS,
            (path, "cios", "modexp"),
            timed=lambda: cuda_modexp.modexp(base, wins6, *consts),
            extra={"nw": NW6, "plain_nw": plain_nw, "ms_at_plain_nw": t_cmp,
                   "select": "reads all 16 table entries"},
        )

    def stack_consts(cs):
        return (to_i32(np.stack([c.n_limbs for c in cs]), dev),
                to_i32(np.array([c.n0inv for c in cs], np.uint32), dev),
                to_i32(np.stack([c.r2_limbs for c in cs]), dev),
                to_i32(np.stack([c.one_limbs for c in cs]), dev))

    n2c = stack_consts([pub.mont_n2])
    sqc = stack_consts([prv.mont_p2, prv.mont_q2])
    r_wins = to_i32(nprng.integers(0, 16, (1, B, NP * 2)), dev)  # randbits / 4
    k6_check("var", pub.hs_limbs[None, None], r_wins, n2c, PLAIN_NW)  # DJN encrypt
    base_g = to_i32(nprng.integers(0, 1 << 15, (2, B, prv.Lp2)), dev)
    base_g[..., -1] = 0  # below R
    k6_check("grouped", base_g, prv.exp_wins, sqc, PLAIN_NW)  # CRT decrypt
    wide_n = rng.getrandbits(8192) | (1 << 8191) | 1
    widec = stack_consts([MontConstants.create(wide_n, 8192)])
    B_wide, L_wide = 37, widec[0].shape[-1]
    assert L_wide == cuda_modexp.KERNEL_MAX_L
    base_w = to_i32(nprng.integers(0, 1 << 15, (1, B_wide, L_wide)), dev)
    base_w[..., -1] = 0
    wins_w = to_i32(nprng.integers(0, 16, (1, B_wide, 256)), dev)
    k6_check("L547", base_w, wins_w, widec, 8)
    # K7: the fold of the CRT decrypt (x_hi * R^2 * R^-1 in both systems)
    check(
        "mont_raw", src + "mont_raw.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:288",
        f"a[2,{B},{prv.Lp2}] b[2,1,{prv.Lp2}] -> [2,{B},{prv.Lp2}]",
        lambda: cuda_modexp.mont_raw(base_g, prv.sq_r2[:, None, :], sqc[0], sqc[1]),
        lambda: cuda_modexp.mont_raw_plain(base_g, prv.sq_r2[:, None, :], sqc[0],
                                           sqc[1]),
        nbytes(base_g) * 2 + nbytes(prv.sq_r2, sqc[0]),
        2.0 * B * (2.0 * 2 * prv.Lp2 * prv.Lp2), PEAK_32BIT_OPS,
        ("cios", "cios", "mont_raw"),
        extra={"compared": "digit for digit (the plain version's digit schedule)"},
    )
    # K4 at the width of n^2 (every encrypt, CT+CT and obfuscation of "cios")
    a_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    a_n2[..., -1] = 0
    b_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    b_n2[..., -1] = 0
    check(
        "mod_mul[n2]", src + "mod_mul.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:295",
        f"a[1,{B},{pub.L2}] b[1,{B},{pub.L2}] -> [1,{B},{pub.L2}]",
        lambda: cuda_modexp.mod_mul(a_n2, b_n2, n2c[0], n2c[1], n2c[2]),
        lambda: cuda_modexp.mod_mul_plain(a_n2, b_n2, n2c[0], n2c[1], n2c[2]),
        nbytes(a_n2) * 3 + nbytes(n2c[0], n2c[2]),
        1.0 * B * 2 * (2.0 * 2 * pub.L2 * pub.L2), PEAK_32BIT_OPS,
        ("cios", "cios", "mod_mul"),
    )
    del base_g, base_w, wins_w, a_n2, b_n2, r_wins, n2c, sqc, widec
    emit({"phase": "kernel_checks", "key_bits": key_bits, "rows": B,
          "keygen_seconds": round(check_keygen_s, 3),
          "fb_modexp2_plain_out_equal": plain_out_equal,
          "mod_mul_single_group_equal": single_equal,
          "checks": [{kk: v for kk, v in c.items()
                      if kk in ("name", "equal", "kernel_ms", "plain_ms", "shape",
                                "nw", "plain_nw", "ms_before")}
                     for c in checks]})
    if not (plain_out_equal and single_equal and all(c["equal"] for c in checks)):
        raise AssertionError("a kernel differs from its plain version: "
                             + str([c["name"] for c in checks if not c["equal"]]))
    if args.kernels_only:
        emit({"kernels_only": [{kk: c.get(kk) for kk in ("name", "ms", "max_abs_err",
                                                          "ms_before", "turns_ms")}
                               for c in checks],
              "ptxas": _build.kernel_stats()})
        print(card, flush=True)
        return 0
    del tab, tabs, ct_l, a2, a1, got, want, ckey, pub, prv, kc, kc2, conv
    del base5, pt_wins, kc_st
    torch.cuda.empty_cache()

    # -- main path -----------------------------------------------------------------
    counters = {"rns": cuda_rns2.LAUNCHES, "cios": cuda_modexp.LAUNCHES,
                "k5": cuda_rns2.MODEXP2_FORMS, "forms": cuda_rns2.KERNEL_FORMS,
                "probes": cuda_probes.LAUNCHES}

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
                "rns_modexp2": 0, "modexp": 0, "mont_raw": 0}
    for name, want_n in expected.items():
        if launches[name] != want_n:
            raise AssertionError(
                f"main path launched {name} {launches[name]} times, expected {want_n}")
    # K2 and K3 in their tensor-core form, never the CUDA-core one
    want_forms = {"fb_modexp2_tc": 2, "fb_modexp2_dp4a": 0, "rns_modexp2f_tc": 1,
                  "rns_modexp2f_dp4a": 0}
    if main_counts["forms"] != want_forms:
        raise AssertionError(f"main path ran the forms {main_counts['forms']}, "
                             f"expected {want_forms}")
    # warm timings (outside the counted window)
    wreps = 5
    pt_vals = ptorch.PlainText(vals)
    encrypt_ms = host_ms(lambda: pk.encrypt(pt_vals), wreps)
    decrypt_ms = host_ms(lambda: sk.decrypt(ct), wreps)
    emit({"phase": "main_path", "key_bits": key_bits, "batch": B,
          "roundtrip_ok": True, "oracle_ok": True, "launches": launches,
          "kernel_forms": main_counts["forms"],
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
                      rns_modexp2f=1, rns_modexp2f_tc=1, mod_mul=2)
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
                 fb_modexp2=1, fb_modexp2_tc=1)
    if od.texts == ct.texts:
        raise AssertionError("DJN apply_obfuscator left the ciphertexts unchanged")
    dd = counted("CRT decrypt (DJN)", lambda: sk.decrypt(od),
                 rns_modexp2f=1, rns_modexp2f_tc=1, mod_mul=2)
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
            rns_modexp2=1, shared=1, rns_modexp2f=2, rns_modexp2f_tc=2, mod_mul=4)
    homo_counts = read_counts()
    h_launches = {**homo_counts["rns"], **homo_counts["cios"]}
    for form, cnt in homo_counts["k5"].items():
        if cnt < 1:
            raise AssertionError(f"homomorphic path never ran rns_modexp2[{form}]")
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
    for eng in (pk._engine, sk._engine, hpk._engine, hsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
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

    # -- the CIOS backend ---------------------------------------------------------------
    # the engines take their backend from the runtime config when they are made
    reset_counts()
    t0 = time.perf_counter()
    rkey = ptorch.generate_keypair(key_bits, enable_DJN=True)  # "rns"
    c_keygen_s = time.perf_counter() - t0
    rpk, rsk = rkey.pub_key, rkey.priv_key
    rpk._engine, rsk._engine  # made now, under the default config
    set_config(Config(backend="cios"))
    try:
        ckey = keys_from_ints(rpk.n, rsk.p, rsk.q, rpk.hs, rpk.randbits)
        cpk, csk = ckey.pub_key, ckey.priv_key
        backends = (cpk._engine.backend, csk._engine.backend, rpk._engine.backend)
    finally:
        set_config(Config())
    if backends != ("cios", "cios", "rns"):
        raise AssertionError(f"cios path: engines on {backends}")
    cn, cn2 = cpk.n, cpk.nsquare
    vm = [rng.getrandbits(64) for _ in range(B)]
    vm2 = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]
    vs = rng.getrandbits(64)
    rs_c = [rng.getrandbits(cpk.randbits) for _ in range(2 * B)]
    cpk.set_random(rs_c)
    rpk.set_random(rs_c)
    t0 = time.perf_counter()
    c1 = counted("cios DJN encrypt", lambda: cpk.encrypt(ptorch.PlainText(vm)),
                 modexp=1, mod_mul=1)
    first_cios_encrypt_s = time.perf_counter() - t0
    c2 = counted("cios DJN encrypt", lambda: cpk.encrypt(ptorch.PlainText(vm2)),
                 modexp=1, mod_mul=1)
    n_oracle = 256
    if c1.texts[:n_oracle] != [(cn * m + 1) * pow(cpk.hs, r, cn2) % cn2
                               for m, r in zip(vm[:n_oracle], rs_c)]:
        raise AssertionError("cios path: ciphertexts differ from pow()")
    c_sum = counted("cios ct + ct", lambda: c1 + c2, mod_mul=1)
    c_mul = counted("cios ct * pt (per-row)", lambda: c_sum * ptorch.PlainText(ve),
                    modexp=1)
    c_mul2 = counted("cios ct * pt (scalar)", lambda: c_mul * ptorch.PlainText([vs]),
                     modexp=1)
    c_obf = counted("cios apply_obfuscator", lambda: cpk.apply_obfuscator(c_mul2),
                    modexp=1, mod_mul=1)
    for t in (c1, c_sum, c_mul, c_mul2, c_obf):
        assert t.device_payload().arr.is_cuda
    want_c = [((x + y) * e * vs) % cn for x, y, e in zip(vm, vm2, ve)]
    d_crt = counted("cios CRT decrypt", lambda: csk.decrypt(c_obf),
                    mont_raw=1, modexp=1, mod_mul=2)
    csk.enable_crt = False
    d_raw = counted("cios RAW decrypt", lambda: csk.decrypt(c_obf),
                    modexp=1, mod_mul=1)
    csk.enable_crt = True
    if d_crt.texts != want_c or d_raw.texts != want_c:
        raise AssertionError("cios path: decrypted values differ from "
                             "((a + b) * e * s) mod n")
    if c_obf.texts == c_mul2.texts:
        raise AssertionError("cios path: apply_obfuscator left the ciphertexts unchanged")
    for eng in (cpk._engine, csk._engine, rpk._engine, rsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
    torch.cuda.synchronize()
    cios_counts = read_counts()
    # the same key on the "rns" backend (outside the counted window): equal
    # ciphertexts for the same m and r, and it decrypts what "cios" made
    r1 = rpk.encrypt(ptorch.PlainText(vm))
    r2 = rpk.encrypt(ptorch.PlainText(vm2))
    if c1.texts != r1.texts or c2.texts != r2.texts:
        raise AssertionError("cios path: ciphertexts differ from the rns backend's")
    if rsk.decrypt(c_obf).texts != want_c:
        raise AssertionError("cios path: the rns backend decrypts cios ciphertexts wrong")
    if any(cios_counts[grp][name] for grp in ("rns", "k5") for name in cios_counts[grp]):
        raise AssertionError(f"cios path launched an RNS kernel: {cios_counts}")
    pt_vm, pt_ve, pt_vs = (ptorch.PlainText(v) for v in (vm, ve, [vs]))
    c_ms = {
        "encrypt_djn": host_ms(lambda: cpk.encrypt(pt_vm), wreps),
        "add_ctct": host_ms(lambda: c1 + c2, wreps),
        "mul_ctpt_per_row": host_ms(lambda: c_sum * pt_ve, wreps),
        "mul_ctpt_scalar": host_ms(lambda: c_mul * pt_vs, wreps),
        "apply_obfuscator_djn": host_ms(lambda: cpk.apply_obfuscator(c_mul2), wreps),
        "decrypt_crt": host_ms(lambda: csk.decrypt(c_obf), wreps),
    }
    csk.enable_crt = False
    c_ms["decrypt_raw"] = host_ms(lambda: csk.decrypt(c_obf), wreps)
    csk.enable_crt = True
    emit({"phase": "cios_path", "key_bits": key_bits, "batch": B,
          "oracle_rows": n_oracle, "oracle_ok": True, "equals_rns_backend": True,
          "values_ok": True, "launches": cios_counts["cios"],
          "keygen_seconds": round(c_keygen_s, 3),
          "first_encrypt_seconds": round(first_cios_encrypt_s, 3),
          "host_ms": c_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("cios encrypt_djn", lambda: cpk.encrypt(pt_vm)),
                       ("cios decrypt_crt", lambda: csk.decrypt(c_obf))):
            emit(profile_call(op, fn))
    del c1, c2, r1, r2, c_sum, c_mul, c_mul2, c_obf, d_crt, d_raw
    del rkey, rpk, rsk, ckey, cpk, csk
    torch.cuda.empty_cache()

    # -- the modexp API ---------------------------------------------------------------------
    m_big = rng.getrandbits(4096) | (1 << 4095) | 1
    bs = [rng.randrange(m_big) for _ in range(B)]
    es = [rng.getrandbits(128) for _ in range(B - 2)] + [0, 1]
    got = counted("modexp, one modulus", lambda: ptorch.modexp(bs, es, m_big),
                  modexp=1)
    if got != [pow(b, e, m_big) for b, e in zip(bs, es)]:
        raise AssertionError("modexp API: 4096-bit modulus differs from pow()")
    mods3 = [rng.getrandbits(w) | (1 << (w - 1)) | 1 for w in (512, 1000, 3072)]
    ms3 = [mods3[i % 3] for i in range(30)]
    bs3 = [rng.getrandbits(3000) for _ in range(30)]
    es3 = [rng.getrandbits(200) for _ in range(30)]
    got3 = counted("modexp, three moduli", lambda: ptorch.modexp(bs3, es3, ms3),
                   modexp=3)
    if got3 != [pow(b, e, m) for b, e, m in zip(bs3, es3, ms3)]:
        raise AssertionError("modexp API: vector of moduli differs from pow()")
    got1 = counted("modexp, scalars", lambda: ptorch.modexp(bs[0], es[0], mods3[1]),
                   modexp=1)
    if got1 != pow(bs[0], es[0], mods3[1]):
        raise AssertionError("modexp API: scalar call differs from pow()")
    emit({"phase": "modexp_api", "rows": B, "modulus_bits": 4096,
          "exponent_bits": 128, "one_modulus_ok": True, "three_moduli_ok": True,
          "scalar_ok": True, "modexp_launches": 5,
          "host_ms": host_ms(lambda: ptorch.modexp(bs, es, m_big), 3)})

    # -- the hybrid batch split -----------------------------------------------------------
    # The plain tail on the card is L steps of a dozen small launches a
    # product, so this phase runs at a key width that keeps it short.
    hy_bits, hy_B = 256, 10
    t0 = time.perf_counter()
    ykey = ptorch.generate_keypair(hy_bits, enable_DJN=True)
    ypk, ysk = ykey.pub_key, ykey.priv_key
    yv = [rng.getrandbits(64) for _ in range(hy_B)]

    def spy(engine, method):
        calls = []
        orig = getattr(engine, method)

        def wrapper(*a):
            calls.append(a)
            return orig(*a)

        setattr(engine, method, wrapper)
        return calls

    try:
        ptorch.set_hybrid_mode(ptorch.HybridMode.HALF)
        enc_tail = spy(ypk._engine.secondary, "_encrypt_djn_impl")
        yct = counted("hybrid HALF encrypt", lambda: ypk.encrypt(ptorch.PlainText(yv)),
                      # the head rows; the tail is plain
                      fb_table2=1, fb_modexp2=1, fb_modexp2_tc=1)
        if ypk._engine.secondary.backend != "plain" or not yct.device_payload().arr.is_cuda:
            raise AssertionError("hybrid: the twin engine is not the plain backend")
        if [len(c[0]) for c in enc_tail] != [hy_B - hy_B // 2]:
            raise AssertionError(f"hybrid HALF: tail calls {[len(c[0]) for c in enc_tail]}")
        # a device-resident ciphertext skips the split
        dec_tail = spy(ysk._engine.secondary, "_decrypt_crt_impl")
        if ysk.decrypt(yct).texts != yv or dec_tail:
            raise AssertionError("hybrid: device-resident decrypt was split or wrong")
        # host ints split at int(ratio * size)
        ptorch.set_hybrid_ratio(0.4)
        if ptorch.get_hybrid_mode() != ptorch.HybridMode.UNDEFINED:
            raise AssertionError("hybrid: set_hybrid_ratio kept the mode")
        yhost = ptorch.CipherText(ypk, yct.texts)
        ydec = counted("hybrid 0.4 decrypt", lambda: ysk.decrypt(yhost),
                       rns_modexp2f=1, rns_modexp2f_tc=1, mod_mul=2)
        if ydec.texts != yv or [len(c[0]) for c in dec_tail] != [hy_B - int(0.4 * hy_B)]:
            raise AssertionError("hybrid ratio 0.4: wrong split or values")
        # a "cios" primary splits the same way
        ypk._engine.backend = "cios"
        yct2 = counted("hybrid 0.4 cios encrypt",
                       lambda: ypk.encrypt(ptorch.PlainText(yv)), modexp=1, mod_mul=1)
        ypk._engine.backend = "rns"
        if ysk.decrypt(ptorch.CipherText(ypk, yct2.texts)).texts != yv:
            raise AssertionError("hybrid: cios head + plain tail decrypts wrong")
        if [len(c[0]) for c in enc_tail][1:] != [hy_B - int(0.4 * hy_B)]:
            raise AssertionError("hybrid ratio 0.4 (cios): wrong split")
    finally:
        ptorch.set_hybrid_off()
    n_tail = (len(enc_tail), len(dec_tail))
    yct3 = counted("encrypt after set_hybrid_off",
                   lambda: ypk.encrypt(ptorch.PlainText(yv)), fb_modexp2=1, fb_modexp2_tc=1)
    ydec3 = counted("decrypt after set_hybrid_off",
                    lambda: ysk.decrypt(ptorch.CipherText(ypk, yct3.texts)),
                    rns_modexp2f=1, rns_modexp2f_tc=1, mod_mul=2)
    if ydec3.texts != yv or (len(enc_tail), len(dec_tail)) != n_tail:
        raise AssertionError("set_hybrid_off: the batch was still split")
    if not ptorch.get_hybrid_mode() == ptorch.HybridMode.OPTIMAL:
        raise AssertionError("set_hybrid_off: mode not OPTIMAL")
    emit({"phase": "hybrid", "key_bits": hy_bits, "batch": hy_B,
          "half_tail_rows": hy_B - hy_B // 2, "ratio_0.4_tail_rows": hy_B - int(0.4 * hy_B),
          "device_resident_skips_split": True, "off_restores_single_backend": True,
          "values_ok": True, "seconds": round(time.perf_counter() - t0, 3)})


    # -- wide keys: the kernels at their shapes --------------------------------------------
    # One 4096-bit DJN key serves the kernel checks (its engines' constant
    # sets) and the wide path below (its fixed-base table is built there, by the
    # first encrypt); a 3072-bit key serves the 480-lane check and its own phase.
    WIDE_PLAIN_NW = 64  # windows on which the long modexps are compared
    t0 = time.perf_counter()
    wkey = ptorch.generate_keypair(4096, enable_DJN=True)
    w_keygen_s = time.perf_counter() - t0
    wpk, wsk = wkey.pub_key, wkey.priv_key
    t0 = time.perf_counter()
    _, wkc, _ = wpk._engine.rns
    w_ctx_s = time.perf_counter() - t0
    wpack = cuda_rns2._kernel_pack(wkc)
    wform = (wpack["f32"], wpack["lean"], wpack["W"])
    if wform != (True, False, 640):
        raise AssertionError(f"4096-bit n^2 constant set has form {wform}")
    wk = wpack["k"]
    NPw = max(8, -(-(-(-wpk.randbits // 8)) // 8) * 8)
    n_before = len(checks)
    gA = residues(wkc["modsA"][0], NPw)
    gB = residues(wkc["modsBx"][0], NPw)
    tabs = check(
        "fb_table2[w640]", src + "fb_table2.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:1066",
        f"gA[1,{NPw},{wk}] gB[1,{NPw},{wk + 1}] -> [1,256,{NPw},{wk}],[1,256,{NPw},{wk + 1}]",
        lambda: cuda_rns2.fb_table2(gA[None], gB[None], wkc),
        lambda: cuda_rns2.fb_table2_plain(gA[None], gB[None], wkc),
        nbytes(gA, gB) + 256 * NPw * (2 * wk + 1) * 4,
        255.0 * NPw * mm_ops(wk, wk + 2, wk + 1), PEAK_INT8_OPS,
        ("wide", "rns", "fb_table2"),
    )
    tab = cuda_rns2.fb_gather_table(*tabs)
    fb_table_bytes = nbytes(tab)
    del tabs
    wins = torch.from_numpy(
        nprng.integers(0, 256, (1, B, NPw), dtype=np.uint8)).to(dev)
    check(
        "fb_modexp2[w640]", src + "fb_modexp2.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:1197",
        f"tab[{NPw},256,{2 * wk + 1}] bytes[1,{B},{NPw}] -> [1,{B},{2 * wk + 1}]",
        lambda: cuda_rns2.fb_modexp2(tab, wins, wkc, mont_out=True),
        lambda: cuda_rns2.fb_modexp2_plain(tab, wins, wkc, mont_out=True),
        min(nbytes(tab), B * NPw * (2 * wk + 1) * 4) + nbytes(wins)
        + B * (2 * wk + 1) * 4,
        (NPw - 1.0) * B * mm_ops(wk, wk + 2, wk + 1), PEAK_INT8_OPS,
        ("wide", "rns", "fb_modexp2"),
    )
    del tab, wins
    torch.cuda.empty_cache()
    base5 = to_i32(nprng.integers(0, 1 << 15, (1, B, wpk._engine.L2)), dev)
    k5_check("shared@w640", base5, wpk._engine.n_wins, wkc, True, "wide", WIDE_PLAIN_NW)
    pt_wins = to_i32(nprng.integers(0, 16, (1, B, 16)), dev)
    k5_check("var@w640", base5, pt_wins, wkc, False, "wide")
    wkc2, _ = wsk._engine.rns_crt
    if wsk._engine.crt_folded or "maskB" in wkc2:
        raise AssertionError("a 4096-bit key's CRT decrypt must take the grouped layout")
    ct_l = to_i32(nprng.integers(0, 1 << 15, (1, B, wkc2["CinA"].shape[-2])), dev)
    k5_check("grouped@L548", ct_l, wsk._engine.exp_wins[:, 0].contiguous(), wkc2, True,
             "wide", WIDE_PLAIN_NW)
    # K6, K7 and K4 at the shapes the "cios" calls of the wide path give them:
    # the DJN encrypt's shared base hs under n^2 with randbits / 4 windows a
    # row, the CRT decrypt's grouped modexp, fold and tail at p^2 / q^2 and
    # p / q width, and the product at n^2 width.  The long modexps are
    # compared on WIDE_CIOS_NW windows (the plain version is thousands of
    # small launches a product), timed on all.
    WIDE_CIOS_NW = 8
    wpub, wprv = wpk._engine, wsk._engine
    wn2c = stack_consts([wpub.mont_n2])
    wsqc = stack_consts([wprv.mont_p2, wprv.mont_q2])
    wL2, wLp, wLp2 = wpub.L2, wprv.Lp, wprv.Lp2
    r_wins = to_i32(nprng.integers(0, 16, (1, B, -(-wpk.randbits // 4))), dev)
    k6_check("var@L%d" % wL2, wpub.hs_limbs[None, None], r_wins, wn2c, WIDE_CIOS_NW,
             "wide")
    base_g = to_i32(nprng.integers(0, 1 << 15, (2, B, wLp2)), dev)
    base_g[..., -1] = 0  # below R
    k6_check("grouped@L%d" % wLp2, base_g, wprv.exp_wins, wsqc, WIDE_CIOS_NW, "wide")
    check(
        "mont_raw[L%d]" % wLp2, src + "mont_raw.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:288",
        f"a[2,{B},{wLp2}] b[2,1,{wLp2}] -> [2,{B},{wLp2}]",
        lambda: cuda_modexp.mont_raw(base_g, wprv.sq_r2[:, None, :], wsqc[0], wsqc[1]),
        lambda: cuda_modexp.mont_raw_plain(base_g, wprv.sq_r2[:, None, :], wsqc[0],
                                           wsqc[1]),
        nbytes(base_g) * 2 + nbytes(wprv.sq_r2, wsqc[0]),
        2.0 * B * (2.0 * 2 * wLp2 * wLp2), PEAK_32BIT_OPS,
        ("wide", "cios", "mont_raw"),
        extra={"compared": "digit for digit (the plain version's digit schedule)"},
    )
    a_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, wL2)), dev)
    a_n2[..., -1] = 0
    b_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, wL2)), dev)
    b_n2[..., -1] = 0
    check(
        "mod_mul[n2@L%d]" % wL2, src + "mod_mul.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:295",
        f"a[1,{B},{wL2}] b[1,{B},{wL2}] -> [1,{B},{wL2}]",
        lambda: cuda_modexp.mod_mul(a_n2, b_n2, wn2c[0], wn2c[1], wn2c[2]),
        lambda: cuda_modexp.mod_mul_plain(a_n2, b_n2, wn2c[0], wn2c[1], wn2c[2]),
        nbytes(a_n2) * 3 + nbytes(wn2c[0], wn2c[2]),
        1.0 * B * 2 * (2.0 * 2 * wL2 * wL2), PEAK_32BIT_OPS,
        ("wide", "cios", "mod_mul"),
    )
    a_pq = to_i32(nprng.integers(0, 1 << 15, (2, B, wLp)), dev)
    a_pq[..., -2:] = 0  # below p and q
    check(
        "mod_mul[crt@L%d]" % wLp, src + "mod_mul.cu",
        "pailliercryptolib_tpu/ops/pallas_modexp.py:295",
        f"a[2,{B},{wLp}] b[2,1,{wLp}] -> [2,{B},{wLp}]",
        lambda: cuda_modexp.mod_mul(a_pq, wprv.hfun[:, None, :], wprv.pq_n,
                                    wprv.pq_n0inv, wprv.pq_r2),
        lambda: cuda_modexp.mod_mul_plain(a_pq, wprv.hfun[:, None, :], wprv.pq_n,
                                          wprv.pq_n0inv, wprv.pq_r2),
        nbytes(a_pq) * 2 + nbytes(wprv.hfun),
        2.0 * B * 2 * (2.0 * 2 * wLp * wLp), PEAK_32BIT_OPS,
        ("wide", "cios", "mod_mul"),
    )
    del base5, pt_wins, ct_l, r_wins, base_g, a_n2, b_n2, a_pq, wn2c, wsqc, wpub, wprv
    t0 = time.perf_counter()
    key3 = ptorch.generate_keypair(3072, enable_DJN=True)
    keygen3_s = time.perf_counter() - t0
    _, kc3, _ = key3.pub_key._engine.rns
    if cuda_rns2._kernel_pack(kc3)["W"] != 480:
        raise AssertionError("3072-bit n^2 constant set is not 480 lanes wide")
    base3 = to_i32(nprng.integers(0, 1 << 15, (1, B, key3.pub_key._engine.L2)), dev)
    k5_check("shared@w480", base3, key3.pub_key._engine.n_wins, kc3, True, "wide3072",
             WIDE_PLAIN_NW)
    del base3
    wide_checks = checks[n_before:]
    emit({"phase": "wide_kernel_checks", "key_bits": [4096, 3072], "rows": B,
          "keygen_seconds": round(w_keygen_s, 3),
          "keygen_3072_seconds": round(keygen3_s, 3),
          "n2_context_seconds": round(w_ctx_s, 3),
          "form_4096": {"f32": wform[0], "lean": wform[1], "W": wform[2], "k": wk},
          "fb_gather_table_bytes": fb_table_bytes,
          "checks": [{kk: v for kk, v in c.items()
                      if kk in ("name", "equal", "kernel_ms", "plain_ms", "shape",
                                "nw", "plain_nw")}
                     for c in wide_checks]})
    if not all(c["equal"] for c in wide_checks):
        raise AssertionError("a kernel differs from its plain version: "
                             + str([c["name"] for c in wide_checks if not c["equal"]]))
    torch.cuda.empty_cache()

    # -- the wide path: 4096-bit keys through the public API ----------------------------------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    wn, wn2 = wpk.n, wpk.nsquare
    va = [rng.getrandbits(64) for _ in range(B)]
    vb = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]
    vs = rng.getrandbits(64)
    pt_a, pt_b, pt_e, pt_s = (ptorch.PlainText(v) for v in (va, vb, ve, [vs]))
    t0 = time.perf_counter()
    wa = counted("wide DJN encrypt", lambda: wpk.encrypt(pt_a),
                 # fresh DeviceSeed; builds the table
                 fb_table2=1, fb_modexp2=1, fb_modexp2_dp4a=1)
    w_first_encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wd = counted("wide CRT decrypt", lambda: wsk.decrypt(wa),
                 rns_modexp2=1, grouped=1, mod_mul=2)  # grouped K5, no folded kernel
    w_first_decrypt_s = time.perf_counter() - t0
    if wd.texts != va:
        raise AssertionError("wide path: decrypt(encrypt(m)) != m")
    n_oracle = 64
    rs_w = [rng.getrandbits(wpk.randbits) for _ in range(n_oracle)]
    wpk.set_random(rs_w)
    w64 = counted("wide DJN encrypt (injected r)",
                  lambda: wpk.encrypt(ptorch.PlainText(va[:n_oracle])),
                  fb_modexp2=1, fb_modexp2_dp4a=1)
    if w64.texts != [(wn * m + 1) * pow(wpk.hs, r, wn2) % wn2
                     for m, r in zip(va, rs_w)]:
        raise AssertionError("wide path: injected-r ciphertexts differ from pow()")
    wb = counted("wide DJN encrypt", lambda: wpk.encrypt(pt_b),
                 fb_modexp2=1, fb_modexp2_dp4a=1)
    w_sum = counted("wide ct + ct", lambda: wa + wb)
    w_m1 = counted("wide ct * pt (per-row)", lambda: w_sum * pt_e, rns_modexp2=1, var=1)
    w_m2 = counted("wide ct * pt (scalar)", lambda: w_m1 * pt_s, rns_modexp2=1, shared=1)
    w_ob = counted("wide apply_obfuscator", lambda: wpk.apply_obfuscator(w_m2),
                   fb_modexp2=1, fb_modexp2_dp4a=1)
    for t in (wa, w_sum, w_m1, w_m2, w_ob):
        assert t.device_payload().arr.is_cuda and t._texts is None
    want_w = [((x + y) * e * vs) % wn for x, y, e in zip(va, vb, ve)]
    wd_crt = counted("wide CRT decrypt", lambda: wsk.decrypt(w_ob),
                     rns_modexp2=1, grouped=1, mod_mul=2)
    wsk.enable_crt = False
    wd_raw = counted("wide RAW decrypt", lambda: wsk.decrypt(w_ob),
                     rns_modexp2=1, shared=1, mod_mul=1)
    wsk.enable_crt = True
    if wd_crt.texts != want_w or wd_raw.texts != want_w:
        raise AssertionError("wide path: decrypted values differ from "
                             "((a + b) * e * s) mod n")
    if w_ob.texts == w_m2.texts:
        raise AssertionError("wide path: apply_obfuscator left the ciphertexts unchanged")
    # normal mode on the same modulus: a non-DJN public key of the same n
    npk = ptorch.PublicKey(wn, 4096)
    wc = counted("wide normal encrypt", lambda: npk.encrypt(pt_a),
                 rns_modexp2=1, shared=1)
    rs8 = [rng.randrange(1, wn) for _ in range(8)]
    npk.set_random(rs8)
    wc8 = counted("wide normal encrypt (injected r)",
                  lambda: npk.encrypt(ptorch.PlainText(va[:8])), rns_modexp2=1, shared=1)
    if wc8.texts != [(wn * m + 1) * pow(r, wn, wn2) % wn2 for m, r in zip(va, rs8)]:
        raise AssertionError("wide path: normal-mode ciphertexts differ from pow()")
    if counted("wide CRT decrypt", lambda: wsk.decrypt(wc),
               rns_modexp2=1, grouped=1, mod_mul=2).texts != va:
        raise AssertionError("wide path: normal-mode round trip failed")
    # the same key on the "cios" backend
    set_config(Config(backend="cios"))
    try:
        wckey = keys_from_ints(wn, wsk.p, wsk.q, wpk.hs, wpk.randbits)
        wcpk, wcsk = wckey.pub_key, wckey.priv_key
        backends = (wcpk._engine.backend, wcsk._engine.backend, wpk._engine.backend)
    finally:
        set_config(Config())
    if backends != ("cios", "cios", "rns"):
        raise AssertionError(f"wide path: engines on {backends}")
    wcpk.set_random(rs_w)
    wc64 = counted("wide cios DJN encrypt",
                   lambda: wcpk.encrypt(ptorch.PlainText(va[:n_oracle])),
                   modexp=1, mod_mul=1)
    if wc64.texts != w64.texts:
        raise AssertionError("wide path: cios ciphertexts differ from the rns backend's")
    wcd = counted("wide cios CRT decrypt", lambda: wcsk.decrypt(w_ob),
                  mont_raw=1, modexp=1, mod_mul=2)
    if wcd.texts != want_w:
        raise AssertionError("wide path: the cios backend decrypts rns ciphertexts wrong")
    # the whole batch with fresh obfuscators (the shape the K6 check above holds)
    wcb = counted("wide cios DJN encrypt (batch)", lambda: wcpk.encrypt(pt_b),
                  modexp=1, mod_mul=1)
    if counted("wide cios CRT decrypt", lambda: wcsk.decrypt(wcb),
               mont_raw=1, modexp=1, mod_mul=2).texts != vb:
        raise AssertionError("wide path: cios round trip failed")
    for eng in (wpk._engine, wsk._engine, npk._engine, wcpk._engine, wcsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
    torch.cuda.synchronize()
    wide_counts = read_counts()
    w_launches = {**wide_counts["rns"], **wide_counts["cios"]}
    if wide_counts["rns"]["rns_modexp2f"] != 0:
        raise AssertionError("wide path launched the folded CRT kernel")
    w_peak = torch.cuda.max_memory_allocated()
    wr = 3
    w_ms = {
        "encrypt_djn": host_ms(lambda: wpk.encrypt(pt_a), wr),
        "decrypt_crt": host_ms(lambda: wsk.decrypt(w_ob), wr),
        "add_ctct": host_ms(lambda: wa + wb, wr),
        "mul_ctpt_per_row": host_ms(lambda: w_sum * pt_e, wr),
        "mul_ctpt_scalar": host_ms(lambda: w_m1 * pt_s, wr),
        "apply_obfuscator_djn": host_ms(lambda: wpk.apply_obfuscator(w_m2), wr),
        "encrypt_normal": host_ms(lambda: npk.encrypt(pt_a), wr),
        "cios_encrypt_djn": host_ms(lambda: wcpk.encrypt(pt_a), wr),
        "cios_decrypt_crt": host_ms(lambda: wcsk.decrypt(w_ob), wr),
    }
    wsk.enable_crt = False
    w_ms["decrypt_raw"] = host_ms(lambda: wsk.decrypt(w_ob), wr)
    wsk.enable_crt = True
    emit({"phase": "wide_path", "key_bits": 4096, "batch": B,
          "roundtrip_ok": True, "oracle_rows": n_oracle, "oracle_ok": True,
          "values_ok": True, "normal_oracle_ok": True, "equals_cios_backend": True,
          "cios_decrypts_rns": True, "launches": w_launches,
          "rns_modexp2_forms": wide_counts["k5"],
          "keygen_seconds": round(w_keygen_s, 3),
          "table_build_seconds": round(wpk._engine.fb_build_seconds, 3),
          "first_encrypt_seconds": round(w_first_encrypt_s, 3),
          "first_decrypt_seconds": round(w_first_decrypt_s, 3),
          "host_ms": w_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wr} warm calls",
          "peak_device_bytes": w_peak})
    if args.profile:
        for op, fn in (("wide encrypt", lambda: wpk.encrypt(pt_a)),
                       ("wide decrypt", lambda: wsk.decrypt(w_ob))):
            emit(profile_call(op, fn))
    del wa, wb, wd, w64, w_sum, w_m1, w_m2, w_ob, wd_crt, wd_raw, wc, wc8, wc64, wcd, wcb
    del wkey, wpk, wsk, npk, wckey, wcpk, wcsk, wkc, wkc2
    torch.cuda.empty_cache()

    # -- 3072-bit keys, a ragged batch ---------------------------------------------------------
    reset_counts()
    B3 = 300
    pk3, sk3 = key3.pub_key, key3.priv_key
    vals3 = [rng.getrandbits(64) for _ in range(B3)]
    ct3 = counted("3072-bit DJN encrypt", lambda: pk3.encrypt(ptorch.PlainText(vals3)),
                  fb_table2=1, fb_modexp2=1, fb_modexp2_dp4a=1)
    d3 = counted("3072-bit CRT decrypt", lambda: sk3.decrypt(ct3),
                 rns_modexp2=1, grouped=1, mod_mul=2)
    sk3.enable_crt = False
    d3r = counted("3072-bit RAW decrypt", lambda: sk3.decrypt(ct3),
                  rns_modexp2=1, shared=1, mod_mul=1)
    sk3.enable_crt = True
    if d3.texts != vals3 or d3r.texts != vals3:
        raise AssertionError("3072-bit keys: decrypt(encrypt(m)) != m")
    wide3_counts = read_counts()
    emit({"phase": "wide_3072", "key_bits": 3072, "batch": B3, "roundtrip_ok": True,
          "raw_roundtrip_ok": True, "crt_layout": "grouped",
          "launches": {**wide3_counts["rns"], **wide3_counts["cios"]},
          "keygen_seconds": round(keygen3_s, 3)})
    del ct3, d3, d3r, key3, pk3, sk3, kc3
    torch.cuda.empty_cache()

    # -- the probes ------------------------------------------------------------------------------
    # Each chain and product body against its plain version, then one counted
    # run of every probe; rates from the kernels' median times.  Operations a
    # step (for the bounds): one for a single instruction, two where a step is
    # two instructions or one fused multiply-add; the Barrett step of P1 is
    # counted as ten.  Single instructions are held against half the 32-bit
    # multiply-add rate, fused ones against all of it.
    OP_COST = {"where_sub": 2, "cvt_roundtrip": 2, "mul_mask12": 2, "shift_add": 2,
               "mul_add": 2, "fmul_add": 2}
    n_before = len(checks)
    probe_runs = list(p5_runs)  # (record, the probe's own call)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def long_rate(rec, run_long, element_ops):
        """A probe at its own step count lasts tens of microseconds, of the
        order of the host's time to launch it; the rate is taken from a run of
        LONG times the steps, where the launch no longer shows."""
        run_long()
        rec["long_ms"] = cuda_ms(run_long, reps)
        rec["long_element_ops"] = element_ops
        rec["G_element_ops_per_s"] = element_ops / rec["long_ms"] / 1e6
        rec["above_instruction_limit"] = rec["G_element_ops_per_s"] * 1e9 > instruction_limit

    LONG = 64
    # what the card can start: four warp instructions a clock and SM at the
    # maximum SM clock.  A chain above it was folded by ptxas (two adds in one
    # IADD3, x ^ c ^ c = x, merged shifts, powers of a constant multiplier).
    max_clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    instruction_limit = (torch.cuda.get_device_properties(0).multi_processor_count
                   * 128 * max_clock_mhz * 1e6)

    def chain_check(name, replaces, x, c, op, iters, chain=cuda_probes.op_chain,
                    chain_plain=cuda_probes.op_chain_plain):
        cost = OP_COST.get(op, 1)
        peak = PEAK_32BIT_OPS if op == "mul_add" else PEAK_32BIT_OPS / 2
        run = lambda: chain(x, c, op, iters)
        rec_i = len(checks)
        check(name, psrc, replaces,
              f"x{list(x.shape)} c{list(c.shape)} {iters} steps of {op}",
              lambda: bits(run()),
              lambda: bits(chain_plain(x, c, op, iters)),
              nbytes(x, c) + nbytes(x), 1.0 * x.numel() * iters * cost, peak,
              ("probes", "probe_runs", name))
        long_rate(checks[rec_i], lambda: chain(x, c, op, iters * LONG),
                  x.numel() * iters * LONG)
        probe_runs.append((checks[rec_i], run))

    for tag, (R, C), byrow in cuda_probes.P1_CASES:
        x = cuda_probes.to_words(cuda_probes.make_inputs("p1", (R, C)), dev)
        nconst = R if byrow else C
        m = torch.full((nconst,), cuda_probes.P1_MODULUS, dtype=torch.int32, device=dev)
        mu = torch.full((nconst,), (1 << 28) // cuda_probes.P1_MODULUS,
                        dtype=torch.int32, device=dev)
        run = (lambda x=x, m=m, mu=mu, byrow=byrow:
               cuda_probes.barrett_chain(x, m, mu, byrow))
        rec_i = len(checks)
        name = f"probe_p1[{tag}]"
        check(name, psrc, "benchmarks/probe_layout.py:41",
              f"x{list(x.shape)} m,mu[{nconst}] {cuda_probes.P1_ITERS} Barrett steps, "
              f"constants by {'row' if byrow else 'column'}",
              run,
              lambda x=x, m=m, mu=mu, byrow=byrow:
              cuda_probes.barrett_chain_plain(x, m, mu, byrow),
              2 * nbytes(x) + nbytes(m, mu),
              10.0 * x.numel() * cuda_probes.P1_ITERS, PEAK_32BIT_OPS / 2,
              ("probes", "probe_runs", name))
        long_rate(checks[rec_i],
                  lambda x=x, m=m, mu=mu, byrow=byrow: cuda_probes.barrett_chain(
                      x, m, mu, byrow, iters=16 * cuda_probes.P1_ITERS),
                  x.numel() * 16 * cuda_probes.P1_ITERS)
        probe_runs.append((checks[rec_i], run))
    for tag, op in cuda_probes.P2_CHAINS:
        x, c = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p2", op))
        chain_check(f"probe_p2[{tag}]", "benchmarks/probe_ops.py:39", x, c, op,
                    cuda_probes.P2_ITERS)
    # the lagged chains: one IADD3 / LOP3 / SHF a step that cannot be folded,
    # on P2's inputs; they complete P2 where ptxas folds its constant-operand
    # add, xor and shift chains
    x, c = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p2", "add"))
    for tag, op in cuda_probes.LAG_CHAINS:
        chain_check(f"probe_p2[lagged {tag}]", "benchmarks/probe_ops.py:39", x, c, op,
                    cuda_probes.P2_ITERS, cuda_probes.lag_chain,
                    cuda_probes.lag_chain_plain)
    for tag, op in cuda_probes.P4_CHAINS:
        x, y = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p4", op))
        chain_check(f"probe_p4[{tag}]", "benchmarks/probe_vpu_ops.py:77", x, y, op,
                    cuda_probes.P4_ITERS)
    # P3.  The record of each body is one product: kernel against plain
    # version and numpy, `ms`, `bound_ms` and `library_ms` all for the same
    # work (it lasts a few microseconds, less than its launch).  The rate of
    # the body comes from P3_REPS accumulated products in one launch
    # (`ms_reps`, `TOPs`), where the launch no longer shows.
    P3_REPS = 512
    xn, tn = cuda_probes.make_inputs("p3")
    want3 = torch.from_numpy(xn.astype(np.int64) @ tn.astype(np.int64)).to(dev)
    x8 = torch.from_numpy(xn.astype(np.int8)).to(dev)
    t8 = torch.from_numpy(tn.astype(np.int8)).to(dev)
    xp8, tTp8 = cuda_probes.pack_i8(x8, t8)
    xf, tf = x8.to(torch.float32), t8.to(torch.float32)
    M3, K3, N3 = cuda_probes.P3_SHAPE
    p3_ops = 2.0 * M3 * K3 * N3
    p3_exact = True

    def p3_check(name, shape, run, run_reps, plain, operands, peak, library, libname):
        rec_i = len(checks)
        got = check(name, psrc, "benchmarks/probe_i8mm.py:41", shape, run, plain,
                    nbytes(*operands) + M3 * N3 * 4, p3_ops, peak,
                    ("probes", "probe_runs", name), library=library,
                    extra={"library": libname, "reps": P3_REPS})
        run_reps()  # warm
        rec = checks[rec_i]
        rec["ms_reps"] = cuda_ms(run_reps, reps)
        rec["TOPs"] = p3_ops * P3_REPS / rec["ms_reps"] / 1e9
        probe_runs.append((rec, run))
        return got

    for body in ("dp4a", "mma"):
        run_reps = lambda body=body: cuda_probes.i8mm(xp8, tTp8, body=body, reps=P3_REPS)
        got = p3_check(
            f"probe_p3[int8 {body}]", f"x[{M3},{K3}] t[{K3},{N3}] int8 -> int32",
            lambda body=body: cuda_probes.i8mm(xp8, tTp8, body=body), run_reps,
            lambda: cuda_probes.i8mm_plain(xp8, tTp8), (x8, t8), PEAK_INT8_OPS,
            lambda: torch._int_mm(x8, t8), "torch._int_mm")
        p3_exact &= torch.equal(got.to(torch.int64), want3)
        p3_exact &= torch.equal(run_reps(), cuda_probes.i8mm_plain(xp8, tTp8, reps=P3_REPS))
    # float32: more than six accumulated products leave the exact range, so
    # the P3_REPS run is timed and not compared
    got = p3_check(
        "probe_p3[f32 fma]", f"x[{M3},{K3}] t[{K3},{N3}] float32",
        lambda: bits(cuda_probes.f32mm(xf, tf)),
        lambda: cuda_probes.f32mm(xf, tf, reps=P3_REPS),
        lambda: bits(cuda_probes.f32mm_plain(xf, tf)), (xf, tf), PEAK_32BIT_OPS,
        lambda: torch.matmul(xf, tf), "torch.matmul")
    p3_exact &= torch.equal(got.view(torch.float32).to(torch.int64), want3)
    probe_checks = checks[n_before:]
    if not (p3_exact and all(c["equal"] for c in probe_checks)):
        raise AssertionError("a probe differs from its plain version or from numpy: "
                             + str([c["name"] for c in probe_checks if not c["equal"]]))
    # the probes' own run: every one launched once, counted
    reset_counts()
    probe_launches = {}
    for rec, run in probe_runs:
        before = sum(cuda_probes.LAUNCHES.values())
        run()
        probe_launches[rec["name"]] = sum(cuda_probes.LAUNCHES.values()) - before
    torch.cuda.synchronize()
    probe_counts = read_counts()
    if sum(probe_counts["probes"].values()) != len(probe_runs):
        raise AssertionError(f"probes launched {probe_counts['probes']}")
    rates = {}
    for rec in probe_checks:
        keys = (("ms", "long_ms", "G_element_ops_per_s", "above_instruction_limit")
                if "long_ms" in rec
                else ("ms", "library_ms", "ms_reps", "reps", "TOPs"))
        rates[rec["name"]] = {kk: rec[kk] for kk in keys}
    emit({"phase": "probes", "equal_plain": True, "p3_exact_against_numpy": True,
          "launches": probe_counts["probes"], "long_factor": LONG,
          "instruction_limit_G_per_s": instruction_limit / 1e9, "max_sm_clock_mhz": max_clock_mhz,
          "rates": rates})
    del x, c, y, m, mu, x8, t8, xp8, tTp8, xf, tf, want3, probe_runs

    # -- serialization ---------------------------------------------------------------------------
    t0 = time.perf_counter()
    skey = ptorch.generate_keypair(key_bits, enable_DJN=True)
    spk, ssk = skey.pub_key, skey.priv_key
    Bs = 256
    vals_s = [rng.getrandbits(64) for _ in range(Bs)]
    cts = spk.encrypt(ptorch.PlainText(vals_s))
    if cts._texts is not None or not cts.device_payload().arr.is_cuda:
        raise AssertionError("serialize: the ciphertext batch is not device-resident")
    blob_pk, blob_sk, blob_ct = ser.dumps(spk), ser.dumps(ssk), ser.dumps(cts)
    pk2 = ser.loads(blob_pk, ptorch.PublicKey)
    sk2 = ser.loads(blob_sk, ptorch.PrivateKey)
    ct2 = ser.loads(blob_ct, ptorch.CipherText)
    if (pk2.n, pk2.hs, pk2.randbits, pk2.bits) != (spk.n, spk.hs, spk.randbits, spk.bits):
        raise AssertionError("serialize: the public key changed")
    if (sk2.p, sk2.q) != (ssk.p, ssk.q) or ct2.public_key.n != spk.n:
        raise AssertionError("serialize: the private key or the ciphertext's key changed")
    if ser.dumps(pk2) != blob_pk or ser.dumps(ct2) != blob_ct:
        raise AssertionError("serialize: bytes differ after a round trip")
    if sk2.decrypt(ct2).texts != vals_s or ssk.decrypt(pk2.encrypt(
            ptorch.PlainText(vals_s))).texts != vals_s:
        raise AssertionError("serialize: loaded keys or ciphertexts decrypt wrong")
    if sk2._engine.device.type != "cuda" or pk2._engine.device.type != "cuda":
        raise AssertionError("serialize: loaded keys do not run on the card")
    emit({"phase": "serialize", "key_bits": key_bits, "batch": Bs,
          "bytes": {"public_key": len(blob_pk), "private_key": len(blob_sk),
                    "ciphertext": len(blob_ct)},
          "roundtrip_ok": True, "seconds": round(time.perf_counter() - t0, 3)})

    probe_counts["probe_runs"] = probe_launches
    path_counts = {"main": main_counts, "homo": homo_counts, "cios": cios_counts,
                   "wide": wide_counts, "wide3072": wide3_counts,
                   "probes": probe_counts}
    for c in checks:
        path, grp, name = c.pop("_count")
        c["launches"] = path_counts[path][grp][name]
        if c["launches"] < 1:
            raise AssertionError(f"{c['name']} was launched no time on its path")
    emit({"kernels": checks})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
