"""Backend choice + hybrid-split walkthrough on the PyTorch/CUDA port
(reference: example/example_hybridmode.cpp).

The port has three backends: ``"rns"`` (the default: the residue-number-
system kernels), ``"cios"`` (the Montgomery-limb kernels) and ``"plain"``
(plain PyTorch).  Where the reference splits a modexp vector between QAT
and AVX512 by a tunable ratio (ipcl/mod_exp.cpp:688-732), the port splits
each batch between the engine's kernel backend and ``"plain"`` with the
same policy API (set_hybrid_mode / set_hybrid_ratio / set_hybrid_off) —
and, like the reference, the OPTIMAL default routes everything to the
kernel backend.

    python examples_torch/example_backends.py [--device cuda|cpu] [--bits 1024]
"""

import argparse
import time

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.ops.dispatch import default_backend
from pailliercryptolib_tpu_torch.utils.config import Config, get_config, set_config


def time_encrypt(pk, pt, label, warm=True):
    if warm:  # kernel build at first use, per-key constants
        pk.encrypt(pt).block_until_ready()
    t = time.perf_counter()
    ct = pk.encrypt(pt)
    ct.block_until_ready()
    print(f"{label:>16}: {(time.perf_counter() - t) * 1000:7.1f} ms / {len(pt)} encrypts")
    return ct


def main(device="cuda", bits=1024, batch=256):
    print("default backend:", default_backend())
    key = ptorch.generate_keypair(bits, enable_DJN=True, device=device)
    pub, prv = key.pub_key, key.priv_key
    pt = ptorch.PlainText(list(range(1, batch + 1)))

    # each backend by name: keys whose engines are made under the config
    saved = get_config()
    try:
        for backend in ("rns", "cios", "plain"):
            set_config(Config(backend=backend))
            pk = ptorch.PublicKey(pub.n, bits, hs=pub.hs, randbits=pub.randbits,
                                  device=device)
            sk = ptorch.PrivateKey(pk, prv.p, prv.q)
            # plain PyTorch has nothing to build, and on a GPU it is thousands
            # of small launches a product: timed once, cold
            ct = time_encrypt(pk, pt, backend, warm=backend != "plain")
            assert pk._engine.backend == backend
            assert sk.decrypt(ct).texts == pt.texts
            assert prv.decrypt(ptorch.CipherText(pub, ct.texts)).texts == pt.texts
    finally:
        set_config(saved)

    # OPTIMAL (default): the whole batch on the kernel backend
    ct = time_encrypt(pub, pt, "OPTIMAL")
    assert prv.decrypt(ct).texts == pt.texts

    # a manual 75/25 split: head on the kernel pipeline, tail on plain
    # PyTorch (the reference's QAT-head / IPP-tail split)
    ptorch.set_hybrid_ratio(0.75)
    try:
        ct = time_encrypt(pub, pt, "ratio 0.75", warm=False)
        assert prv.decrypt(ct).texts == pt.texts

        # everything on the plain fallback (the reference's HybridMode::IPP)
        ptorch.set_hybrid_mode(ptorch.HybridMode.XLA)
        ct = time_encrypt(pub, pt, "HybridMode.XLA", warm=False)
        assert prv.decrypt(ct).texts == pt.texts
    finally:
        ptorch.set_hybrid_off()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bits", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.bits)
