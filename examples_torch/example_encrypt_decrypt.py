"""Encrypt/decrypt walkthrough on the PyTorch/CUDA port
(reference: example/example_encrypt_decrypt.cpp).

Generates a DJN keypair, encrypts 8 plaintexts, decrypts, verifies.

    python examples_torch/example_encrypt_decrypt.py [--device cuda|cpu] [--bits 1024]
"""

import argparse

import pailliercryptolib_tpu_torch as ptorch


def main(device="cuda", bits=1024):
    key = ptorch.generate_keypair(bits, enable_DJN=True, device=device)
    values = [11, 22, 33, 44, 55, 66, 77, 88]
    pt = ptorch.PlainText(values)
    ct = key.pub_key.encrypt(pt)
    dt = key.priv_key.decrypt(ct)
    assert dt.texts == values
    print("encrypt/decrypt roundtrip OK:", dt.texts)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bits", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.bits)
