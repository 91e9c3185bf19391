"""Homomorphic add/mul walkthrough on the PyTorch/CUDA port
(reference: example/example_add_mul.cpp).

    python examples_torch/example_add_mul.py [--device cuda|cpu] [--bits 1024]
"""

import argparse

import pailliercryptolib_tpu_torch as ptorch


def main(device="cuda", bits=1024):
    key = ptorch.generate_keypair(bits, enable_DJN=True, device=device)
    a, b = [10, 20, 30, 40], [5, 6, 7, 8]
    ct_a = key.pub_key.encrypt(ptorch.PlainText(a))
    ct_b = key.pub_key.encrypt(ptorch.PlainText(b))

    sum_ct = ct_a + ct_b                        # CT + CT
    sum_pt = ct_a + ptorch.PlainText(b)         # CT + PT
    prod = ct_a * ptorch.PlainText(b)           # CT * PT
    combo = ct_a + ct_b * ptorch.PlainText(3)   # a + 3b

    dec = key.priv_key.decrypt
    assert dec(sum_ct).texts == [x + y for x, y in zip(a, b)]
    assert dec(sum_pt).texts == [x + y for x, y in zip(a, b)]
    assert dec(prod).texts == [x * y for x, y in zip(a, b)]
    assert dec(combo).texts == [x + 3 * y for x, y in zip(a, b)]
    print("homomorphic add/mul OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bits", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.bits)
