"""Key/ciphertext persistence on the PyTorch/CUDA port
(reference: test/test_serialization.cpp usage).

    python examples_torch/example_serialization.py [--device cuda|cpu] [--bits 1024]
"""

import argparse

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.utils import serialize as ser


def main(device="cuda", bits=1024):
    key = ptorch.generate_keypair(bits, enable_DJN=True, device=device)
    ct = key.pub_key.encrypt(ptorch.PlainText([42, 43]))

    blob_pk = ser.dumps(key.pub_key)
    blob_sk = ser.dumps(key.priv_key)
    blob_ct = ser.dumps(ct)
    print(f"pk {len(blob_pk)}B  sk {len(blob_sk)}B  ct {len(blob_ct)}B")

    pk2 = ser.loads(blob_pk, ptorch.PublicKey, device=device)
    sk2 = ser.loads(blob_sk, ptorch.PrivateKey, device=device)
    ct2 = ser.loads(blob_ct, ptorch.CipherText, device=device)
    assert pk2.n == key.pub_key.n
    assert sk2.decrypt(ct2).texts == [42, 43]
    print("serialization roundtrip OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bits", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.bits)
