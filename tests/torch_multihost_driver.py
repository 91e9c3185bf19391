"""Two-process driver of the PyTorch/CUDA port's mesh over gloo (launched by
tests/test_torch_multihost.py; imports no JAX).

Each process brings two CPU entries; the global mesh spans four, process i
owning entries 2i and 2i + 1.  The flow goes through the public API:
initialize_context(distributed=True) -> PublicKey.encrypt ->
PrivateKey.decrypt, with a key from fixed primes and injected obfuscator
exponents, so the split ciphertexts are checked bit for bit against host
pow(): exact equality with what one process computes.  Counterpart of
tests/multihost_driver.py.

    python tests/torch_multihost_driver.py PROCESS_ID NUM_PROCESSES PORT
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import torch  # noqa: E402

import pailliercryptolib_tpu_torch as ptorch  # noqa: E402
from pailliercryptolib_tpu_torch.parallel import context as pctx  # noqa: E402

torch.set_num_threads(1)
ctx = pctx.initialize_context(
    "CPU",
    distributed=True,
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
    device="cpu",
    mesh_devices=2,
)
assert len(ctx.mesh) == 2 * nproc and ctx.mesh.spans_processes
assert list(ctx.mesh.local) == [2 * pid, 2 * pid + 1], ctx.mesh.local

# deterministic DJN key from fixed primes (identical on every process)
P_ = 232599217864819576116843431118455220359  # 128-bit primes
Q_ = 336405090652084295268975770772500216531
n = P_ * Q_
n2 = n * n
h = (-(2 * 2)) % n  # DJN h with rmod = 2
hs = pow(h, n, n2)
pk = ptorch.PublicKey(n, n.bit_length(), hs=hs, randbits=n.bit_length() // 2,
                      device="cpu")
sk = ptorch.PrivateKey(pk, P_, Q_)
assert pk._engine.mesh is ctx.mesh and pk._engine.backend == "plain"

B = 16
vals = [1000003 * (i + 1) for i in range(B)]
rs = [(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 120) for i in range(B)]
expect = [(n * m + 1) * pow(hs, r, n2) % n2 for m, r in zip(vals, rs)]

# "plain": the rows spread 4 an entry; this process computes its own only
pk.set_random(list(rs))
ct = pk.encrypt(ptorch.PlainText(vals))
payload = ct.device_payload()
mine = [i for i, p in enumerate(payload.parts) if p is not None]
assert mine == [2 * pid, 2 * pid + 1], mine
assert all(payload.parts[i].size == 4 for i in mine)
assert ct.texts == expect, "split ciphertext != host pow() reference"
assert sk.decrypt(ct).texts == vals, "roundtrip mismatch"
s = ct + ct
assert sk.decrypt(s).texts == [2 * v for v in vals]

# "rns": the reference's padding puts all 16 rows in entry 0 (process 0)
for e in (pk._engine, sk._engine):
    e.backend = "rns"
pk.set_random(list(rs))
ct = pk.encrypt(ptorch.PlainText(vals))
mine = [i for i, p in enumerate(ct.device_payload().parts) if p is not None]
assert mine == ([0] if pid == 0 else []), mine
assert ct.texts == expect
assert sk.decrypt(ct + ct).texts == [2 * v for v in vals]

pctx.terminate_context()
print(f"TORCH_MULTIHOST_OK pid={pid}", flush=True)
