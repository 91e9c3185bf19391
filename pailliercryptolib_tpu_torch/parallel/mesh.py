"""Multi-device execution: the batch axis split across a list of devices.

Counterpart of the JAX package's ``parallel/mesh.py``.  The reference has
no distributed backend (SURVEY.md §2.5); batched modexp is embarrassingly
parallel, so the design is pure data parallelism: the ciphertext batch is
cut into contiguous blocks of rows, one a mesh entry, and every entry runs
the same pipeline or kernel wrapper on its rows on its own device.  The only
communication is input distribution and the gather of the results.

A mesh is a :class:`DeviceMesh`: a list of ``torch.device``s, one an entry,
in the order of the batch axis.  An entry may repeat a device (``[cuda:0,
cuda:0]`` splits a batch on one card, which is overhead and nothing else,
and the only way one card shows the sharded path).  Where the mesh spans the
processes of a ``torch.distributed`` group (parallel/context.py), each
process owns a contiguous block of entries (``local``) and runs only those;
an entry's device is a device of the process that owns it.

Where JAX places an array "batch-sharded" on a mesh, the functions here
take and return a list with one tensor an entry (None for an entry of
another process): :func:`shard_batch` makes one, :func:`gather` joins one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import paillier_ops as pops

#: The batch tile the reference pads every kernel-backend batch to
#: (``BATCH_TILE`` of its Pallas kernels).  The port pads nothing, but cuts a
#: batch at the boundaries the reference's padding gives (:func:`batch_bounds`),
#: so that equal seed rows give equal ciphertexts in both packages.
BATCH_TILE = 128


class DeviceMesh(list):
    """A mesh: one ``torch.device`` an entry, in row-major order of
    ``shape`` (``(n,)`` over ``("batch",)``, or ``(2, n / 2)`` over
    ``("crt", "batch")``).  ``local`` is the range of entries this process
    runs: all of them, unless the mesh spans processes."""

    def __init__(self, devices, local: Optional[range] = None,
                 axis_names: Tuple[str, ...] = ("batch",), shape=None):
        super().__init__(devices)
        self.local = range(len(self)) if local is None else local
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (len(self),)

    @property
    def spans_processes(self) -> bool:
        return len(self.local) != len(self)


def _resolve(device) -> torch.device:
    from ..models.engine import resolve_device

    return resolve_device(device)


def local_devices(device="cuda", count: Optional[int] = None) -> List[torch.device]:
    """The devices of this process for a mesh of ``count`` entries: the CUDA
    devices in index order (all of them by default), or ``count`` entries of
    the CPU (one by default).  More entries than CUDA devices raise: list a
    repeated device explicitly instead."""
    dev = _resolve(device)
    if dev.type == "cpu":
        return [dev] * (1 if count is None else count)
    avail = torch.cuda.device_count()
    count = avail if count is None else count
    if count > avail:
        raise ValueError(
            f"{count} mesh entries asked for, {avail} CUDA devices here; pass "
            "the devices explicitly (e.g. devices=['cuda:0', 'cuda:0']) to "
            "repeat one"
        )
    return [torch.device("cuda", i) for i in range(count)]


def as_mesh(mesh) -> DeviceMesh:
    """A DeviceMesh (returned as it is), or a list of devices / device names
    as a 1-D DeviceMesh."""
    if isinstance(mesh, DeviceMesh):
        return mesh
    return DeviceMesh([_resolve(d) for d in mesh])


def make_mesh(
    n_devices: Optional[int] = None, *, crt_axis: bool = False, device="cuda"
) -> DeviceMesh:
    """1-D ``("batch",)`` mesh of ``n_devices`` entries, or 2-D
    ``("crt": 2, "batch": n / 2)`` when ``crt_axis``.  A 2-D mesh splits the
    batch over all its entries (the reference's ``P(("crt", "batch"))``)."""
    devs = local_devices(device, n_devices)
    if crt_axis:
        if len(devs) % 2:
            raise ValueError("crt_axis mesh needs an even device count")
        return DeviceMesh(devs, axis_names=("crt", "batch"),
                          shape=(2, len(devs) // 2))
    return DeviceMesh(devs)


def batch_bounds(size: int, nshards: int, backend: str) -> List[Tuple[int, int]]:
    """Rows ``[lo, hi)`` of each of ``nshards`` entries for a ``size``-row
    batch: the reference's padded shard boundaries, cut to the live rows.

    The reference pads the batch to Bp rows before it shards it: on the
    kernel backends to a multiple of ``BATCH_TILE * nshards``, on the plain
    one (its ``"xla"``) to the next power of two, rounded up to a multiple of
    ``nshards`` (its ``_pad_batch``); entry i holds rows [i Bp / S,
    (i + 1) Bp / S).  Entries past the live rows are empty (lo == hi)."""
    if backend != "plain":
        tile = BATCH_TILE * nshards
        padded = -(-size // tile) * tile
    else:
        padded = 1 << max(0, (size - 1).bit_length())
        padded = -(-padded // nshards) * nshards
    per = padded // nshards
    return [(min(i * per, size), min((i + 1) * per, size)) for i in range(nshards)]


def even_bounds(size: int, nshards: int) -> List[Tuple[int, int]]:
    """Contiguous blocks of ceil(size / nshards) rows (the last ones may be
    short or empty): the split of :func:`shard_batch`."""
    per = -(-size // nshards)
    return [(min(i * per, size), min((i + 1) * per, size)) for i in range(nshards)]


def shard_batch(arr, mesh, axis: int = 0) -> List[Optional[torch.Tensor]]:
    """Place a [B, ...] array with its batch axis split over the mesh's
    entries (input distribution): one tensor an entry on its device, None
    for an entry of another process."""
    mesh = as_mesh(mesh)
    t = torch.as_tensor(arr)
    bounds = even_bounds(t.shape[axis], len(mesh))
    return [
        t.narrow(axis, lo, hi - lo).to(mesh[i]) if i in mesh.local else None
        for i, (lo, hi) in enumerate(bounds)
    ]


def shard_batch_middle(arr, mesh) -> List[Optional[torch.Tensor]]:
    """Place a [G, B, ...] array with axis 1 split over the mesh's entries."""
    return shard_batch(arr, mesh, axis=1)


def gather(parts: Sequence[Optional[torch.Tensor]], device=None, axis: int = 0):
    """Join the parts of this process (a single-process mesh: all of them)
    along ``axis`` on ``device`` (default: the first part's)."""
    parts = [p for p in parts if p is not None and p.shape[axis] > 0]
    dev = parts[0].device if device is None else device
    return torch.cat([p.to(dev) for p in parts], dim=axis)


def _replicate(obj, dev):
    """``obj`` with every tensor in it (dicts, tuples and lists walked) on
    ``dev``; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _replicate(v, dev) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replicate(v, dev) for v in obj)
    return obj


def shard_stage(mesh, fn, data_argnums, **kwargs):
    """Run a pipeline stage entry by entry over the mesh.

    The arguments listed in ``data_argnums`` are [B, ...] batches: a list
    of one tensor an entry (:func:`shard_batch`), or a whole tensor, which is
    split here; everything else (scalars, constant tensors, constant dicts)
    is replicated to each entry's device.  Returns one result an entry (None
    for an entry of another process or one with no rows), so chained stages
    never gather.  A shard's launches are exactly the unsharded stage's on
    its rows."""
    mesh = as_mesh(mesh)
    data_argnums = frozenset(data_argnums)

    def call(*args):
        args = [
            shard_batch(a, mesh) if i in data_argnums and isinstance(a, torch.Tensor)
            else a
            for i, a in enumerate(args)
        ]
        out = [None] * len(mesh)
        consts = {}
        for i in mesh.local:
            if any(args[j][i] is None or args[j][i].shape[0] == 0 for j in data_argnums):
                continue
            dev = mesh[i]
            if dev not in consts:
                consts[dev] = [
                    None if j in data_argnums else _replicate(a, dev)
                    for j, a in enumerate(args)
                ]
            call_args = [
                args[j][i] if j in data_argnums else consts[dev][j]
                for j in range(len(args))
            ]
            out[i] = fn(*call_args, **kwargs)
        return out

    return call


def sharded_encrypt_djn(mesh, backend: str):
    """DJN encrypt (ops/paillier_ops.encrypt_djn_op on ``"cios"`` or
    ``"plain"``) with the batch split over the mesh: arguments (m, r_wins,
    n_limbs, n2_n, n2_n0inv, n2_r2, n2_one, hs), m and r_wins batched."""
    return shard_stage(mesh, pops.encrypt_djn_op, (0, 1), backend=backend)


def sharded_decrypt_crt(mesh, backend: str):
    """CRT decrypt (ops/paillier_ops.decrypt_crt_op on ``"cios"`` or
    ``"plain"``) with the ciphertext batch split over a ``("batch",)`` or a
    ``("crt", "batch")`` mesh; on a 2-D mesh the batch is split over all its
    entries, as in the reference.  Arguments as decrypt_crt_op's, ct
    batched."""
    return shard_stage(mesh, pops.decrypt_crt_op, (0,), backend=backend)


def sharded_rns_modexp(mesh, consts: dict, *, shared: bool = False):
    """K5 (ops/cuda_rns2.rns_modexp2) over [G, B, L] limbs with B split over
    the mesh: ``fn(x, wins, consts)`` with x (and wins, unless ``shared``)
    from :func:`shard_batch_middle` or whole; returns one [G, b, 2k + 1]
    residue tensor an entry.  The constants are replicated once a device."""
    from ..ops.cuda_rns2 import rns_modexp2

    mesh = as_mesh(mesh)
    per_dev = {}

    def fn(x, wins, consts_=consts):
        if isinstance(x, torch.Tensor):
            x = shard_batch_middle(x, mesh)
        if not shared and isinstance(wins, torch.Tensor):
            wins = shard_batch_middle(wins, mesh)
        out = [None] * len(mesh)
        for i in mesh.local:
            if x[i] is None or x[i].shape[1] == 0:
                continue
            dev = mesh[i]
            if (dev, id(consts_)) not in per_dev:
                per_dev[(dev, id(consts_))] = _replicate(consts_, dev)
            w = _replicate(wins, dev) if shared else wins[i]
            out[i] = rns_modexp2(x[i], w, per_dev[(dev, id(consts_))], shared=shared)
        return out

    return fn
