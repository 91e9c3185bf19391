"""Runtime context: device discovery, mesh setup, backend selection.

Counterpart of the JAX package's ``parallel/context.py``, the analog of
``ipcl::initializeContext("CPU"/"QAT"/"HYBRID")`` (ipcl/utils/context.cpp:
16-44): where the reference brings up the QAT device runtime, the port
optionally joins a ``torch.distributed`` process group (gloo), builds a 1-D
mesh of devices over the ciphertext batch axis (parallel/mesh.DeviceMesh)
and records the compute backend of the engines made afterwards.  Engines
made while a context with two or more mesh entries is live split every
batch over them (models/engine.py); without a context nothing changes.
``terminate_context`` drops the context (and the process group it made).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .mesh import DeviceMesh, local_devices


@dataclasses.dataclass
class PaillierContext:
    choice: str
    mesh: Optional[DeviceMesh]
    backend: str  # "rns" | "cios" | "plain"
    initialized: bool = True


_CONTEXT: Optional[PaillierContext] = None
_OWNS_GROUP = False

_VALID = ("DEFAULT", "CPU", "TPU", "MESH", "HYBRID", "QAT")


def initialize_context(
    choice: str = "DEFAULT",
    *,
    distributed: bool = False,
    mesh_devices: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    devices: Optional[Sequence] = None,
) -> PaillierContext:
    """Bring up the runtime.

    choice:
      - "DEFAULT" / "TPU": the backend of ops/dispatch.default_backend
        (config, ``PAILLIER_TORCH_BACKEND``, else ``"rns"``).
      - "CPU": force the plain PyTorch backend (the reference's CPU path).
      - "MESH" / "HYBRID" / "QAT": accepted for API parity with the
        reference's string map (ipcl/utils/context.cpp:16-21); they behave
        as "DEFAULT".
    The mesh: ``devices`` (an explicit list, which may repeat a device:
    ``["cuda:0", "cuda:0"]``), else the local devices of ``device`` —
    every CUDA device (a count above theirs raises), or for ``"cpu"``
    ``mesh_devices`` entries of the CPU — cut to ``mesh_devices``.
    distributed: join the gloo process group at
    ``tcp://coordinator_address`` as ``process_id`` of ``num_processes``
    (unless one is already initialized); the mesh then spans every
    process's entries, each process owning a contiguous block, and the
    public APIs split batches across processes.  Idempotent: a live context
    is returned as it is.
    """
    global _CONTEXT, _OWNS_GROUP
    choice = choice.upper()
    if choice not in _VALID:
        raise ValueError(f"initializeContext: unknown choice {choice!r}")
    if _CONTEXT is not None and _CONTEXT.initialized:
        return _CONTEXT  # idempotent, like isUsingQAT (context.cpp:30-38)
    if devices is not None:
        from .mesh import as_mesh

        local = list(as_mesh(devices))
        if mesh_devices is not None:
            if mesh_devices > len(local):
                raise ValueError(
                    f"{mesh_devices} mesh entries asked for, {len(local)} devices given"
                )
            local = local[:mesh_devices]
    else:
        local = local_devices(device, mesh_devices)
    if distributed:
        import torch.distributed as dist

        if not dist.is_initialized():
            if None in (coordinator_address, num_processes, process_id):
                raise ValueError(
                    "distributed=True needs coordinator_address, num_processes "
                    "and process_id"
                )
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
            )
            _OWNS_GROUP = True
        world, rank = dist.get_world_size(), dist.get_rank()
        lists = [None] * world
        dist.all_gather_object(lists, [str(d) for d in local])
        if len({len(x) for x in lists}) != 1:
            raise ValueError("every process must bring the same number of mesh entries")
        k = len(local)
        mesh = DeviceMesh(
            [torch.device(d) for x in lists for d in x],
            local=range(rank * k, (rank + 1) * k),
        )
    else:
        mesh = DeviceMesh(local)
    if choice == "CPU":
        backend = "plain"  # force the fallback, like initializeContext("CPU")
    else:
        from ..ops.dispatch import default_backend

        backend = default_backend()
    _CONTEXT = PaillierContext(choice=choice, mesh=mesh, backend=backend)
    return _CONTEXT


def get_context() -> PaillierContext:
    if _CONTEXT is None:
        return initialize_context()
    return _CONTEXT


def peek_context() -> Optional[PaillierContext]:
    """The live context if initialize_context ran, else None (engines use
    this: a context must be opted into, never auto-created)."""
    return _CONTEXT


def terminate_context() -> None:
    global _CONTEXT, _OWNS_GROUP
    _CONTEXT = None
    if _OWNS_GROUP:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _OWNS_GROUP = False


def is_running() -> bool:
    return _CONTEXT is not None
