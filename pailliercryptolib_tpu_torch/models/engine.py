"""Per-key device engines: codec + pipeline dispatch on one torch device.

Counterpart of the JAX package's ``models/engine.py``, for keys up to 4096
bits: DJN and normal-mode encrypt, apply_obfuscator, encrypt without
obfuscation, CT+CT, CT*PT, CRT and RAW decrypt, each on three backends
(ops/dispatch.py): ``"rns"`` (the default: the residue-number-system
kernels), ``"cios"`` (the 15-bit-limb Montgomery kernels, a complete second
implementation) and ``"plain"`` (plain PyTorch on the engine's device, only
when asked for by name or for the tail of a hybrid batch split).  The
backend of an engine is its ``backend=`` argument, else the live runtime
context's (parallel/context.py), else the runtime config /
``PAILLIER_TORCH_BACKEND``, else ``"rns"``; the attribute ``backend`` may be
set later.  The engine owns the precomputed device constants of one key (the analog of the per-key
state the reference precomputes in its PublicKey/PrivateKey constructors,
ipcl/pub_key.cpp:18-49 and ipcl/pri_key.cpp:13-37) and converts between host
Python ints and fixed-shape limb tensors around every batched call.

Every engine takes an explicit ``device`` (default ``"cuda"``).  With the
default and no GPU the constructor raises; nothing carries on on the CPU
unless the caller asked for ``device="cpu"`` (as the tests do), where the
kernels' plain versions run.  Batches are not padded: the kernels mask
their ragged last row tile themselves, so the reference's ``_pad_batch`` and
the re-padding of a hybrid split's result have no counterpart here.

The hybrid batch split (ops/dispatch.py: ``set_hybrid_mode`` /
``set_hybrid_ratio``) runs the head rows of a host-side batch on the
engine's own backend and the tail rows on a ``"plain"`` twin engine, and
concatenates on the device.  Under the defaults nothing is split and the
twin is never built.

Keys wider than 2048 bits run through the same entry points: their n^2
allocates moduli below 2^13, so its constant sets take the f32-reciprocal
reduction with the full fold on up to 640 lanes, and their CRT decrypt takes
the grouped layout (one residue system a group of the generic modexp kernel)
where narrower keys take the folded one — the reference's rule.  Keys above
4096 bits raise ``ValueError``, as in the reference's key generator.

**Mesh split.**  An engine given ``mesh=`` (a list of devices), or made while
a runtime context with a mesh is live (``initialize_context``), splits every
batch over the mesh's entries when it has two or more: each entry runs the
unsharded pipeline on a contiguous block of rows on its device, through the
engine's twin there (one a distinct device, holding the per-key constants,
K1's table included), and the result is a :class:`ShardedLimbs` whose parts
stay where they were computed; chained operations run part by part and only
``fetch`` gathers (across processes, by an all-gather over gloo).  The rows
are cut at the reference's padded shard boundaries (parallel/mesh.batch_bounds)
and entry i expands seed row i of :meth:`PublicEngine._seed_rows`, so equal
seed rows give the reference's ciphertexts.  A repeated device (``[cuda:0,
cuda:0]``) is allowed: on one card it only adds overhead.

**CUDA graphs.**  On a CUDA device the device part of three calls on the
``"rns"`` backend runs through the engine's ops/graphs.GraphCache: the normal
and the DJN encrypt with a DeviceSeed, and the CRT decrypt.  The first such
call on a stream with given operand shapes runs eagerly, the second is
captured, later ones replay the graph, so that the host enqueues the call's
kernels in one launch and does not wait for the device.
Every other call, and every call on the CPU, runs eagerly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import paillier_ops as pops
from ..ops.cuda_rns2 import (
    FB_WINDOW_BITS,
    fold_group_consts2,
    stack_group_consts2,
)
from ..ops.dispatch import check_backend, default_backend, hybrid_head_count
from ..ops.graphs import GraphCache
from ..ops.limbs import (
    LIMB_BITS,
    ints_to_bytes_le,
    ints_to_limbs,
    ints_to_windows,
    limbs_for_bits,
    limbs_to_ints,
    max_bitlength,
    num_windows,
    pack_pairs_np,
    unpack_pairs_np,
)
from ..ops.montgomery import MontConstants, to_i32
from ..ops.rns import RNSContext, rns_supported
from ..parallel.context import peek_context
from ..parallel.mesh import as_mesh, batch_bounds
from ..utils import rng as _rng
from ..utils import trace
from ..utils.rng import DeviceSeed

#: Widest key (the reference's N_BIT_SIZE_MAX): one residue system of its n^2
#: is 640 lanes, a thread block of the wide kernel instances; its n^2 is 547
#: limbs, the widest operand of the CIOS kernels.
MAX_KEY_BITS = 4096
#: Lanes up to which the (p^2, q^2) pair of a CRT decrypt lies folded side by
#: side (2k + 2 of them); wider pairs run grouped.  The reference's rule, kept
#: so that outputs and launch counts are the reference's.
FOLDED_MAX_LANES = 384


def resolve_device(device) -> torch.device:
    """The device an engine runs on.  A CUDA device that is not there is an
    error, never a reason to carry on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class DevLimbs:
    """A device-resident batch of canonical 15-bit limbs [B, L] (int32) plus
    the live batch size.

    Every engine op accepts and returns DevLimbs, so chained pipelines stay
    on the device; the host list-of-ints view materializes lazily (one
    packed download) only when ``.texts`` is read.  ``call`` is the call id
    of the engine call that made it (utils/trace.py; 0 unless recording), so
    that the spans of its ``fetch`` share it."""

    __slots__ = ("arr", "size", "call")

    def __init__(self, arr: torch.Tensor, size: int, call: int = 0):
        self.arr = arr
        self.size = size
        self.call = call

    def fetch(self) -> List[int]:
        with trace.span("api.fetch", call=self.call, rows=self.size):
            packed_np = _download(self.arr[: self.size])
            with trace.span("api.codec_out"):
                return limbs_to_ints(unpack_pairs_np(packed_np, self.arr.shape[-1]))

    def sync(self) -> None:
        """Block until the producing computation completed on the device."""
        if self.arr.device.type == "cuda":
            torch.cuda.synchronize(self.arr.device)


def _download(arr: torch.Tensor) -> np.ndarray:
    """Canonical limbs on the device -> packed uint32 words on the host.  The
    wait for the current stream is made apart from the copy, which makes the
    same wait, so that the two are timed apart."""
    with trace.span("api.pack_out"):
        packed = pops.pack_out_op(arr)
    if packed.device.type == "cuda":
        with trace.span("api.wait"):
            torch.cuda.current_stream(packed.device).synchronize()
    with trace.span("api.download"):
        return packed.cpu().numpy().astype(np.uint32)


def sync_device(dev: DevLimbs) -> None:
    """Wait until ``dev`` (a DevLimbs or ShardedLimbs) is computed: the JAX
    package's ``sync_device`` (``models/engine.py:130``)."""
    dev.sync()


class ShardedLimbs(DevLimbs):
    """A batch split over the entries of a mesh (parallel/mesh.DeviceMesh):
    ``parts[i]`` is a DevLimbs of rows ``bounds[i]`` on entry i's device,
    None where the entry has no rows or belongs to another process; ``arr``
    is None.  Chained engine operations run part by part without gathering;
    only :meth:`fetch` (and an engine without this mesh) gathers."""

    __slots__ = ("parts", "bounds", "mesh")

    def __init__(self, parts, bounds, size: int, mesh):
        super().__init__(None, size)
        self.parts, self.bounds, self.mesh = parts, bounds, mesh

    def fetch(self) -> List[int]:
        """Every row as host ints.  Where the mesh spans processes, every
        process calls this together: the parts are all-gathered (the
        reference's ``process_allgather``)."""
        with trace.span("api.fetch", call=self.call, rows=self.size):
            mine = {
                i: (_download(p.arr[: p.size]), p.arr.shape[-1])
                for i, p in enumerate(self.parts) if p is not None
            }
            if self.mesh.spans_processes:
                import torch.distributed as dist

                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, mine)
                mine = {i: v for d in every for i, v in d.items()}
            width = next(iter(mine.values()))[1]
            with trace.span("api.codec_out"):
                packed = np.concatenate([mine[i][0] for i in sorted(mine)])
                return limbs_to_ints(unpack_pairs_np(packed, width))

    def sync(self) -> None:
        for p in self.parts:
            if p is not None:
                p.sync()

    def gather(self, device):
        """The rows joined on ``device`` as one DevLimbs; host ints where
        parts lie in other processes."""
        if self.mesh.spans_processes:
            return self.fetch()
        parts = [p.arr[: p.size].to(device) for p in self.parts if p is not None]
        return DevLimbs(torch.cat(parts), self.size)


def _same_mesh(a, b) -> bool:
    return a is b or (list(a) == list(b) and a.local == b.local)


def _part(o, i: int, lo: int, hi: int, size: int, dev, seed_rows):
    """Operand ``o`` of a ``size``-row operation, cut to entry i's rows
    [lo, hi) on ``dev``: a seed row, a part, a row slice, or a size-1
    operand shared by every row (a scalar plaintext, a size-1 ciphertext)."""
    if seed_rows is not None:
        return DeviceSeed(np.asarray(seed_rows[i]))
    if isinstance(o, ShardedLimbs):
        return o.parts[i]
    if isinstance(o, DevLimbs):
        arr = o.arr[:1] if o.size == 1 and size > 1 else o.arr[lo:hi]
        return DevLimbs(arr.to(dev), arr.shape[0])
    if isinstance(o, np.ndarray):
        return o[lo:hi]
    o = list(o)
    return o if len(o) == 1 and size > 1 else o[lo:hi]


def _ct_operand(ct, width: int, device):
    """CipherText operand (DevLimbs or int list) -> ([B, width] int32
    tensor on ``device``, size).  A payload split over a mesh is gathered."""
    if isinstance(ct, ShardedLimbs):
        ct = ct.gather(device)
    if isinstance(ct, DevLimbs):
        arr, size = ct.arr, ct.size
        if arr.device != device:
            raise ValueError(
                f"ciphertext lies on {arr.device}, the key's engine on {device}"
            )
        pad = width - arr.shape[-1]
        if pad < 0:
            raise ValueError("ciphertext limbs wider than the operation expects")
        if pad > 0:
            zeros = torch.zeros(
                arr.shape[:-1] + (pad,), dtype=arr.dtype, device=arr.device
            )
            arr = torch.cat([arr, zeros], dim=-1)
        return arr[:size].contiguous(), size
    # host ints -> device canonical limbs via a packed upload
    with trace.span("api.codec_in"):
        packed = pack_pairs_np(ints_to_limbs(list(ct), width))
    with trace.span("api.upload"):
        return pops.unpack_in_op(to_i32(packed, device), width), len(ct)


def _payload_size(ct) -> int:
    return ct.size if isinstance(ct, DevLimbs) else len(ct)


def _round_windows(nw: int) -> int:
    """Round a window count up to a multiple of 8 (as the reference does,
    so window arrays of the two packages have the same shape)."""
    return max(8, -(-nw // 8) * 8)


def _check_key_bits(nbits: int) -> None:
    if nbits > MAX_KEY_BITS:
        raise ValueError(
            f"{nbits}-bit key: key size exceeds supported range "
            f"({MAX_KEY_BITS} bits)"
        )


def _resolve_backend(backend: Optional[str]) -> str:
    """Explicit choice > runtime context (initialize_context) > runtime
    config / environment > ``"rns"``.  The context hook is the reference's
    initializeContext("CPU"/"QAT") switch (ipcl/utils/context.cpp:16-44): a
    context initialized with "CPU" forces ``"plain"`` on engines made
    afterwards."""
    if backend:
        return check_backend(backend)
    ctx = peek_context()
    if ctx is not None:
        return ctx.backend
    return default_backend()


def _resolve_mesh(mesh, device: torch.device):
    """The engine's mesh: an explicit ``mesh`` (a list of devices; an empty
    one for none) over the live context's; used from two entries up, else
    None.  Its entries must be devices of the engine's type."""
    if mesh is None:
        ctx = peek_context()
        if ctx is None or ctx.mesh is None:
            return None
        mesh = ctx.mesh
    mesh = as_mesh(mesh)
    if len(mesh) < 2:
        return None
    if any(d.type != device.type for d in mesh):
        raise ValueError(
            f"the mesh's devices {[str(d) for d in mesh]} are not of the engine's "
            f"device {device}; make the key on the mesh's device type"
        )
    return mesh


def _width_backend(backend: str, mod_bits: int) -> str:
    """Downgrade the RNS backend to the width-generic CIOS kernels when the
    modulus exceeds the prime pool's reach (ops/rns.rns_supported).  Every
    key size the engines accept stays on RNS; this gate protects wider
    moduli."""
    if backend != "rns" or rns_supported(mod_bits):
        return backend
    return "cios"


def _decode_bytes(r):
    """A [B, nbytes] uint8 exponent matrix (least significant byte first)
    -> ints, for the backends that take window-encoded exponents; anything
    else -> a list of ints."""
    if isinstance(r, np.ndarray) and r.dtype == np.uint8:
        return [int.from_bytes(row.tobytes(), "little") for row in r]
    return [int(v) for v in r]


class _EngineCommon:
    """The hybrid batch split (ipcl/mod_exp.cpp:688-732) and the split of a
    batch over a mesh, shared by the public and private engines."""

    @property
    def secondary(self):
        """The plain-PyTorch twin engine for hybrid batch splits (the
        reference's IPP-path analog, ipcl/mod_exp.cpp:727-728); it inherits
        the mesh."""
        if self.backend == "plain":
            return self
        if self._secondary is None:
            self._secondary = self._replica(
                "plain", self.device, self.mesh if self.mesh is not None else ()
            )
        return self._secondary

    def _on(self, dev):
        """The engine that runs a mesh entry on ``dev``: this one on its own
        device, else one twin a distinct device, made at first use with the
        per-key constants there; it follows a later change of ``backend``."""
        if dev == self.device:
            return self
        eng = self._replicas.get(dev)
        if eng is None:
            eng = self._replicas[dev] = self._replica(self.backend, dev, ())
        eng.backend = self.backend
        return eng

    def _dispatch(self, op: Optional[str], method: str, size: int, operands):
        """Run pipeline ``method`` on a ``size``-row batch: split over the
        mesh when the engine has one, else through the hybrid split under
        policy ``op`` (None: never split)."""
        if self.mesh is not None:
            return self._sharded(op, method, size, operands)
        if op is None:
            return getattr(self, method)(*operands)
        return self._hybrid(op, method, size, operands)

    def _sharded(self, op: Optional[str], method: str, size: int, operands):
        """Each local mesh entry with rows runs ``method`` (through the
        hybrid split under ``op``) on its rows on its device.  The rows are
        cut where a ShardedLimbs operand of this mesh and size is cut, else
        at :func:`batch_bounds`; an operand split otherwise is gathered and
        cut anew.  A DeviceSeed becomes one seed row an entry."""
        mesh = self.mesh
        operands = list(operands)
        bounds = None
        for k, o in enumerate(operands):
            if not isinstance(o, ShardedLimbs):
                continue
            if bounds is None and o.size == size and _same_mesh(o.mesh, mesh):
                bounds = o.bounds
            elif o.bounds != bounds or not _same_mesh(o.mesh, mesh):
                operands[k] = o.fetch()
        if bounds is None:
            bounds = batch_bounds(size, len(mesh), self.backend)
        seeds = [
            self._seed_rows(o) if isinstance(o, DeviceSeed) else None
            for o in operands
        ]
        parts = [None] * len(mesh)
        for i in mesh.local:
            lo, hi = bounds[i]
            if hi == lo:
                continue
            eng = self._on(mesh[i])
            args = [_part(o, i, lo, hi, size, mesh[i], s) for o, s in zip(operands, seeds)]
            if op is None:
                parts[i] = getattr(eng, method)(*args)
            else:
                parts[i] = eng._hybrid(op, method, hi - lo, args)
        return ShardedLimbs(parts, bounds, size, mesh)

    def _cios(self) -> str:
        """The backend of a limb product outside the RNS kernels."""
        return "cios" if self.backend == "rns" else self.backend

    def _hybrid(self, op: str, method: str, size: int, operands):
        """Run pipeline ``method`` on a batch, split at the hybrid ratio:
        head rows on this engine's kernel backend, tail rows on the plain
        twin, concatenated on the device.  The whole batch stays on this
        engine when no split applies: full-primary policy, a plain engine,
        or device-resident operands (which cannot be resliced on the host)."""
        if self.backend == "plain" or any(
            isinstance(o, DevLimbs) for o in operands
        ):
            return getattr(self, method)(*operands)
        nh = hybrid_head_count(op, size, self.backend)
        if nh >= size:
            return getattr(self, method)(*operands)

        def part(o, sl):
            if isinstance(o, np.ndarray):
                return o[sl]
            o = list(o)
            return o if len(o) == 1 and size > 1 else o[sl]  # shared scalar

        tail = getattr(self.secondary, method)(
            *[part(o, slice(nh, size)) for o in operands]
        )
        if nh == 0:
            return DevLimbs(tail.arr[: tail.size], size)
        head = getattr(self, method)(*[part(o, slice(0, nh)) for o in operands])
        return DevLimbs(
            torch.cat([head.arr[: head.size], tail.arr[: tail.size]]), size
        )


class PublicEngine(_EngineCommon):
    """Device pipelines for one public key."""

    def __init__(
        self,
        n: int,
        bits: int,
        hs: Optional[int],
        randbits: int,
        backend: Optional[str] = None,
        device="cuda",
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
        self.backend = _width_backend(_resolve_backend(backend), 2 * self.nbits)
        self.mesh = _resolve_mesh(mesh, self.device)
        self._replicas = {}
        self._secondary: Optional["PublicEngine"] = None
        self.n = n
        self.nsquare = n * n
        self.Ln = limbs_for_bits(self.nbits)
        self.mont_n2 = MontConstants.create(self.nsquare, 2 * self.nbits)
        self.L2 = self.mont_n2.num_limbs
        self.n_limbs = to_i32(ints_to_limbs([n], self.Ln)[0], self.device)
        self.n2_args = self.mont_n2.as_device_args(self.device)  # n, n0inv, r2, one
        self.n2_n = self.n2_args[0]
        # shared exponent n as windows for the normal obfuscator r^n mod n^2
        self.n_wins = to_i32(ints_to_windows([n], self.nbits), self.device)
        self.randbits = randbits
        self.hs_int = hs
        self.hs_limbs = self._hs_limbs()
        self._rns = None
        self._fb = None
        self._fb_mask = None
        self._graphs = GraphCache()
        #: seconds the last fixed-base table build took (host square chain
        #: + device table kernel): span ``engine.fb_table``, for the caller's
        #: set-up accounting
        self.fb_build_seconds = 0.0

    def _hs_limbs(self) -> Optional[torch.Tensor]:
        if self.hs_int is None:
            return None
        return to_i32(ints_to_limbs([self.hs_int], self.L2)[0], self.device)

    def _replica(self, backend: str, device, mesh) -> "PublicEngine":
        return PublicEngine(
            self.n, self.nbits, self.hs_int, self.randbits, backend=backend,
            device=device, mesh=mesh,
        )

    def set_hs(self, hs: int, randbits: Optional[int] = None) -> None:
        """Install new DJN parameters (ipcl/pub_key.cpp:131-137); the
        fixed-base table is sized from ``randbits`` and built from hs."""
        self.hs_int = hs
        self.hs_limbs = self._hs_limbs()
        if randbits is not None:
            self.randbits = randbits
        self._fb = None
        self._fb_mask = None
        self._graphs = GraphCache()  # the graphs read the old table
        self._secondary = None  # the plain twin re-derives hs on next use
        self._replicas = {}  # so do the mesh's twins

    @property
    def rns(self):
        """Lazy RNS machinery for n^2: (context, kernel consts, conversion
        consts)."""
        if self._rns is None:
            with trace.span("engine.rns"):
                ctx = RNSContext.create(self.nsquare, in_limbs=self.L2)
                kc = stack_group_consts2([ctx], device=self.device)
                conv = ctx.device_consts(self.device)
                self._rns = (ctx, kc, conv)
            trace.count("engine.constants_built")
        return self._rns

    @property
    def fixedbase(self):
        """Lazy per-key fixed-base table for hs^r: (table, NP).  Built once
        per key: a host square chain g_i = hs^(2^(8 i)) mod n^2 feeds the
        device table kernel."""
        if self._fb is None:
            if self.hs_int is None:
                raise ValueError("fixed-base table needs the DJN base hs")
            with trace.timed("engine.fb_table") as sp:
                nbytes = -(-self.randbits // FB_WINDOW_BITS)
                NP = max(8, -(-nbytes // 8) * 8)
                _, kc, conv = self.rns
                g = [self.hs_int % self.nsquare]
                for _ in range(NP - 1):
                    g.append(pow(g[-1], 256, self.nsquare))
                g_limbs = to_i32(ints_to_limbs(g, self.L2), self.device)
                tab = pops.fb_table_stage(g_limbs, kc, conv)
                self._fb = (tab, NP)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.fb_build_seconds = sp.seconds
            trace.count("engine.constants_built")
        return self._fb

    @property
    def fb_mask(self):
        """[NP] uint8 byte mask for device-generated obfuscator exponents
        (0xFF for full randbits bytes, a partial top byte, 0 beyond)."""
        if self._fb_mask is None:
            _, NP = self.fixedbase
            nbytes = -(-self.randbits // 8)
            mask = np.zeros((NP,), np.uint8)
            mask[:nbytes] = 0xFF
            top = self.randbits % 8
            if top:
                mask[nbytes - 1] = (1 << top) - 1
            self._fb_mask = torch.from_numpy(mask).to(self.device)
            trace.count("engine.constants_built")
        return self._fb_mask

    def _upload_narrow(self, xs: List[int]) -> torch.Tensor:
        """Upload a batch using only the limbs that cover its widest value
        (rounded to 8, as the reference does)."""
        with trace.span("api.codec_in"):
            lm = -(-max_bitlength(xs) // LIMB_BITS)
            Lm = min(self.Ln, max(8, -(-lm // 8) * 8))
            limbs = ints_to_limbs(xs, Lm)
        with trace.span("api.upload"):
            return to_i32(limbs, self.device)

    def _seed_tensor(self, r: DeviceSeed) -> torch.Tensor:
        """[1, 11] int64 seed row of 32-bit words on the device."""
        with trace.span("api.upload"):
            return torch.from_numpy(r.data.astype(np.int64)[None]).to(self.device)

    def _seed_rows(self, r: DeviceSeed) -> np.ndarray:
        """[S, 11] uint32 seed rows, one a mesh entry: row 0 is ``r``'s, the
        others fresh DeviceSeeds, so that the entries draw independent
        ChaCha20 keystreams (each from counter 0 over its own rows, as the
        reference's shards do)."""
        S = len(self.mesh) if self.mesh is not None else 1
        return np.stack([r.data] + [DeviceSeed().data for _ in range(S - 1)])

    def _obf_bytes(self, r, size: int, NP: int) -> Optional[torch.Tensor]:
        """Injected or host-drawn DJN exponents (a [B, nbytes] uint8 array or
        ints) -> [size, NP] uint8 tensor of exponent bytes, or None when an
        injected exponent is wider than the fixed-base table."""
        if isinstance(r, np.ndarray) and r.dtype == np.uint8:
            if r.shape[0] != size or r.shape[1] > NP:
                raise ValueError("obfuscator byte matrix does not fit the batch/table")
            rb = np.zeros((size, NP), np.uint8)
            rb[:, : r.shape[1]] = r
        else:
            if len(r) != size:
                raise ValueError("one obfuscator exponent per row expected")
            if -(-max(self.randbits, max_bitlength(r)) // 8) > NP:
                return None
            rb = ints_to_bytes_le(r, NP)
        return torch.from_numpy(np.array(rb)).to(self.device)

    def _hs_pow_var(self, r: List[int], kc) -> torch.Tensor:
        """hs^r for injected exponents wider than the fixed-base table: the
        generic modexp kernel with per-row windows on a broadcast base.
        Residues of a value <= 2N, not in Montgomery form."""
        ebits = max(self.randbits, max_bitlength(r))
        nw = _round_windows(num_windows(ebits))
        r_w = to_i32(ints_to_windows(r, nw * 4), self.device)
        return pops.rns_modexp_stage(self.hs_limbs.expand(len(r), -1), r_w, kc)

    def _host_rows(self, r, size: int, what: str) -> torch.Tensor:
        """Per-row host ints -> [size, L2] limbs on the device."""
        r = [int(v) for v in r]
        if len(r) != size:
            raise ValueError(f"one {what} per row expected")
        with trace.span("api.codec_in"):
            limbs = ints_to_limbs(r, self.L2)
        with trace.span("api.upload"):
            return to_i32(limbs, self.device)

    def _exp_windows(self, r: List[int], floor_bits: int) -> torch.Tensor:
        """Per-row exponents -> [B, NW] windows on the device, NW rounded
        to a multiple of 8 and covering at least ``floor_bits``."""
        nw = _round_windows(num_windows(max(floor_bits, max_bitlength(r))))
        return to_i32(ints_to_windows(r, nw * 4), self.device)

    def _seed_fallback(self, r, size: int, op: str, normal: bool = False):
        """Materialize a DeviceSeed into a host draw for the paths that
        cannot expand it on the device: hybrid batch splits (a seed cannot
        be row-sliced) and the backends other than ``"rns"``.  ``normal``
        draws normal-mode obfuscator bases r in [1, n-1] instead of DJN
        exponent bytes."""
        if not isinstance(r, DeviceSeed):
            return r
        if (
            self.backend != "rns"
            or hybrid_head_count(op, size, self.backend) < size
        ):
            if normal:
                return [
                    v % (self.n - 1) + 1
                    for v in _rng.batch_random_bits(size, self.nbits)
                ]
            return r.materialize(size, self.randbits)
        return r

    # -- pipelines ------------------------------------------------------------
    #
    # Every pipeline returns DevLimbs (device-resident canonical limbs).  The
    # *_dev entry points run the _impl pipelines through the hybrid split.

    def encrypt_djn_dev(self, m: Sequence[int], r) -> DevLimbs:
        with trace.span("api.submit", trace.NEW, op="encrypt_djn", rows=len(m)) as sp:
            r = self._seed_fallback(r, len(m), "encrypt")
            return sp.carry(self._dispatch("encrypt", "_encrypt_djn_impl", len(m), (m, r)))

    def _encrypt_djn_impl(self, m: Sequence[int], r) -> DevLimbs:
        """``r`` is a list of ints (injected test randoms), a [B, nbytes]
        uint8 array from the OS CSPRNG (utils/rng.batch_random_bytes), or
        a utils/rng.DeviceSeed, which is expanded on the device."""
        size = len(m)
        m_a = self._upload_narrow(list(m))
        if self.backend != "rns":  # window-encoded exponents, shared base hs
            r = _decode_bytes(r)
            if len(r) != size:
                raise ValueError("one obfuscator exponent per row expected")
            out = pops.encrypt_djn_op(
                m_a, self._exp_windows(r, self.randbits), self.n_limbs,
                *self.n2_args, self.hs_limbs, backend=self.backend,
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        tab, NP = self.fixedbase
        if isinstance(r, DeviceSeed):
            mask = self.fb_mask
            out = self._graphs.run(
                "encrypt_djn",
                lambda seed, m: pops.encrypt_fb_fused_rng_stage(
                    tab, seed, mask, m, self.n_limbs, kc, conv, self.n2_n
                ),
                self._seed_tensor(r), m_a,
            )
            return DevLimbs(out, size)
        if not isinstance(r, np.ndarray):
            r = [int(v) for v in r]
        r_b = self._obf_bytes(r, size, NP)
        if r_b is not None:  # exponents fit the table
            out = pops.encrypt_fb_fused_stage(
                tab, r_b, m_a, self.n_limbs, kc, conv, self.n2_n
            )
        else:  # injected oversized exponents: variable-base fallback
            res = self._hs_pow_var(r, kc)
            out = pops.encrypt_post_stage(
                res, m_a, self.n_limbs, conv, self.n2_n, res_mont=False
            )
        return DevLimbs(out, size)

    def encrypt_normal_dev(self, m: Sequence[int], r) -> DevLimbs:
        with trace.span("api.submit", trace.NEW, op="encrypt_normal", rows=len(m)) as sp:
            r = self._seed_fallback(r, len(m), "encrypt", normal=True)
            return sp.carry(
                self._dispatch("encrypt", "_encrypt_normal_impl", len(m), (m, r))
            )

    def _encrypt_normal_impl(self, m: Sequence[int], r) -> DevLimbs:
        """ct = (n*m+1) * r^n mod n^2.  ``r`` is a utils/rng.DeviceSeed (the
        base is then drawn on the device, unreduced) or a list of ints."""
        size = len(m)
        m_a = self._upload_narrow(list(m))
        if self.backend != "rns":  # the seed fallback left a host list
            r_a = self._host_rows(r, size, "obfuscator base")
            out = pops.encrypt_normal_op(
                m_a, r_a, self.n_wins, self.n_limbs, *self.n2_args,
                backend=self.backend,
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if isinstance(r, DeviceSeed):
            out = self._graphs.run(
                "encrypt_normal",
                lambda seed, m: pops.encrypt_normal_rng_stage(
                    seed, m, self.n_wins, self.n_limbs, kc, conv, self.n2_n,
                    ebits=2 * self.nbits + 3,
                ),
                self._seed_tensor(r), m_a,
            )
            return DevLimbs(out, size)
        r_a = self._host_rows(r, size, "obfuscator base")
        # the exponent (n) is shared by every row: shared-window kernel
        res = pops.rns_modexp_shared_stage(r_a, self.n_wins, kc)
        out = pops.encrypt_post_stage(res, m_a, self.n_limbs, conv, self.n2_n)
        return DevLimbs(out, size)

    def obfuscate_dev(self, ct, r) -> DevLimbs:
        size = _payload_size(ct)
        with trace.span("api.submit", trace.NEW, op="obfuscate", rows=size) as sp:
            r = self._seed_fallback(r, size, "encrypt")
            return sp.carry(self._dispatch("encrypt", "_obfuscate_impl", size, (ct, r)))

    def _obfuscate_impl(self, ct, r) -> DevLimbs:
        """Standalone re-obfuscation: ct * hs^r (DJN, ipcl/pub_key.cpp:51-64)
        or ct * r^n (normal, :66-80) mod n^2.  ``ct`` is DevLimbs or a host
        int list; ``r`` follows encrypt_djn_dev's conventions."""
        ct_a, size = _ct_operand(ct, self.L2, self.device)
        if self.backend != "rns":
            if self.hs_int is None:  # normal mode: per-row bases, exponent n
                base = self._host_rows(r, size, "obfuscator base")
                wins = self.n_wins
            else:  # DJN: the shared base hs, per-row exponents
                r = _decode_bytes(r)
                if len(r) != size:
                    raise ValueError("one obfuscator exponent per row expected")
                base, wins = self.hs_limbs, self._exp_windows(r, self.randbits)
            out = pops.obfuscate_op(
                ct_a, base, wins, *self.n2_args, backend=self.backend
            )
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if self.hs_int is None:  # normal mode: obf = r^n, shared exponent n
            r_a = self._host_rows(r, size, "obfuscator base")
            res = pops.rns_modexp_shared_stage(r_a, self.n_wins, kc)
            out = pops.mul_res_post_stage(ct_a, res, conv, self.n2_n)
            return DevLimbs(out, size)
        tab, NP = self.fixedbase  # DJN: obf = hs^r
        if isinstance(r, DeviceSeed):
            out = pops.obfuscate_fb_fused_rng_stage(
                tab, self._seed_tensor(r), self.fb_mask, ct_a, kc, conv, self.n2_n
            )
            return DevLimbs(out, size)
        if not isinstance(r, np.ndarray):
            r = [int(v) for v in r]
        r_b = self._obf_bytes(r, size, NP)
        if r_b is not None:
            res = pops.rns_fb_modexp_stage(tab, r_b, kc, mont_out=True)
        else:
            res = self._hs_pow_var(r, kc)
        out = pops.mul_res_post_stage(
            ct_a, res, conv, self.n2_n, res_mont=r_b is not None
        )
        return DevLimbs(out, size)

    def encrypt_noobf_dev(self, m: Sequence[int]) -> DevLimbs:
        with trace.span("api.submit", trace.NEW, op="encrypt_noobf", rows=len(m)) as sp:
            return sp.carry(self._dispatch(None, "_encrypt_noobf_impl", len(m), (m,)))

    def _encrypt_noobf_impl(self, m: Sequence[int]) -> DevLimbs:
        m_a = self._upload_narrow(list(m))
        return DevLimbs(pops.encrypt_noobf_op(m_a, self.n_limbs, self.n2_n), len(m))

    def add_ctct_dev(self, a, b) -> DevLimbs:
        size = _payload_size(a)
        with trace.span("api.submit", trace.NEW, op="add_ctct", rows=size) as sp:
            return sp.carry(self._dispatch(None, "_add_ctct_impl", size, (a, b)))

    def _add_ctct_impl(self, a, b) -> DevLimbs:
        a_a, size = _ct_operand(a, self.L2, self.device)
        b_a, b_size = _ct_operand(b, self.L2, self.device)
        if b_size == 1 and size != 1:
            b_a = b_a.expand_as(a_a)
        elif b_size != size:
            raise ValueError("CT + CT: operands of one size (or a size-1 b)")
        if self.backend != "rns":
            n2_n, n2_n0inv, n2_r2, _ = self.n2_args
            out = pops.add_ctct_op(
                a_a, b_a, n2_n, n2_n0inv, n2_r2, backend=self._cios()
            )
            return DevLimbs(out, size)
        _, _, conv = self.rns
        return DevLimbs(pops.add_ctct_rns_op(a_a, b_a, conv, self.n2_n), size)

    def mul_ctpt_dev(self, ct, pt: Sequence[int]) -> DevLimbs:
        size = _payload_size(ct)
        with trace.span("api.submit", trace.NEW, op="mul_ctpt", rows=size) as sp:
            return sp.carry(self._dispatch("multiply", "_mul_ctpt_impl", size, (ct, pt)))

    def _mul_ctpt_impl(self, ct, pt: Sequence[int]) -> DevLimbs:
        ct_a, size = _ct_operand(ct, self.L2, self.device)
        pt = [int(v) for v in pt]
        # a scalar PT keeps its size-1 row: the shared-exponent kernel path
        shared_pt = len(pt) == 1 and size != 1
        if not shared_pt and len(pt) != size:
            raise ValueError("CT * PT: one plaintext per row, or one scalar")
        nw = _round_windows(num_windows(max_bitlength(pt)))
        pt_w = to_i32(ints_to_windows(pt, nw * 4), self.device)
        if self.backend != "rns":  # a [1, NW] scalar is read by every row
            out = pops.mul_ctpt_op(ct_a, pt_w, *self.n2_args, backend=self.backend)
            return DevLimbs(out, size)
        _, kc, conv = self.rns
        if shared_pt:
            res = pops.rns_modexp_shared_stage(ct_a, pt_w, kc)
        else:
            res = pops.rns_modexp_stage(ct_a, pt_w, kc)
        out = pops.rns_finalize_stage(res, conv, self.n2_n, self.L2)
        return DevLimbs(out, size)

    # -- list-returning wrappers (the JAX package's models/engine.py:769-785):
    # each runs its *_dev form, hybrid split and mesh included, and fetches

    def encrypt_djn(self, m, r) -> List[int]:
        return self.encrypt_djn_dev(m, r).fetch()

    def encrypt_normal(self, m, r) -> List[int]:
        return self.encrypt_normal_dev(m, r).fetch()

    def encrypt_noobf(self, m) -> List[int]:
        return self.encrypt_noobf_dev(m).fetch()

    def add_ctct(self, a, b) -> List[int]:
        return self.add_ctct_dev(a, b).fetch()

    def mul_ctpt(self, ct, pt) -> List[int]:
        return self.mul_ctpt_dev(ct, pt).fetch()


class PrivateEngine(_EngineCommon):
    """Device pipelines for one private key (CRT + RAW decrypt)."""

    def __init__(
        self,
        n: int,
        p: int,
        q: int,
        lam: int,
        x: int,
        hp: int,
        hq: int,
        backend: Optional[str] = None,
        device="cuda",
        mesh=None,
    ):
        assert p < q
        self.device = resolve_device(device)
        dev = self.device
        pbits = max(p.bit_length(), q.bit_length())
        self.n = n
        self.nbits = n.bit_length()
        _check_key_bits(self.nbits)
        # CRT decrypt runs at p^2 / q^2 width; the RAW path gates on the
        # width of n^2 per call
        self.backend = _width_backend(_resolve_backend(backend), 2 * pbits)
        self.mesh = _resolve_mesh(mesh, dev)
        self._replicas = {}
        self._secondary: Optional["PrivateEngine"] = None
        self.Lp = limbs_for_bits(pbits)
        self.mont_p2 = MontConstants.create(p * p, 2 * pbits)
        self.mont_q2 = MontConstants.create(q * q, 2 * pbits)
        self.Lp2 = self.mont_p2.num_limbs
        assert self.mont_q2.num_limbs == self.Lp2
        self.mont_p = MontConstants.create(p, pbits)
        self.mont_q = MontConstants.create(q, pbits)
        assert self.mont_q.num_limbs == self.Lp

        def stack(a_p, a_q):
            return to_i32(np.stack([a_p, a_q]), dev)

        self.sq_n = stack(self.mont_p2.n_limbs, self.mont_q2.n_limbs)
        self.sq_n0inv = to_i32(
            np.array([self.mont_p2.n0inv, self.mont_q2.n0inv], np.uint32), dev
        )
        self.sq_r2 = stack(self.mont_p2.r2_limbs, self.mont_q2.r2_limbs)
        self.sq_one = stack(self.mont_p2.one_limbs, self.mont_q2.one_limbs)
        ewbits = _round_windows(num_windows(pbits)) * 4
        self.exp_wins = to_i32(
            np.stack(
                [ints_to_windows([p - 1], ewbits), ints_to_windows([q - 1], ewbits)]
            ),
            dev,
        )  # [2, 1, NW]
        R_lp = 1 << (LIMB_BITS * self.Lp)
        self.hensel = stack(
            ints_to_limbs([pow(p, -1, R_lp)], self.Lp)[0],
            ints_to_limbs([pow(q, -1, R_lp)], self.Lp)[0],
        )
        self.hfun = stack(
            ints_to_limbs([hp], self.Lp)[0], ints_to_limbs([hq], self.Lp)[0]
        )
        self.pq_n = stack(self.mont_p.n_limbs, self.mont_q.n_limbs)
        self.pq_n0inv = to_i32(
            np.array([self.mont_p.n0inv, self.mont_q.n0inv], np.uint32), dev
        )
        self.pq_r2 = stack(self.mont_p.r2_limbs, self.mont_q.r2_limbs)
        self.pinv_q = to_i32(ints_to_limbs([pow(p, -1, q)], self.Lp)[0], dev)
        self.p_limbs = to_i32(ints_to_limbs([p], self.Lp)[0], dev)
        # RAW-mode constants (lambda exponent over n^2, then L-function by n)
        self.mont_n2 = MontConstants.create(n * n, 2 * self.nbits)
        self.mont_n = MontConstants.create(n, self.nbits)
        self.Ln = self.mont_n.num_limbs
        self.n2_args = self.mont_n2.as_device_args(dev)  # n, n0inv, r2, one
        self.n2_n = self.n2_args[0]
        lam_bits = _round_windows(num_windows(self.nbits)) * 4
        self.lam_wins = to_i32(ints_to_windows([lam], lam_bits), dev)
        R_ln = 1 << (LIMB_BITS * self.Ln)
        self.hensel_n = to_i32(ints_to_limbs([pow(n, -1, R_ln)], self.Ln)[0], dev)
        self.x_limbs = to_i32(ints_to_limbs([x], self.Ln)[0], dev)
        self.n_n = to_i32(self.mont_n.n_limbs, dev)
        self.n_n0inv = to_i32(np.array([self.mont_n.n0inv], np.uint32), dev)
        self.n_r2 = to_i32(self.mont_n.r2_limbs, dev)
        self._p, self._q, self._pbits = p, q, pbits
        self._lam, self._x, self._hp, self._hq = lam, x, hp, hq
        self._rns_crt = None
        self._rns_crt_stacked = None
        self._rns_crt_ctx_pair = None
        self._rns_crt_conv = None
        self._rns_raw = None
        self._graphs = GraphCache()

    def _replica(self, backend: str, device, mesh) -> "PrivateEngine":
        return PrivateEngine(
            self.n, self._p, self._q, self._lam, self._x, self._hp, self._hq,
            backend=backend, device=device, mesh=mesh,
        )

    def _rns_crt_ctxs(self):
        """The (p^2, q^2) RNSContext pair.

        in_limbs spans the FULL n^2-width ciphertext (2*Lp2): the Cin
        weights (2^(15 l) mod h^2) mod m fold ct into each residue system
        inside the kernel's input conversion, so decrypt has no separate
        "ct mod p^2" stage.  The represented value is
        V < 2*Lp2 * 2^15 * N; product_bits sizes M_A >= 2^26 * N above it
        so the first to-Montgomery multiply contracts V*N/M_A + 2N < 3N."""
        if self._rns_crt_ctx_pair is None:
            in_limbs = 2 * self.Lp2
            bits = 2 * self._pbits + LIMB_BITS + in_limbs.bit_length() + 1
            with trace.span("engine.crt_consts"):
                cp = RNSContext.create(
                    self._p * self._p, in_limbs=in_limbs, product_bits=bits
                )
                cq = RNSContext.create(
                    self._q * self._q, in_limbs=in_limbs, product_bits=bits
                )
            self._rns_crt_ctx_pair = (cp, cq)
            trace.count("engine.constants_built")
        return self._rns_crt_ctx_pair

    @property
    def crt_folded(self) -> bool:
        """Whether this key's CRT decrypt takes the folded lane layout: both
        residue systems fit ``FOLDED_MAX_LANES`` side by side (keys up to 2048
        bits).  Wider keys (2k + 2 = 452 / 612 lanes at 3072 / 4096 bits) take
        the grouped layout, whose per-group k stays within 320 lanes
        and eligible for the lean fold."""
        cp, _ = self._rns_crt_ctxs()
        return 2 * cp.k + 2 <= FOLDED_MAX_LANES

    def _crt_conv(self):
        """(conv_p, conv_q): the pair's conversion constants on the device."""
        if self._rns_crt_conv is None:
            with trace.span("engine.crt_consts"):
                cp, cq = self._rns_crt_ctxs()
                self._rns_crt_conv = (
                    cp.device_consts(self.device), cq.device_consts(self.device)
                )
            trace.count("engine.constants_built")
        return self._rns_crt_conv

    @property
    def rns_crt(self):
        """(p^2, q^2) RNS machinery for CRT decrypt: (kernel consts, conv
        consts), f32-reciprocal reduction.  Folded layout
        (fold_group_consts2 shared_input: both residue systems side by side
        in one thread block, so every squaring serves both CRT halves) when
        :attr:`crt_folded`, else the grouped one of :attr:`rns_crt_stacked`."""
        if self._rns_crt is None:
            with trace.span("engine.crt_consts"):
                if not self.crt_folded:
                    self._rns_crt = self.rns_crt_stacked
                else:
                    kc2 = fold_group_consts2(
                        list(self._rns_crt_ctxs()), f32_mu=True, shared_input=True,
                        device=self.device,
                    )
                    self._rns_crt = (kc2, self._crt_conv())
            trace.count("engine.constants_built")
        return self._rns_crt

    @property
    def rns_crt_stacked(self):
        """The same (p^2, q^2) pair in the GROUPED layout (stack_group_consts2
        with the f32-reciprocal reduction): one residue system per group of
        the generic modexp kernel.  :func:`decrypt_crt_rns_op` takes either;
        the results agree."""
        if self._rns_crt_stacked is None:
            with trace.span("engine.crt_consts"):
                kc2 = stack_group_consts2(
                    list(self._rns_crt_ctxs()), f32_mu=True, device=self.device
                )
                self._rns_crt_stacked = (kc2, self._crt_conv())
            trace.count("engine.constants_built")
        return self._rns_crt_stacked

    @property
    def rns_raw(self):
        """RNS machinery for the RAW path (modulus n^2): (kernel consts,
        conversion consts)."""
        if self._rns_raw is None:
            with trace.span("engine.raw_consts"):
                ctx = RNSContext.create(self.n * self.n, in_limbs=self.mont_n2.num_limbs)
                self._rns_raw = (
                    stack_group_consts2([ctx], device=self.device),
                    ctx.device_consts(self.device),
                )
            trace.count("engine.constants_built")
        return self._rns_raw

    def decrypt_crt_dev(self, ct) -> DevLimbs:
        size = _payload_size(ct)
        with trace.span("api.submit", trace.NEW, op="decrypt_crt", rows=size) as sp:
            return sp.carry(self._dispatch("decrypt", "_decrypt_crt_impl", size, (ct,)))

    def _decrypt_crt_impl(self, ct, grouped: bool = False) -> DevLimbs:
        """``grouped`` runs the stacked constants through the generic modexp
        kernel instead of the folded ones (same result)."""
        ct_a, size = _ct_operand(ct, 2 * self.Lp2, self.device)
        if self.backend != "rns":
            out = pops.decrypt_crt_op(
                ct_a,
                self.sq_n, self.sq_n0inv, self.sq_r2, self.sq_one,
                self.exp_wins, self.hensel, self.hfun,
                self.pq_n, self.pq_n0inv, self.pq_r2,
                self.pinv_q, self.p_limbs,
                backend=self.backend,
            )
            return DevLimbs(out, size)
        kc2, conv2 = self.rns_crt_stacked if grouped else self.rns_crt
        if grouped or not self.crt_folded:
            trace.count("pipelines.crt_grouped")
        out = self._graphs.run(
            "decrypt_crt_grouped" if grouped else "decrypt_crt",
            lambda c: pops.decrypt_crt_rns_op(
                c,
                self.sq_n,
                self.exp_wins, self.hensel, self.hfun,
                self.pq_n, self.pq_n0inv, self.pq_r2,
                self.pinv_q, self.p_limbs,
                kc2, conv2,
            ),
            ct_a,
        )
        return DevLimbs(out, size)

    def decrypt_raw_dev(self, ct) -> DevLimbs:
        size = _payload_size(ct)
        with trace.span("api.submit", trace.NEW, op="decrypt_raw", rows=size) as sp:
            return sp.carry(self._dispatch("decrypt", "_decrypt_raw_impl", size, (ct,)))

    def _decrypt_raw_impl(self, ct) -> DevLimbs:
        """m = L(c^lambda mod n^2) * x mod n (ipcl/pri_key.cpp:92-111)."""
        L2 = self.mont_n2.num_limbs
        ct_a, size = _ct_operand(ct, L2, self.device)
        # RAW runs at n^2 width, wider than the CRT path's p^2
        raw_backend = _width_backend(self.backend, 2 * self.nbits)
        if raw_backend != "rns":
            out = pops.decrypt_raw_op(
                ct_a, self.lam_wins, *self.n2_args, self.hensel_n, self.x_limbs,
                self.n_n, self.mont_n.n0inv, self.n_r2, backend=raw_backend,
            )
            return DevLimbs(out, size)
        kc, conv = self.rns_raw
        res_r = pops.rns_modexp_shared_stage(ct_a, self.lam_wins, kc)
        res = pops.rns_finalize_stage(res_r, conv, self.n2_n, L2)
        out = pops.hensel_post_stage(
            res, self.hensel_n, self.x_limbs, self.n_n, self.n_n0inv, self.n_r2
        )
        return DevLimbs(out, size)

    # -- list-returning wrappers (the JAX package's models/engine.py:1079-1083)

    def decrypt_crt(self, ct) -> List[int]:
        return self.decrypt_crt_dev(ct).fetch()

    def decrypt_raw(self, ct) -> List[int]:
        return self.decrypt_raw_dev(ct).fetch()
