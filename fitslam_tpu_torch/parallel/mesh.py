"""Meshes of ranks and their collectives (port of ``fitslam_tpu/parallel/mesh.py``).

The reference's ``Mesh`` + ``shard_map`` is single-controller SPMD: one
process drives every device. The port follows PyTorch's idiom instead: one
process a device (a rank), joined in a ``torch.distributed`` process group.
Every rank runs the same program; a sharded function gets the whole input on
every rank, works on the rank's contiguous slice of each sharded input, and
returns on every rank what the reference returns to its one controller.

The reference's collectives map across as:

- ``psum`` -> ``psum`` (``all_reduce(SUM)``); ``pmax`` / ``pmin`` ->
  ``all_reduce(MAX / MIN)``;
- ``out_specs=P(axis)`` (the shards concatenated) -> ``all_gather``;
- ``ppermute`` -> ``broadcast`` from the sending rank: gloo takes
  ``all_reduce``, ``broadcast`` and ``all_gather`` with CUDA tensors, but its
  ``send`` / ``recv`` hand the device pointer to the TCP transport and fail.

``Mesh`` is a thin class of the port's own rather than PyTorch's
``DeviceMesh``: a ``DeviceMesh`` binds rank r to card r and picks the backend
by device type, while ranks that share one card (two gloo ranks on
``cuda:0``, the only layout one card allows, as NCCL refuses two ranks on a
device) are outside its model. The backend is always the caller's choice:
``gloo`` for CPU tensors and for ranks that share a card, ``nccl`` for one
rank a card. A collective the backend cannot do raises; nothing switches
backend or device.

``launch`` starts ``n`` ranks as spawned processes (a parent that has
touched CUDA cannot fork), rendezvous through a file store in a fresh
temporary directory.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fitslam_tpu_torch.utils import jit

BACKENDS = ("gloo", "nccl")

# the device of this process's rank: set by ``launch`` and ``init_rank``
_RANK_DEVICE: Optional[torch.device] = None


class Mesh:
    """``n`` ranks of a process group laid out as a named grid.

    ``devices`` holds the ranks' global numbers in the grid's shape (the
    reference's ``mesh.devices``), ``shape`` maps each axis name to its size,
    ``rank`` is this process's rank in the mesh's group (-1 where the process
    is not a member) and ``device`` the device its tensors live on. ``stats``
    counts the collectives issued; with ``timed`` set, each collective
    synchronises the device before and after it and adds its wall time to
    ``stats["seconds"]``. ``solvers`` keeps the captured state of the sharded
    solvers that ran on this rank (``solver_state``), so their regions are
    captured once and replayed in later solves while the mesh lives."""

    def __init__(self, ranks: Sequence[int], axis_names: Sequence[str], shape: Sequence[int],
                 group, backend: str, device):
        self.devices = np.asarray(ranks).reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.group = group
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank(group) if group is not None else -1
        self.timed = False
        self.stats = {"collectives": 0, "seconds": 0.0}
        self.solvers: Dict[str, "_SolverOwner"] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def solver_state(self, name: str, key: Tuple, axis: str, state: Dict[str, Any],
                     capture: bool = True) -> jit.SlotState:
        """The ``jit.SlotState`` of sharded solver ``name`` on this rank,
        holding ``state`` (the solve's inputs and the fields its regions
        chain through). Captured, it is kept on the mesh, one a solver: its
        slot is keyed by the rank, the mesh's size and ``axis`` and ``key``
        (the shapes and the host values the regions bake in), and a solve of
        other shapes replaces it. A solve of the kept key assigns ``state``
        into its buffers. ``capture=False``: a fresh eager state a solve."""
        if not capture:
            return jit.SlotState(self, None, self.device, state, capture=False)
        key = (name, self.rank, self.size, axis) + tuple(key)
        owner = self.solvers.get(name)
        if owner is None or owner.key != key:
            owner = self.solvers[name] = _SolverOwner(key, self.device, state)
            return owner.state
        for field, value in state.items():
            owner.state[field] = value
        return owner.state

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.rank < 0:
            raise RuntimeError("this process is not a rank of the mesh")
        coords = np.unravel_index(self.rank, self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    def _check(self, axis: str, x: torch.Tensor) -> None:
        if self.rank < 0:
            raise RuntimeError("this process is not a rank of the mesh")
        if self.shape[axis] != self.size:
            raise NotImplementedError(
                f"collectives over axis {axis!r} of a {self.shape} mesh: only over an axis "
                "that spans the whole mesh")
        if self.backend == "nccl" and x.device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors only")
        if self.backend == "gloo" and x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the gloo backend takes no {x.device.type} tensors")

    def _run(self, fn: Callable[[], Any], x: torch.Tensor):
        self.stats["collectives"] += 1
        if not self.timed:
            fn()
            return
        sync = torch.cuda.synchronize if x.device.type == "cuda" else (lambda *a: None)
        sync(x.device)
        t0 = time.perf_counter()
        fn()
        sync(x.device)
        self.stats["seconds"] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, op: str = "sum", axis: str = "data") -> torch.Tensor:
        """``op`` ("sum", "max" or "min") of ``x`` over the ranks; a new tensor."""
        self._check(axis, x)
        out = x.clone().contiguous()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        self._run(lambda: dist.all_reduce(out, op=red, group=self.group), out)
        return out

    def all_gather(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The ranks' ``x`` concatenated along dim 0 in rank order, on every
        rank."""
        self._check(axis, x)
        as_int = x.dtype == torch.bool
        src = (x.to(torch.uint8) if as_int else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        self._run(lambda: dist.all_gather(parts, src, group=self.group), src)
        out = torch.cat(parts)
        return out.bool() if as_int else out

    def broadcast(self, x: torch.Tensor, src: int, axis: str = "data") -> torch.Tensor:
        """``x`` of the rank at ``src`` along ``axis``, on every rank (in place)."""
        self._check(axis, x)
        x = x.contiguous()
        src_global = int(self.devices.reshape(-1)[src])
        self._run(lambda: dist.broadcast(x, src=src_global, group=self.group), x)
        return x


class _SolverOwner:
    """The owner of one sharded solver's slot on a rank (``Mesh.solvers``):
    the slot turns idle, for the next owner of its key, when this goes."""

    def __init__(self, key: Tuple, device, state: Dict[str, Any]):
        self.key = key
        self.state = jit.SlotState(self, key, device, state)


def psum(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The reference's ``jax.lax.psum``: the sum over the ranks."""
    return mesh.all_reduce(x, "sum", axis)


def pmax(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    return mesh.all_reduce(x, "max", axis)


def pmin(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    return mesh.all_reduce(x, "min", axis)


def init_rank(backend: str, init_method: str, world_size: int, rank: int,
              device=None) -> torch.device:
    """Join this process to the default process group as ``rank`` of
    ``world_size`` and record its device (``cpu``, ``cuda:N``)."""
    global _RANK_DEVICE
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device or "cpu")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # float32 products stay float32 on every rank, as StereoSlam sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    _RANK_DEVICE = device
    return device


def make_mesh(num_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, backend: Optional[str] = None) -> Mesh:
    """A 1-D (default) or N-D mesh over the first ``num_devices`` ranks of
    the default process group. Every rank of the group must call it (a
    subgroup is made collectively); ranks outside the first ``num_devices``
    get a mesh they are not a member of.

    In a process with no process group, ``make_mesh(1)`` makes a one-rank
    group (``backend``, default gloo) so that a single-process caller works
    as in the reference; any other size raises."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {num_devices} ranks needs a process group: start "
                               "the ranks with mesh.launch or multihost.initialize")
        dist.init_process_group(backend or "gloo", store=dist.HashStore(), world_size=1,
                                rank=0)
    world = dist.get_world_size()
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"asked for the {backend} backend; the process group runs {have}")
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    member = dist.get_rank() < n
    device = _RANK_DEVICE or torch.device("cpu")
    return Mesh(range(n), axis_names, shape, group if member else None, have, device)


def data_sharding(mesh: Mesh, axis: str = "data") -> Callable:
    """The rank's contiguous slice along dim 0 of every tensor of a tree
    (the reference's ``P(axis)`` placement); the dim must divide by the axis."""
    n = mesh.shape[axis]

    def put(tree):
        def shard(x):
            if x.shape[0] % n:
                raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by {n} ranks")
            b = x.shape[0] // n
            k = mesh.axis_index(axis)
            return x[k * b:(k + 1) * b]
        return map_tree(shard, tree)
    return put


def replicated(mesh: Mesh) -> Callable:
    """Every tensor of a tree kept whole (the reference's ``P()``)."""
    return lambda tree: tree


def map_tree(fn: Callable, tree):
    """``fn`` on every tensor of a tree of NamedTuples, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return tree


def leaves(tree) -> list:
    """The tensors of a tree in order."""
    out = []
    map_tree(lambda x: out.append(x), tree)
    return out


def pack(tree) -> torch.Tensor:
    """Every tensor of a tree, as raw bytes, in one contiguous uint8 buffer."""
    return torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in leaves(tree)])


def unpack(buf: torch.Tensor, like):
    """The tree of ``pack`` read back from ``buf``, with the shapes and dtypes
    of the tree ``like``."""
    parts = leaves(like)
    sizes = [x.numel() * x.element_size() for x in parts]
    if sum(sizes) != buf.numel():
        raise ValueError(f"buffer of {buf.numel()} bytes for a tree of {sum(sizes)}")
    it = iter(zip(torch.split(buf, sizes), parts))

    def read(_):
        b, x = next(it)
        return b.clone().view(x.dtype).reshape(x.shape)
    return map_tree(read, like)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _rank_main(rank, n, backend, devices, init_method, payload, results):
    try:
        # ranks run side by side: one thread each keeps them off each other's cores
        torch.set_num_threads(1)
        init_rank(backend, init_method, n, rank, devices[rank])
        with open(payload, "rb") as f:
            fn, args, kwargs = pickle.load(f)
        out = map_tree(lambda x: x.detach().cpu(), fn(*args, **kwargs))
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_devices(n: int, backend: str, device: str) -> list:
    """The device of each of ``n`` ranks: ``cpu``; ``cuda`` (rank r on card
    r); or one card that every rank shares (``cuda:0``, gloo only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs a CUDA device a rank")
        return ["cpu"] * n
    if dev.index is None:
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks on {torch.cuda.device_count()} cards, one a card")
        return [f"cuda:{r}" for r in range(n)]
    if backend == "nccl" and n > 1:
        raise ValueError("NCCL refuses two ranks on one card: use gloo for ranks that share it")
    return [str(dev)] * n


def launch(fn: Callable, n: int, *args, backend: str = "gloo", device: str = "cuda",
           timeout: float = 600.0, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on ``n`` spawned ranks joined in one
    process group; returns each rank's result (tensors moved to the CPU), in
    rank order. The ranks run on ``rank_devices(n, backend, device)``: the
    cards by default, the CPU only when asked for. ``fn`` and its arguments
    cross by pickle, so ``fn`` must be importable (a module-level function). A rank that raises, dies or
    outlasts ``timeout`` seconds fails the launch with its traceback; every
    rank is stopped before this returns or raises."""
    devices = rank_devices(n, backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="fitslam_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    # the call goes by file: a spawned child drains its start pipe only after
    # importing torch, so a large argument in the pipe would start the ranks
    # one after another
    payload = os.path.join(tmp, "payload")
    with open(payload, "wb") as f:
        pickle.dump((fn, args, kwargs), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, devices, init_method, payload, results),
                         daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < n:
            try:
                rank, ok, body = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(got))} did not "
                                       f"finish in {timeout:.0f} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{body}")
            got[rank] = pickle.loads(body)
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
