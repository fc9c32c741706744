"""K3, the wavefront sweep (port of ``fitslam_tpu/ops/pallas_grid.py``; the
module keeps the reference's name so the pair maps file to file).

``wavefront_sweeps`` runs ``iters`` Jacobi min-plus relaxation sweeps of a
(G, G) potential: every sweep reads only the previous sweep's potential,

    pot = min(pot, where(passable, min4(neighbours) + step, BIG)),

with a neighbour outside the grid counting as BIG. On a CUDA tensor it
launches a hand-written kernel of ``csrc/wavefront_sweep.cu`` (all sweeps in
one call from Python); on a CPU tensor it runs ``wavefront_sweeps_plain``,
the plain PyTorch twin. There is no fallback between the two: a build or
launch failure raises. With ``min`` and one float32 ``+`` per cell and sweep,
kernel and twin agree exactly.

Which kernel runs is a size rule, ``sweep_plan``, as the reference gates its
kernel on VMEM (``models/nav.py``): a grid whose cells fit the registers of
one thread-block cluster (at most 16 blocks of at most 512 threads, each
thread a tile of 4 or 8 rows by 4 columns: up to 512 x 512 cells) runs the
resident kernel, one launch that keeps the potential on chip for every
sweep; a larger grid runs the tiled kernel, 8 sweeps a launch. A resident
plan whose cluster the card cannot schedule raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fitslam_tpu_torch.ops.grid import neighbour, padded
from fitslam_tpu_torch.utils.cuda_build import check_cuda_error, load_kernel_library

BIG = 1e9


def wavefront_sweeps_plain(pot0: torch.Tensor, step_cost: torch.Tensor,
                           passable: torch.Tensor, iters: int) -> torch.Tensor:
    """The reference's roll loop (``models/nav.py`` XLA path) with the edges
    filled by BIG instead of wrapped."""
    pot = pot0.to(torch.float32)
    step = step_cost.to(torch.float32)
    ok = _as_bool(passable)
    for _ in range(iters):
        p = padded(pot, BIG)
        best = torch.minimum(torch.minimum(neighbour(p, 1, 0), neighbour(p, -1, 0)),
                             torch.minimum(neighbour(p, 0, 1), neighbour(p, 0, -1)))
        pot = torch.minimum(pot, torch.where(ok, best + step, BIG))
    return pot


def _as_bool(passable: torch.Tensor) -> torch.Tensor:
    return passable if passable.dtype == torch.bool else passable > 0.5


def _check(pot0: torch.Tensor, step_cost: torch.Tensor, passable: torch.Tensor,
           iters: int) -> None:
    if pot0.dim() != 2 or pot0.dtype != torch.float32:
        raise ValueError(f"pot0 must be a (H, W) float32 tensor, got "
                         f"{tuple(pot0.shape)} {pot0.dtype}")
    for name, t in (("step_cost", step_cost), ("passable", passable)):
        if t.shape != pot0.shape or t.device != pot0.device:
            raise ValueError(f"{name} must match pot0's shape and device, got "
                             f"{tuple(t.shape)} on {t.device}")
    if step_cost.dtype != torch.float32:
        raise ValueError(f"step_cost must be float32, got {step_cost.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


class SweepPlan(NamedTuple):
    design: str            # "resident" (one cluster, one launch) or "tiled"
    rows_per_thread: int   # resident: a thread's tile is rows_per_thread x 4 cells
    threads_x: int         # resident: threads across the width, ceil(W / 4)
    threads_y: int         # resident: threads down a block's band of rows
    blocks: int            # resident: blocks of the cluster, one band each
    group: int = 1         # resident: sweeps between two exchanges of the bands'
                           # rows; a group of k > 1 adds k halo rows on each side


TILED = SweepPlan("tiled", 0, 0, 0, 0)
RESIDENT_MAX_THREADS = 512     # a block's threads (<= 128 registers each)
RESIDENT_MAX_BLOCKS = 16       # the H100's non-portable cluster size


def sweep_plan(H: int, W: int, group: int = 1) -> SweepPlan:
    """The size rule: which K3 kernel sweeps an (H, W) grid, and how the
    resident kernel cuts it. The grid is cut into up to 16 bands of
    ceil(H / 16) rows, one block (one SM) each: the most SMs one cluster
    has, since a sweep's time is the per-SM work plus a fixed exchange with
    the neighbouring bands. Tiles are 4 rows where a band's threads fit in
    512 and 8 where they do not; a grid whose band needs more than 512
    threads even then is tiled.

    ``group`` > 1 plans the bands to exchange rows once every ``group``
    sweeps instead, each band holding ``group`` halo rows on either side
    (the rule itself exchanges after every sweep, which measured faster at
    every grid size: PERF.md); it raises ValueError where a band's threads cannot hold the halo rows or
    the grid is a single band."""
    tx = -(-W // 4)
    band = -(-H // RESIDENT_MAX_BLOCKS)
    if group > 1:
        own = max(band, group)
        for rt in (4, 8):
            ty = -(-(own + 2 * group) // rt)
            blocks = -(-H // (rt * ty - 2 * group))
            if tx * ty <= RESIDENT_MAX_THREADS and blocks > 1:
                return SweepPlan("resident", rt, tx, ty, blocks, group)
        raise ValueError(f"no resident plan of ({H}, {W}) exchanges every {group} sweeps")
    for rt in (4, 8):
        ty = -(-band // rt)
        if tx * ty <= RESIDENT_MAX_THREADS:
            return SweepPlan("resident", rt, tx, ty, -(-H // (rt * ty)))
    return TILED


def wavefront_sweeps(pot0: torch.Tensor, step_cost: torch.Tensor,
                     passable: torch.Tensor, iters: int,
                     plan: Optional[SweepPlan] = None) -> torch.Tensor:
    """pot0, step_cost: (H, W) float32; passable: (H, W) bool (or float 0/1).
    Returns the potential after ``iters`` sweeps. ``plan`` overrides the
    size rule (``sweep_plan``) on a CUDA tensor, to hold either kernel
    against the twin at any size."""
    _check(pot0, step_cost, passable, iters)
    if pot0.device.type == "cpu":
        return wavefront_sweeps_plain(pot0, step_cost, passable, iters)
    if pot0.device.type != "cuda":
        raise ValueError(f"unsupported device {pot0.device}")
    H, W = pot0.shape
    plan = plan or sweep_plan(H, W)
    lib = load_kernel_library("wavefront_sweep")
    resident, tiled = lib.fitslam_wavefront_sweeps_resident, lib.fitslam_wavefront_sweeps_tiled
    resident.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    tiled.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    resident.restype = tiled.restype = ctypes.c_int
    src = pot0.contiguous()
    step = step_cost.contiguous()
    ok = _as_bool(passable).contiguous().view(torch.uint8)
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        if plan.design == "resident":
            err = resident(
                src.data_ptr(), step.data_ptr(), ok.data_ptr(), H, W, iters,
                plan.rows_per_thread, plan.threads_x, plan.threads_y, plan.group,
                plan.blocks, out.data_ptr(), stream)
        else:
            scratch = torch.empty_like(src)
            err = tiled(
                src.data_ptr(), step.data_ptr(), ok.data_ptr(), H, W, iters,
                out.data_ptr(), scratch.data_ptr(), stream)
    if err == -1:
        raise RuntimeError(f"wavefront_sweep: the card cannot schedule a cluster of "
                           f"{plan.blocks} blocks of {plan.threads_x * plan.threads_y} threads")
    if err == -2:
        raise ValueError(f"wavefront_sweep: {plan} does not cover a ({H}, {W}) grid")
    check_cuda_error(err, "wavefront_sweep")
    wavefront_sweeps.launches += 1
    return out


#: K3 calls on CUDA tensors since the count was last reset (one call runs
#: all ``iters`` sweeps)
wavefront_sweeps.launches = 0
