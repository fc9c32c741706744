"""K3, the wavefront sweep (port of ``fitslam_tpu/ops/pallas_grid.py``; the
module keeps the reference's name so the pair maps file to file).

``wavefront_sweeps`` runs ``iters`` Jacobi min-plus relaxation sweeps of a
(G, G) potential: every sweep reads only the previous sweep's potential,

    pot = min(pot, where(passable, min4(neighbours) + step, BIG)),

with a neighbour outside the grid counting as BIG. On a CUDA tensor it
launches the hand-written kernel ``csrc/wavefront_sweep.cu`` (all sweeps in
one call from Python); on a CPU tensor it runs ``wavefront_sweeps_plain``,
the plain PyTorch twin. There is no fallback between the two: a build or
launch failure raises. With ``min`` and one float32 ``+`` per cell and sweep,
kernel and twin agree exactly.
"""

from __future__ import annotations

import ctypes

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


def wavefront_sweeps(pot0: torch.Tensor, step_cost: torch.Tensor,
                     passable: torch.Tensor, iters: int) -> torch.Tensor:
    """pot0, step_cost: (H, W) float32; passable: (H, W) bool (or float 0/1).
    Returns the potential after ``iters`` sweeps."""
    _check(pot0, step_cost, passable, iters)
    if pot0.device.type == "cpu":
        return wavefront_sweeps_plain(pot0, step_cost, passable, iters)
    if pot0.device.type != "cuda":
        raise ValueError(f"unsupported device {pot0.device}")
    lib = load_kernel_library("wavefront_sweep")
    fn = lib.fitslam_wavefront_sweeps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    H, W = pot0.shape
    src = pot0.contiguous()
    step = step_cost.contiguous()
    ok = _as_bool(passable).contiguous().view(torch.uint8)
    out = torch.empty_like(src)
    scratch = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), step.data_ptr(), ok.data_ptr(), H, W, iters,
                 out.data_ptr(), scratch.data_ptr(), stream)
    check_cuda_error(err, "wavefront_sweep")
    wavefront_sweeps.launches += 1
    return out


#: K3 calls on CUDA tensors since the count was last reset (one call runs
#: all ``iters`` sweeps)
wavefront_sweeps.launches = 0
