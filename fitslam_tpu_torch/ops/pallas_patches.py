"""K1, the ORB patch gather (port of ``fitslam_tpu/ops/pallas_patches.py``;
the module keeps the reference's name so the pair maps file to file).

``gather_patches`` launches the hand-written CUDA kernel
``csrc/patch_gather.cu`` on a CUDA tensor and runs ``gather_patches_plain``,
its plain PyTorch twin, on a CPU tensor. There is no fallback between the
two: a build or launch failure raises. ``extract_orb`` no longer calls it:
its main path is the fused describe in the same source
(``ops/orb.py::describe_keypoints``), which shares the window placement.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fitslam_tpu_torch.utils.cuda_build import check_cuda_error, load_kernel_library


def gather_patches_plain(img: torch.Tensor, xy_int: torch.Tensor, patch: int) -> torch.Tensor:
    """(H, W) image + (N, 2) integer (x, y) -> (N, patch, patch) patches of
    the image zero-padded by patch//2. The start is placed as
    lax.dynamic_slice places it: a negative start wraps once by the padded
    extent, then every start is clamped so the window fits."""
    half = patch // 2
    H, W = img.shape
    padded = F.pad(img, (half, half, half, half))
    ext_y, ext_x = padded.shape
    sx = xy_int[:, 0].long()
    sy = xy_int[:, 1].long()
    sx = torch.where(sx < 0, sx + ext_x, sx).clamp(0, ext_x - patch)
    sy = torch.where(sy < 0, sy + ext_y, sy).clamp(0, ext_y - patch)
    off = torch.arange(patch, device=img.device)
    rows = sy[:, None] + off[None, :]
    cols = sx[:, None] + off[None, :]
    return padded[rows[:, :, None], cols[:, None, :]]


def _check(img: torch.Tensor, xy_int: torch.Tensor, patch: int) -> None:
    if img.dim() != 2 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous (H, W) float32 tensor, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if (xy_int.dim() != 2 or xy_int.shape[1] != 2 or xy_int.dtype != torch.int32
            or not xy_int.is_contiguous()):
        raise ValueError(f"xy_int must be a contiguous (N, 2) int32 tensor, got "
                         f"{tuple(xy_int.shape)} {xy_int.dtype}")
    if xy_int.device != img.device:
        raise ValueError("img and xy_int must be on the same device")
    if not 1 <= patch <= 128:
        raise ValueError(f"patch must be in [1, 128], got {patch}")


def gather_patches(img: torch.Tensor, xy_int: torch.Tensor, patch: int) -> torch.Tensor:
    """(H, W) float32 image + (N, 2) int32 (x, y) -> (N, patch, patch)."""
    _check(img, xy_int, patch)
    if img.device.type == "cpu":
        return gather_patches_plain(img, xy_int, patch)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    lib = load_kernel_library("patch_gather")
    fn = lib.fitslam_patch_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    H, W = img.shape
    n = xy_int.shape[0]
    out = torch.empty((n, patch, patch), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), H, W, xy_int.data_ptr(), n, patch, out.data_ptr(), stream)
    check_cuda_error(err, "patch_gather")
    gather_patches.launches += int(n > 0)
    return out


#: K1 launches on CUDA tensors since the count was last reset
gather_patches.launches = 0
