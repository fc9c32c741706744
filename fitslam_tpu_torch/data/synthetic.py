"""Procedural stereo frames (port of the dense renderer in
``fitslam_tpu/data/synthetic.py``): a straight corridor trajectory and a
Gaussian-blob renderer of a landmark world.

Worlds come from files, not from a seed: the reference draws them with
``jax.random``, which torch cannot reproduce (ROADMAP fault F4). The bench
world is committed as ``tests/data/bench_corridor_world.npz`` (``load_world``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics, project_stereo

BENCH_WORLD = Path(__file__).resolve().parents[2] / "tests" / "data" / "bench_corridor_world.npz"


def load_world(path=BENCH_WORLD, device="cuda") -> torch.Tensor:
    """(L, 3) float32 world landmarks from an npz with a ``landmarks`` array."""
    return torch.as_tensor(np.load(path)["landmarks"].astype(np.float32), device=device)


def straight_trajectory(num_frames: int, length: float = 30.0, height: float = 1.2,
                        start_x: float = 2.0, device="cuda") -> lie.SE3:
    """Camera moving along +x looking forward (corridor sequence), T_wc."""
    x = torch.linspace(start_x, start_x + length, num_frames, device=device)
    t_wc = torch.stack([x, torch.zeros_like(x), torch.full_like(x, height)], dim=-1)
    fwd = torch.tensor([1.0, 0.0, 0.0], device=device).expand(t_wc.shape)
    down = torch.tensor([0.0, 0.0, -1.0], device=device).expand(t_wc.shape)
    right = torch.linalg.cross(down, fwd)
    R_wc = torch.stack([right, down, fwd], dim=-1)
    return lie.SE3(R_wc, t_wc)


def _hash01(i: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash, in int64 arithmetic masked to 32 bits."""
    x = (i.long() * 2654435761) & 0xFFFFFFFF
    x = x ^ 0x9E3779B9
    x = x ^ (x >> 16)
    return (x & 0xFFFF).float() / 65535.0


def _splat(u, v, lum, height, width, sigma):
    """Scatter-add Gaussian blobs: a 7x7 stamp per landmark. ``sigma`` is a
    scalar or a per-landmark (L,) tensor."""
    R = 3
    dev = u.device
    iu = torch.round(u).long()
    iv = torch.round(v).long()
    offs = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    sig = sig[:, None, None] if sig.dim() == 1 else sig
    w = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sig * sig))
    w = torch.broadcast_to(w, (u.shape[0], 2 * R + 1, 2 * R + 1))
    rows = iv[:, None, None] + dy[None]
    cols = iu[:, None, None] + dx[None]
    vals = lum[:, None, None] * w
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = torch.where(inb, rows * width + cols, height * width)
    img = torch.zeros((height * width + 1,), dtype=torch.float32, device=dev)
    img.index_add_(0, flat.reshape(-1), torch.where(inb, vals, 0.0).reshape(-1))
    return torch.clamp(img[: height * width].reshape(height, width), 0.0, 255.0)


def render_dense(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, width: int = 640,
                 height: int = 480, splat_sigma: float = 1.5,
                 max_depth: float = 25.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (left, right) grayscale images: landmarks splatted as Gaussian
    blobs with per-landmark deterministic intensity and size."""
    idx = torch.arange(landmarks.shape[0], device=landmarks.device)
    lum = 60.0 + 195.0 * _hash01(idx)
    sig = splat_sigma * (0.6 + 1.4 * _hash01(idx + 77777))

    def render_one(T_cam: lie.SE3):
        p_c = lie.apply(lie.inverse(T_cam), landmarks)
        uvr, z_ok = project_stereo(K, p_c)
        vis = z_ok & (p_c[..., 2] < max_depth)
        return _splat(uvr[..., 0], uvr[..., 1], torch.where(vis, lum, 0.0), height, width, sig)

    left = render_one(T_wc)
    # right camera: offset by +baseline along the camera x-axis
    right = render_one(lie.SE3(T_wc.R, T_wc.t + T_wc.R[..., :, 0] * K.baseline))
    return left, right


def render_stereo(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3,
                  width: int = 640, height: int = 480, splat_sigma: float = 1.2,
                  max_depth: float = 18.0):
    """Stereo rendering with the reference's ``render_stereo`` defaults."""
    return render_dense(K, landmarks, T_wc, width=width, height=height,
                        splat_sigma=splat_sigma, max_depth=max_depth)
