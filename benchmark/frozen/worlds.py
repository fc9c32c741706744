"""Frozen copies of the port's synthetic worlds, trajectories and stereo
renderer (``fitslam_tpu_torch/data/synthetic.py`` and the helpers of
``ops/numerics.py`` and ``ops/geometry.py`` it calls), so that a later change
to the port cannot change the benchmark's camera stream. Each function names
the lines it was copied from; the arithmetic is the same operation for
operation, so a frame rendered here equals the port's bit for bit
(``benchmark/tests/test_frozen.py``).

A pose is a pair ``(R, t)`` of float32 tensors, world-from-camera: camera +z
forward, +x right, +y down. Landmarks are an (L, 3) float32 tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.frozen import prng


# ops/numerics.py:16-21
def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as IEEE division, on either device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


# ops/numerics.py:31-36
def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


# ops/numerics.py:60-84 (segment_plan + segment_sum_fixed)
def segment_sum_fixed(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of each segment one after the other in row order."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    keys, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(n + 1, device=ids.device))
    flat = data.reshape(data.shape[0], math.prod(data.shape[1:]))[order]
    out = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0, unsafe=True, initial=0.0)
    return out.reshape((n,) + tuple(data.shape[1:]))


# data/synthetic.py:65-70
def _wall_offsets(k_side, k_noise, num: int, base: float, width: float) -> np.ndarray:
    side = np.where(prng.bernoulli(k_side, 0.5, (num,)), np.float32(1), np.float32(-1))
    wall = np.float32(base) + side * np.float32(width) / np.float32(2)
    return wall + np.float32(0.05) * prng.normal(k_noise, (num,))


# data/synthetic.py:73-81
def corridor_world(seed: int, num: int, length: float, width: float) -> np.ndarray:
    """(num, 3) float32 landmarks on the two walls of a corridor along +x,
    drawn from ``jax.random.PRNGKey(seed)``'s stream."""
    key = prng.prng_key(seed)
    k1, k2, k3 = prng.split(key, 3)
    x = prng.uniform(k1, (num,), 0.0, length)
    y = _wall_offsets(k2, k3, num, 0.0, width)
    z = prng.uniform(prng.fold_in(key, 7), (num,), 0.0, 2.5)
    return np.stack([x, y, z], axis=-1)


# data/synthetic.py:140-149
def straight_trajectory(num_frames: int, length: float, height: float, start_x: float,
                        device) -> tuple:
    """Camera moving along +x looking forward: (R (N, 3, 3), t (N, 3))."""
    x = torch.linspace(start_x, start_x + length, num_frames, device=device)
    t_wc = torch.stack([x, torch.zeros_like(x), torch.full_like(x, height)], dim=-1)
    fwd = torch.tensor([1.0, 0.0, 0.0], device=device).expand(t_wc.shape)
    down = torch.tensor([0.0, 0.0, -1.0], device=device).expand(t_wc.shape)
    right = torch.linalg.cross(down, fwd)
    return torch.stack([right, down, fwd], dim=-1), t_wc


# data/synthetic.py:186-192
def _hash01(i: torch.Tensor) -> torch.Tensor:
    x = (i.long() * 2654435761) & 0xFFFFFFFF
    x = x ^ 0x9E3779B9
    x = x ^ (x >> 16)
    return true_div((x & 0xFFFF).float(), 65535.0)


# data/synthetic.py:195-218
def _splat(u, v, lum, height, width, sigma):
    R = 3
    dev = u.device
    iu = torch.round(u).long()
    iv = torch.round(v).long()
    offs = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    sig = sig[:, None, None] if sig.dim() == 1 else sig
    w = torch.exp((-(dx ** 2 + dy ** 2) / (2 * sig * sig)).double()).float()
    w = torch.broadcast_to(w, (u.shape[0], 2 * R + 1, 2 * R + 1))
    rows = iv[:, None, None] + dy[None]
    cols = iu[:, None, None] + dx[None]
    vals = lum[:, None, None] * w
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = torch.where(inb, rows * width + cols, height * width)
    img = segment_sum_fixed(torch.where(inb, vals, 0.0).reshape(-1), flat.reshape(-1),
                            height * width)
    return torch.clamp(img.reshape(height, width), 0.0, 255.0)


# data/synthetic.py:221-234
def _dot3(a0, b0, a1, b1, a2, b2):
    return fma32(a2, b2, fma32(a1, b1, a0 * b0))


def _to_camera(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    t_inv = [-_dot3(R[0, i], t[0], R[1, i], t[1], R[2, i], t[2]) for i in range(3)]
    return torch.stack([_dot3(pts[:, 0], R[0, i], pts[:, 1], R[1, i], pts[:, 2], R[2, i])
                        + t_inv[i] for i in range(3)], dim=-1)


class Camera:
    """Pinhole stereo intrinsics as the port holds them: float32 0-d tensors
    (``ops/geometry.py:17-34``)."""

    def __init__(self, fx, fy, cx, cy, baseline, device):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.fx, self.fy, self.cx, self.cy, self.baseline = f(fx), f(fy), f(cx), f(cy), f(baseline)
        self.bf = self.baseline * self.fx


# ops/geometry.py:37-44 + data/synthetic.py:237-242
def _eye_image(K: Camera, landmarks, R, t, lum, sig, width, height, max_depth):
    p_c = _to_camera(R, t, landmarks)
    z = p_c[..., 2]
    z_ok = z > 1e-3
    z_safe = torch.where(z_ok, z, torch.ones_like(z))
    u = K.fx * p_c[..., 0] / z_safe + K.cx
    v = K.fy * p_c[..., 1] / z_safe + K.cy
    vis = z_ok & (z < max_depth)
    return _splat(u, v, torch.where(vis, lum, 0.0), height, width, sig)


# data/synthetic.py:245-274 (render_stereo -> render_dense -> _stereo_images)
def render_stereo(K: Camera, landmarks: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                  width: int, height: int, max_depth: float = 18.0,
                  splat_sigma: float = 1.2):
    """(left, right) float32 grey images of Gaussian blobs, one a landmark."""
    idx = torch.arange(landmarks.shape[0], device=landmarks.device)
    lum = 60.0 + 195.0 * _hash01(idx)
    sig = splat_sigma * (0.6 + 1.4 * _hash01(idx + 77777))
    left = _eye_image(K, landmarks, R, t, lum, sig, width, height, max_depth)
    right = _eye_image(K, landmarks, R, t + R[..., :, 0] * K.baseline, lum, sig, width, height,
                       max_depth)
    return left, right
