"""ORB feature extraction (port of ``fitslam_tpu/ops/orb.py``).

FAST-9/16 ring score, 3x3 non-max suppression, exact per-level top-k and a
sub-pixel corner parabola per pyramid level; then one describe call for the
keypoints of all levels (``describe_keypoints``): the 40x40 window of each
keypoint, intensity-centroid orientation, in-patch blur and rotated BRIEF
over 30 angle bins. On a CUDA tensor that call is one launch of the fused
kernel in ``csrc/patch_gather.cu`` (K1); on a CPU tensor it runs
``describe_keypoints_plain``, its twin. Outputs are fixed-shape
``FrameFeatures`` with validity masks, field for field as in the reference.

Parity notes (ROADMAP faults F2, F3, F15):
- top-k is a stable descending sort, which returns tied values in ascending
  index order as ``lax.top_k`` does; ``torch.topk`` does not;
- the reference rounds the gathered patch, the blur matrix and the blurred
  patch to bfloat16 and multiplies with float32 accumulation; the port rounds
  at the same three points;
- the twin fixes the order of every sum so that the kernel can repeat it bit
  for bit: the blur is 7 taps in increasing offset, columns then rows, each
  product and add rounded on its own; the moments are summed in float64 in
  the kernel's thread-and-warp tree and rounded once to float32; the angle
  bin divides by 2 pi with a true division.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fitslam_tpu_torch.ops import image as imops
from fitslam_tpu_torch.ops.numerics import top_k_stable
from fitslam_tpu_torch.ops.pallas_patches import gather_patches_plain
from fitslam_tpu_torch.utils.cuda_build import check_cuda_error, load_kernel_library
from fitslam_tpu_torch.utils.transfer import upload

PATCH = 32
HALF = PATCH // 2
EDGE = 16            # border margin where no keypoint is extracted
N_ANGLE_BINS = 30
N_PAIRS = 256

# FAST-16 Bresenham circle of radius 3, in ring order (dr, dc)
_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame features (level-0 coordinates)."""

    xy: torch.Tensor        # (N, 2) float32, (x, y) in level-0 pixels
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 radians
    level: torch.Tensor     # (N,) int32
    desc: torch.Tensor      # (N, 256) bfloat16 in {-1, +1} — rBRIEF bits
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def pack_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """(N, 256) ±1 -> (N, 8) packed bits, bit k of word j = desc[32 j + k] > 0.

    The words are the reference's uint32 values stored as int32 (two's
    complement), the layout K2 reads."""
    bits = (desc > 0).reshape(desc.shape[0], 8, 32).long()
    shifts = torch.arange(32, device=desc.device)
    v = torch.sum(bits << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32).contiguous()


def unpack_descriptors(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) packed words (int32 as ``pack_descriptors`` stores them, or the
    reference's uint32 values) -> (N, 256) ±1 bfloat16."""
    words = packed.long() & 0xFFFFFFFF
    shifts = torch.arange(32, device=packed.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], 256).to(torch.bfloat16) * 2 - 1


# ---------------------------------------------------------------------------
# BRIEF pattern and constant matrices (regenerated with the reference's numpy
# code; tests/test_torch_orb.py asserts they are equal)
# ---------------------------------------------------------------------------


def _make_brief_pattern(seed: int = 7) -> np.ndarray:
    """(N_PAIRS, 2, 2) integer (dr, dc) offsets, Gaussian sigma = patch/5."""
    rng = np.random.RandomState(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_PAIRS, 2, 2))
    return np.clip(np.round(pts), -(HALF - 3), HALF - 3).astype(np.int32)


def _make_rotated_pairs() -> np.ndarray:
    """(N_ANGLE_BINS, N_PAIRS, 2) flat in-patch indices of each pair's points
    A and B, rotated to each angle bin."""
    pattern = _make_brief_pattern()
    out = np.zeros((N_ANGLE_BINS, N_PAIRS, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        theta = 2.0 * math.pi * b / N_ANGLE_BINS
        ct, st = math.cos(theta), math.sin(theta)
        dr, dc = pattern[..., 0], pattern[..., 1]
        rc = np.round(ct * dc - st * dr).astype(np.int32)
        rr = np.round(st * dc + ct * dr).astype(np.int32)
        rr = np.clip(rr + HALF, 0, PATCH - 1)
        rc = np.clip(rc + HALF, 0, PATCH - 1)
        out[b] = rr * PATCH + rc
    return out


def _make_rotated_diff_matrix() -> np.ndarray:
    """(PATCH*PATCH, N_ANGLE_BINS * N_PAIRS) sampling-difference matrix of the
    reference: +1 at pair k's rotated point A, -1 at point B, per bin.

    The port does not multiply by it: ``patch @ D`` has at most two non-zero
    terms per column, so it equals ``patch[A] - patch[B]`` exactly, which
    ``_descriptors`` gathers directly from ``_ROTATED_PAIRS``."""
    flat = _make_rotated_pairs()
    D = np.zeros((PATCH * PATCH, N_ANGLE_BINS * N_PAIRS), dtype=np.float32)
    for b in range(N_ANGLE_BINS):
        for k in range(N_PAIRS):
            D[flat[b, k, 0], b * N_PAIRS + k] += 1.0
            D[flat[b, k, 1], b * N_PAIRS + k] -= 1.0
    return D


_ROTATED_PAIRS = _make_rotated_pairs()

_rr, _cc = np.meshgrid(np.arange(PATCH) - HALF, np.arange(PATCH) - HALF, indexing="ij")
_CIRC = ((_rr**2 + _cc**2) <= 15**2).astype(np.float32)
_W_CENTROID = np.stack(
    [(_cc * _CIRC).reshape(-1), (_rr * _CIRC).reshape(-1)], axis=-1
).astype(np.float32)  # columns: [x-moment, y-moment]

GPATCH = 40
_GHALF = GPATCH // 2


def _make_blur_matrix(sigma: float = 2.0, radius: int = 3) -> np.ndarray:
    off = np.arange(-radius, radius + 1)
    w = np.exp(-(off.astype(np.float64) ** 2) / (2.0 * sigma * sigma))
    w /= w.sum()
    B = np.zeros((GPATCH, PATCH), np.float32)
    margin = _GHALF - HALF
    for j in range(PATCH):
        for k, o in enumerate(off):
            B[j + margin + o, j] += w[k]
    return B


_BLUR_MATRIX = _make_blur_matrix()
# the matrix's 7 taps (one column, offsets -3..3), rounded to bfloat16 as the
# reference rounds the matrix; every column holds the same 7
_BLUR_TAPS = tuple(torch.as_tensor(_BLUR_MATRIX[_GHALF - HALF - 3:_GHALF - HALF + 4, 0])
                   .bfloat16().float().tolist())
# the moments' summation tree: 4 pixels a thread, 32 threads a warp, 8 warps
_THREADS = 256


_device_constants: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _on_device(name: str, device) -> torch.Tensor:
    """A module constant on ``device``, uploaded once and without a wait
    (``upload``): ``torch.as_tensor(..., device=)`` would be a synchronous
    host-to-device copy."""
    key = (name, torch.device(device))
    if key not in _device_constants:
        value = {"pairs": _ROTATED_PAIRS.astype(np.int32),
                 "w_centroid64": np.ascontiguousarray(_W_CENTROID.T, np.float64)}[name]
        _device_constants[key] = upload(value, device)
    return _device_constants[key]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# FAST corner response
# ---------------------------------------------------------------------------


def _rotl16(b: torch.Tensor, k: int) -> torch.Tensor:
    return ((b << k) | (b >> (16 - k))) & 0xFFFF


def _contiguous9(bits16: torch.Tensor) -> torch.Tensor:
    """(16, H, W) 0/1 ring bits -> (H, W) bool: >= 9 contiguous set bits."""
    weights = (2 ** torch.arange(16, device=bits16.device, dtype=torch.int32))
    b = torch.sum(bits16 * weights[:, None, None], dim=0, dtype=torch.int32)
    c2 = b & _rotl16(b, 1)
    c4 = c2 & _rotl16(c2, 2)
    c8 = c4 & _rotl16(c4, 4)
    c9 = c8 & _rotl16(b, 8)
    return c9 != 0


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 corner score (0 where not a corner). The ring is
    built with rolls; their wrap-around only reaches the EDGE border, which
    the caller masks."""
    ring = torch.stack(
        [torch.roll(img, shifts=(-int(dr), -int(dc)), dims=(-2, -1)) for dr, dc in _FAST_OFFSETS],
        dim=0)
    diff = ring - img[None]
    t = float(threshold)
    bright = (diff > t).to(torch.int32)
    dark = (diff < -t).to(torch.int32)
    is_corner = _contiguous9(bright) | _contiguous9(dark)
    excess_b = torch.sum(torch.clamp(diff - t, min=0.0), dim=0)
    excess_d = torch.sum(torch.clamp(-diff - t, min=0.0), dim=0)
    score = torch.maximum(excess_b, excess_d)
    return torch.where(is_corner, score, torch.zeros_like(score))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    neigh_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh_max, score, torch.zeros_like(score))


def _border_mask(h: int, w: int, margin: int, device) -> torch.Tensor:
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return (r >= margin) & (r < h - margin) & (c >= margin) & (c < w - margin)


# ---------------------------------------------------------------------------
# Patch-based orientation + descriptor (the twin of the fused kernel)
# ---------------------------------------------------------------------------


def _orientations(patches: torch.Tensor) -> torch.Tensor:
    """(N, 32, 32) raw patches -> (N,) intensity-centroid angles. The moments
    are float64 sums in the kernel's order (thread t sums pixels t, t+256,
    t+512, t+768; then lanes pair at distance 16..1 in each warp and warps
    at 4..1), rounded once to float32."""
    n = patches.shape[0]
    w = _on_device("w_centroid64", patches.device)            # (2, 1024)
    p = patches.reshape(n, 1, 4, _THREADS).double() * w.reshape(1, 2, 4, _THREADS)
    s = ((p[:, :, 0] + p[:, :, 1]) + p[:, :, 2]) + p[:, :, 3]  # (N, 2, 256): a thread each
    s = s.reshape(n, 2, _THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    s = s[..., 0]                                            # (N, 2, 8): a warp each
    for off in (4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    m = s[..., 0].float()                                    # (N, 2) = [m10, m01]
    return torch.atan2(m[:, 1], m[:, 0])


def _angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """round(angle / 2 pi * 30) mod 30. The divisor is a tensor: PyTorch
    divides by a CPU scalar on CUDA through its reciprocal, on the CPU truly."""
    q = angle / torch.full_like(angle, 2.0 * math.pi)
    return torch.round(q * N_ANGLE_BINS).long() % N_ANGLE_BINS


def _blur(window: torch.Tensor) -> torch.Tensor:
    """(N, 40, 40) bf16-valued windows -> (N, 32, 32): the separable blur as
    7 taps in increasing offset, columns then rows, each product and add a
    float32 operation of its own."""
    lo = _GHALF - HALF - 3
    cols = window[:, :, lo:lo + PATCH] * _BLUR_TAPS[0]
    for q in range(1, 7):
        cols = cols + window[:, :, lo + q:lo + q + PATCH] * _BLUR_TAPS[q]
    rows = cols[:, lo:lo + PATCH, :] * _BLUR_TAPS[0]
    for q in range(1, 7):
        rows = rows + cols[:, lo + q:lo + q + PATCH, :] * _BLUR_TAPS[q]
    return rows


def _descriptors(smooth: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """rBRIEF: (N, 1024) bf16-valued blurred patches + angle bins -> (N, 256)
    ±1 bfloat16, +1 where the pair's point A is darker than point B."""
    pairs = _on_device("pairs", smooth.device)[bins].long()  # (N, 256, 2)
    a = torch.gather(smooth, 1, pairs[:, :, 0])
    b = torch.gather(smooth, 1, pairs[:, :, 1])
    sel = a - b
    return torch.where(sel < 0, 1.0, -1.0).to(torch.bfloat16)


def _check_describe(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                    counts: Sequence[int]) -> None:
    if not 1 <= len(levels) <= 8 or len(counts) != len(levels):
        raise ValueError(f"1-8 levels with a keypoint count each, got {len(levels)} levels "
                         f"and {len(counts)} counts")
    for img in levels:
        if (img.dim() != 2 or img.dtype != torch.float32 or not img.is_contiguous()
                or img.device != xy.device):
            raise ValueError(f"levels must be contiguous (H, W) float32 tensors on the "
                             f"keypoints' device, got {tuple(img.shape)} {img.dtype} {img.device}")
    if (xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype != torch.int32
            or not xy.is_contiguous()):
        raise ValueError(f"xy must be a contiguous (N, 2) int32 tensor, got "
                         f"{tuple(xy.shape)} {xy.dtype}")
    if min(counts) < 0 or sum(counts) != xy.shape[0]:
        raise ValueError(f"keypoint counts {list(counts)} do not add up to N={xy.shape[0]}")


def describe_keypoints_plain(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                             counts: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of the fused kernel: the keypoints of all levels (``counts[l]``
    of level ``l``, concatenated in level order in ``xy``) -> (angle (N,)
    float32, desc (N, 256) ±1 bfloat16)."""
    _check_describe(levels, xy, counts)
    parts = torch.split(xy, list(counts))
    window = torch.cat([gather_patches_plain(img, p, GPATCH) for img, p in zip(levels, parts)])
    crop = _GHALF - HALF
    angle = _orientations(window[:, crop:crop + PATCH, crop:crop + PATCH])
    smooth = _bf16(_blur(_bf16(window))).reshape(-1, PATCH * PATCH)
    return angle, _descriptors(smooth, _angle_bins(angle))


def describe_keypoints(levels: Sequence[torch.Tensor], xy: torch.Tensor,
                       counts: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angle and rBRIEF descriptor of the keypoints of all pyramid levels.

    ``levels``: the level images, (H_l, W_l) float32; ``xy``: (N, 2) int32
    integer (x, y) of ``counts[l]`` keypoints of each level ``l``, in level
    order. Returns (angle (N,) float32, desc (N, 256) ±1 bfloat16) in that
    order. One launch of the fused kernel on a CUDA tensor (a build or launch
    failure raises), the plain twin on a CPU tensor."""
    _check_describe(levels, xy, counts)
    if xy.device.type == "cpu":
        return describe_keypoints_plain(levels, xy, counts)
    if xy.device.type != "cuda":
        raise ValueError(f"unsupported device {xy.device}")
    lib = load_kernel_library("patch_gather")
    fn = lib.fitslam_orb_describe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_lv, n = len(levels), xy.shape[0]
    imgs = (ctypes.c_void_p * n_lv)(*(img.data_ptr() for img in levels))
    hs = (ctypes.c_int * n_lv)(*(img.shape[0] for img in levels))
    ws = (ctypes.c_int * n_lv)(*(img.shape[1] for img in levels))
    cnt = (ctypes.c_int * n_lv)(*counts)
    taps = (ctypes.c_float * 7)(*_BLUR_TAPS)
    pairs = _on_device("pairs", xy.device)
    angle = torch.empty((n,), dtype=torch.float32, device=xy.device)
    desc = torch.empty((n, N_PAIRS), dtype=torch.bfloat16, device=xy.device)
    with torch.cuda.device(xy.device):
        stream = torch.cuda.current_stream(xy.device).cuda_stream
        err = fn(n_lv, imgs, hs, ws, cnt, xy.data_ptr(), taps, pairs.data_ptr(),
                 angle.data_ptr(), desc.data_ptr(), stream)
    check_cuda_error(err, "orb_describe")
    describe_keypoints.launches += int(n > 0)
    return angle, desc


#: fused-kernel launches on CUDA tensors since the count was last reset
describe_keypoints.launches = 0


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------


def _level_feature_counts(num_features: int, num_levels: int, scale_factor: float) -> List[int]:
    inv = [1.0 / (scale_factor ** (2 * l)) for l in range(num_levels)]
    total = sum(inv)
    counts = [max(8, int(round(num_features * v / total))) for v in inv]
    counts[0] += num_features - sum(counts)
    return counts


def extract_orb(
    img: torch.Tensor,
    num_features: int = 1024,
    num_levels: int = 4,
    scale_factor: float = 1.4142135,
    fast_threshold: float = 20.0,
) -> FrameFeatures:
    """Extract ORB features from a grayscale float32 image (H, W) in [0, 255]."""
    dev = img.device
    pyr = [level.contiguous() for level in imops.build_pyramid(img, num_levels, scale_factor)]
    counts = _level_feature_counts(num_features, num_levels, scale_factor)
    h0, w0 = img.shape[-2:]

    kps, xs, ys, resp, lvls, valids = [], [], [], [], [], []
    for lvl, (level_img, k_lvl) in enumerate(zip(pyr, counts)):
        h, w = level_img.shape[-2:]
        sx = w0 / w
        sy = h0 / h
        score_raw = fast_score_map(level_img, fast_threshold)
        score = _nms3(score_raw)
        score = torch.where(_border_mask(h, w, EDGE, dev), score, torch.zeros_like(score))
        flat = score.reshape(-1)
        k_lvl = min(k_lvl, flat.shape[0])
        top_scores, top_idx = top_k_stable(flat, k_lvl)
        yy = (top_idx // w).to(torch.int32)
        xx = (top_idx % w).to(torch.int32)
        ok = top_scores > 0.0
        kps.append(torch.stack([xx, yy], dim=-1))

        yl, xl = yy.long(), xx.long()
        sxp = score_raw[yl, torch.clamp(xl + 1, max=w - 1)]
        sxm = score_raw[yl, torch.clamp(xl - 1, min=0)]
        syp = score_raw[torch.clamp(yl + 1, max=h - 1), xl]
        sym = score_raw[torch.clamp(yl - 1, min=0), xl]
        s0 = score_raw[yl, xl]
        den_x = sxm - 2.0 * s0 + sxp
        den_y = sym - 2.0 * s0 + syp
        safe_x = torch.where(den_x.abs() > 1e-6, den_x, torch.ones_like(den_x))
        safe_y = torch.where(den_y.abs() > 1e-6, den_y, torch.ones_like(den_y))
        ddx = torch.where(den_x.abs() > 1e-6, 0.5 * (sxm - sxp) / safe_x, torch.zeros_like(den_x))
        ddy = torch.where(den_y.abs() > 1e-6, 0.5 * (sym - syp) / safe_y, torch.zeros_like(den_y))
        ddx = torch.clamp(ddx, -0.5, 0.5)
        ddy = torch.clamp(ddy, -0.5, 0.5)

        xs.append((xx.float() + ddx) * sx)
        ys.append((yy.float() + ddy) * sy)
        resp.append(top_scores)
        lvls.append(torch.full((k_lvl,), lvl, dtype=torch.int32, device=dev))
        valids.append(ok)

    angle, desc = describe_keypoints(pyr, torch.cat(kps).contiguous(), [k.shape[0] for k in kps])
    xy = torch.stack([torch.cat(xs), torch.cat(ys)], dim=-1)
    response = torch.cat(resp)
    level = torch.cat(lvls)
    valid = torch.cat(valids)

    n = xy.shape[0]
    if n != num_features:
        order_scores = torch.where(valid, response, torch.full_like(response, -1.0))
        _, order = top_k_stable(order_scores, num_features)
        xy, response, angle = xy[order], response[order], angle[order]
        level, desc, valid = level[order], desc[order], valid[order]
    return FrameFeatures(xy, response, angle, level, desc, valid)
