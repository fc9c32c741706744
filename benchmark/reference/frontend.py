"""Plain reference of the stereo frontend: ORB keypoints and rotated-BRIEF
descriptors of one grey image, and the sub-pixel stereo disparity of a
feature, written from the method's description in plain PyTorch.

It follows the semantics the port states (``ORB`` in ORB-SLAM's sense, with
the port's fixed sizes): an image pyramid of ``num_levels`` levels, each
``scale_factor`` smaller and cut to a multiple of 8, made by an antialiased
bilinear resize of the level above; on each level the FAST-9/16 corner score
(the larger of the bright and dark excess sums over the 16-pixel ring, 0
where no 9 contiguous ring pixels pass the threshold), a 3x3 non-maximum
suppression, a 16-pixel border, the level's share of the features by score
(ties to the lower raster index) and a parabola through the raw scores for
the sub-pixel position; then on the integer keypoint of its level the
intensity-centroid angle over the 31-pixel disc of a 32x32 patch, the patch
blurred by a 7-tap Gaussian (sigma 2) with the window, the taps and the
result rounded to bfloat16, and 256 point-pair tests of the ORB pattern
rotated to one of 30 angle bins (+1 where the first point is darker).

Nothing here comes from the program: the pattern is drawn anew from its
stated seed, the sums are taken in their natural order, and ``dtype`` sets
the precision every image operation runs in (float32 as the configuration
states; the control runs it in bfloat16).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PATCH, HALF, WINDOW = 32, 16, 40
EDGE = 16
N_PAIRS, N_BINS = 256, 30
FAST_RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
             (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (N, 2) float32 level-0 pixels, sub-pixel
    level: torch.Tensor   # (N,) int64
    ixy: torch.Tensor     # (N, 2) int64 integer (x, y) on the keypoint's level
    score: torch.Tensor   # (N,)
    valid: torch.Tensor   # (N,) bool
    desc: torch.Tensor    # (N, 256) bool, True = +1


def pyramid_shapes(h: int, w: int, levels: int, scale: float) -> List[Tuple[int, int]]:
    return [(max(32, int(math.floor(h / scale ** l / 8)) * 8),
             max(32, int(math.floor(w / scale ** l / 8)) * 8)) for l in range(levels)]


def level_counts(n: int, levels: int, scale: float) -> List[int]:
    """Features a level: proportional to its area, at least 8, the rest on
    level 0."""
    inv = [1.0 / scale ** (2 * l) for l in range(levels)]
    counts = [max(8, int(round(n * v / sum(inv)))) for v in inv]
    counts[0] += n - sum(counts)
    return counts


def pyramid(img: torch.Tensor, levels: int, scale: float, dtype=torch.float32):
    shapes = pyramid_shapes(img.shape[0], img.shape[1], levels, scale)
    out = [img.to(dtype)]
    for hw in shapes[1:]:
        out.append(F.interpolate(out[-1][None, None].float(), size=hw, mode="bilinear",
                                 align_corners=False, antialias=True)[0, 0].to(dtype))
    return out


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 score of every pixel at least 3 from the border (0
    elsewhere and where no 9 contiguous ring pixels pass)."""
    h, w = img.shape
    c = img[3:h - 3, 3:w - 3]
    ring = torch.stack([img[3 + dr:h - 3 + dr, 3 + dc:w - 3 + dc] for dr, dc in FAST_RING]) - c
    corner = torch.zeros_like(c, dtype=torch.bool)
    for passed in (ring > threshold, ring < -threshold):
        for start in range(16):
            ok = passed[start]
            for k in range(1, 9):
                ok = ok & passed[(start + k) % 16]
            corner = corner | ok
    excess = torch.maximum(torch.clamp(ring - threshold, min=0).sum(0),
                           torch.clamp(-ring - threshold, min=0).sum(0))
    score = torch.zeros_like(img)
    score[3:h - 3, 3:w - 3] = torch.where(corner, excess, torch.zeros_like(excess))
    return score


def detect(levels, num_features: int, scale: float, threshold: float):
    """Per level: (integer x, y, score, sub-pixel level-0 x, y) of its share
    of the features, best score first."""
    h0, w0 = levels[0].shape
    out = []
    for lvl, (img, k) in enumerate(zip(levels, level_counts(num_features, len(levels), scale))):
        h, w = img.shape
        raw = fast_score(img, threshold)
        pooled = F.max_pool2d(raw[None, None].float(), 3, stride=1, padding=1)[0, 0].to(raw.dtype)
        s = torch.where(raw >= pooled, raw, torch.zeros_like(raw))
        s[:EDGE], s[h - EDGE:], s[:, :EDGE], s[:, w - EDGE:] = 0, 0, 0, 0
        flat = s.reshape(-1)
        k = min(k, flat.numel())
        order = torch.sort(flat, descending=True, stable=True).indices[:k]
        y, x = order // w, order % w
        top = flat[order]

        def at(yy, xx):
            return raw[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

        s0 = at(y, x)
        sub = []
        for lo, hi in ((at(y, x - 1), at(y, x + 1)), (at(y - 1, x), at(y + 1, x))):
            den = lo - 2 * s0 + hi
            ok = den.abs() > 1e-6
            d = torch.where(ok, 0.5 * (lo - hi) / torch.where(ok, den, torch.ones_like(den)),
                            torch.zeros_like(den))
            sub.append(d.clamp(-0.5, 0.5))
        fx = (x.to(sub[0].dtype) + sub[0]) * (w0 / w)
        fy = (y.to(sub[1].dtype) + sub[1]) * (h0 / h)
        out.append((x, y, top, fx, fy))
    return out


def brief_pairs() -> np.ndarray:
    """(30, 256, 2) flat indices into a 32x32 patch of each pair's points,
    rotated to each angle bin: the pattern is 256 pairs of Gaussian offsets
    (sigma = 32 / 5) from ``RandomState(7)``, rounded and kept 3 pixels
    inside the patch."""
    pts = np.random.RandomState(7).normal(0.0, PATCH / 5.0, size=(N_PAIRS, 2, 2))
    pat = np.clip(np.round(pts), -(HALF - 3), HALF - 3)
    out = np.zeros((N_BINS, N_PAIRS, 2), np.int64)
    for b in range(N_BINS):
        th = 2 * math.pi * b / N_BINS
        dr, dc = pat[..., 0], pat[..., 1]
        rc = np.clip(np.round(math.cos(th) * dc - math.sin(th) * dr) + HALF, 0, PATCH - 1)
        rr = np.clip(np.round(math.sin(th) * dc + math.cos(th) * dr) + HALF, 0, PATCH - 1)
        out[b] = (rr * PATCH + rc).astype(np.int64)
    return out


def blur_taps(dtype=torch.bfloat16) -> torch.Tensor:
    off = np.arange(-3, 4, dtype=np.float64)
    w = np.exp(-off ** 2 / 8.0)
    return torch.tensor(w / w.sum(), dtype=torch.float32).to(dtype).float()


def describe(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, dtype=torch.float32):
    """(angle, (N, 256) bool descriptor) of integer keypoints (x, y) on
    ``img``: the 40x40 window around each (zero outside the image)."""
    dev = img.device
    pad = F.pad(img.float(), (WINDOW // 2,) * 4)
    off = torch.arange(WINDOW, device=dev)
    win = pad[(y[:, None] + off)[:, :, None], (x[:, None] + off)[:, None, :]]   # (N, 40, 40)
    c = WINDOW // 2 - HALF
    patch = win[:, c:c + PATCH, c:c + PATCH].double()
    rr, cc = torch.meshgrid(torch.arange(PATCH, device=dev) - HALF,
                            torch.arange(PATCH, device=dev) - HALF, indexing="ij")
    disc = (rr ** 2 + cc ** 2 <= 15 ** 2).double()
    m10 = (patch * cc * disc).sum((1, 2)).float()
    m01 = (patch * rr * disc).sum((1, 2)).float()
    angle = torch.atan2(m01, m10)
    bins = torch.round(angle / (2 * math.pi) * N_BINS).long() % N_BINS
    # separable blur: columns, then rows; every stage rounded to bfloat16
    # where the method rounds it, the sums in ``dtype``
    taps = blur_taps().to(dev).to(dtype)
    w16 = win.to(torch.bfloat16).to(dtype)
    cols = sum(w16[:, :, c - 3 + q:c - 3 + q + PATCH] * taps[q] for q in range(7))
    rows = sum(cols[:, c - 3 + q:c - 3 + q + PATCH, :] * taps[q] for q in range(7))
    smooth = rows.to(torch.bfloat16).float().reshape(-1, PATCH * PATCH)
    pairs = torch.as_tensor(brief_pairs(), device=dev)[bins]                    # (N, 256, 2)
    a = torch.gather(smooth, 1, pairs[..., 0])
    b = torch.gather(smooth, 1, pairs[..., 1])
    return angle, a < b


def extract(img: torch.Tensor, num_features: int, levels: int, scale: float,
            threshold: float, dtype=torch.float32) -> Keypoints:
    pyr = pyramid(img, levels, scale, dtype)
    xs, ys, lv, ix, iy, sc, ds = [], [], [], [], [], [], []
    for lvl, (x, y, top, fx, fy) in enumerate(detect(pyr, num_features, scale, threshold)):
        _, desc = describe(pyr[lvl], x, y, dtype)
        xs.append(fx.float()), ys.append(fy.float()), ix.append(x), iy.append(y)
        sc.append(top.float()), ds.append(desc)
        lv.append(torch.full_like(x, lvl))
    score = torch.cat(sc)
    return Keypoints(torch.stack([torch.cat(xs), torch.cat(ys)], -1), torch.cat(lv),
                     torch.stack([torch.cat(ix), torch.cat(iy)], -1), score, score > 0,
                     torch.cat(ds))


def ssd_disparity(img_l: torch.Tensor, img_r: torch.Tensor, x_l: torch.Tensor,
                  y_l: torch.Tensor, x_r_int: torch.Tensor, dtype=torch.float32):
    """Sub-pixel disparity of left features (x_l, y_l) whose right match lies
    at the integer column ``x_r_int``: the zero-mean sum of squared
    differences of a 7x5 window at the right columns x_r_int - 1, x_r_int,
    x_r_int + 1 against the left window at the rounded left pixel, and a
    parabola through the three (its vertex clamped to half a pixel).
    Returns (disparity, whether x_r_int is the lowest of the three)."""
    dev = img_l.device
    H, W = img_l.shape
    xl = torch.round(x_l).long().clamp(3, W - 4)
    yl = torch.round(y_l).long().clamp(2, H - 3)
    dy = torch.arange(-2, 3, device=dev)
    dx = torch.arange(-3, 4, device=dev)
    rows = (yl[:, None] + dy)[:, :, None]

    def win(img, cx):
        p = img.to(dtype)[rows, (cx[:, None] + dx)[:, None, :]]
        return p - p.mean((1, 2), keepdim=True)

    left = win(img_l, xl)
    ssd = torch.stack([((win(img_r, (x_r_int + o).clamp(3, W - 4)) - left) ** 2).sum((1, 2))
                       for o in (-1, 0, 1)], -1).float()
    sm, s0, sp = ssd.unbind(-1)
    den = sm - 2 * s0 + sp
    ok = den.abs() > 1e-6
    delta = torch.where(ok, 0.5 * (sm - sp) / torch.where(ok, den, torch.ones_like(den)),
                        torch.zeros_like(den)).clamp(-0.5, 0.5)
    return xl.float() - (x_r_int.float() + delta), (s0 <= sm) & (s0 <= sp)
