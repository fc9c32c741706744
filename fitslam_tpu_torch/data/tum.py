"""TUM RGB-D dataset format: pure-numpy reader and writers (port of
``fitslam_tpu/data/tum.py``; it holds no JAX, so it is a copy, kept here so
that the port imports nothing of the reference package).

A TUM RGB-D sequence directory holds

    rgb.txt          "timestamp filename" per line (# comments)
    depth.txt        same, 16-bit depth images, meters = value / factor
    groundtruth.txt  "timestamp tx ty tz qx qy qz qw" (camera-to-world)
    rgb/*.pgm|png    intensity images
    depth/*.pgm|png  depth images

Images here are PGM (P5 binary / P2 ascii, 8- or 16-bit) decoded with a
pure-numpy codec, so the committed sequences load with no compiler and no
imaging library. PNG files are read through PIL when it imports (real TUM
downloads ship PNG); without it reading one raises, naming the file.

Association follows the TUM associate.py convention: nearest timestamps
within `max_dt`. Frames stay numpy: the caller moves them to the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PGM codec (pure numpy)
# ---------------------------------------------------------------------------


def read_pgm(path) -> np.ndarray:
    """Read a PGM (P5 binary or P2 ascii) image. Returns uint8 or uint16
    (native byte order; P5 16-bit is big-endian per the spec)."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval — whitespace/comment separated
    tokens: List[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=np.int32).reshape(h, w)
        return vals.astype(np.uint16 if maxval > 255 else np.uint8)
    if magic != b"P5":
        raise ValueError(f"not a PGM file: {path} (magic {magic!r})")
    i += 1  # single whitespace after maxval
    if maxval > 255:
        img = np.frombuffer(data, dtype=">u2", offset=i, count=w * h)
        return img.reshape(h, w).astype(np.uint16)
    img = np.frombuffer(data, dtype=np.uint8, offset=i, count=w * h)
    return img.reshape(h, w).copy()


def write_pgm(path, img: np.ndarray) -> None:
    """Write uint8 or uint16 grayscale as binary P5."""
    img = np.asarray(img)
    maxval = 255 if img.dtype == np.uint8 else 65535
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n{maxval}\n".encode())
        if maxval > 255:
            f.write(img.astype(">u2").tobytes())
        else:
            f.write(img.astype(np.uint8).tobytes())


def _read_image(path) -> np.ndarray:
    path = str(path)
    if path.endswith(".pgm"):
        return read_pgm(path)
    try:
        from PIL import Image  # real TUM sequences ship PNG

        return np.asarray(Image.open(path))
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"{path}: PNG decoding needs PIL; convert to PGM for the "
            "pure-Python path") from e


# ---------------------------------------------------------------------------
# Ground-truth poses
# ---------------------------------------------------------------------------


def quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


def rot_to_quat(R: np.ndarray) -> Tuple[float, float, float, float]:
    """3x3 rotation matrix -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qw = (R[k, j] - R[j, k]) / s
        qx, qy, qz = q
    return float(qx), float(qy), float(qz), float(qw)


def _parse_list(path) -> List[Tuple[float, List[str]]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def _associate(a: List[float], b: List[float], max_dt: float) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    pairs = []
    j = 0
    used = set()
    for i, ta in enumerate(a):
        # advance j to the closest b timestamp
        while j + 1 < len(b) and abs(b[j + 1] - ta) <= abs(b[j] - ta):
            j += 1
        if j < len(b) and abs(b[j] - ta) <= max_dt and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


class TumFrame(NamedTuple):
    timestamp: float
    gray: np.ndarray        # (H, W) float32, 0..255
    depth: np.ndarray       # (H, W) float32 meters (0 = no return)
    T_wc: Optional[np.ndarray]  # (4, 4) camera-to-world GT (None if absent)


class TumRgbdSequence:
    """Associated TUM RGB-D sequence. Iterate to get TumFrame records."""

    def __init__(self, root, depth_factor: float = 5000.0,
                 max_dt: float = 0.03):
        self.root = Path(root)
        self.depth_factor = depth_factor
        rgb = _parse_list(self.root / "rgb.txt")
        depth = _parse_list(self.root / "depth.txt")
        pairs = _associate([t for t, _ in rgb], [t for t, _ in depth], max_dt)
        self.entries = [(rgb[i][0], rgb[i][1][0], depth[j][1][0])
                        for i, j in pairs]
        self.gt: List[Optional[np.ndarray]] = [None] * len(self.entries)
        gt_path = self.root / "groundtruth.txt"
        if gt_path.exists():
            rows = _parse_list(gt_path)
            ts = [t for t, _ in rows]
            for n, (t, _, _) in enumerate(self.entries):
                m = min(range(len(ts)), key=lambda k: abs(ts[k] - t))
                if abs(ts[m] - t) <= max_dt:
                    v = [float(x) for x in rows[m][1]]
                    T = np.eye(4)
                    T[:3, :3] = quat_to_rot(v[3], v[4], v[5], v[6])
                    T[:3, 3] = v[:3]
                    self.gt[n] = T

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        for n, (t, rgb_rel, depth_rel) in enumerate(self.entries):
            gray = _read_image(self.root / rgb_rel).astype(np.float32)
            if gray.ndim == 3:
                gray = gray @ np.array([0.299, 0.587, 0.114], np.float32)
            d = _read_image(self.root / depth_rel).astype(np.float32)
            yield TumFrame(t, gray, d / self.depth_factor, self.gt[n])

    def gt_poses(self) -> List[np.ndarray]:
        return [T for T in self.gt if T is not None]


# ---------------------------------------------------------------------------
# Writer (recording sequences in TUM layout)
# ---------------------------------------------------------------------------


def write_sequence(root, frames, depth_factor: float = 5000.0) -> None:
    """Write [(timestamp, gray uint8 (H,W), depth float m, T_wc 4x4)] as a
    TUM RGB-D directory with PGM images."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for t, gray, depth, T_wc in frames:
        name = f"{t:.6f}"
        write_pgm(root / "rgb" / f"{name}.pgm", gray.astype(np.uint8))
        d16 = np.clip(np.round(depth * depth_factor), 0, 65535).astype(np.uint16)
        write_pgm(root / "depth" / f"{name}.pgm", d16)
        rgb_lines.append(f"{name} rgb/{name}.pgm")
        depth_lines.append(f"{name} depth/{name}.pgm")
        qx, qy, qz, qw = rot_to_quat(T_wc[:3, :3])
        tx, ty, tz = T_wc[:3, 3]
        gt_lines.append(f"{name} {tx:.6f} {ty:.6f} {tz:.6f} "
                        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    (root / "rgb.txt").write_text(
        "# color images\n# timestamp filename\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text(
        "# depth images\n# timestamp filename\n" + "\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n"
        + "\n".join(gt_lines) + "\n")
