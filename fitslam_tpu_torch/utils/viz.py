"""Artifact recorder + renderers (port of ``fitslam_tpu/utils/viz.py``, a copy:
the module has no JAX in it).

The reference's `RosVisualizer` publishes every debug artifact as RViz
topics and exports a coverage-vs-time CSV. Here "publishing" appends a
host-side numpy snapshot to a named stream; streams export together as one
`.npz` (+ coverage CSV), and grids render to dependency-free PGM/PPM images
(the formats the ROS map server uses). Every function takes host arrays:
the caller reads a tensor on the card back first (``.cpu()``), once a
publish. The grid constants come from the port's ``ops/grid.py``.
"""

from __future__ import annotations

import csv
import io
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fitslam_tpu_torch.ops.grid import FREE, LETHAL, UNKNOWN


class ArtifactRecorder:
    """Named append-only streams of timestamped numpy snapshots.

    Equivalent surface to RosVisualizer's topic set: call
    `publish("frontiers", pts, t)` wherever the reference would publish a
    marker array. `enabled=False` turns every call into a no-op.
    """

    def __init__(self, enabled: bool = True, trailing_pose_len: int = 10):
        self.enabled = enabled
        self._streams: Dict[str, List[Tuple[float, np.ndarray]]] = {}
        # trailing robot poses (reference keeps a 10-pose deque,
        # FrontierRoadmap.cpp:264-277)
        self.trailing_poses: deque = deque(maxlen=trailing_pose_len)
        self._coverage: List[Tuple[float, int, float]] = []

    def publish(self, stream: str, value, t: float = 0.0):
        if not self.enabled:
            return
        self._streams.setdefault(stream, []).append(
            (float(t), np.asarray(value)))

    def publish_pose(self, xy_yaw, t: float = 0.0):
        if not self.enabled:
            return
        self.trailing_poses.append(np.asarray(xy_yaw, np.float32))
        self.publish("robot_pose", xy_yaw, t)

    def record_coverage(self, grid: np.ndarray, t: float):
        """explored_map_counter parity: known-cell count + fraction at t."""
        if not self.enabled:
            return
        g = np.asarray(grid)
        known = int((g != UNKNOWN).sum())
        self._coverage.append((float(t), known, known / g.size))

    # -- exports -----------------------------------------------------------

    def streams(self) -> Sequence[str]:
        return sorted(self._streams)

    def latest(self, stream: str) -> Optional[np.ndarray]:
        s = self._streams.get(stream)
        return s[-1][1] if s else None

    def export_npz(self, path: str):
        """One npz: `<stream>__t` (times) + `<stream>__{i}` (snapshots)."""
        payload: Dict[str, np.ndarray] = {}
        for name, entries in self._streams.items():
            payload[f"{name}__t"] = np.array([t for t, _ in entries])
            for i, (_, v) in enumerate(entries):
                payload[f"{name}__{i}"] = v
        if self.trailing_poses:
            payload["trailing_poses"] = np.stack(list(self.trailing_poses))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **payload)

    def export_coverage_csv(self, path: Optional[str] = None) -> str:
        """exportMapCoverage parity: CSV `time,known_cells,fraction`."""
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["time_s", "known_cells", "coverage_fraction"])
        for row in self._coverage:
            w.writerow([f"{row[0]:.3f}", row[1], f"{row[2]:.6f}"])
        text = buf.getvalue()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        return text


# ---------------------------------------------------------------------------
# Dependency-free grid renderers (PGM/PPM — same formats the ROS map server
# uses, so artifacts drop into existing robotics tooling)
# ---------------------------------------------------------------------------


def grid_to_pgm(occ: np.ndarray, path: str):
    """Write an occupancy grid as binary PGM (unknown=128, free=255,
    lethal=0, costs shaded)."""
    g = np.asarray(occ)
    img = np.where(
        g == UNKNOWN, 128,
        np.clip(255 - g.astype(np.int32), 0, 255)).astype(np.uint8)
    img = img[::-1]  # world +y up -> image row 0 at top
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def render_world_ppm(
    occ: np.ndarray,
    path: str,
    robot_cell: Optional[Tuple[int, int]] = None,
    frontier_cells: Optional[np.ndarray] = None,
    path_cells: Optional[np.ndarray] = None,
    roadmap_cells: Optional[np.ndarray] = None,
):
    """Color composite: grid grayscale + frontiers (red), plan (blue),
    roadmap nodes (green), robot (yellow 3x3). Cells are (col, row) = (x, y)
    grid indices."""
    g = np.asarray(occ)
    base = np.where(
        g == UNKNOWN, 128,
        np.clip(255 - g.astype(np.int32), 0, 255)).astype(np.uint8)
    img = np.stack([base] * 3, axis=-1)

    def paint(cells, color, rad=0):
        if cells is None:
            return
        cells = np.asarray(cells).reshape(-1, 2).astype(int)
        for dx in range(-rad, rad + 1):
            for dy in range(-rad, rad + 1):
                xs = np.clip(cells[:, 0] + dx, 0, g.shape[1] - 1)
                ys = np.clip(cells[:, 1] + dy, 0, g.shape[0] - 1)
                img[ys, xs] = color

    paint(roadmap_cells, (0, 200, 0))
    paint(frontier_cells, (230, 0, 0))
    paint(path_cells, (0, 80, 230))
    if robot_cell is not None:
        paint(np.array([robot_cell]), (255, 220, 0), rad=1)
    img = img[::-1]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def load_pgm(path: str) -> np.ndarray:
    """Round-trip reader for grid_to_pgm output (tests / tooling)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        assert int(f.readline()) == 255
        img = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
    return img[::-1].copy()
