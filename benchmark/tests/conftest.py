"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, the ``gpu`` marker, and a tiny stereo cell added as files alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card; skips without one")
    import torch

    # the tiny cells' CPU work is small: a few threads run it as fast as
    # many and keep it steady on a shared host
    torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tiny_settings():
    cfg = json.loads((ROOT / "benchmark/configs/stereo_slam_640.json").read_text())
    s = cfg["settings"]
    s["camera"].update(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    s["orb"].update(num_features=384, num_levels=2)
    s["mapping"].update(max_keyframes=32, max_landmarks=4096, max_observations=16384)
    return cfg


TINY_TRAFFIC = {
    "driver": "stereo_stream",
    "world": {"kind": "corridor", "num": 3000, "length": 40.0, "width": 5.0},
    "trajectory": {"kind": "straight", "frames": 12, "length": 1.8, "height": 1.2,
                   "start_x": 0.5},
    "render": {"max_depth": 18.0},
    "warm_episodes": 0,
    "sample_frames": 3,
    "sample_within": 5,
    "sample_keyframes": 2,
    "keyframes_within": 4,
    "trace_slice": {"skip": 2, "frames": 2},
}

# the tiny cell's limits: the corridor's, but the pose and map gaps', which
# the 320x240 map's coarser landmarks widen (their readings on the CPU: pose
# 0-9.3 mm, map 0-4.4 mm; the map's bfloat16 control 90-160 mm)
TINY_LIMITS = {"kp_unmatched": {"max": 0.48}, "desc_bits_off": {"max": 0.002},
               "depth_gap_px": {"max": 0.0003}, "pose_gap_mm": {"max": 20.0},
               "map_gap_mm": {"max": 20.0}, "sampled_frames": {"min": 3},
               "sampled_keyframes": {"min": 2}, "sampled_landmarks": {"min": 20}}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout's benchmark with one more cell, ``tiny_stereo.tiny_corridor``
    (CPU-sized), added as new files and entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "configs/tiny_stereo.json").write_text(json.dumps(tiny_settings()))
    (b / "traffic/tiny_corridor.json").write_text(json.dumps(TINY_TRAFFIC))
    (b / "limits/tiny_stereo.tiny_corridor.json").write_text(json.dumps(TINY_LIMITS))
    (b / "metrics/tiny_keyframes.py").write_text(
        "def read(run):\n    return sum(s['keyframe'] for s in run['steps'])\n")
    cell = "tiny_stereo.tiny_corridor"
    spec["configs"].append({"name": "tiny_stereo", "source": "test", "reduced": [],
                            "file": "benchmark/configs/tiny_stereo.json", "why": "test"})
    spec["workloads"].append({"name": cell, "config": "tiny_stereo", "traffic": "tiny_corridor",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"].startswith("frame"):
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "tiny_keyframes", "unit": "keyframes",
                              "better": "higher", "source": "program_counter",
                              "layer": "keyframe path", "moves": "frames_per_s",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
