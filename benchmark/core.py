"""The harness's general part: it finds a cell's configuration, traffic mix,
metrics and limits by the names in ``BENCHMARK.json``, runs the mix's driver
once, and prints the result line.

Files, each found by name and never listed here:
- ``benchmark/configs/<config>.json``: the deployment (``settings`` holds
  the port's ``FitSlamConfig`` as it is run, section by section);
- ``benchmark/traffic/<mix>.json``: the mix's parameters, whose ``driver``
  names the general generator in ``benchmark/drivers/<driver>.py``;
- ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning a number or None (nothing to read: the metric is left out);
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness comparison prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]
# what may not be loaded in the process that prints the result (whole
# top-level module names: the port's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "fitslam_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a missing file, a loaded JAX)."""


def load_json(path: Path) -> Any:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric files carry dots in their names)."""
    if not path.is_file():
        raise Refused(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, Dict[str, float]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``root``'s ``BENCHMARK.json`` with its files
    read from ``root/benchmark``."""
    spec = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise Refused(f"no workload {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    return Cell(
        name=cell_name,
        root=root,
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, cell_name)],
        limits=load_json(here / "limits" / f"{cell_name}.json"),
    )


def driver(cell: Cell) -> ModuleType:
    name = cell.traffic["driver"]
    return load_module(cell.root / "benchmark" / "drivers" / f"{name}.py",
                       f"benchmark_driver_{name}")


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.root / "benchmark" / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fitslam_config(settings: Dict[str, Any]):
    """The port's ``FitSlamConfig`` with every section of ``settings``
    (nested groups too); a key the port does not have raises."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    return _replaced(FitSlamConfig(), settings)


def _replaced(obj, values: Dict[str, Any]):
    fixed = {}
    for k, v in values.items():
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            v = _replaced(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        fixed[k] = v
    return dataclasses.replace(obj, **fixed)


class Tracer:
    """The traced run's instruments: a ``torch.profiler`` slice over steps
    ``skip`` to ``skip + frames - 1`` of the window, and the kernel
    wrappers' launch counters over the same steps. Off (every call a no-op)
    in an untraced run."""

    def __init__(self, enabled: bool, skip: int = 0, frames: int = 0, device="cuda"):
        self.enabled, self.skip, self.frames, self.device = enabled, skip, frames, device
        self.prof = None
        self.window_s = None
        self.launches: Dict[str, int] = {}
        self.labels = set()
        self._t0 = 0.0
        self._counts0: Dict[str, int] = {}

    def in_slice(self, k: int) -> bool:
        return self.enabled and self.skip <= k < self.skip + self.frames

    def label(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        self.labels.add(name)
        return torch.profiler.record_function(name)

    def before_step(self, k: int) -> None:
        if not (self.enabled and k == self.skip):
            return
        import torch

        sync(self.device)
        self._counts0 = launch_counts()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def after_step(self, k: int) -> None:
        if not (self.enabled and self.prof is not None and k == self.skip + self.frames - 1):
            return
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.launches = {n: v - self._counts0[n] for n, v in launch_counts().items()}

    @property
    def done(self) -> bool:
        return self.window_s is not None


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU, where the tests run drivers)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0


def launch_counts() -> Dict[str, int]:
    """The port's kernel wrappers' launch counters (they count replays of
    captured regions too)."""
    from fitslam_tpu_torch.ops import orb, pallas_grid, pallas_matching

    return {"K1": orb.describe_keypoints.launches,
            "K2": pallas_matching.hamming_top2.launches,
            "K3": pallas_grid.wavefront_sweeps.launches}
