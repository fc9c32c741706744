"""EventLogger-equivalent profiling (port of ``fitslam_tpu/utils/profiling.py``).

Named scopes at four tiers (iteration / module / submodule / event) with
wall-clock accumulation. PyTorch launches CUDA work asynchronously, so a
scope that must measure device work passes ``block_on=<tensor or tuple>``
and the timer stops after ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch

ITERATION, MODULE, SUBMODULE, EVENT = 0, 1, 2, 3


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)


def device_sync(x) -> None:
    """Wait until the work producing every CUDA tensor in ``x`` has finished."""
    devices = {t.device for t in _leaves(x) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


@dataclass
class EventLogger:
    """Accumulating wall-clock profiler. One instance per engine; cheap."""

    time_tier: int = MODULE          # suppress tiers below this
    stats: Dict[str, _Stat] = field(default_factory=lambda: defaultdict(_Stat))
    _t0: float = field(default_factory=time.monotonic)

    def time_since_start(self) -> float:
        """Scheduling timer (reference: getTimeSinceStart, used by BT nodes)."""
        return time.monotonic() - self._t0

    @contextmanager
    def scope(self, name: str, tier: int = EVENT, block_on=None):
        t0 = time.monotonic()
        try:
            yield
        finally:
            if block_on is not None:
                device_sync(block_on)
            dt = time.monotonic() - t0
            if tier <= self.time_tier:
                self.stats[name].add(dt)


@dataclass
class SimClock(EventLogger):
    """An EventLogger whose scheduling timer reads a simulation's time,
    ``sim_s``, which the caller advances, instead of the host's: periodic
    work (the roadmap's cleanup) then falls on the same steps of a simulated
    run on a fast host and a slow one."""

    sim_s: float = 0.0

    def time_since_start(self) -> float:
        return self.sim_s
