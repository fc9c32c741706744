"""What the readers of the program's own spans share. The program
(``fitslam_tpu_torch.utils.profiling``) records a span at each layer
boundary, at each captured region's call (a ``replay`` is one graph
launch from the host) and at each counted device->host read (``sync``),
with its host interval on ``time.perf_counter`` (the clock of the
harness's ``t_window``) and, for a region's call on the card, its device
interval mapped to the same clock. A reader keeps the spans whose host
start lies in ``[t_window, t_window + window_s]`` and that were not taken
under the traced run's ``torch.profiler`` slice (``profiled``), and
returns None where none is left: a program without the recorder, or with
``FITSLAM_TRACE=0``. A share of the window's time leaves out the slice's
stretch, from the last span before it to the first after it, which holds
the profiler's own start and stop."""

from __future__ import annotations

import statistics
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from benchmark import profile


class Window(NamedTuple):
    spans: List            # profiling.Span, outside the profiled slice
    t0: float              # the window's host start and end
    t1: float
    cut: Optional[Tuple[float, float]]   # the profiled slice's host stretch

    @property
    def host_s(self) -> float:
        """The window's host seconds, the profiled slice left out."""
        return self.t1 - self.t0 - sum(e - s for s, e in self.clipped([self.cut] if self.cut
                                                                      else []))

    def clipped(self, intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
        """``intervals`` cut to the window."""
        return [(max(s, self.t0), min(e, self.t1)) for s, e in intervals
                if min(e, self.t1) > max(s, self.t0)]

    def outside_cut(self, intervals) -> List[Tuple[float, float]]:
        """``intervals`` cut to the window, the profiled slice cut out."""
        out = []
        for s, e in self.clipped(intervals):
            if self.cut is None or e <= self.cut[0] or s >= self.cut[1]:
                out.append((s, e))
                continue
            if s < self.cut[0]:
                out.append((s, self.cut[0]))
            if e > self.cut[1]:
                out.append((self.cut[1], e))
        return out


def window(run, spans=None) -> Optional[Window]:
    """The run's window of the program's spans (``spans``: the recorder's
    ``spans`` function, by default the program's own)."""
    if spans is None:
        try:
            from fitslam_tpu_torch.utils import profiling

            spans = profiling.spans
        except (ImportError, AttributeError):     # a program without the recorder
            return None
    t0 = run["t_window"]
    t1 = t0 + run["window_s"]
    got = spans(t0, t1)
    kept = [s for s in got if not s.profiled]
    if not kept:
        return None
    prof = [s for s in got if s.profiled]
    cut = None
    if prof:
        # from the last span before the slice to the first after it: the
        # profiler's own start and stop lie between
        p0, p1 = min(s.t0 for s in prof), max(s.t1 for s in prof)
        cut = (max([s.t1 for s in kept if s.t1 <= p0], default=t0),
               min([s.t0 for s in kept if s.t0 >= p1], default=t1))
    return Window(kept, t0, t1, cut)


def count(w: Window, kind: Optional[str] = None, name: Optional[str] = None) -> int:
    return sum(1 for s in w.spans if (kind is None or s.kind == kind)
               and (name is None or s.name == name))


def per(w: Optional[Window], value: float, unit_name: str) -> Optional[float]:
    """``value`` over the count of layer spans ``unit_name`` (a frame, a
    step); None without one."""
    if w is None:
        return None
    n = count(w, "layer", unit_name)
    return value / n if n else None


def device_intervals(spans) -> Optional[List[Tuple[float, float]]]:
    """The device intervals of ``spans``; None where one has none (a run
    off the card)."""
    out = [(s.d0, s.d1) for s in spans]
    return None if any(d0 is None for d0, _ in out) else out


def outside_graphs_pct(w: Optional[Window]) -> Optional[float]:
    """The share of the window's host time (the profiled slice left out)
    in which no captured region ran on the device, in %."""
    if w is None:
        return None
    replays = [s for s in w.spans if s.kind == "replay"]
    dev = device_intervals(replays) if replays else None
    if dev is None or w.host_s <= 0:
        return None
    return 100.0 * (1.0 - profile.union_length(w.outside_cut(dev)) / w.host_s)


def replays_under(w: Window, name: str) -> Dict[int, List]:
    """{seq of each layer span ``name``: the replays below it}, every layer
    span ``name`` of the window a key (a read of the same name is no
    layer)."""
    by_seq = {s.seq: s for s in w.spans}
    out: Dict[int, List] = {s.seq: [] for s in w.spans if s.kind == "layer" and s.name == name}
    for s in w.spans:
        if s.kind != "replay":
            continue
        p = s.parent
        while p in by_seq:
            if p in out:
                out[p].append(s)
                break
            p = by_seq[p].parent
    return out


def device_ms(replays) -> Optional[float]:
    """The union of ``replays``' device intervals, in ms (0 for none)."""
    dev = device_intervals(replays)
    return None if dev is None else 1e3 * profile.union_length(dev)


def mean_device_ms_under(w: Optional[Window], name: str) -> Optional[float]:
    """The mean, over the window's layer spans ``name``, of the device ms
    of the replays below each; None off the card (no span of the window
    has a device time)."""
    if w is None or not any(s.d0 is not None for s in w.spans):
        return None
    got = [device_ms(r) for r in replays_under(w, name).values()]
    return statistics.fmean(got) if got and None not in got else None
