"""Reduction of a ``torch.profiler`` slice to the few numbers the metrics
read: each device operation's interval, the device's busy time (the union
of those intervals), time by operation name, and the longest idle gaps
labelled by what the host was doing. Only this summary is kept."""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]

# host activities of the profiler itself: an idle stretch of the device
# under one of them is the trace's cost, not the program's
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def union_length(intervals: Sequence[Interval]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(device: Sequence[Interval], host: Sequence[Tuple[str, float, float]],
              start: float, end: float, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest stretches of [start, end] in which no device
    operation ran, each named by the innermost host span that covers its
    middle ("host" where none does), longest first (every one with
    ``top=None``). Times in seconds."""
    busy = merged(device)
    gaps, t = [], start
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
    if end > t:
        gaps.append((t, end))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    spans = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in spans]
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        covering = [(hs, he, n) for n, hs, he in spans[:bisect.bisect_right(starts, mid)]
                    if he >= mid]
        name = min(covering, key=lambda c: c[1] - c[0])[2] if covering else "host"
        out.append((name, e - s))
    return out


def summarize(prof, window_s: float, labels=()) -> Dict:
    """The slice's summary: ``busy_s``, ``window_s``, ``by_name`` (name -> [seconds,
    count]), ``device_ops`` (the ten names of most time), ``idle_gaps`` (the
    ten longest) and ``profiler_idle_s`` (the idle time under the profiler's
    own host activities, ``PROFILER_OWN``). ``labels`` are the harness's own
    ``record_function`` spans: their device-side annotations are no device
    work."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            if ev.name not in labels:
                device.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    if not device:
        return {"busy_s": 0.0, "window_s": window_s, "by_name": {},
                "device_ops": [], "idle_gaps": [], "profiler_idle_s": 0.0, "n_device_ops": 0}
    by_name: Dict[str, List[float]] = {}
    for n, s, e in device:
        rec = by_name.setdefault(n, [0.0, 0])
        rec[0] += e - s
        rec[1] += 1
    intervals = [(s, e) for _, s, e in device]
    t0 = min([s for _, s, _ in host] + [s for s, _ in intervals])
    ops = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    gaps = idle_gaps(intervals, host, t0, t0 + window_s, top=None)
    return {
        "busy_s": union_length(intervals),
        "window_s": window_s,
        "by_name": by_name,
        "device_ops": [[n, v[0]] for n, v in ops],
        "idle_gaps": [[n, g] for n, g in gaps[:10]],
        "profiler_idle_s": sum(g for n, g in gaps if n in PROFILER_OWN),
        "n_device_ops": len(device),
    }


def kernel_seconds(summary: Dict, *needles: str) -> Tuple[float, int]:
    """Device seconds and count of the operations whose name holds one of
    ``needles``."""
    t, n = 0.0, 0
    for name, (sec, cnt) in summary.get("by_name", {}).items():
        if any(k in name for k in needles):
            t += sec
            n += cnt
    return t, n
