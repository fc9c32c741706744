"""EventLogger-equivalent profiling (port of ``fitslam_tpu/utils/profiling.py``)
and the process-wide span recorder that it writes into.

``EventLogger`` mirrors the reference's EventLogger singleton + RAII Profiler
(frontier_exploration/include/.../util/event_logger.hpp:20-82,
src/util/event_logger.cpp:27-97): named start/end events at four severity
tiers (iteration / module / submodule / event), wall-clock accumulation,
``time_since_start`` usable as a scheduling timer, a summary table and CSV
export. It times on ``time.perf_counter``.

``RECORDER`` keeps the spans of the whole process in one ring, allocated once
(``CAPACITY`` spans; the oldest are overwritten and counted in ``dropped``).
A span is a layer's call (``span``, ``EventLogger.scope``), a captured
region's call (``utils/jit.py``: ``replay``, ``eager``, ``warm_up``,
``capture``) or a counted device->host read (``host_read``: ``sync``), with
its parent and the root span of the call it belongs to, its host start and
end on ``time.perf_counter``, and for a region's call on a CUDA device its
device start and end: timing events recorded on the current stream at its
entry and exit, taken in turn from a pool made once (``EVENTS``). Nothing
waits for them while the program runs; ``spans()`` resolves them when it is
read. Device times come back on the host's clock through anchors: right
after a counted read returns, the stream is drained up to it, so an event
recorded then (the read's end) runs at once, and ``perf_counter`` read
beside it gives the device-to-host offset; each device time is mapped
through the last anchor before it. A span taken while a ``torch.profiler``
session runs is marked ``profiled``: its host times are the profiler's,
not the program's.

Beside the ring sit process-wide counters, which outlive every engine and
slot: graph replays, eager region calls, warm-ups, captures and their
seconds, and host reads and their wait by site. ``FITSLAM_TRACE=0`` in the
environment stops the spans; the counters stay. The program emits no
``record_function`` or NVTX range: a profile of it shows only its kernels.
"""

from __future__ import annotations

import bisect
import csv
import functools
import io
import itertools
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

ITERATION, MODULE, SUBMODULE, EVENT = 0, 1, 2, 3
_TIER_NAMES = {ITERATION: "iteration", MODULE: "module", SUBMODULE: "submodule", EVENT: "event"}

#: the ring's spans: the missions cell makes ~23 a step at ~27 steps a
#: second, the corridor ~10 a frame at ~50 frames a second (PERF.md), so
#: this holds some 3.5 minutes of either, more than a benchmark window
CAPACITY = 1 << 17

#: a device's timing events, made at its first timed span and used in turn:
#: the missions record ~25 a step, the corridor ~9.5 a frame (PERF.md), so
#: this holds some 1.5 minutes of either
EVENTS = 1 << 16

#: the kinds whose device interval is recorded: a region's call. A layer
#: span is timed on the host only (two more events a span cost more than
#: the budget), a read's end is an anchor.
TIMED = frozenset(("replay", "eager", "warm_up", "capture"))


class Span(NamedTuple):
    """One span as ``spans()`` returns it. ``parent`` and ``root`` are
    ``seq`` numbers (``parent`` -1 for a root); ``t0``/``t1`` host seconds on
    ``time.perf_counter``; ``d0``/``d1`` the device interval of a region's
    call on the card, on the same clock (else None)."""

    seq: int
    name: str
    kind: str
    parent: int
    root: int
    t0: float
    t1: float
    d0: Optional[float]
    d1: Optional[float]
    profiled: bool


_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def _current_stream(dev: int):
    """``torch.cuda.current_stream(dev)`` without building a new stream
    object at each call (that costs ~3 host us on the card, PERF.md)."""
    key = torch._C._cuda_getCurrentStream(dev)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


class _Events:
    """One device's pool of timing events, each made (its first record)
    when the pool is, so that no step pays for it; numbered in the order
    they are recorded, number ``e`` in slot ``e % n``. Made once, at the
    first timed span: the device then waits for those first records (a
    wait of set-up, out of torch's sync debug mode), so that the next
    anchor finds the stream drained."""

    def __init__(self, dev: int, n: int):
        self.n, self.next = n, 0
        stream = torch.cuda.current_stream(dev)
        self.pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for ev in self.pool:
            ev.record(stream)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize(dev)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def record(self, dev: int) -> int:
        e = self.next
        self.next = e + 1
        self.pool[e % self.n].record(_current_stream(dev))
        return e

    def held(self, e: int) -> bool:
        return self.next - self.n <= e < self.next


# the fields of a closed span's record in the ring (a tuple: it holds no
# container, so the garbage collector stops tracking it), and of an open
# span's entry on the stack (a list, completed at its end)
_SEQ, _NAME, _KIND, _PARENT, _ROOT, _T0, _T1, _DEV, _E0, _E1, _A0, _A1, _ANCHOR, _PROF = range(14)
_OPEN_T0, _OPEN_DEV, _OPEN_E0, _OPEN_A0, _OPEN_PROF = 5, 6, 7, 8, 9


class Recorder:
    """The process's spans and counters (see the module's docstring). A
    closed span's record (``_SEQ`` .. ``_PROF``): its seq, name, kind,
    parent's and root's seqs, host start and end, CUDA device index (-1
    none), the numbers of its two events (-1 none), the seq of the last
    anchor at each of them, whether its end is an anchor, and
    ``profiled``."""

    def __init__(self, capacity: int = CAPACITY, enabled: Optional[bool] = None,
                 events: int = EVENTS):
        self.capacity, self.n_events = capacity, events
        self.enabled = (os.environ.get("FITSLAM_TRACE", "1") != "0") if enabled is None \
            else enabled
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._count = itertools.count()
        self._top = 0                             # one past the newest seq
        self._device_times: Dict[int, tuple] = {}  # seq -> (d0, d1), once resolved
        self._events: Dict[int, _Events] = {}
        self._devs: Dict[object, int] = {}
        self._last_anchor: Dict[int, int] = {}    # device index -> seq
        self._local = threading.local()
        # counters
        self.replays = 0
        self.eager_calls = 0
        self.warm_ups = 0
        self.captures = 0
        self.capture_s = 0.0
        self.reads: Dict[str, int] = defaultdict(int)
        self.read_wait_s: Dict[str, float] = defaultdict(float)
        self.dropped = 0
        self.last_dropped_t0 = float("-inf")       # host start of the newest span dropped

    # -- recording ------------------------------------------------------
    def _dev_of(self, device) -> int:
        """The CUDA index of ``device`` (-1 off the card; an index-less
        "cuda" is the device current when it is first seen)."""
        dev = self._devs.get(device)
        if dev is None:
            d = torch.device(device)
            dev = -1
            if d.type == "cuda" and torch.cuda.is_available():
                dev = d.index if d.index is not None else torch.cuda.current_device()
            self._devs[device] = dev
        return dev

    def _pool(self, dev: int) -> _Events:
        ev = self._events.get(dev)
        if ev is None:
            ev = self._events[dev] = _Events(dev, self.n_events)
        return ev

    def begin(self, name: str, kind: str, device=None) -> Optional[list]:
        """Open a span; returns its entry (None when spans are off). A
        region's call or a read on a CUDA ``device`` records its events."""
        if kind == "replay":
            self.replays += 1
        elif kind == "eager":
            self.eager_calls += 1
        elif kind == "warm_up":
            self.warm_ups += 1
        elif kind == "capture":
            self.captures += 1
        if not self.enabled:
            return None
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        parent, root = (stack[-1][_SEQ], stack[-1][_ROOT]) if stack else (-1, -1)
        dev = -1 if device is None else self._dev_of(device)
        seq = next(self._count)
        self._top = seq + 1
        r = [seq, name, kind, parent, seq if parent < 0 else root, 0.0, dev, -1, -1,
             _autograd_profiler._is_profiler_enabled]
        if dev >= 0 and kind in TIMED:
            pool = self._pool(dev)
            r[_OPEN_A0] = self._last_anchor.get(dev, -1)
            r[_OPEN_T0] = time.perf_counter()
            r[_OPEN_E0] = pool.record(dev)
        else:
            r[_OPEN_T0] = time.perf_counter()
        stack.append(r)
        return r

    def end(self, r: Optional[list], t0: float = 0.0, anchor: bool = False) -> float:
        """Close the span of entry ``r`` (``t0``: its host start, for the
        counters when spans are off); with ``anchor``, an event recorded at
        its end is an anchor. Returns its host seconds."""
        if r is None:
            return time.perf_counter() - t0
        seq, dev, e0 = r[_SEQ], r[_OPEN_DEV], r[_OPEN_E0]
        e1 = a1 = -1
        if dev >= 0 and (e0 >= 0 or anchor):
            a1 = self._last_anchor.get(dev, -1)
            e1 = self._pool(dev).record(dev)
            if anchor:
                self._last_anchor[dev] = seq
        anchor = anchor and e1 >= 0
        t1 = time.perf_counter()
        stack = self._local.stack
        if stack and stack[-1] is r:
            stack.pop()
        self._store((seq, r[_NAME], r[_KIND], r[_PARENT], r[_ROOT], r[_OPEN_T0], t1, dev, e0,
                     e1, r[_OPEN_A0], a1, anchor, r[_OPEN_PROF]))
        return t1 - r[_OPEN_T0]

    def _store(self, rec: tuple) -> None:
        i = rec[_SEQ] % self.capacity
        old = self._ring[i]
        if old is not None:
            if old[_SEQ] > rec[_SEQ]:             # open for a whole lap of the ring
                self.dropped += 1
                self.last_dropped_t0 = rec[_T0]
                return
            self.dropped += 1
            self.last_dropped_t0 = old[_T0]
            self._device_times.pop(old[_SEQ], None)
        self._ring[i] = rec

    def record(self, name: str, t0: float, t1: float) -> None:
        """A finished host span (``EventLogger.start``/``end``), under the
        open span."""
        r = self.begin(name, "layer")
        if r is not None:
            self._local.stack.pop()
            self._store((r[_SEQ], name, "layer", r[_PARENT], r[_ROOT], t0, t1, r[_OPEN_DEV],
                         -1, -1, -1, -1, False, r[_OPEN_PROF]))

    # -- reading --------------------------------------------------------
    def _live(self) -> List[tuple]:
        """The closed spans' records the ring holds, oldest first."""
        cap, ring = self.capacity, self._ring
        out = []
        for s in range(max(0, self._top - cap), self._top):
            rec = ring[s % cap]
            if rec is not None and rec[_SEQ] == s:
                out.append(rec)
        return out

    def spans(self, since: float = float("-inf"), until: float = float("inf")) -> List[Span]:
        """The closed spans whose host start lies in [since, until], oldest
        first, every device time resolved (this waits for the device)."""
        picked = [r for r in self._live() if since <= r[_T0] <= until]
        done = self._device_times
        todo = {r[_DEV] for r in picked if r[_E0] >= 0 and r[_SEQ] not in done}
        anchors: Dict[int, tuple] = {}
        for dev in todo:                  # a drained stream: a fresh anchor last
            torch.cuda.synchronize(dev)
            self.end(self.begin("profiling.anchor", "sync", torch.device("cuda", dev)),
                     anchor=True)
            held = self._events[dev].held
            got = [r for r in self._live() if r[_ANCHOR] and r[_DEV] == dev and held(r[_E1])]
            anchors[dev] = ([r[_SEQ] for r in got], got)
        out = []
        for r in picked:
            got = done.get(r[_SEQ])
            if got is None:
                got = (None, None)
                if r[_E0] >= 0:
                    a = anchors[r[_DEV]]
                    got = (self._map(r[_E0], r[_A0], r[_DEV], a),
                           self._map(r[_E1], r[_A1], r[_DEV], a))
                    if None in got:
                        got = (None, None)
                done[r[_SEQ]] = got
            out.append(Span(r[_SEQ], r[_NAME], r[_KIND], r[_PARENT], r[_ROOT], r[_T0], r[_T1],
                            got[0], got[1], r[_PROF]))
        return out

    def _map(self, e: int, a: int, dev: int, anchors: tuple) -> Optional[float]:
        """Event number ``e`` on the host's clock, through the last anchor
        at or before seq ``a`` that is still held (else the first after
        it); None where the pool has reused its event. ``anchors``: (their
        seqs, their records)."""
        pool = self._events[dev]
        seqs, recs = anchors
        if not seqs or not pool.held(e):
            return None
        k = bisect.bisect_right(seqs, a) - 1
        at = recs[max(k, 0)]
        ev, ev_at = pool.pool[e % pool.n], pool.pool[at[_E1] % pool.n]
        if k >= 0:
            return at[_T1] + ev_at.elapsed_time(ev) / 1e3
        return at[_T1] - ev.elapsed_time(ev_at) / 1e3

    def counters(self) -> Dict[str, object]:
        return {"replays": self.replays, "eager_calls": self.eager_calls,
                "warm_ups": self.warm_ups, "captures": self.captures,
                "capture_s": self.capture_s, "reads": dict(self.reads),
                "read_wait_s": dict(self.read_wait_s), "dropped": self.dropped}


class _Open:
    """A span open as a ``with`` block."""

    __slots__ = ("rec", "name", "kind", "device", "r", "t0")

    def __init__(self, rec: Recorder, name: str, kind: str, device):
        self.rec, self.name, self.kind, self.device = rec, name, kind, device

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.r = self.rec.begin(self.name, self.kind, self.device)
        return self

    def __exit__(self, *exc):
        dt = self.rec.end(self.r, self.t0)
        if self.kind == "capture":
            self.rec.capture_s += dt
        return False


class host_read:
    """A counted device->host read of ``site`` as a ``sync`` span: its
    wait is added to the site's counters, and on a CUDA device its end is
    an anchor of the device's clock (the read drained the stream). A read
    that waits on an earlier event, with work queued behind it, passes
    ``drained=False`` and is no anchor."""

    __slots__ = ("rec", "site", "device", "drained", "r", "t0")

    def __init__(self, site: str, device=None, drained: bool = True):
        self.rec = RECORDER
        self.site, self.device, self.drained = site, device, drained

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.r = self.rec.begin(self.site, "sync", self.device)
        return self

    def __exit__(self, *exc):
        dt = self.rec.end(self.r, self.t0, anchor=self.drained)
        self.rec.reads[self.site] += 1
        self.rec.read_wait_s[self.site] += dt
        return False


RECORDER = Recorder()


def span(name: str, kind: str = "layer", device=None) -> _Open:
    """A span of the process's recorder around a ``with`` block."""
    return _Open(RECORDER, name, kind, device)


def layer(name: str):
    """A method as a ``layer`` span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with _Open(RECORDER, name, "layer", None):
                return fn(*args, **kwargs)
        return traced
    return wrap


def spans(since: float = float("-inf"), until: float = float("inf")) -> List[Span]:
    """``RECORDER.spans``: the process's spans that start in [since, until]."""
    return RECORDER.spans(since, until)


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    last_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.last_s = dt

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


@dataclass
class EventLogger:
    """Accumulating wall-clock profiler. One instance per engine; cheap.
    Its scopes are spans of ``RECORDER`` as well."""

    time_tier: int = MODULE          # suppress tiers below this (TIME_LEVEL analog)
    verbose: bool = False
    stats: Dict[str, _Stat] = field(default_factory=lambda: defaultdict(_Stat))
    _open: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    def _record(self, name: str, tier: int, dt: float):
        if tier <= self.time_tier:
            self.stats[name].add(dt)
            if self.verbose:
                print(f"[{_TIER_NAMES[tier]}] {name}: {dt * 1e3:.2f} ms")

    def start(self, name: str):
        self._open[name] = time.perf_counter()

    def end(self, name: str, tier: int = EVENT) -> float:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return 0.0
        t1 = time.perf_counter()
        RECORDER.record(name, t0, t1)
        dt = t1 - t0
        self._record(name, tier, dt)
        return dt

    def scope(self, name: str, tier: int = EVENT) -> "_Scope":
        """RAII profiling scope (reference: PROFILE_FUNCTION macro), a
        ``layer`` span of ``RECORDER``."""
        return _Scope(self, name, tier)

    def time_since_start(self) -> float:
        """Scheduling timer (reference: getTimeSinceStart, used by BT nodes)."""
        return time.perf_counter() - self._t0

    def summary(self) -> str:
        lines = [f"{'name':<40}{'count':>7}{'mean ms':>10}{'min ms':>9}{'max ms':>9}{'total s':>9}"]
        for name in sorted(self.stats, key=lambda n: -self.stats[n].total_s):
            s = self.stats[name]
            lines.append(
                f"{name:<40}{s.count:>7}{s.mean_s * 1e3:>10.2f}{s.min_s * 1e3:>9.2f}"
                f"{s.max_s * 1e3:>9.2f}{s.total_s:>9.2f}"
            )
        return "\n".join(lines)

    def to_csv(self, path: Optional[str] = None) -> str:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["name", "count", "mean_ms", "min_ms", "max_ms", "total_s"])
        for name, s in sorted(self.stats.items()):
            w.writerow([name, s.count, s.mean_s * 1e3, s.min_s * 1e3, s.max_s * 1e3, s.total_s])
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def reset(self):
        self.stats.clear()
        self._open.clear()
        self._t0 = time.perf_counter()


class _Scope:
    __slots__ = ("log", "name", "tier", "open")

    def __init__(self, log: EventLogger, name: str, tier: int):
        self.log, self.name, self.tier = log, name, tier
        self.open = _Open(RECORDER, name, "layer", None)

    def __enter__(self):
        self.open.__enter__()
        return self

    def __exit__(self, *exc):
        self.open.__exit__(*exc)
        self.log._record(self.name, self.tier, time.perf_counter() - self.open.t0)
        return False


@dataclass
class SimClock(EventLogger):
    """An EventLogger whose scheduling timer reads a simulation's time,
    ``sim_s``, which the caller advances, instead of the host's: periodic
    work (the roadmap's cleanup) then falls on the same steps of a simulated
    run on a fast host and a slow one."""

    sim_s: float = 0.0

    def time_since_start(self) -> float:
        return self.sim_s


_GLOBAL: Optional[EventLogger] = None


def global_logger() -> EventLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = EventLogger()
    return _GLOBAL
