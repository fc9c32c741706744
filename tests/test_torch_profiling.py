"""The process-wide span recorder (``fitslam_tpu_torch/utils/profiling.py``)
and what feeds it: nesting (parent and root), windows by host start, the
ring's wrap and its ``dropped`` count, the ``profiled`` flag,
``FITSLAM_TRACE=0``, device times mapped to the host's clock through
anchors (a stand-in device clock on the CPU), captured regions' calls
counted by kind past ``release_idle``, and the counted host reads of the
frame step as ``sync`` spans, one for each ``host_syncs``.

On the card (no JAX imported here):

    python3 -m pytest --noconftest -m gpu tests/test_torch_profiling.py -q

a replay's device start mapped to the host's clock is not before its host
launch, less the anchor error; a frame's replays take no more device time
than the frame's wall time; and torch's sync debug mode counts the same
syncs a frame with the recorder on and off.
"""

import dataclasses
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitslam_tpu_torch.data.tum import read_pgm
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.utils import jit, profiling
from fitslam_tpu_torch.utils.config import FitSlamConfig

SEQ = Path(__file__).resolve().parent / "data" / "corridor_seq"

#: the anchors' error on the card, measured (PERF.md §6): a device time
#: mapped to the host's clock is within this of where it ran
ANCHOR_ERROR_S = 100e-6


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder of 64 spans in the process-wide one's place."""
    r = profiling.Recorder(64, enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


def test_spans_nest_under_their_parent_and_root(rec):
    with profiling.span("frame", device="cpu"):
        with profiling.span("backend"):
            with profiling.host_read("read", "cpu"):
                pass
        with profiling.span("region", "replay"):
            pass
    with profiling.span("next"):
        pass
    got = {s.name: s for s in profiling.spans()}
    frame, backend, read = got["frame"], got["backend"], got["read"]
    assert (frame.parent, frame.root) == (-1, frame.seq)
    assert (backend.parent, backend.root) == (frame.seq, frame.seq)
    assert (read.parent, read.root, read.kind) == (backend.seq, frame.seq, "sync")
    assert (got["region"].parent, got["region"].kind) == (frame.seq, "replay")
    assert (got["next"].parent, got["next"].root) == (-1, got["next"].seq)
    assert frame.t0 <= backend.t0 <= read.t0 <= read.t1 <= backend.t1 <= frame.t1
    assert all(s.d0 is None and s.d1 is None for s in got.values())     # no device
    assert rec.replays == 1 and rec.reads == {"read": 1} and rec.read_wait_s["read"] >= 0


def test_a_window_holds_the_spans_that_start_in_it(rec):
    marks = []
    for name in "abcd":
        with profiling.span(name):
            marks.append(time.perf_counter())
    assert [s.name for s in profiling.spans(marks[0], marks[2])] == ["b", "c"]
    assert [s.name for s in profiling.spans(until=marks[0])] == ["a"]
    assert [s.name for s in profiling.spans(marks[2])] == ["d"]
    with profiling.span("open"):
        assert "open" not in [s.name for s in profiling.spans()]   # closed spans only


def test_the_ring_wraps_and_counts_what_it_dropped(rec):
    for k in range(100):
        with profiling.span(f"s{k}"):
            pass
    got = profiling.spans()
    assert [s.name for s in got] == [f"s{k}" for k in range(36, 100)]
    assert [s.seq for s in got] == list(range(36, 100))
    assert rec.dropped == 36
    assert got[0].t0 > rec.last_dropped_t0       # the oldest held began after every drop


def test_spans_under_a_profiler_are_marked(rec):
    with profiling.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("traced"):
            pass
    with profiling.span("after"):
        pass
    assert [(s.name, s.profiled) for s in profiling.spans()] == [
        ("before", False), ("traced", True), ("after", False)]


def test_fitslam_trace_0_stops_the_spans_not_the_counters(monkeypatch):
    monkeypatch.setenv("FITSLAM_TRACE", "0")
    off = profiling.Recorder(64)
    monkeypatch.setattr(profiling, "RECORDER", off)
    assert not off.enabled
    with profiling.span("frame"):
        with profiling.span("region", "replay"):
            pass
        with profiling.span("region", "capture"):
            time.sleep(0.002)
        with profiling.host_read("read", "cpu"):
            time.sleep(0.002)
    assert profiling.spans() == [] and off.dropped == 0
    assert (off.replays, off.captures, off.reads["read"]) == (1, 1, 1)
    assert off.capture_s >= 0.002 and off.read_wait_s["read"] >= 0.002
    monkeypatch.setenv("FITSLAM_TRACE", "1")
    assert profiling.Recorder(64).enabled


class _Clock:
    """A stand-in device: a clock 1000 s off the host's, and work queued on
    it that ends ``busy_until`` (an event recorded behind it runs then)."""

    def __init__(self):
        self.busy_until = 0.0

    def now(self):
        return max(time.perf_counter(), self.busy_until) + 1000.0


def _fake_card(monkeypatch):
    clock = _Clock()

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            self.t = clock.now()

        def elapsed_time(self, end):
            if self.t is None or end.t is None:
                raise RuntimeError("event not recorded")
            return (end.t - self.t) * 1e3

    cuda = SimpleNamespace(Event=Event, current_stream=lambda dev=None: None,
                           current_device=lambda: 0, synchronize=lambda dev=None: None,
                           is_available=lambda: True, get_sync_debug_mode=lambda: 0,
                           set_sync_debug_mode=lambda mode: None)
    monkeypatch.setattr(profiling.torch, "cuda", cuda)
    monkeypatch.setattr(profiling, "_current_stream", lambda dev: None)
    return clock


def test_device_times_come_back_on_the_hosts_clock(monkeypatch, rec):
    """A region's call has a device interval, mapped through the anchor
    before it (a drained read) or the first after it where none is before;
    queued work delays its end; a layer and a read are timed on the host."""
    clock = _fake_card(monkeypatch)
    dev = torch.device("cuda", 0)
    with profiling.span("early", "replay", dev):        # before any anchor
        pass
    with profiling.host_read("read", dev):
        pass
    with profiling.span("frame"):
        with profiling.span("region", "replay", dev):
            clock.busy_until = time.perf_counter() + 0.005   # 5 ms of queued work
        with profiling.host_read("read", dev):
            time.sleep(0.006)
    clock.busy_until = 0.0
    got = {s.name: s for s in profiling.spans()}
    for name in ("early", "region"):
        assert abs(got[name].d0 - got[name].t0) < 2e-3, got[name]
    assert got["region"].d1 - got["region"].t1 > 3e-3     # it ended with the queued work
    assert got["frame"].d0 is None and got["read"].d0 is None
    assert rec.reads["read"] == 2


def test_a_reused_event_leaves_its_span_without_device_times(monkeypatch):
    rec = profiling.Recorder(64, enabled=True, events=6)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _fake_card(monkeypatch)
    dev = torch.device("cuda", 0)
    for k in range(4):                 # two events a call, numbered 0-7
        with profiling.span(f"r{k}", "replay", dev):
            pass
    got = profiling.spans()            # its closing anchor takes number 8: 3-8 held
    assert [s.d0 is None for s in got if s.kind == "replay"] == [True, True, False, False]


def _count_regions(slot, n):
    out = []
    for k in range(n):
        out.append(slot.run("twice", jit.pure(lambda x: 2 * x), torch.full((3,), float(k)))[1])
    return out


class _Owner:
    pass


def test_region_calls_are_counted_by_kind_past_release_idle(rec):
    owner = _Owner()
    state = jit.SlotState(owner, ("profiling-test",), "cpu", {"x": torch.zeros(3)})
    outs = _count_regions(state.claim(), 3)
    assert float(outs[-1][0]) == 4.0
    assert rec.eager_calls == 3 and rec.replays == 0
    del owner, state
    jit.release_idle()
    assert rec.eager_calls == 3
    assert [(s.name, s.kind) for s in profiling.spans()] == [("twice", "eager")] * 3


def test_card_calls_are_warm_up_capture_then_replays(monkeypatch, rec):
    """The kinds a region's calls take on the card (graph work stubbed)."""
    monkeypatch.setattr(jit, "_check_not_nested", lambda name, dev: None)
    slot = SimpleNamespace(device=torch.device("cuda"), _owner=None, owns=lambda t: False)
    step = jit.CapturedStep(jit.pure(lambda x: x + 1), "region", slot)
    launched = []

    def capture(args):
        step._bind(args)
        step.written, step.out = (), ()
        step.graph = SimpleNamespace(replay=lambda: launched.append(1))

    monkeypatch.setattr(step, "_warm_up", lambda args: (args, ()))
    monkeypatch.setattr(step, "_capture", capture)
    for _ in range(4):
        step(torch.zeros(2))
    assert [s.kind for s in profiling.spans()] == ["warm_up", "capture", "replay", "replay",
                                                   "replay"]
    assert (rec.warm_ups, rec.captures, rec.replays, len(launched)) == (1, 1, 3, 3)
    assert step.calls == 4


def _config():
    """tests/test_torch_jit.py's golden configuration."""
    W, H = 320, 240
    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                      baseline=0.2),
             orb=R(cfg.orb, num_features=512, num_levels=2, fast_threshold=12.0),
             tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.3, reloc_enabled=False),
             mapping=R(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                       max_observations=12288, local_window=4, ba_iters=3),
             loop=R(cfg.loop, enabled=False))


def _frames(n, device="cpu"):
    lefts = sorted((SEQ / "left").glob("*.pgm"))[:n]
    rights = sorted((SEQ / "right").glob("*.pgm"))[:n]
    return [(torch.tensor(read_pgm(l).astype(np.float32), device=device),
             torch.tensor(read_pgm(r).astype(np.float32), device=device))
            for l, r in zip(lefts, rights)]


def _below(spans, top):
    """The spans of ``spans`` below ``top`` (by their parent chain)."""
    by = {s.seq: s for s in spans}
    out = []
    for s in spans:
        p = s.parent
        while p in by and p != top.seq:
            p = by[p].parent
        if p == top.seq:
            out.append(s)
    return out


def test_each_counted_read_of_a_frame_is_a_sync_span(monkeypatch):
    """Every ``host_syncs`` of the frame step is a ``sync`` span below its
    ``StereoSlam.process_frame`` span, beside the ``frontend`` and
    ``backend_step`` scopes and the regions' calls."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(4096, enabled=True))
    slam = StereoSlam(_config(), "cpu")
    syncs = []
    for pair in _frames(6):
        before = slam.host_syncs
        slam.process_frame(*pair)
        syncs.append(slam.host_syncs - before)
    got = profiling.spans()
    frames = [s for s in got if s.name == "StereoSlam.process_frame"]
    assert len(frames) == 6 and all(f.parent == -1 for f in frames)
    for f, n in zip(frames, syncs):
        below = _below(got, f)
        assert [s.kind for s in below].count("sync") == n
        names = {s.name for s in below}
        assert {"frontend", "backend_step", "frontend_stereo", "StereoSlam.step",
                "backend_step.can_insert"} <= names
        assert all(s.kind == "eager" for s in below if s.name == "frontend_stereo")
    assert sum(syncs) == sum(profiling.RECORDER.reads.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times and CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _run_frames(card, n_warm=4, n=8):
    slam = StereoSlam(_config(), card)
    frames = _frames(n_warm + n, card)
    for pair in frames[:n_warm]:                 # warm-up and capture of each region
        slam.process_frame(*pair)
    torch.cuda.synchronize()
    since = time.perf_counter()
    for pair in frames[n_warm:]:
        slam.process_frame(*pair)
    return slam, profiling.spans(since)


@pytest.mark.gpu
def test_a_replay_starts_on_the_device_after_its_launch(card):
    if not profiling.RECORDER.enabled:
        pytest.skip("FITSLAM_TRACE=0: no spans")
    _, got = _run_frames(card)
    replays = [s for s in got if s.kind == "replay"]
    assert len(replays) >= 8 * 3
    for s in replays:
        assert s.d0 is not None and s.d1 >= s.d0
        assert s.d0 >= s.t0 - ANCHOR_ERROR_S, (s.name, s.d0 - s.t0)


@pytest.mark.gpu
def test_a_frames_replays_take_no_more_than_its_wall_time(card):
    if not profiling.RECORDER.enabled:
        pytest.skip("FITSLAM_TRACE=0: no spans")
    _, got = _run_frames(card)
    frames = [s for s in got if s.name == "StereoSlam.process_frame"]
    assert len(frames) == 8
    for f in frames:
        device_s = sum(s.d1 - s.d0 for s in _below(got, f) if s.kind == "replay")
        assert 0 < device_s <= f.t1 - f.t0 + ANCHOR_ERROR_S


@pytest.mark.gpu
def test_the_recorder_adds_no_device_sync(card, monkeypatch):
    def syncs_a_frame(enabled):
        monkeypatch.setattr(profiling.RECORDER, "enabled", enabled)
        slam = StereoSlam(_config(), card)
        frames = _frames(12, card)
        for pair in frames[:4]:
            slam.process_frame(*pair)
        counts = []
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for pair in frames[4:]:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    slam.process_frame(*pair)
                counts.append(sum("synchroniz" in str(w.message) for w in caught))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return counts

    on, off = syncs_a_frame(True), syncs_a_frame(False)
    assert on == off and sum(on) > 0
