"""The readers of the program's own spans on fixed synthetic spans: a window
of three frames (one a keyframe with a compaction, one a keyframe without)
and a profiled frame between them, a frame before the window, and mission
steps with their EKF flushes and a tick; None where the window holds no
span, where every span in it was profiled, where the spans carry no device
times (a run off the card), and where the program has no recorder."""

import pytest

from benchmark import core
from fitslam_tpu_torch.utils import profiling

Span = profiling.Span
T0, WIN = 100.0, 10.0
RUN = {"t_window": T0, "window_s": WIN}


def spans_of(rows):
    """Spans from (seq, name, kind, parent, t0, t1, d0, d1[, profiled]); as
    the program records them, a layer or a read keeps no device interval."""
    out = []
    for r in rows:
        seq, name, kind, parent, t0, t1, d0, d1 = r[:8]
        if kind not in profiling.TIMED:
            d0 = d1 = None
        out.append(Span(seq, name, kind, parent, seq if parent < 0 else -2, t0, t1, d0, d1,
                        r[8] if len(r) > 8 else False))
    return out


FRAME = "StereoSlam.process_frame"

CORRIDOR = spans_of([
    # a frame before the window: left out
    (1, FRAME, "layer", -1, 99.0, 99.9, 99.0, 99.9),
    (2, "frontend_stereo", "replay", 1, 99.1, 99.2, 99.1, 99.5),
    # frame A, a keyframe with a compaction
    (10, FRAME, "layer", -1, 100.0, 102.0, 100.0, 102.0),
    (11, "frontend", "layer", 10, 100.0, 100.2, 100.0, 100.6),
    (12, "frontend_stereo", "replay", 11, 100.05, 100.1, 100.1, 100.6),
    (13, "backend_step", "layer", 10, 100.2, 101.9, 100.6, 101.9),
    (14, "track", "replay", 13, 100.3, 100.35, 100.6, 101.0),
    (15, "backend_step.can_insert", "sync", 13, 100.35, 101.0, 101.0, 101.0),
    (16, "keyframe", "replay", 13, 101.0, 101.05, 101.0, 101.5),
    (17, "backend_step.recycle", "sync", 13, 101.05, 101.5, 101.5, 101.5),
    (18, "compact", "replay", 13, 101.5, 101.55, 101.5, 101.6),
    (19, "finish_keyframe", "replay", 13, 101.55, 101.6, 101.6, 101.8),
    (20, "StereoSlam.step", "sync", 13, 101.6, 101.85, 101.8, 101.85),
    # frame B, no keyframe
    (30, FRAME, "layer", -1, 103.0, 104.0, 103.0, 104.0),
    (31, "frontend_stereo", "replay", 30, 103.0, 103.05, 103.0, 103.4),
    (32, "track", "replay", 30, 103.05, 103.1, 103.4, 103.6),
    (33, "backend_step.can_insert", "sync", 30, 103.1, 103.6, 103.6, 103.6),
    (34, "finish", "replay", 30, 103.6, 103.65, 103.6, 103.7),
    (35, "StereoSlam.step", "sync", 30, 103.65, 103.7, 103.7, 103.7),
    # a profiled frame: left out, and its host extent out of the window's time
    (40, FRAME, "layer", -1, 105.0, 106.0, 105.0, 106.0, True),
    (41, "frontend_stereo", "replay", 40, 105.0, 105.1, 105.0, 105.9, True),
    # frame D, a keyframe without a compaction
    (50, FRAME, "layer", -1, 107.0, 109.0, 107.0, 109.0),
    (51, "frontend_stereo", "replay", 50, 107.0, 107.05, 107.0, 107.5),
    (52, "track", "replay", 50, 107.05, 107.1, 107.5, 107.7),
    (53, "backend_step.can_insert", "sync", 50, 107.1, 107.7, 107.7, 107.7),
    (54, "keyframe", "replay", 50, 107.7, 107.75, 107.7, 108.0),
    (55, "finish_keyframe", "replay", 50, 107.75, 107.8, 108.0, 108.1),
    (56, "StereoSlam.step", "sync", 50, 107.8, 108.3, 108.2, 108.3),
])

STEP, FLUSH, TICK = "SimCamera.frame", "DualEkf.flush", "exploration.tick"

MISSIONS = spans_of([
    # step 1: camera, frame, a tick, the flush
    (1, STEP, "layer", -1, 100.0, 100.5, 100.0, 100.5),
    (2, "camera", "replay", 1, 100.0, 100.1, 100.1, 100.4),
    (3, "ActiveSlamSystem.tick_exploration", "layer", -1, 101.0, 103.0, 101.0, 103.0),
    (4, TICK, "layer", 3, 101.5, 102.0, 101.5, 102.5),
    (5, "tick+fi/9", "replay", 4, 101.6, 101.7, 101.6, 102.4),
    (6, "publish", "replay", 3, 102.6, 102.7, 102.6, 102.8),      # beside the tick's span
    (7, FLUSH, "layer", -1, 103.0, 104.0, 103.0, 104.0),
    (8, "ekf_odom", "replay", 7, 103.1, 103.2, 103.1, 103.5),
    (9, "ekf_map", "replay", 7, 103.2, 103.3, 103.4, 103.8),      # overlaps the first
    (10, FLUSH, "sync", 7, 103.3, 103.9, 103.8, 103.9),
    # step 2: camera and a flush with nothing to fuse
    (20, STEP, "layer", -1, 105.0, 105.5, 105.0, 105.5),
    (21, "camera", "replay", 20, 105.0, 105.1, 105.1, 105.3),
    (22, FLUSH, "layer", -1, 106.0, 106.2, 106.0, 106.2),
    # a profiled step
    (30, STEP, "layer", -1, 107.0, 108.0, 107.0, 108.0, True),
    (31, "camera", "replay", 30, 107.0, 107.1, 107.0, 107.9, True),
    (32, FLUSH, "layer", -1, 107.5, 107.9, 107.5, 107.9, True),
])


def recorded(monkeypatch, rows):
    monkeypatch.setattr(profiling, "spans",
                        lambda since, until: [s for s in rows if since <= s.t0 <= until])


def reader(name):
    cell = ("stereo_slam_640.corridor" if name.endswith(".slam")
            else "active_slam_rooms64_ekf.missions")
    return core.reader(core.resolve(cell), name).read


def test_corridor_readers(monkeypatch):
    recorded(monkeypatch, CORRIDOR)
    # frames A, B, D: 5 + 3 + 4 replays
    assert reader("graph_launches_per_frame.slam")(RUN) == pytest.approx(12 / 3)
    # waits 0.65 + 0.45 + 0.25, 0.5 + 0.05, 0.6 + 0.5 s
    assert reader("sync_wait_ms_per_frame.slam")(RUN) == pytest.approx(3000 / 3)
    # A: keyframe, compact, finish_keyframe over 101.0-101.8; D: 107.7-108.1
    assert reader("keyframe_device_ms.slam")(RUN) == pytest.approx((800 + 400) / 2)
    # replays busy 100.1-101.8, 103.0-103.7, 107.0-108.1: 3.5 s of the
    # window's 10 s less the profiled frame's stretch, from frame B's end
    # to frame D's start (104-107)
    assert reader("outside_graphs.slam")(RUN) == pytest.approx(100 * (1 - 3.5 / 7))


def test_missions_readers(monkeypatch):
    recorded(monkeypatch, MISSIONS)
    # step 1: camera, tick, publish, two windows; step 2: camera
    assert reader("graph_launches_per_step.active")(RUN) == pytest.approx(6 / 2)
    # the windows' union 103.1-103.8 and an empty flush
    assert reader("flush_device_ms.active")(RUN) == pytest.approx((700 + 0) / 2)
    # the tick's program alone, not the published path beside it
    assert reader("tick_device_ms.active")(RUN) == pytest.approx(800)
    # busy 100.1-100.4, 101.6-102.4, 102.6-102.8, 103.1-103.8, 105.1-105.3:
    # 2.2 s of 10 s less the profiled step's stretch, from the last flush's
    # end to the window's (106.2-110)
    assert reader("outside_graphs.active")(RUN) == pytest.approx(100 * (1 - 2.2 / 6.2))


NAMES = ["graph_launches_per_frame.slam", "outside_graphs.slam", "sync_wait_ms_per_frame.slam",
         "keyframe_device_ms.slam", "graph_launches_per_step.active", "outside_graphs.active",
         "flush_device_ms.active", "tick_device_ms.active"]


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans_in_the_window(monkeypatch, name):
    recorded(monkeypatch, CORRIDOR + MISSIONS)
    assert reader(name)({"t_window": 200.0, "window_s": 10.0}) is None
    profiled = [s._replace(profiled=True) for s in CORRIDOR + MISSIONS]
    recorded(monkeypatch, profiled)
    assert reader(name)(RUN) is None
    monkeypatch.delattr(profiling, "spans")       # a program without the recorder
    assert reader(name)(RUN) is None


@pytest.mark.parametrize("name", ["outside_graphs.slam", "keyframe_device_ms.slam",
                                  "outside_graphs.active", "flush_device_ms.active",
                                  "tick_device_ms.active"])
def test_device_metrics_none_off_the_card(monkeypatch, name):
    recorded(monkeypatch, [s._replace(d0=None, d1=None) for s in CORRIDOR + MISSIONS])
    assert reader(name)(RUN) is None
