"""The metric arithmetic on fixed inputs: a rate over the whole window, the
95th percentile over all samples, a roofline share from bytes and
operations, and the idle share from a synthetic kernel timeline."""

import pytest

from benchmark import core, profile, stats
from benchmark.frozen import kernel_counts as kc


def test_rate_is_all_work_over_all_time():
    assert stats.rate(350, 10.0) == 35.0


def test_p95_over_all_samples():
    v = list(range(1, 101))                  # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([5.0] * 19 + [100.0], 95) == 5.0
    assert stats.percentile([5.0] * 18 + [100.0, 100.0], 95) == 100.0
    assert stats.median([3, 1, 2, 10]) == 2.5


def test_roofline_share_from_bytes_and_ops():
    # K2 at 1024 x 20480 is bound by its operations: 2 * na * nb * 256 int8
    ops = 2 * 1024 * 20480 * 256
    assert kc.k2_bound_s(1024, 20480, kc.GATE_WINDOW) == pytest.approx(ops / 1979e12)
    # a bytes-bound case: 1e9 bytes, no operations
    assert kc.bound_s(1e9, 0, "f32") == pytest.approx(1e9 / 3.35e12)
    run = {"profile": {"by_name": {"void orb_describe_kernel(...)": [20e-6, 2]}},
           "launches": {"K1": 2}, "steps": [],
           "settings": {"camera": {"width": 640, "height": 480},
                        "orb": {"num_features": 1024, "num_levels": 4,
                                "scale_factor": 1.4142135}}}
    share = core_reader("k1_roofline.slam").read(run)
    levels = [((480, 640), 546), ((336, 448), 273), ((240, 320), 137), ((168, 224), 68)]
    assert share == pytest.approx(100 * 2 * kc.k1_bound_s(levels, 1024) / 20e-6)
    assert core_reader("k1_roofline.slam").read({**run, "launches": {"K1": 0}}) is None


def test_idle_share_from_a_timeline():
    kernels = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (8.0, 9.0)]
    assert profile.union_length(kernels) == 4.0
    host = [("frame", 0.0, 10.0), ("tick", 4.0, 8.0), ("Buffer Flush", 9.2, 9.9)]
    gaps = profile.idle_gaps(kernels, host, 0.0, 10.0, top=None)
    assert gaps == [("tick", 4.0), ("frame", 1.0), ("Buffer Flush", 1.0)]
    run = {"profile": {"busy_s": 4.0, "window_s": 10.0, "profiler_idle_s": 0.0}}
    assert core_reader("device_idle.slam").read(run) == pytest.approx(60.0)
    # the profiler's own buffer flush leaves its stretch out
    run["profile"]["profiler_idle_s"] = sum(g for n, g in gaps if n in profile.PROFILER_OWN)
    assert core_reader("device_idle.slam").read(run) == pytest.approx(100 * (1 - 4 / 9))


def core_reader(name):
    return core.reader(core.resolve("stereo_slam_640.corridor"), name)
