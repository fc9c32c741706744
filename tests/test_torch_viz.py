"""The port's artifact recorder and renderers (``utils/viz.py``, a copy of the
reference's JAX-free module): the counterparts of tests/test_viz.py's cases,
each beside the reference on the same inputs. Tolerance: exact (the same
numpy); the PGM, PPM, CSV and npz contents byte- or value-equal."""

import numpy as np

from fitslam_tpu.utils import viz as jviz
from fitslam_tpu_torch.ops.grid import FREE, LETHAL, UNKNOWN
from fitslam_tpu_torch.utils import viz


def test_recorder_streams_and_npz(tmp_path):
    npz = {}
    for name, mod in (("port", viz), ("ref", jviz)):
        rec = mod.ArtifactRecorder()
        rec.publish("frontiers", np.array([[1.0, 2.0], [3.0, 4.0]]), t=0.5)
        rec.publish("frontiers", np.array([[5.0, 6.0]]), t=1.0)
        for k in range(12):
            rec.publish_pose(np.array([k, 0.0, 0.0]), t=k * 0.1)
        assert len(rec.trailing_poses) == 10  # deque cap (FrontierRoadmap :264)
        assert rec.streams() == ["frontiers", "robot_pose"]
        p = tmp_path / f"{name}.npz"
        rec.export_npz(str(p))
        npz[name] = dict(np.load(p))
    data = npz["port"]
    np.testing.assert_allclose(data["frontiers__t"], [0.5, 1.0])
    assert data["frontiers__1"].shape == (1, 2)
    assert data["trailing_poses"].shape == (10, 3)
    assert sorted(data) == sorted(npz["ref"])
    for k, v in npz["ref"].items():
        np.testing.assert_array_equal(data[k], v)


def test_coverage_csv(tmp_path):
    texts = []
    for mod in (viz, jviz):
        rec = mod.ArtifactRecorder()
        g = np.full((10, 10), UNKNOWN, np.uint8)
        rec.record_coverage(g, t=0.0)
        g[:5] = FREE
        rec.record_coverage(g, t=1.0)
        texts.append(rec.export_coverage_csv(str(tmp_path / f"{mod.__name__}.csv")))
    lines = texts[0].strip().splitlines()
    assert lines[0] == "time_s,known_cells,coverage_fraction"
    assert lines[1].split(",")[1] == "0"
    assert lines[2].split(",")[1] == "50"
    assert texts[0] == texts[1]
    with open(tmp_path / f"{viz.__name__}.csv", newline="") as f:
        assert f.read() == texts[1]


def test_disabled_recorder_is_noop():
    rec = viz.ArtifactRecorder(enabled=False)
    rec.publish("x", np.zeros(3))
    rec.publish_pose(np.zeros(3))
    rec.record_coverage(np.zeros((4, 4), np.uint8), 0.0)
    assert not rec.streams() and rec.export_coverage_csv().count("\n") == 1
    assert rec.export_coverage_csv() == jviz.ArtifactRecorder(enabled=False).export_coverage_csv()


def test_pgm_roundtrip(tmp_path):
    g = np.full((16, 16), UNKNOWN, np.uint8)
    g[2:6, 2:6] = FREE
    g[8, 8] = LETHAL
    g[10, 3] = 100
    p, pj = str(tmp_path / "map.pgm"), str(tmp_path / "ref.pgm")
    viz.grid_to_pgm(g, p)
    jviz.grid_to_pgm(g, pj)
    assert open(p, "rb").read() == open(pj, "rb").read()
    img = viz.load_pgm(p)
    assert img.shape == (16, 16)
    assert img[3, 3] == 255 - FREE
    assert img[8, 8] == max(0, 255 - LETHAL)
    assert img[0, 0] == 128
    np.testing.assert_array_equal(img, jviz.load_pgm(pj))


def test_render_world_ppm(tmp_path):
    g = np.full((32, 32), FREE, np.uint8)
    g[5:9, 20] = LETHAL
    g[25:, :4] = UNKNOWN
    kw = dict(robot_cell=(16, 16), frontier_cells=np.array([[2, 2], [3, 3]]),
              path_cells=np.array([[10, 10]]), roadmap_cells=np.array([[20, 20]]))
    p, pj = str(tmp_path / "world.ppm"), str(tmp_path / "ref.ppm")
    viz.render_world_ppm(g, p, **kw)
    jviz.render_world_ppm(g, pj, **kw)
    raw = open(p, "rb").read()
    assert raw == open(pj, "rb").read()
    assert raw.startswith(b"P6\n32 32\n255\n")
    img = np.frombuffer(raw.split(b"255\n", 1)[1], np.uint8).reshape(32, 32, 3)
    assert tuple(img[31 - 16, 16]) == (255, 220, 0)   # robot (y flipped)
    assert tuple(img[31 - 2, 2]) == (230, 0, 0)       # frontier
