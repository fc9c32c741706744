"""The rest of the port's ops and utils, held against the reference:
``lie.adjoint`` / ``interpolate`` / ``quat_from_rotmat`` /
``rotmat_from_quat``, ``geometry.triangulate_stereo`` /
``triangulate_two_view`` / ``ray_world`` / ``reprojection_residual``,
``image._conv2d_same`` / ``gaussian_kernel1d`` / ``gaussian_blur`` /
``sobel_gradients``, the YAML config loader with dotted overrides and
``ParallelConfig``, the logging levels and ``EventLogger``'s summary and CSV,
with the counterparts of tests/test_lie.py's adjoint, quaternion and
interpolation tests and of tests/test_config.py.

Tolerances: float32 results within 1e-5 (products summed in another order;
1e-4 for images of 0-255 grey levels); the configuration, the log lines'
format, the summary and the CSV exactly equal.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fitslam_tpu.ops import geometry as jgeo
from fitslam_tpu.ops import image as jimg
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.utils import config as jcfg
from fitslam_tpu.utils import logging as jlog
from fitslam_tpu.utils import profiling as jprof
from fitslam_tpu_torch.ops import geometry as tgeo
from fitslam_tpu_torch.ops import image as timg
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.utils import config as tcfg
from fitslam_tpu_torch.utils import logging as tlog
from fitslam_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


def _poses(seed, n, scale=0.4):
    xi = (scale * np.random.RandomState(seed).normal(size=(n, 6))).astype(np.float32)
    return jlie.se3_exp(jnp.asarray(xi)), tlie.se3_exp(torch.from_numpy(xi))


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_lie_leftovers_match_reference():
    jT, tT = _poses(0, 16)
    _close(tlie.adjoint(tT), jlie.adjoint(jT))
    jB, tB = _poses(1, 16)
    for alpha in (0.0, 0.3, 1.0):
        jM, tM = jlie.interpolate(jT, jB, alpha), tlie.interpolate(tT, tB, alpha)
        _close(tM.R, jM.R)
        _close(tM.t, jM.t)
    q_j, q_t = jlie.quat_from_rotmat(jT.R), tlie.quat_from_rotmat(tT.R)
    _close(q_t, q_j)
    _close(tlie.rotmat_from_quat(q_t), jlie.rotmat_from_quat(q_j))
    # the four Shepperd branches: rotations by pi about each axis, identity
    R = np.stack([np.eye(3)] + [np.diag(d) for d in ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))])
    R = R.astype(np.float32)
    _close(tlie.quat_from_rotmat(torch.from_numpy(R)), jlie.quat_from_rotmat(jnp.asarray(R)))


def test_adjoint_identity():
    """tests/test_lie.py::test_adjoint_identity through the port."""
    _, T = _poses(6, 1)
    T = tlie.SE3(T.R[0], T.t[0])
    eps = torch.from_numpy((0.01 * np.random.RandomState(7).normal(size=6)).astype(np.float32))
    lhs = tlie.compose(tlie.compose(T, tlie.se3_exp(eps)), tlie.inverse(T))
    rhs = tlie.se3_exp(tlie.adjoint(T) @ eps)
    np.testing.assert_allclose(lhs.matrix().numpy(), rhs.matrix().numpy(), atol=1e-4)


def test_quat_roundtrip():
    """tests/test_lie.py::test_quat_roundtrip through the port."""
    phi = np.random.RandomState(8).normal(size=(64, 3)).astype(np.float32)
    phi *= (2.0 * np.random.RandomState(9).rand(64, 1) / np.linalg.norm(phi, axis=1,
                                                                         keepdims=True)
            ).astype(np.float32)
    R = tlie.so3_exp(torch.from_numpy(phi))
    q = tlie.quat_from_rotmat(R)
    np.testing.assert_allclose(tlie.rotmat_from_quat(q).numpy(), R.numpy(), atol=1e-5)
    q_ref = Rotation.from_matrix(R.numpy().astype(np.float64)).as_quat()
    q_ref = np.concatenate([q_ref[:, 3:4], q_ref[:, :3]], axis=1)
    np.testing.assert_allclose(np.abs(q.numpy()), np.abs(q_ref), atol=1e-5)


def test_interpolate_endpoints():
    """tests/test_lie.py::test_interpolate_endpoints through the port."""
    _, A = _poses(9, 1, 0.3)
    _, B = _poses(10, 1, 0.3)
    for alpha, ref in [(0.0, A), (1.0, B)]:
        M = tlie.interpolate(A, B, alpha)
        np.testing.assert_allclose(M.matrix().numpy(), ref.matrix().numpy(), atol=1e-5)


def test_geometry_leftovers_match_reference():
    rng = np.random.RandomState(3)
    vals = (320.0, 318.0, 320.0, 240.0, 0.12)
    jK = jgeo.Intrinsics(*vals)
    tK = tgeo.Intrinsics(*[torch.tensor(v) for v in vals])
    jT, tT = _poses(4, 2, 0.2)
    j1, t1 = jlie.SE3(jT.R[0], jT.t[0]), tlie.SE3(tT.R[0], tT.t[0])
    j2, t2 = jlie.SE3(jT.R[1], jT.t[1] + jnp.asarray([0.5, 0.0, 0.0])), \
        tlie.SE3(tT.R[1], tT.t[1] + torch.tensor([0.5, 0.0, 0.0]))
    uv = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    uv2 = (uv + rng.normal(scale=5.0, size=uv.shape)).astype(np.float32)
    disp = rng.uniform(-1.0, 40.0, 200).astype(np.float32)
    for args_j, args_t in (((jK, j1, jnp.asarray(uv), jnp.asarray(disp)),
                            (tK, t1, torch.from_numpy(uv), torch.from_numpy(disp))),
                           ((jK, j1, jnp.asarray(uv[0]), jnp.asarray(disp[0])),
                            (tK, t1, torch.from_numpy(uv[0]), torch.tensor(disp[0])))):
        pj, vj = jgeo.triangulate_stereo(*args_j)
        pt, vt = tgeo.triangulate_stereo(*args_t)
        _close(pt, pj, 1e-4)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    pj, vj = jgeo.triangulate_two_view(jK, j1, j2, jnp.asarray(uv), jnp.asarray(uv2))
    pt, vt = tgeo.triangulate_two_view(tK, t1, t2, torch.from_numpy(uv), torch.from_numpy(uv2))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.any() and not vt.all()
    _close(pt[vt], np.asarray(pj)[vt.numpy()], 1e-3)
    rays = tgeo.ray_world(tK, t1, torch.from_numpy(uv))
    np.testing.assert_allclose(torch.linalg.norm(rays, dim=-1).numpy(), 1.0, atol=1e-6)
    pts = rng.uniform([-3, -2, 1], [3, 2, 12], (200, 3)).astype(np.float32)
    rj, okj = jgeo.reprojection_residual(jK, j1, jnp.asarray(pts), jnp.asarray(uv))
    rt, okt = tgeo.reprojection_residual(tK, t1, torch.from_numpy(pts), torch.from_numpy(uv))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    _close(rt, rj, 1e-3)


def test_image_leftovers_match_reference():
    img = np.random.RandomState(0).uniform(0, 255, (2, 37, 53)).astype(np.float32)
    np.testing.assert_array_equal(timg.gaussian_kernel1d(1.3, 4), jimg.gaussian_kernel1d(1.3, 4))
    for sigma, radius in ((2.0, 3), (1.2, 2)):
        _close(timg.gaussian_blur(torch.from_numpy(img), sigma, radius),
               jimg.gaussian_blur(jnp.asarray(img), sigma, radius), 1e-4)
    for got, ref in zip(timg.sobel_gradients(torch.from_numpy(img[0])),
                        jimg.sobel_gradients(jnp.asarray(img[0]))):
        _close(got, ref, 1e-4)
    k = np.random.RandomState(1).normal(size=(4, 5)).astype(np.float32)   # even sizes: SAME pads
    _close(timg._conv2d_same(torch.from_numpy(img), torch.from_numpy(k)),
           jimg._conv2d_same(jnp.asarray(img), jnp.asarray(k)), 1e-3)


def test_defaults_validate_and_equal_reference():
    cfg = tcfg.FitSlamConfig().validate()
    assert cfg.fisher_information.threshold == 550.0
    assert tcfg.to_dict(cfg) == jcfg.to_dict(jcfg.FitSlamConfig())
    assert dataclasses.asdict(tcfg.ParallelConfig()) == dataclasses.asdict(jcfg.ParallelConfig())


def test_yaml_roundtrip(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("orb:\n  num_features: 2048\nfisher_information:\n  threshold: 2.0\n"
                 "cost_assigner:\n  cost_calculation_methods: [ArrivalInformation]\n"
                 "parallel:\n  data_axis: rows\n")
    cfg = tcfg.load_config(str(p))
    assert cfg.orb.num_features == 2048
    assert cfg.fisher_information.threshold == 2.0
    assert cfg.cost_assigner.cost_calculation_methods == ("ArrivalInformation",)
    assert cfg.parallel.data_axis == "rows"
    assert cfg.roadmap.max_edge_length == 6.1      # untouched sections keep their defaults
    assert tcfg.to_dict(cfg) == jcfg.to_dict(jcfg.load_config(str(p)))


def test_overrides():
    over = {"tracking.min_inliers": 30, "nav.desired_speed": 0.8,
            "cost_assigner.cost_calculation_methods": ["RandomCosts"]}
    cfg = tcfg.load_config(overrides=over)
    assert cfg.tracking.min_inliers == 30 and cfg.nav.desired_speed == 0.8
    assert tcfg.to_dict(cfg) == jcfg.to_dict(jcfg.load_config(overrides=over))
    assert tcfg.apply_overrides(tcfg.FitSlamConfig(), {"orb.num_levels": 2}).orb.num_levels == 2


def test_unknown_key_rejected(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("orb:\n  bogus_key: 1\n")
    with pytest.raises(KeyError, match="bogus_key"):
        tcfg.load_config(str(p))
    with pytest.raises(KeyError, match="nope"):
        tcfg.load_config(overrides={"orb.nope": 1})


def test_load_config_needs_yaml_only_for_a_path(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("no yaml here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert tcfg.load_config().orb.num_features == 1024
    with pytest.raises(ImportError, match="PyYAML"):
        tcfg.load_config(str(tmp_path / "cfg.yaml"))


def test_profiling_smoke(monkeypatch):
    """tests/test_config.py::test_profiling_smoke through the port."""
    monkeypatch.setattr(tprof, "RECORDER", tprof.Recorder(64, enabled=True))
    log = tprof.EventLogger(time_tier=tprof.MODULE)
    with log.scope("frontier_search", tprof.MODULE):
        pass
    since = time.perf_counter()
    log.start("tick")
    assert log.end("tick", tprof.MODULE) >= 0.0
    assert "frontier_search" in log.stats
    assert log.stats["tick"].count == 1
    # start/end: one host span on the benchmark's clock, after the scope's
    (scope, tick) = tprof.spans()
    assert (scope.name, tick.name) == ("frontier_search", "tick")
    assert tick.kind == "layer" and since <= tick.t0 <= tick.t1 <= time.perf_counter()
    assert tick.d0 is None and not tick.profiled and tick.parent == -1
    assert "frontier_search" in log.to_csv()
    assert log.time_since_start() >= 0.0
    assert log.end("never_started") == 0.0
    log.reset()
    assert not log.stats
    assert tprof.global_logger() is tprof.global_logger()


@pytest.mark.parametrize("level", ["trace", "debug", "info", "warn", "error", "fatal", "flow",
                                   "highlight"])
def test_logging_levels_match_reference_format(level, capsys):
    for mod in (tlog, jlog):
        mod.set_level(tlog.TRACE)
    try:
        getattr(tlog, level)("probe")
        getattr(jlog, level)("probe")
    finally:
        for mod in (tlog, jlog):
            mod.set_level(tlog.INFO)
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 2
    tag = lambda ln: ln.split()[0]   # noqa: E731
    assert tag(lines[0]) == tag(lines[1]) and lines[0].endswith("] probe")
    assert lines[1].endswith("] probe")


def test_event_logger_summary_and_csv_equal_reference(tmp_path):
    jl, tl = jprof.EventLogger(time_tier=jprof.EVENT), tprof.EventLogger(time_tier=tprof.EVENT)
    events = [("backend_step", 0.012), ("frontend", 0.004), ("backend_step", 0.020),
              ("tick", 0.050), ("frontend", 0.003)]
    for name, dt in events:
        jl.stats[name].add(dt)
        tl.stats[name].add(dt)
    assert tl.summary() == jl.summary()
    assert tl.to_csv(str(tmp_path / "t.csv")) == jl.to_csv()
    assert (tmp_path / "t.csv").read_bytes().decode() == jl.to_csv()


def test_version_equals_reference():
    import fitslam_tpu_torch
    from fitslam_tpu import version

    assert fitslam_tpu_torch.__version__ == version.__version__
