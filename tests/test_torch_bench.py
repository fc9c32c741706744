"""The port's measurement entry points beside the reference's: the
configurations of ``fitslam_tpu_torch/bench.py`` and ``bench_suite.py``, the
BA problem's draws, the headline world, ``graft_entry.entry()``'s frame step
against ``__graft_entry__.entry()``'s, the headline record's keys at a cut
size, the command lines' refusals (no card, no fallback, no write over
``BENCH_SUITE.json``), and the modes that are not SLAM runs (ablation, ba,
scaling on two CPU ranks, kernels) with the reference's keys
(``test_torch_bench_modes.py`` has the SLAM modes and the key tables).

Tolerances of the frame step (ROADMAP fault F5, as
``tests/test_torch_tracking.py``): pose within 1e-3, ``lm_match`` agreement
>= 98 %, inlier count within 2 %. The BA problem's draws are bit-equal to
``jax.random``'s; what is computed from them (poses, points) is held to 1e-6
and the projections to 1e-6 relative or 1e-4 px (float32 operations in
another order).
"""

import dataclasses
import importlib
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fitslam_tpu.utils.config import FitSlamConfig as RefConfig
from fitslam_tpu_torch import bench, bench_suite, graft_entry
from fitslam_tpu_torch.utils import prng
from tests.test_ba import _make_problem
from tests.test_torch_bench_modes import (  # noqa: F401 (committed is a fixture)
    BA_KEYS, KERNEL_KEYS, METHOD_KEYS, PORT_KEYS, REFERENCE, _check, _finite, _line, committed)

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _reference_suite():
    """The repo-level ``bench_suite.py``. Its import sets a default JAX
    compilation-cache directory in the environment, which this process and
    its children must not inherit: the environment is restored."""
    key = "JAX_COMPILATION_CACHE_DIR"
    before = os.environ.get(key)
    try:
        return importlib.import_module("bench_suite")
    finally:
        if before is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = before


@pytest.mark.parametrize("small", [False, True])
def test_slam_cfg_matches_reference(small):
    ref_cfg, ref_wh = _reference_suite()._slam_cfg(small)
    cfg, wh = bench_suite._slam_cfg(small)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert wh == ref_wh


def _reference_mode_config(name):
    """The configurations the reference's modes build inside their
    functions, written out from the repo-level bench_suite.py."""
    R = dataclasses.replace
    suite = _reference_suite()
    if name.startswith("loop"):                      # bench_suite.py:113-123
        cfg, _ = suite._slam_cfg(name == "loop small")
        return R(cfg, loop=R(cfg.loop, enabled=True, min_gap_keyframes=15, min_score=0.22,
                             consistency_threshold=2, min_matches=40))
    if name.startswith("ablation"):                  # bench_suite.py:626-638
        meth = bench_suite.ABLATION_METHODS[name.split()[1]]
        c = RefConfig()
        return R(c, frontier_search=R(c.frontier_search, search_radius_m=6.0, max_frontiers=64),
                 roadmap=R(c.roadmap, max_nodes=256, cleanup_period_s=5.0),
                 nav=R(c.nav, wavefront_iters=192, desired_speed=0.8),
                 exploration_bt=R(c.exploration_bt, nav2_goal_timeout_s=30.0),
                 fisher_information=R(c.fisher_information, enabled=False),
                 cost_assigner=R(c.cost_assigner, cost_calculation_methods=meth))
    # active_slam (bench_suite.py:359-387) and marsyard (:699-720)
    W, H, feats, levels, fx = {"active": (640, 480, 1024, 4, 400.0),
                               "active small": (320, 240, 320, 2, 200.0),
                               "marsyard": (320, 240, 320, 2, 200.0)}[name]
    c = RefConfig()
    return R(c,
             camera=R(c.camera, width=W, height=H, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
                      baseline=0.2),
             orb=R(c.orb, num_features=feats, num_levels=levels, fast_threshold=12.0),
             tracking=R(c.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.25),
             mapping=R(c.mapping, max_keyframes=48, max_landmarks=3072, max_observations=8192,
                       local_window=4, ba_iters=3),
             loop=R(c.loop, enabled=False),
             traversability=R(c.traversability, max_points_per_cloud=4096, max_clouds=48),
             frontier_search=R(c.frontier_search, search_radius_m=6.0, max_frontiers=64),
             roadmap=R(c.roadmap, max_nodes=256, cleanup_period_s=5.0),
             nav=R(c.nav, wavefront_iters=192, desired_speed=0.7),
             fisher_information=R(c.fisher_information, threshold=5.0))


PORT_MODE_CONFIGS = {
    "loop": lambda: bench_suite.loop_config(False),
    "loop small": lambda: bench_suite.loop_config(True),
    "active": lambda: bench_suite.active_config(640, 480, 1024, 4, fx=0.625 * 640),
    "active small": lambda: bench_suite.active_config(320, 240, 320, 2, fx=0.625 * 320),
    "marsyard": lambda: bench_suite.active_config(320, 240, 320, 2, fx=200.0),
    **{f"ablation {m}": (lambda m=m: bench_suite.ablation_config(bench_suite.ABLATION_METHODS[m]))
       for m in ("arrival_info_roadmap", "random", "closest")},
}


@pytest.mark.parametrize("name", list(PORT_MODE_CONFIGS))
def test_mode_config_matches_reference(name):
    assert (dataclasses.asdict(PORT_MODE_CONFIGS[name]())
            == dataclasses.asdict(_reference_mode_config(name)))


def test_headline_config_matches_reference():
    """``bench.py:42-65`` builds its configuration inside ``main()``; its
    fields, written out here, applied to the reference's defaults."""
    R = dataclasses.replace
    W, H = 640, 480
    c = RefConfig()
    ref = R(c,
            camera=R(c.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2, cy=H / 2,
                     baseline=0.2),
            orb=R(c.orb, num_features=1024, num_levels=4, fast_threshold=12.0),
            tracking=R(c.tracking, min_inliers=12, keyframe_min_interval=2,
                       keyframe_translation=0.75),
            mapping=R(c.mapping, max_keyframes=64, max_landmarks=8192, max_observations=32768,
                      local_window=6, ba_iters=3))
    assert dataclasses.asdict(bench.headline_config()) == dataclasses.asdict(ref)
    assert (bench.N_FRAMES, bench.N_FEATURES, bench.N_LEVELS) == (60, 1024, 4)   # bench.py:26-29


def test_headline_world_matches_committed():
    got = bench.headline_world(CPU).numpy()
    ref = np.load(REPO / "tests" / "data" / "bench_corridor_world.npz")["landmarks"]
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_make_ba_problem_matches_reference():
    key = jax.random.PRNGKey(7)
    ref, ref_T, ref_pts = jax.tree.map(np.asarray, _make_problem(key, n_kf=8, n_lm=256,
                                                                 n_obs=1024))
    got, T_gt, pts = bench_suite.make_ba_problem(prng.prng_key(7), 8, 256, 1024, device=CPU)
    # the draws: keys, indices and the three normal draws, bit for bit
    keys = np.asarray(jax.random.split(key, 5))
    np.testing.assert_array_equal(prng.split(prng.prng_key(7), 5), keys)
    kt, kp, kq = keys[1], keys[3], keys[4]
    for k, shape in ((kt, (8, 6)), (kp, (256, 3)), (kq, (1024, 3))):
        np.testing.assert_array_equal(prng.normal(k, shape).view(np.uint32),
                                      np.asarray(jax.random.normal(k, shape)).view(np.uint32))
    np.testing.assert_array_equal(got.obs.kf.numpy(), ref.obs.kf)
    np.testing.assert_array_equal(got.obs.lm.numpy(), ref.obs.lm)
    np.testing.assert_array_equal(got.obs.valid.numpy(), ref.obs.valid)
    np.testing.assert_array_equal(got.obs.sigma2.numpy(), ref.obs.sigma2)
    np.testing.assert_array_equal(pts.numpy(), ref_pts)
    np.testing.assert_array_equal(got.fixed_kf.numpy(), ref.fixed_kf)
    np.testing.assert_array_equal(got.fixed_lm.numpy(), ref.fixed_lm)
    # computed from the draws
    # pixels up to 640: 1e-4 px is two float32 ulps there (u - bf / z cancels, so
    # the right eye's small columns carry the ulps of the large terms)
    np.testing.assert_allclose(got.obs.uvr.numpy(), ref.obs.uvr, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), ref.points, rtol=1e-6, atol=1e-6)
    for a, b in ((got.T_cw, ref.T_cw), (T_gt, ref_T)):
        np.testing.assert_allclose(a.R.numpy(), b.R, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a.t.numpy(), b.t, rtol=1e-6, atol=1e-6)


def test_entry_step_matches_reference():
    ref_fn, ref_args = graft.entry()
    ref_T, ref_lm, ref_n = (np.asarray(x) for x in ref_fn(*ref_args))
    step, args = graft_entry.entry(CPU)
    # the renders agree to a float32 ulp (splats summed in another order)
    np.testing.assert_allclose(args[0].numpy(), np.asarray(ref_args[0]), rtol=1e-6)
    np.testing.assert_allclose(args[1].numpy(), np.asarray(ref_args[1]), rtol=1e-6)
    T, lm, n = step(*args)
    np.testing.assert_allclose(T.numpy(), ref_T, atol=1e-3)
    assert (lm.numpy() == ref_lm).mean() >= 0.98
    assert abs(int(n) - int(ref_n)) <= 0.02 * int(ref_n)
    assert int(ref_n) > 100


def test_headline_record_at_a_cut_size(monkeypatch):
    """``bench.measure`` at 160x120 and 6 frames, with the loop block's
    payload stubbed (its mode is run in test_torch_bench_modes.py): the
    reference's metric, unit and extra keys (``bench.py:117-136``), the
    loop block under its own name, finite values, platform "cpu"."""
    R = dataclasses.replace
    cfg = bench.headline_config()
    cfg = R(cfg, camera=R(cfg.camera, width=160, height=120, fx=100.0, fy=100.0, cx=80.0,
                          cy=60.0),
            orb=R(cfg.orb, num_features=192, num_levels=2))
    loop = {"metric": "loop_slam_frames_per_s_per_chip", "value": 1.5, "unit": "frames/s",
            "vs": 0.025, "extra": {"ate_rmse_m": 0.1, "platform": "cpu", "device": "cpu"}}
    monkeypatch.setattr(bench_suite, "bench_loop_slam", lambda **kw: loop)
    rec = json.loads(json.dumps(bench.measure(cfg, CPU, n_frames=6)))
    assert (rec["metric"], rec["unit"]) == ("stereo_slam_frames_per_s_per_chip", "frames/s")
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(rec["extra"]) == {"ate_rmse_m", "n_keyframes", "n_landmarks", "resolution",
                                 "features", "levels", "platform", "loop_slam", "device"}
    assert rec["extra"]["loop_slam"] == {"frames_per_s_per_chip": 1.5, **loop["extra"]}
    assert rec["extra"]["platform"] == "cpu" and rec["extra"]["resolution"] == "160x120"
    assert rec["value"] > 0 and _finite(rec)
    assert rec["extra"]["ate_rmse_m"] < 0.05


def test_entry_points_refuse_to_run_without_a_card(capsys):
    """No card and no --cpu: the commands fail and print no record (on a
    machine without a CUDA device; with one, the card paths run instead)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) == 1
    assert bench_suite.main(["--mode", "ba"]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_suite.bench_ba(True, device="cuda")
    assert capsys.readouterr().out == ""


def test_out_never_overwrites_the_reference_record():
    with pytest.raises(SystemExit):
        bench_suite.main(["--mode", "ba", "--cpu", "--out", str(REPO / "BENCH_SUITE.json")])


def _reference_ablation(methods, n_steps):
    """The reference's ablation loop (``bench_suite.py:626-665``) for one
    cost method, written out here because the reference's mode writes its
    curves over the committed ``ABLATION_COVERAGE.csv``: (coverage after
    each step, path length)."""
    import jax.numpy as jnp

    from fitslam_tpu.models import sim_robot as sim
    from fitslam_tpu.models.exploration import ExplorationServer
    from fitslam_tpu.models.sim_nav import SimNavInterface
    from fitslam_tpu.ops import grid as gr
    from fitslam_tpu.utils.evaluation import coverage_fraction, path_length

    cfg = _reference_mode_config("ablation " + next(
        k for k, v in bench_suite.ABLATION_METHODS.items() if v == methods))
    spec = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
    gt = jnp.asarray(sim.make_rooms_world(spec, seed=1))
    state = {"explored": jnp.full((spec.size, spec.size), gr.UNKNOWN, jnp.uint8)}
    robot = sim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.2, w_max=2.5)
    nav = SimNavInterface(cfg, spec, robot, lambda: state["explored"], dt=0.15)
    nav.controller.max_omega = 2.0
    server = ExplorationServer(cfg, spec, lambda: state["explored"], nav,
                               get_robot_pose=lambda: (robot.xy, robot.yaw))
    cov = []
    for step in range(n_steps):
        state["explored"] = sim.reveal_sensor(spec, gt, state["explored"],
                                              jnp.asarray(robot.xy, jnp.float32), range_m=3.0)
        if step % 2 == 0:
            server.tick()
        for _ in range(4):
            nav.step()
        cov.append(coverage_fraction(np.asarray(state["explored"]) != gr.UNKNOWN))
    return cov, path_length(np.array([(x, y) for x, y, _ in robot.trajectory]))


def test_ablation_record(capsys, committed):
    """Three cost methods for 12 steps each: the reference's keys, each
    method's entry, and the curves under build/bench/, which equal the
    reference's loop's coverage at every step (to the CSV's 4 decimals), with
    each method's final coverage, steps to 50 % and path length (to the
    record's 0.1 m rounding)."""
    n_steps = 12
    returned = bench_suite.bench_ablation(True, n_steps=n_steps, device=CPU)
    rec = _line(capsys)
    assert rec == json.loads(json.dumps(returned))
    _check("ablation", rec)
    extra = rec["extra"]
    assert set(extra["methods"]) == set(bench_suite.ABLATION_METHODS)
    assert all(set(m) == METHOD_KEYS for m in extra["methods"].values())
    assert extra["csv"] == "build/bench/ABLATION_COVERAGE.csv"
    rows = (REPO / extra["csv"]).read_text().splitlines()
    assert len(rows) == 1 + n_steps
    names = rows[0].split(",")[1:]
    curves = np.array([[float(v) for v in r.split(",")[1:]] for r in rows[1:]])
    for j, name in enumerate(names):
        cov, length = _reference_ablation(bench_suite.ABLATION_METHODS[name], n_steps)
        assert [f"{c:.4f}" for c in curves[:, j]] == [f"{c:.4f}" for c in cov], name
        got = extra["methods"][name]
        assert got["final_coverage"] == round(cov[-1], 3)
        assert got["steps_to_50pct"] == next((i for i, c in enumerate(cov) if c >= 0.5), -1)
        assert abs(got["path_length_m"] - length) <= 0.05 + 1e-6, (name, got, length)


def test_ba_through_the_command_line(capsys, committed):
    """``--mode ba --small --cpu`` prints one line: both sizes, each with the
    reference's keys; the local size's final chi2 equals that of the
    reference's ``ops/ba.bundle_adjust`` (8 iterations) on
    ``tests/test_ba._make_problem(PRNGKey(7))`` at that size to 1e-4
    relative (float32 sums in another order)."""
    from fitslam_tpu.ops import ba as ref_ba
    from tests.test_ba import K as REF_K

    assert bench_suite.main(["--mode", "ba", "--small", "--cpu"]) == 0
    rec = _line(capsys)
    _check("ba", rec, {"local", "global"})
    for name, sz in bench_suite.BA_SIZES_SMALL.items():
        assert set(rec["extra"][name]) == BA_KEYS
        assert {k: rec["extra"][name][k] for k in sz} == sz
    assert rec["value"] == rec["extra"]["local"]["iters_per_s"] > 0
    prob, _, _ = _make_problem(jax.random.PRNGKey(7), **bench_suite.BA_SIZES["local"])
    _, stats = ref_ba.bundle_adjust(REF_K, prob, iters=8)
    ref_chi2 = float(np.asarray(stats.chi2)[-1])
    assert rec["extra"]["local"]["final_chi2"] == pytest.approx(ref_chi2, rel=1e-4)


def test_scaling_on_two_cpu_ranks(capsys, committed):
    """Landmark-sharded BA on 1 and 2 gloo ranks on the CPU: the reference's
    keys with the largest mesh's (2 here, 8 on the card) in place of
    ``chi2_8dev``; chi2 equal on both meshes."""
    bench_suite.bench_scaling(True, device=CPU, ranks=(1, 2))
    rec = _line(capsys)
    _check("scaling", rec, REFERENCE["scaling"][2] - {"chi2_8dev"})
    extra = rec["extra"]
    assert extra["problem"] == {"n_kf": 64, "n_lm": 4096, "n_obs": 16384}
    assert set(extra["coupling_Y_bytes_per_dev"]) == {"1dev", "2dev"}
    assert extra["chi2_parity_all_mesh_sizes"] is True
    assert extra["ranks_share_card"] is False and extra["backend"] == "gloo"


def test_kernels_mode(capsys):
    """The port's kernel bench on the CPU runs each kernel's wrapper (its
    plain twin there) at the small shapes: K2's window time as the
    reference's metric, each entry with its twin, yardstick and bound."""
    bench_suite.bench_kernels(True, device=CPU)
    rec = _line(capsys)
    assert (rec["metric"], rec["unit"]) == ("kernel_match_us_at_map_capacity", "us")
    names = {"K1 describe", "K2 window", "K2 stereo", "K2 verify", "K3 G=64"}
    assert set(rec["extra"]) == names | PORT_KEYS
    assert all(set(rec["extra"][n]) == KERNEL_KEYS for n in names)
    assert rec["value"] == pytest.approx(rec["extra"]["K2 window"]["ms"] * 1e3, rel=1e-3)
    assert rec["extra"]["K2 window"]["library_ms"] is not None


def test_failed_mode_prints_no_line(capsys, monkeypatch):
    """A mode that raises prints no record; the command exits 1 and names
    the mode on stderr."""
    def broken(small, device):
        raise ValueError("broken on purpose")

    monkeypatch.setitem(bench_suite.MODES, "ba", broken)
    assert bench_suite.main(["--mode", "ba", "--cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "mode ba FAILED: ValueError: broken on purpose" in out.err
