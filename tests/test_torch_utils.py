"""The port's copies of the reference's jax-free helpers: the ported slices'
config sections (with ``preset`` and ``validate``), the ATE, path-length and
coverage evaluation and the PGM reader. The port keeps copies so that it
imports nothing of the reference package; these tests hold each copy equal
to the reference (exactly: the arithmetic is the same numpy)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fitslam_tpu.data import tum as jtum
from fitslam_tpu.utils import config as jcfg
from fitslam_tpu.utils import evaluation as jev
from fitslam_tpu_torch.data import tum as ttum
from fitslam_tpu_torch.utils import config as tcfg
from fitslam_tpu_torch.utils import evaluation as tev

SEQ = Path(__file__).resolve().parent / "data" / "corridor_seq"
ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ["camera", "orb", "tracking", "mapping", "loop", "traversability",
            "frontier_search", "cost_calculator", "cost_assigner", "roadmap",
            "path_optimizer", "goal_hysteresis", "fisher_information", "exploration_bt",
            "sensor_simulator", "nav", "costmaps", "localization", "recovery", "multi_robot"]


@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_defaults_equal_reference(section):
    ref = getattr(jcfg.FitSlamConfig(), section)
    port = getattr(tcfg.FitSlamConfig(), section)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_config_holds_only_the_slice_sections():
    assert [f.name for f in dataclasses.fields(tcfg.FitSlamConfig)] == SECTIONS


@pytest.mark.parametrize("mode", ["rapid", "light", "active_slam"])
def test_config_presets_equal_reference(mode):
    ref = jcfg.FitSlamConfig.preset(mode)
    port = tcfg.FitSlamConfig.preset(mode)
    for section in SECTIONS:
        assert dataclasses.asdict(getattr(port, section)) == dataclasses.asdict(getattr(ref, section))
    with pytest.raises(KeyError):
        tcfg.FitSlamConfig.preset("fast")


def test_config_validate_raises_as_reference():
    cfg = tcfg.FitSlamConfig()
    bad = [
        dataclasses.replace(cfg, goal_hysteresis=dataclasses.replace(
            cfg.goal_hysteresis, use_roadmap=True)),
        dataclasses.replace(cfg, cost_assigner=dataclasses.replace(cfg.cost_assigner, alpha=0.0)),
        dataclasses.replace(cfg, fisher_information=dataclasses.replace(
            cfg.fisher_information, threshold=0.0)),
        dataclasses.replace(cfg, traversability=dataclasses.replace(
            cfg.traversability, lethal_threshold=300)),
        dataclasses.replace(cfg, frontier_search=dataclasses.replace(
            cfg.frontier_search, max_frontier_cluster_size=0)),
    ]
    for c in bad:
        with pytest.raises(ValueError):
            c.validate()
    assert cfg.validate() is cfg


def test_path_length_and_coverage_equal_reference():
    rng = np.random.RandomState(5)
    traj = np.cumsum(rng.normal(size=(40, 2)), axis=0)
    assert tev.path_length(traj) == jev.path_length(traj)
    assert tev.path_length(np.c_[traj, traj[:, :1]]) == jev.path_length(np.c_[traj, traj[:, :1]])
    known = rng.rand(32, 32) < 0.3
    assert tev.coverage_fraction(known) == jev.coverage_fraction(known)


def test_interop_passes_grid_spec_through():
    from fitslam_tpu.ops.grid import GridSpec2D as JSpec
    from fitslam_tpu_torch.ops.grid import GridSpec2D as TSpec
    from fitslam_tpu_torch.utils import interop

    spec = JSpec(320, 0.25, -40.0, -40.0)
    got = interop.to_torch(spec)
    assert isinstance(got, TSpec) and tuple(got) == tuple(spec)
    assert all(type(a) is type(b) for a, b in zip(got, spec))
    assert interop.to_numpy(got) is got
    assert got.world_to_cell is not None and got.extent == spec.extent


def test_exploration_slice_imports_no_jax():
    code = (
        "import sys\n"
        "import fitslam_tpu_torch.models.sim_nav, fitslam_tpu_torch.models.exploration\n"
        "import fitslam_tpu_torch.ops.pallas_grid, fitslam_tpu_torch.utils.interop\n"
        "import fitslam_tpu_torch.models.active_slam, fitslam_tpu_torch.ops.fisher\n"
        "import fitslam_tpu_torch.ops.grid, fitslam_tpu_torch.data.synthetic\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fitslam_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_logging_warn_matches_reference_format(capsys):
    from fitslam_tpu.utils import logging as jlog
    from fitslam_tpu_torch.utils import logging as tlog

    tlog.warn("probe")
    jlog.warn("probe")
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 2
    assert [ln.split("]")[-1] for ln in lines] == [" probe", " probe"]
    assert all("WARN" in ln for ln in lines)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_rmse_equals_reference(seed):
    rng = np.random.RandomState(seed)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(30, 3))
    for align in (True, False):
        assert tev.ate_rmse(list(est), list(gt), align=align) == jev.ate_rmse(list(est), list(gt), align=align)
    assert tev.ate_rmse(est[:, :3, 3], gt[:, :3, 3]) == jev.ate_rmse(est[:, :3, 3], gt[:, :3, 3])


def test_read_pgm_equals_reference(tmp_path):
    for path in sorted((SEQ / "left").glob("*.pgm"))[:3]:
        np.testing.assert_array_equal(ttum.read_pgm(path), jtum.read_pgm(path))
    deep = np.random.RandomState(3).randint(0, 65535, (5, 7)).astype(np.uint16)
    jtum.write_pgm(tmp_path / "deep.pgm", deep)
    got = ttum.read_pgm(tmp_path / "deep.pgm")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, deep)
    ascii_pgm = tmp_path / "ascii.pgm"
    ascii_pgm.write_bytes(b"P2\n# comment\n3 2\n255\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(ttum.read_pgm(ascii_pgm), jtum.read_pgm(ascii_pgm))


def test_event_logger_keeps_tiers_up_to_its_own():
    import torch

    from fitslam_tpu_torch.utils.profiling import EVENT, MODULE, EventLogger

    log = EventLogger(time_tier=MODULE)
    for _ in range(3):
        with log.scope("step", MODULE, block_on=(torch.zeros(2),)):
            pass
        with log.scope("detail", EVENT):
            pass
    assert log.stats["step"].count == 3 and log.stats["step"].mean_s >= 0.0
    assert "detail" not in log.stats


@pytest.mark.parametrize("entry", ["models.slam:StereoSlam",
                                   "models.exploration:ExplorationServer",
                                   "models.sim_nav:SimNavInterface",
                                   "models.roadmap:empty_roadmap",
                                   "models.slam_map:empty_map",
                                   "models.tracking:init_track_state",
                                   "data.synthetic:load_world",
                                   "data.synthetic:straight_trajectory",
                                   "models.active_slam:ActiveSlamSystem",
                                   "models.active_slam:camera_pose_from_robot",
                                   "data.synthetic:world_from_occupancy",
                                   "data.synthetic:marsyard_world",
                                   "ops.grid:empty_cloud_buffer",
                                   "ops.grid:empty_cell_stats",
                                   "ops.fisher:generate_lookup_table",
                                   "ops.fisher:load_lookup_table",
                                   "models.localization:DualEkf",
                                   "models.localization:initial_state",
                                   "models.localization:default_process_noise",
                                   "models.localization:pack_rows",
                                   "run_dataset:replay",
                                   "run_dataset:record_sequence"])
def test_entry_points_default_to_cuda(entry):
    """The port's entry points and the state they build run on the card
    unless the caller passes device="cpu" (read from the signature, so no
    card is needed)."""
    import importlib
    import inspect

    import torch

    module, name = entry.split(":")
    fn = getattr(importlib.import_module(f"fitslam_tpu_torch.{module}"), name)
    default = inspect.signature(fn).parameters["device"].default
    assert default is not inspect.Parameter.empty, f"{entry} has no device default"
    assert torch.device(default).type == "cuda"


def test_localization_config_and_active_slam_preset_equal_reference():
    ref, port = jcfg.FitSlamConfig.preset("active_slam"), tcfg.FitSlamConfig.preset("active_slam")
    assert dataclasses.asdict(port) == {k: v for k, v in dataclasses.asdict(ref).items()
                                        if k in SECTIONS}
    assert dataclasses.asdict(tcfg.LocalizationConfig()) == dataclasses.asdict(
        jcfg.LocalizationConfig())
    assert port.fisher_information.enabled and not port.localization.enabled


def test_active_slam_builds_with_the_ekf_layer():
    """With cfg.localization.enabled the system builds on the CPU with its
    dual EKF on the same device, and wires the nav layer's executed twists
    into the odometry input."""
    from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem
    from fitslam_tpu_torch.models.localization import DualEkf
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    class Nav:
        on_cmd = None

    cfg = tcfg.FitSlamConfig.preset("active_slam")
    cfg = dataclasses.replace(cfg, localization=dataclasses.replace(cfg.localization,
                                                                    enabled=True))
    nav = Nav()
    system = ActiveSlamSystem(cfg, GridSpec2D(16, 0.25, -2.0, -2.0), nav=nav,
                              get_robot_pose=lambda: None, device="cpu")
    assert isinstance(system.ekf, DualEkf) and system.ekf.device.type == "cpu"
    assert nav.on_cmd == system.observe_odometry
    system.observe_odometry(0.5, 0.1, 0.15)
    assert len(system.ekf._odom_rows) == 2 and len(system.ekf._map_rows) == 2
    system.observe_imu_orientation(0.0, 0.0, 0.3)      # a rate row and an orientation row
    assert len(system.ekf._odom_rows) == 4 and len(system.ekf._map_rows) == 4
    xy, yaw = system.estimated_robot_pose()            # one flush, one read
    assert system.ekf.flushes == 1 and system.host_syncs == 1
    assert system.estimated_robot_pose() == (xy, yaw) and system.host_syncs == 1   # cached
    assert xy[0] > 0.0 and 0.0 < yaw < 0.3


def test_run_dataset_parser_defaults_to_cuda():
    """python -m fitslam_tpu_torch.run_dataset runs on the card unless --cpu
    is given."""
    import torch

    from fitslam_tpu_torch import run_dataset

    parser = run_dataset.build_parser()
    assert torch.device(run_dataset.device_of(parser.parse_args([]))).type == "cuda"
    assert run_dataset.device_of(parser.parse_args(["--cpu"])) == "cpu"
