"""The SLAM modes of ``fitslam_tpu_torch/bench_suite.py`` (loop_slam,
rgbd_fusion, active_slam, marsyard) on the CPU at their small size, their
frames cut to a few (the other modes are in ``test_torch_bench.py``): each
prints one JSON line whose metric, unit and extra keys are the reference's (written out
below with the line of the repo-level ``bench_suite.py`` that sets them),
plus the port's ``platform`` ("cpu" here) and ``device``; every value is
finite; the files a mode writes go under ``build/bench/``, never over the
reference's committed artifacts at the repo root.
"""

import hashlib
import json
import math
from pathlib import Path

import pytest
import torch

from fitslam_tpu_torch import bench_suite

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
PORT_KEYS = {"platform", "device"}   # every record's extra, beside the reference's keys
COMMITTED = ("ABLATION_COVERAGE.csv", "ABLATION_COVERAGE.png", "MARSYARD_COVERAGE.csv",
             "MARSYARD_TRAJECTORY.ppm", "BENCH_SUITE.json")

# (metric, unit, extra keys) of each reference mode
REFERENCE = {
    # bench_suite.py:207-223 (the extra) and :195-203 (a seed's entry)
    "loop_slam": ("loop_slam_frames_per_s_per_chip", "frames/s",
                  {"ate_rmse_m", "ate_rmse_m_max", "ate_rmse_uncorrected_m", "loops_closed_min",
                   "seeds_with_loops", "n_seeds", "per_seed", "loop_closing_included",
                   "rotation_deg_total", "resolution", "platform"}),
    # bench_suite.py:334-340
    "rgbd_fusion": ("rgbd_fusion_frames_per_s_per_chip", "frames/s",
                    {"n_keyframes", "grid", "frontiers_final", "resolution"}),
    # bench_suite.py:430-438
    "active_slam": ("active_slam_ticks_per_s", "ticks/s",
                    {"ate_rmse_m", "coverage", "goals_sent", "fi_rejections", "n_keyframes",
                     "includes"}),
    # bench_suite.py:783-791
    "marsyard": ("marsyard_ticks_per_s", "ticks/s",
                 {"terrain_lethal_cells", "lethal_precision_vs_gt", "gt_lethal_violations",
                  "final_coverage", "goals_sent", "world", "artifacts"}),
    # bench_suite.py:673-678 (a method's entry: :659-665)
    "ablation": ("ablation_best_final_coverage", "fraction",
                 {"methods", "best", "csv", "world", "steps"}),
    # bench_suite.py:469-475
    "ba": ("ba_iters_per_s_local", "iters/s", {"local"}),
    # bench_suite.py:522-566; the port adds the collectives' count and ms, the
    # backend and whether the ranks share one card
    "scaling": ("dist_ba_scaling_efficiency_2dev", "fraction",
                {"t1_s", "t2_s", "speedup_2dev", "efficiency_2dev", "chi2_1dev", "chi2_2dev",
                 "chi2_8dev", "problem", "coupling_Y_bytes_per_dev", "bytes_psum_per_iter",
                 "chi2_parity_all_mesh_sizes", "note", "collectives_per_iter",
                 "collectives_ms_per_iter", "backend", "ranks_share_card"}),
}
SEED_KEYS = {"seed", "fps", "ate_rmse_m", "ate_rmse_pre_refine_m", "ate_rmse_uncorrected_m",
             "refine_s", "loops_closed", "n_keyframes"}
METHOD_KEYS = {"final_coverage", "steps_to_50pct", "path_length_m"}
BA_KEYS = {"iters_per_s", "n_kf", "n_lm", "n_obs", "final_chi2"}
# the port's own kernel bench: the reference's (bench_suite.py:794-998) times
# XLA against the MXU by lax.scan differencing, which is TPU-only
KERNEL_KEYS = {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape"}


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def _digests():
    return {name: hashlib.sha256((REPO / name).read_bytes()).hexdigest()
            for name in COMMITTED if (REPO / name).exists()}


def _line(capsys) -> dict:
    """The one JSON line a mode printed."""
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert rec["extra"]["platform"] == "cpu" and rec["extra"]["device"] == "cpu"
    assert _finite(rec), rec
    return rec


def _check(name, rec, extra_keys=None):
    metric, unit, keys = REFERENCE[name]
    assert (rec["metric"], rec["unit"]) == (metric, unit)
    assert set(rec["extra"]) == (keys if extra_keys is None else extra_keys) | PORT_KEYS


@pytest.fixture(scope="module")
def committed():
    before = _digests()
    yield
    assert _digests() == before, "a mode wrote over the reference's committed artifacts"


CUT_RUNS = {
    "loop_slam": lambda: bench_suite.bench_loop_slam(True, n_frames=4, seeds=(1,), device=CPU,
                                                     refine_cycles=0),
    "rgbd_fusion": lambda: bench_suite.bench_rgbd_fusion(True, n_frames=4, device=CPU),
    "active_slam": lambda: bench_suite.bench_active_slam(True, n_frames=12, device=CPU),
    "marsyard": lambda: bench_suite.bench_marsyard(True, n_frames=12, device=CPU),
}


@pytest.mark.parametrize("name", list(CUT_RUNS))
def test_mode_record(name, capsys, committed):
    returned = CUT_RUNS[name]()
    rec = _line(capsys)
    assert rec == json.loads(json.dumps(returned))
    _check(name, rec)
    extra = rec["extra"]
    if name == "loop_slam":
        assert extra["n_seeds"] == 1 and set(extra["per_seed"][0]) == SEED_KEYS
    if name == "marsyard":
        assert extra["artifacts"] == ["build/bench/MARSYARD_COVERAGE.csv",
                                      "build/bench/MARSYARD_TRAJECTORY.ppm"]
        assert all((REPO / a).is_file() for a in extra["artifacts"])
