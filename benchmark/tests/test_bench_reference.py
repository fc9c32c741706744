"""The plain reference agrees with the port at a tiny size: the ORB
frontend keypoint for keypoint and bit for bit, the stereo disparity, and a
tracked pose; and it sees a pose that is off."""

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.reference import frontend as ref_front
from benchmark.tests.conftest import TINY_TRAFFIC, tiny_settings


@pytest.fixture(scope="module")
def episode():
    """Eight frames of the tiny corridor through the port's StereoSlam (CPU),
    each with the driver's snapshot."""
    from fitslam_tpu_torch.models.slam import StereoSlam

    cell = core.resolve("stereo_slam_640.corridor")
    cell.config = tiny_settings()
    cell.traffic = dict(TINY_TRAFFIC, trajectory=dict(TINY_TRAFFIC["trajectory"], frames=8,
                                                      length=1.2))
    drv = core.driver(cell)
    cfg, frames, gt = drv.prepare(cell, 2**31 + 9, torch.device("cpu"))
    slam = StereoSlam(cfg, "cpu")
    snaps = []
    for i, pair in enumerate(frames):
        snaps.append(drv.snapshot(slam, slam.process_frame(*pair), i))
    return drv, cell.config["settings"], frames, snaps


def test_frontend_equals_the_port(episode):
    from fitslam_tpu_torch.ops import orb

    _, s, frames, _ = episode
    o = s["orb"]
    left = frames[3][0]
    port = orb.extract_orb(left, o["num_features"], o["num_levels"], o["scale_factor"],
                           o["fast_threshold"])
    ref = ref_front.extract(left, o["num_features"], o["num_levels"], o["scale_factor"],
                            o["fast_threshold"])
    assert torch.equal(port.valid, ref.valid)
    assert torch.equal(port.xy, ref.xy)
    assert torch.equal(port.level.long(), ref.level)
    assert torch.equal(port.desc > 0, ref.desc)


def test_frames_agree_with_the_reference(episode):
    drv, s, frames, snaps = episode
    for snap in snaps:
        g = drv.frontend_gaps(snap, *frames[snap["i"]], s)
        assert g["kp_unmatched"] == 0.0 and g["desc_bits_off"] == 0.0
        assert g["depth_gap_px"] < 1e-4
        dt, _, n = drv.pose_gap(snap, g, s)
        assert n > 100 and dt < 0.02


def test_first_keyframe_pose_is_exact_and_an_offset_is_seen(episode):
    drv, s, frames, snaps = episode
    g = drv.frontend_gaps(snaps[0], *frames[0], s)
    assert drv.pose_gap(snaps[0], g, s)[0] < 1e-5
    moved = snaps[0]["pose_wc"].copy()
    moved[:3, 3] += np.array([0.05, 0.0, 0.0])
    dt, _, _ = drv.pose_gap(dict(snaps[0], pose_wc=moved), g, s)
    assert abs(dt - 0.05) < 0.005
