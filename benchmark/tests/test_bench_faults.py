"""The comparison that decides ``correct`` fails what it must: the control
(the reference computed in bfloat16 in the program's place) and a run whose
timed path is broken underneath, once for each fault the stereo cells can
have, the map's update among them. The tiny cell runs on the CPU; the card
check is skipped."""

import numpy as np
import pytest
import torch

from benchmark import core, report
from benchmark.tests.conftest import TINY_LIMITS


def test_control_is_not_correct(tiny_root):
    cell = core.resolve("tiny_stereo.tiny_corridor", root=tiny_root)
    drv = core.driver(cell)
    cfg, frames, gt = drv.prepare(cell, 3, torch.device("cpu"))
    snaps, _ = drv.episode(cfg, frames, drv.Sampler(cell.traffic, 3), torch.device("cpu"))
    ctl = drv.control_readings(snaps, frames, cell.config["settings"])
    ctl["sampled_frames"] = len(snaps)
    ctl["sampled_keyframes"] = sum("obs_kf" in s for s in snaps)
    ctl["sampled_landmarks"] = TINY_LIMITS["sampled_landmarks"]["min"]
    verdict = report.judge({k: ctl[k] for k in TINY_LIMITS}, TINY_LIMITS)
    assert not verdict["kp_unmatched"]["ok"] and not verdict["map_gap_mm"]["ok"]


def _run(tiny_root):
    cell = core.resolve("tiny_stereo.tiny_corridor", root=tiny_root)
    return report.run_cell(cell, 2**31 + 1, 5.0, False, 0.0, device="cpu")


def test_sound_run_is_correct(tiny_root):
    r = _run(tiny_root)
    assert r["correct"], r["checks"]


def test_step_that_leaves_its_state_unchanged(tiny_root, monkeypatch):
    from fitslam_tpu_torch.models.slam import StereoSlam

    real = StereoSlam.process_frame

    def stale(self, left, right):
        if self.frame_id < 2:
            return real(self, left, right)
        self.frame_id += 1                       # nothing tracked, the old pose
        return dict(self._last_info)

    def keep(self, left, right):
        info = stale(self, left, right)
        self._last_info = info
        return info

    monkeypatch.setattr(StereoSlam, "process_frame", keep)
    r = _run(tiny_root)
    assert not r["correct"] and r["checks"]["pose_gap_mm"]["value"] > 50


def test_half_the_features_left_out(tiny_root, monkeypatch):
    from fitslam_tpu_torch.models import tracking

    real = tracking.process_stereo

    def half(*a, **k):
        f = real(*a, **k)
        valid = f.feats.valid.clone()
        valid[1::2] = False
        return f._replace(feats=f.feats._replace(valid=valid))

    monkeypatch.setattr(tracking, "process_stereo", half)
    r = _run(tiny_root)
    assert not r["correct"] and r["checks"]["kp_unmatched"]["value"] > 0.3


def test_map_update_corrupted(tiny_root, monkeypatch):
    from fitslam_tpu_torch.models import slam_map

    real = slam_map.insert_keyframe

    def deeper(m, K, T_cw, feats, depth, *a, **k):
        return real(m, K, T_cw, feats, depth * 1.03, *a, **k)

    monkeypatch.setattr(slam_map, "insert_keyframe", deeper)
    r = _run(tiny_root)
    assert not r["correct"]
    assert r["checks"]["map_gap_mm"]["value"] > TINY_LIMITS["map_gap_mm"]["max"]


@pytest.mark.parametrize("where", ["pose", "descriptor"])
def test_answer_altered_where_produced(tiny_root, monkeypatch, where):
    if where == "pose":
        from fitslam_tpu_torch.models.slam import StereoSlam

        real = StereoSlam.process_frame

        def shifted(self, left, right):
            info = real(self, left, right)
            info["pose_wc"] = info["pose_wc"] + np.pad(np.array([[0.0, 0.0, 0.0, 0.03]]),
                                                       ((0, 3), (0, 0)))
            return info

        monkeypatch.setattr(StereoSlam, "process_frame", shifted)
        check = "pose_gap_mm"
    else:
        from fitslam_tpu_torch.ops import orb

        real = orb.describe_keypoints_plain

        def flipped(*a, **k):
            angle, desc = real(*a, **k)
            desc = desc.clone()
            desc[:, :16] = -desc[:, :16]
            return angle, desc

        monkeypatch.setattr(orb, "describe_keypoints_plain", flipped)
        check = "desc_bits_off"
    r = _run(tiny_root)
    assert not r["correct"] and r["checks"][check]["value"] > TINY_LIMITS[check]["max"]
