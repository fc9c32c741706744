"""The port's counterpart of ``tests/test_place.py``: the bag-of-words
signature separates true revisits from aliased rooms, and the loop closer's
consistency gate refuses a one-shot false loop; on the CPU with the
reference's assertions. The random descriptors and points are
``jax.random``'s draws, bit for bit, through ``utils/prng.py``."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from fitslam_tpu_torch.models import loop_closing as lc
from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics, project_stereo
from fitslam_tpu_torch.ops.orb import FrameFeatures
from fitslam_tpu_torch.ops.place import centered_cosine_scores, signature_from_descriptors
from fitslam_tpu_torch.utils import prng
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

CPU = "cpu"
N = 192  # descriptors a frame


def _rand_desc(key, n=N):
    return torch.from_numpy(np.where(prng.bernoulli(key, 0.5, (n, 256)), 1.0, -1.0)
                            ).to(torch.bfloat16)


def _perturb(key, desc, flip_p):
    """Flip each bit with probability flip_p (viewpoint / noise model)."""
    flip = torch.from_numpy(prng.bernoulli(key, flip_p, tuple(desc.shape)))
    return torch.where(flip, -desc, desc)


def _mix(key, desc_a, desc_b, frac_b):
    """A place whose features are (1 - frac_b) from room A, frac_b fresh."""
    take_b = torch.from_numpy(prng.bernoulli(key, frac_b, (desc_a.shape[0], 1)))
    return torch.where(take_b, desc_b, desc_a)


def test_signature_separates_revisit_from_aliased_room():
    """Revisits (the same descriptors with bit noise) score above every
    aliased room (60-80 % shared features) and far above distinct places,
    through the pipeline's retrieval score (``centered_cosine_scores``, the
    corpus-mean-centred cosine that ``detect_loop`` uses)."""
    key = prng.prng_key(7)
    valid = torch.ones((N,), dtype=torch.bool)
    room_a = _rand_desc(prng.fold_in(key, 0))

    sig_a = signature_from_descriptors(room_a, valid)
    # true revisits: the same physical features, some descriptor-bit noise
    revisit_sigs = []
    for k in range(4):
        d = _perturb(prng.fold_in(key, 10 + k), room_a, 0.02)
        revisit_sigs.append(signature_from_descriptors(d, valid))
    # aliased rooms: 60-80 % of the features look like A's (with a revisit's
    # viewpoint noise), the rest are fresh
    alias_sigs = []
    for k, frac in enumerate([0.2, 0.3, 0.4]):
        fresh = _rand_desc(prng.fold_in(key, 20 + k))
        shared = _perturb(prng.fold_in(key, 35 + k), room_a, 0.02)
        d = _mix(prng.fold_in(key, 30 + k), shared, fresh, frac)
        alias_sigs.append(signature_from_descriptors(d, valid))
    # distinct places
    distinct_sigs = []
    for k in range(4):
        d = _rand_desc(prng.fold_in(key, 40 + k))
        distinct_sigs.append(signature_from_descriptors(d, valid))

    # the keyframe database is the whole corpus (as in a real map); score A's
    # signature against it as detect_loop does
    corpus = torch.stack([sig_a] + revisit_sigs + alias_sigs + distinct_sigs)
    kf_valid = torch.ones((corpus.shape[0],), dtype=torch.bool)
    scores = centered_cosine_scores(sig_a, corpus, kf_valid)
    revisit_scores = [float(scores[1 + k]) for k in range(4)]
    alias_scores = [float(scores[5 + k]) for k in range(3)]
    distinct_scores = [float(scores[8 + k]) for k in range(4)]

    r_min = min(revisit_scores)
    a_max = max(alias_scores)
    d_max = max(distinct_scores)
    # full separation: one threshold classifies revisit, alias and distinct
    # with precision = recall = 1 on this corpus
    assert r_min > a_max > d_max, (revisit_scores, alias_scores, distinct_scores)
    # and the margin is usable (not a knife edge)
    assert r_min - a_max > 0.05
    # distinct places score low in absolute terms
    assert d_max < 0.3


def test_consistency_gate_blocks_one_shot_false_loop():
    """With consistency_threshold=3 a single-keyframe aliased detection is
    not verified; a persistent true revisit is (after 3 consecutive hits)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    K = Intrinsics(fx=f32(200.0), fy=f32(200.0), cx=f32(160.0), cy=f32(120.0), baseline=f32(0.2))
    key = prng.prng_key(3)
    pts_w = torch.from_numpy(prng.uniform(key, (N, 3), -4.0, 4.0)) + torch.tensor([0, 0, 8.0])
    desc = _rand_desc(prng.fold_in(key, 1))
    valid = torch.ones((N,), dtype=torch.bool)

    def frame_at(T_cw, d):
        p_c = (T_cw.R @ pts_w[..., None])[..., 0] + T_cw.t
        uvr, ok = project_stereo(K, p_c)
        feats = FrameFeatures(xy=uvr[:, :2], response=torch.ones((N,)), angle=torch.zeros((N,)),
                              level=torch.zeros((N,), dtype=torch.int32), desc=d,
                              valid=ok & (p_c[..., 2] > 0.5))
        return tr.StereoFrame(feats, p_c[..., 2] * feats.valid)

    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, min_gap_keyframes=3, min_score=0.1,
                                      min_matches=20, consistency_threshold=3,
                                      run_global_ba=False))
    no_match = -torch.ones((N,), dtype=torch.int32)
    T0 = lie.SE3.identity()
    f0 = frame_at(T0, desc)
    sig0 = signature_from_descriptors(desc, valid)
    m = sm.empty_map(16, 512, 2048, device=CPU)
    m = sm.insert_keyframe(m, K, T0, f0.feats, f0.depth, no_match, i32(0), sig0)
    for k in range(1, 8):
        T_k = lie.se3_exp(torch.tensor([5.0 * k, 0, 0, 0, 0, 0]))
        dk = _rand_desc(prng.fold_in(key, 50 + k))
        fk = frame_at(T_k, dk)
        m = sm.insert_keyframe(m, K, T_k, fk.feats, fk.depth, no_match, i32(k),
                               signature_from_descriptors(dk, fk.feats.valid))

    closer = lc.LoopCloser(cfg, K)
    # revisit keyframes (the same place, a consistent candidate = KF0)
    infos = []
    for r in range(3):
        T_est = lie.compose(lie.se3_exp(torch.tensor([0.3, 0.1, 0, 0, 0, 0.03])), T0)
        fr = frame_at(T0, desc)
        m = sm.insert_keyframe(m, K, T_est, fr.feats, fr.depth, no_match, i32(8 + r), sig0)
        slam = SimpleNamespace(map=m, last_frame=fr,
                               state=tr.mark_keyframe(
                                   tr.init_track_state(CPU)._replace(T_cw=T_est), i32(0)))
        infos.append(closer.on_keyframe(slam, int(m.n_kf) - 1))
        m = slam.map
    # the first two detections are held back by the gate; the third closes
    assert infos[0] is None and infos[1] is None
    assert infos[2] is not None and infos[2]["loop_to"] == 0
