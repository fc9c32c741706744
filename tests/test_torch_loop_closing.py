"""Parity of the port's loop closing (``models/loop_closing.py``) with the
reference, stage by stage, on ``tests/test_loop_closing.py``'s drifted
revisit and ``tests/test_scale_correction.py``'s arc; the port's copies of
those tests' assertions; and ``match_ratio_fused`` (K2's loop-verification
call) against the reference's ``match_ratio(mutual=True)``.

The reference builds each scene with its own functions; the port receives
the same arrays through ``utils.interop``. Tolerances: detect_loop's index
exactly and its score within 1e-5; verify_loop's inlier count exactly and
its pose within 1e-4; fuse_loop_landmarks exactly (integer and boolean
fields); poses after the whole correction (PGO and GBA, float32 Gauss-Newton
summed in another order, ROADMAP F5) within 1e-3; re-triangulated points
within 1e-4 relative; the scale search's winner exactly and its chi2 within
1e-4 relative or 1e-3 absolute (at the true scale the chi2 is float32 noise
near zero).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import loop_closing as jlc
from fitslam_tpu.models import slam_map as jsm
from fitslam_tpu.models import tracking as jtr
from fitslam_tpu.ops import ba as jba
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.ops import matching as jmatching
from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
from fitslam_tpu.ops.geometry import project_stereo
from fitslam_tpu.ops.orb import FrameFeatures as JFeatures
from fitslam_tpu.ops.place import signature_from_descriptors
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.models import loop_closing as tlc
from fitslam_tpu_torch.models import tracking as ttr
from fitslam_tpu_torch.ops import ba as tba
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.ops import orb as torb
from fitslam_tpu_torch.ops import pallas_matching as tpm
from fitslam_tpu_torch.utils import interop
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

N = 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.to_torch(_np(tree))


def _K(fx, fy, cx, cy, b):
    return JIntrinsics(*(jnp.float32(v) for v in (fx, fy, cx, cy, b)))


KJ = _K(200.0, 200.0, 160.0, 120.0, 0.2)


def _frame_from_landmarks(key, pts_w, T_cw):
    """tests/test_loop_closing.py's fabricated stereo frame."""
    p_c = (T_cw.R @ pts_w[..., None])[..., 0] + T_cw.t
    uvr, ok = project_stereo(KJ, p_c)
    desc = jnp.where(jax.random.bernoulli(key, 0.5, (N, 256)), 1.0, -1.0).astype(jnp.bfloat16)
    feats = JFeatures(xy=uvr[:, :2], response=jnp.ones((N,)), angle=jnp.zeros((N,)),
                      level=jnp.zeros((N,), jnp.int32), desc=desc,
                      valid=ok & (p_c[..., 2] > 0.5))
    return jtr.StereoFrame(feats, p_c[..., 2] * feats.valid), desc


def _loop_cfg(cls, **loop):
    cfg = cls()
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, min_gap_keyframes=3, min_score=0.1, min_matches=20, **loop))


@pytest.fixture(scope="module")
def revisit():
    """The reference's map of tests/test_loop_closing.py: keyframe 0 at the
    origin, seven far-away keyframes, and keyframe 8 revisiting keyframe 0's
    view from a pose drifted by 0.5 m."""
    kw = jax.random.PRNGKey(0)
    pts_w = jax.random.uniform(kw, (N, 3), minval=-4.0, maxval=4.0) + jnp.array([0, 0, 8.0])
    T_true = jlie.SE3.identity()
    frame0, desc = _frame_from_landmarks(jax.random.fold_in(kw, 1), pts_w, T_true)
    m = jsm.empty_map(16, 512, 2048)
    sig0 = signature_from_descriptors(desc, frame0.feats.valid)
    m = jsm.insert_keyframe(m, KJ, T_true, frame0.feats, frame0.depth,
                            -jnp.ones((N,), jnp.int32), jnp.int32(0), sig0)
    for k in range(1, 8):
        T_k = jlie.se3_exp(jnp.array([5.0 * k, 0, 0, 0, 0, 0]))
        fk, dk = _frame_from_landmarks(jax.random.fold_in(kw, 10 + k), pts_w + 100.0, T_k)
        m = jsm.insert_keyframe(m, KJ, T_k, fk.feats, fk.depth, -jnp.ones((N,), jnp.int32),
                                jnp.int32(k), signature_from_descriptors(dk, fk.feats.valid))
    T_est = jlie.compose(jlie.se3_exp(jnp.array([0.5, 0.2, 0.0, 0.0, 0.0, 0.05])), T_true)
    frame9 = jtr.StereoFrame(frame0.feats, frame0.depth)
    m = jsm.insert_keyframe(m, KJ, T_est, frame9.feats, frame9.depth,
                            -jnp.ones((N,), jnp.int32), jnp.int32(8), sig0)
    return SimpleNamespace(m=m, sig0=sig0, frame9=frame9, T_true=T_true, T_est=T_est,
                           kf9=int(m.n_kf) - 1)


def _close(closer, m, frame, T_est, kf, port):
    """A stand-in engine (map, last frame, tracker on the drifted pose) and
    the closer's record for keyframe ``kf``."""
    if port:
        state = ttr.mark_keyframe(ttr.init_track_state("cpu")._replace(T_cw=T_est),
                                  torch.zeros((), dtype=torch.int32))
    else:
        state = jtr.mark_keyframe(jtr.init_track_state()._replace(T_cw=T_est), jnp.int32(0))
    slam = SimpleNamespace(map=m, last_frame=frame, state=state)
    return slam, closer.on_keyframe(slam, kf)


def test_detect_loop_matches_reference(revisit):
    r = revisit
    ref = jlc.detect_loop(r.m, r.sig0, jnp.int32(r.kf9), 3)
    got = tlc.detect_loop(_port(r.m), _port(r.sig0), r.kf9, 3)
    assert int(got.kf_idx) == int(ref.kf_idx) == 0
    assert float(got.score) > 0.5
    np.testing.assert_allclose(float(got.score), float(ref.score), atol=1e-5)
    # a device-tensor keyframe index retrieves the same
    got_t = tlc.detect_loop(_port(r.m), _port(r.sig0), torch.tensor(r.kf9), 3)
    assert int(got_t.kf_idx) == 0 and float(got_t.score) == float(got.score)


def test_verify_loop_matches_reference(revisit):
    r = revisit
    T_ref, n_ref = jlc.verify_loop(KJ, r.m, r.frame9, jnp.int32(0))
    T_loop, n_inl = tlc.verify_loop(_port(KJ), _port(r.m), _port(r.frame9), 0)
    assert int(n_inl) == int(n_ref) > 50
    np.testing.assert_allclose(T_loop.R.numpy(), np.asarray(T_ref.R), atol=1e-4)
    np.testing.assert_allclose(T_loop.t.numpy(), np.asarray(T_ref.t), atol=1e-4)
    err = float(torch.linalg.norm(tlie.se3_log(tlie.compose(T_loop, tlie.inverse(
        _port(r.T_true))))))
    assert err < 0.02, err
    # the candidate as a device tensor takes the same path
    T2, n2 = tlc.verify_loop(_port(KJ), _port(r.m), _port(r.frame9), torch.tensor(0))
    assert int(n2) == int(n_inl) and torch.equal(T2.t, T_loop.t)


@pytest.mark.parametrize("gba", [True, False])
def test_loop_closer_corrects_drift(revisit, gba):
    r = revisit
    closer_j = jlc.LoopCloser(_loop_cfg(JConfig, run_global_ba=gba), KJ)
    slam_j, info_j = _close(closer_j, r.m, r.frame9, r.T_est, r.kf9, port=False)
    closer = tlc.LoopCloser(_loop_cfg(FitSlamConfig, run_global_ba=gba), _port(KJ))
    slam_t, info_t = _close(closer, _port(r.m), _port(r.frame9), _port(r.T_est), r.kf9,
                            port=True)
    assert info_t is not None and info_t["loop_to"] == info_j["loop_to"] == 0
    assert info_t["inliers"] == info_j["inliers"]
    assert (info_t["gba_chi2"] is None) == (not gba) == (info_j["gba_chi2"] is None)
    T9 = tlie.SE3(slam_t.map.kf_T_cw.R[r.kf9], slam_t.map.kf_T_cw.t[r.kf9])
    err9 = float(torch.linalg.norm(tlie.se3_log(tlie.compose(T9, tlie.inverse(
        _port(r.T_true))))))
    assert err9 < 0.1, err9
    np.testing.assert_allclose(slam_t.state.T_cw.t.numpy(), T9.t.numpy(), atol=1e-6)
    np.testing.assert_allclose(slam_t.map.kf_T_cw.t.numpy(), np.asarray(slam_j.map.kf_T_cw.t),
                               atol=1e-3)
    np.testing.assert_allclose(slam_t.map.kf_T_cw.R.numpy(), np.asarray(slam_j.map.kf_T_cw.R),
                               atol=1e-3)
    np.testing.assert_allclose(float(info_t["pgo_chi2"]), float(info_j["pgo_chi2"]),
                               rtol=1e-3, atol=1e-4)
    # the candidate was retrieved here (one read), then verified (one read)
    assert closer.host_syncs == 2


def test_fuse_loop_landmarks_matches_reference():
    """Keyframe 5 revisits keyframe 0's view and spawns copies of its
    landmarks, moved by up to ~0.5 m: those within 0.25 m and 72 bits are
    merged into keyframe 0's exactly as the reference merges them."""
    kw = jax.random.PRNGKey(2)
    pts_w = jax.random.uniform(kw, (N, 3), minval=-4.0, maxval=4.0) + jnp.array([0, 0, 8.0])
    frame0, desc = _frame_from_landmarks(jax.random.fold_in(kw, 1), pts_w, jlie.SE3.identity())
    m = jsm.empty_map(16, 1024, 4096)
    none = -jnp.ones((N,), jnp.int32)
    sig = signature_from_descriptors(desc, frame0.feats.valid)
    m = jsm.insert_keyframe(m, KJ, jlie.SE3.identity(), frame0.feats, frame0.depth, none,
                            jnp.int32(0), sig)
    for k in range(1, 5):
        T_k = jlie.se3_exp(jnp.array([5.0 * k, 0, 0, 0, 0, 0]))
        fk, dk = _frame_from_landmarks(jax.random.fold_in(kw, 10 + k), pts_w + 100.0, T_k)
        m = jsm.insert_keyframe(m, KJ, T_k, fk.feats, fk.depth, none, jnp.int32(k),
                                signature_from_descriptors(dk, fk.feats.valid))
    m = jsm.insert_keyframe(m, KJ, jlie.SE3.identity(), frame0.feats, frame0.depth, none,
                            jnp.int32(5), sig)
    side_b = np.asarray(m.lm_anchor_kf) == 5
    side_b &= np.asarray(m.lm_valid)
    jitter = np.zeros(m.lm_pos.shape, np.float32)
    jitter[side_b] = np.random.RandomState(4).normal(scale=0.15, size=(int(side_b.sum()), 3))
    m = m._replace(lm_pos=m.lm_pos + jitter)
    ref = jlc.fuse_loop_landmarks(KJ, m, jnp.int32(0), jnp.int32(5))
    got = tlc.fuse_loop_landmarks(_port(KJ), _port(m), 0, 5)
    for f in ("obs_lm", "lm_valid", "lm_nobs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    merged = int(np.asarray(m.lm_valid).sum() - got.lm_valid.sum())
    assert 10 < merged < int(side_b.sum())


def test_match_ratio_fused_matches_reference_on_ties():
    """K2's ungated call with the ratio and mutual tests (the CPU runs its
    plain twin) against the reference's match_ratio(mutual=True) on planted
    ties: rows with two equal best columns, columns with two equal best rows,
    and a sparse landmark mask."""
    rng = np.random.RandomState(9)
    na, nb = 200, 700
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    for i in range(80):                      # planted matches with 0-12 flipped bits
        flip = rng.rand(256) < rng.uniform(0.0, 0.05)
        b[3 * i] = np.where(flip, -a[i], a[i])
    b[400] = b[401] = a[100]                 # a row tie
    a[150] = a[151] = b[3 * 5]               # a column tie
    va = rng.rand(na) < 0.95
    vb = rng.rand(nb) < 0.6
    vb[[15, 400, 401]] = True
    for ratio in (0.85, 0.8):
        dist = jmatching.hamming_matrix(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                                        jnp.asarray(va), jnp.asarray(vb))
        ref = jmatching.match_ratio(dist, max_distance=64, ratio=ratio, mutual=True)
        pack = lambda x: torb.pack_descriptors(torch.tensor(x).to(torch.bfloat16))
        got = tpm.match_ratio_fused(pack(a), torch.tensor(va), pack(b), torch.tensor(vb),
                                    max_distance=64, ratio=ratio, mutual=True)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        ok = np.asarray(ref.valid)
        np.testing.assert_array_equal(got.idx_b.numpy()[ok], np.asarray(ref.idx_b)[ok])
        np.testing.assert_array_equal(got.distance.numpy(), np.asarray(ref.distance))
        assert ok.sum() > 40


# ---------------------------------------------------------------------------
# tests/test_scale_correction.py's arc
# ---------------------------------------------------------------------------

KA = _K(400.0, 400.0, 320.0, 240.0, 0.2)


def _arc_problem(n_kf=10, n_lm=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (n_lm, 3)) + [0, 0, 9.0]
    R_all, t_all = [], []
    for k in range(n_kf):
        c = np.array([0.4 * k, 0.05 * k, 0.2 * np.sin(0.3 * k)])
        R_all.append(np.eye(3))
        t_all.append(-c)
    okf, olm, uvr = [], [], []
    for k in range(n_kf):
        for l in range(n_lm):
            pc = R_all[k] @ pts[l] + t_all[k]
            if pc[2] < 1.0:
                continue
            u = 400 * pc[0] / pc[2] + 320
            v = 400 * pc[1] / pc[2] + 240
            if not (0 <= u < 640 and 0 <= v < 480):
                continue
            okf.append(k)
            olm.append(l)
            uvr.append([u, v, u - 400 * 0.2 / pc[2]])
    O = len(okf)
    T = jlie.SE3(jnp.asarray(np.stack(R_all), jnp.float32), jnp.asarray(np.stack(t_all), jnp.float32))
    obs = jba.Observations(kf=jnp.asarray(okf, jnp.int32), lm=jnp.asarray(olm, jnp.int32),
                           uvr=jnp.asarray(np.asarray(uvr, np.float32)),
                           sigma2=jnp.ones((O,)), valid=jnp.ones((O,), bool))
    return T, jnp.asarray(pts, jnp.float32), obs


def _arc_map(shrink):
    T, pts, obs = _arc_problem()
    R, t = np.asarray(T.R), np.asarray(T.t)
    c = -np.einsum("kij,ki->kj", R.transpose(0, 2, 1), t)
    c_s = c[0] + shrink * (c - c[0])
    t_s = -np.einsum("kij,kj->ki", R, c_s).astype(np.float32)
    pts_s = (c[0] + shrink * (np.asarray(pts) - c[0])).astype(np.float32)
    K_cap = 16
    m = jsm.empty_map(K_cap, 512, obs.kf.shape[0], signature_dim=8)
    m = m._replace(
        kf_T_cw=jlie.SE3(jnp.tile(jnp.eye(3)[None], (K_cap, 1, 1)).at[:10].set(R),
                         jnp.zeros((K_cap, 3)).at[:10].set(t_s)),
        kf_valid=jnp.arange(K_cap) < 10, n_kf=jnp.int32(10),
        lm_pos=jnp.zeros_like(m.lm_pos).at[:pts.shape[0]].set(pts_s),
        lm_valid=jnp.arange(m.lm_valid.shape[0]) < pts.shape[0],
        obs_kf=obs.kf, obs_lm=obs.lm, obs_uvr=obs.uvr, obs_sigma2=obs.sigma2,
        obs_valid=obs.valid)
    return m


def test_retriangulate_recovers_points():
    T, pts, obs = _arc_problem()
    bad = np.asarray(pts) + np.random.RandomState(1).normal(scale=0.4, size=pts.shape).astype(
        np.float32)
    valid = np.ones(pts.shape[0], bool)
    ref = np.asarray(jba.retriangulate_points(KA, T, jnp.asarray(bad), obs, jnp.asarray(valid)))
    out = tba.retriangulate_points(_port(KA), _port(T), torch.tensor(bad), _port(obs),
                                   torch.tensor(valid)).numpy()
    err = np.linalg.norm(out - np.asarray(pts), axis=1)
    observed = np.zeros(pts.shape[0], bool)
    observed[np.asarray(obs.lm)] = True
    assert float(np.median(err[observed])) < 5e-4
    assert float(err[observed].max()) < 1e-2
    assert float(err[~observed].min()) > 1e-2           # the fallback is kept
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the stereo rows' weight is honoured alike
    ref3 = jba.retriangulate_points(KA, T, jnp.asarray(bad), obs, jnp.asarray(valid),
                                    stereo_weight=3.0)
    out3 = tba.retriangulate_points(_port(KA), _port(T), torch.tensor(bad), _port(obs),
                                    torch.tensor(valid), stereo_weight=3.0)
    np.testing.assert_allclose(out3.numpy(), np.asarray(ref3), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shrink", [0.985, 1.0])
def test_scale_search_matches_reference(shrink):
    """The shrunk map recovers s ~ 1/0.985 and halves chi2; the true map
    keeps s = 1; the gauge keyframe's pose is preserved; the winner and the
    chi2 curve equal the reference's."""
    m = _arc_map(shrink)
    scales = np.linspace(0.97, 1.03, 13).astype(np.float32)
    m_ref, s_ref, chis_ref = jlc.scale_search(KA, m, jnp.asarray(scales))
    mt = _port(m)
    m2, s_best, chis = tlc.scale_search(_port(KA), mt, torch.tensor(scales))
    assert float(s_best) == float(s_ref)
    np.testing.assert_allclose(chis.numpy(), np.asarray(chis_ref), rtol=1e-4, atol=1e-3)
    if shrink == 1.0:
        assert abs(float(s_best) - 1.0) < 1e-6
    else:
        assert abs(float(s_best) - 1.0 / shrink) < 0.006
        obs = tba.Observations(mt.obs_kf, mt.obs_lm, mt.obs_uvr, mt.obs_sigma2, mt.obs_valid)
        chi_before = float(tba.chi2_residuals(_port(KA), mt.kf_T_cw, mt.lm_pos, obs))
        assert float(chis.min()) < 0.5 * chi_before
    np.testing.assert_allclose(m2.kf_T_cw.t[0].numpy(), mt.kf_T_cw.t[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(m2.kf_T_cw.t.numpy(), np.asarray(m_ref.kf_T_cw.t), atol=1e-5)
    np.testing.assert_allclose(m2.lm_pos.numpy(), np.asarray(m_ref.lm_pos), rtol=1e-4, atol=1e-4)


def test_refine_map_improves_chi2_and_rebases_tracker():
    """StereoSlam.refine_map lowers the map's robust chi2 and keeps the
    tracker on the refined last keyframe, as the reference's does on the same
    frames (rendered by the reference from its corridor world)."""
    from fitslam_tpu.data import synthetic as jsyn
    from fitslam_tpu.models.slam import StereoSlam as JSlam
    from fitslam_tpu_torch.models.slam import StereoSlam

    W, H = 160, 120
    results = []
    world = jsyn.corridor_world(jax.random.PRNGKey(0), num=1500, length=18.0, width=5.0)
    T = jsyn.straight_trajectory(10, length=1.2, height=1.2, start_x=0.5)
    for cfg_cls, slam_cls, conv in ((JConfig, JSlam, lambda x: x),
                                    (FitSlamConfig, StereoSlam, lambda x: torch.tensor(
                                        np.asarray(x)))):
        cfg = cfg_cls()
        R = dataclasses.replace
        cfg = R(cfg,
                camera=R(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2,
                         cy=H / 2, baseline=0.2),
                orb=R(cfg.orb, num_features=192, num_levels=2, fast_threshold=12.0),
                tracking=R(cfg.tracking, min_inliers=8, keyframe_min_interval=1,
                           keyframe_translation=0.2),
                mapping=R(cfg.mapping, max_keyframes=32, max_landmarks=2048,
                          max_observations=4096, local_window=3, ba_iters=2),
                loop=R(cfg.loop, enabled=False))
        slam = slam_cls(cfg) if slam_cls is JSlam else slam_cls(cfg, "cpu")
        Kj = JIntrinsics.from_config(cfg.camera)
        for i in range(10):
            l, r = jsyn.render_stereo(Kj, world, jlie.SE3(T.R[i], T.t[i]), width=W, height=H)
            slam.process_frame_async(conv(l), conv(r))
        slam.finalize()
        m = slam.map
        ba_mod = jba if slam_cls is JSlam else tba
        obs = ba_mod.Observations(kf=m.obs_kf, lm=m.obs_lm, uvr=m.obs_uvr, sigma2=m.obs_sigma2,
                                  valid=m.obs_valid)
        K = slam.K
        chi_before = float(ba_mod.chi2_residuals(K, m.kf_T_cw, m.lm_pos, obs))
        chi2 = slam.refine_map(cycles=2, gba_iters=5)
        chi_after = float(ba_mod.chi2_residuals(K, slam.map.kf_T_cw, slam.map.lm_pos, obs))
        assert chi2 is not None and np.isfinite(float(chi2))
        assert chi_after <= chi_before * 1.001, (chi_before, chi_after)
        j = int(slam.map.n_kf) - 1
        d = np.asarray(slam.state.T_cw.t) - np.asarray(slam.map.kf_T_cw.t[j])
        assert np.linalg.norm(d) < 1.0
        results.append((int(slam.map.n_kf), np.asarray(slam.map.kf_T_cw.t)[:j + 1], chi_after))
    (nj, tj, cj), (nt, tt, ct) = results
    assert nt == nj
    np.testing.assert_allclose(tt, tj, atol=1e-3)
    np.testing.assert_allclose(ct, cj, rtol=1e-2)
