"""The frame step as captured programs (``fitslam_tpu_torch/utils/jit.py``,
``StereoSlam``'s regions in ``models/slam_step.py``) on the CPU, where every
region runs eagerly through the same static input, state and output buffers
a CUDA graph replays from; and on the card, captured against eager.

- Capture safety: each region's operations, output shapes and types, as a
  ``TorchDispatchMode`` records them, are the same on two frames of
  different content, with no host read and no operation whose output shape
  depends on the data.
- Through the buffers, the engine's trajectory, map and per-frame outputs
  equal the eager engine's bit for bit, and stay within the frame step's
  short-run parity tolerance of the reference's (1e-3 m and 1e-3 on the
  rotation, as in tests/test_torch_multirobot_slam_parity.py).
- Writers outside the regions (a loop correction, ``checkpoint.load_slam``)
  reach the buffers the next step reads: the next frame's outputs equal the
  eager engine's bit for bit.
- The kernel wrappers' launch counters change at capture only; that change
  is added again at each replay.

The reference is imported inside the tests that compare with it, so that
the ``gpu`` test runs on a machine with the card and without JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_jit.py
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fitslam_tpu_torch.data.tum import read_pgm
from fitslam_tpu_torch.models import tracking as ttr
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import ekf_window, orb, pallas_matching
from fitslam_tpu_torch.utils import checkpoint, interop, jit
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SEQ = Path(__file__).resolve().parent / "data" / "corridor_seq"
PARITY_TOL = 1e-3
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique")


def _config(cls=FitSlamConfig, **mapping):
    """tests/test_torch_slam_e2e.py's golden configuration."""
    W, H = 320, 240
    cfg = cls()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                      baseline=0.2),
             orb=R(cfg.orb, num_features=512, num_levels=2, fast_threshold=12.0),
             tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.3, reloc_enabled=False),
             mapping=R(cfg.mapping, **{"max_keyframes": 64, "max_landmarks": 4096,
                                       "max_observations": 12288, "local_window": 4,
                                       "ba_iters": 3, **mapping}),
             loop=R(cfg.loop, enabled=False))


@pytest.fixture(scope="module")
def frames():
    lefts = sorted((SEQ / "left").glob("*.pgm"))[:12]
    rights = sorted((SEQ / "right").glob("*.pgm"))[:12]
    return [(torch.tensor(read_pgm(l).astype(np.float32)),
             torch.tensor(read_pgm(r).astype(np.float32))) for l, r in zip(lefts, rights)]


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# (a) capture safety
# ---------------------------------------------------------------------------


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket._qualified_op_name).replace("::", ".")
        bool_index = func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put,
                                             torch.ops.aten.index_put_) and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()))
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        self.ops.append((name, bool_index, tuple((tuple(o.shape), o.dtype) for o in outs)))
        return out


def _recorded_regions(monkeypatch, runs):
    """{region: [op sequence of each call]} while ``runs()`` drives engines."""
    calls = {}
    real = jit._run_region

    def recording(fn, args):
        name = next(n for s in jit.slots() for n, r in s.regions.items() if r.fn is fn)
        with _Recorder() as rec:
            result = real(fn, args)
        calls.setdefault(name, []).append(rec.ops)
        return result

    monkeypatch.setattr(jit, "_run_region", recording)
    runs()
    return calls


def test_regions_are_capture_safe(frames, monkeypatch):
    """Every region, on two frames of different content, runs the same
    operations with the same output shapes and types, none of them a host
    read or a data-dependent shape. A small landmark table makes the
    recycle region (compaction) run too."""
    cfg = _config(max_landmarks=768, max_observations=4096)

    def runs():
        a = StereoSlam(cfg, "cpu")
        for l, r in frames[:9]:
            a.process_frame_async(l, r)
        b = StereoSlam(cfg, "cpu")                   # a second uninitialized frame
        b.process_frame_async(*frames[5])
        a.finalize(), b.finalize()

    calls = _recorded_regions(monkeypatch, runs)
    assert set(calls) == {"frontend_stereo", "track_uninitialized", "track", "keyframe",
                          "compact", "finish", "finish_keyframe"}, set(calls)
    for name, seqs in calls.items():
        # the last two calls: a region's first call (the warm-up on the card)
        # also fills the lazily built constant tables
        assert len(seqs) >= 2, (name, len(seqs))
        assert seqs[-2] == seqs[-1], f"region {name}: operations differ between two frames"
        bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
        assert not bad, f"region {name} holds {sorted(bad)}"


# ---------------------------------------------------------------------------
# (b) the buffers give the eager results
# ---------------------------------------------------------------------------


def _run_async(cfg, frames, capture):
    slam = StereoSlam(cfg, "cpu", capture=capture)
    for l, r in frames:
        slam.process_frame_async(l, r)
    log = [o for o in slam.outs_log]
    slam.finalize()
    return slam, log


def test_buffered_step_equals_eager_and_reference(frames):
    cfg = _config()
    got, log = _run_async(cfg, frames, capture=True)
    want, want_log = _run_async(cfg, frames, capture=False)
    assert got.capture_stats["track"]["calls"] == len(frames) - 1
    assert len(got.trajectory) == len(want.trajectory) == len(frames)
    for a, b in zip(got.trajectory, want.trajectory):
        np.testing.assert_array_equal(a, b)
    assert _equal_trees(got.map, want.map) and _equal_trees(got.state, want.state)
    assert all(_equal_trees(a, b) for a, b in zip(log, want_log))
    # every entry is a copy of its own: no storage shared between entries
    # or with the regions' buffers
    storages = [{x.untyped_storage().data_ptr() for x in _leaves(o)} for o in log]
    assert all(len(s) == 1 for s in storages)
    assert len(set.union(*storages)) == len(log)
    assert not any(got._slot_state.slot.owns(x) for o in log for x in _leaves(o))

    # the synchronous path through the buffers: the same poses and reads
    sync = StereoSlam(cfg, "cpu")
    infos = [sync.process_frame(l, r) for l, r in frames[:6]]
    for info, T in zip(infos, want.trajectory):
        np.testing.assert_array_equal(info["pose_wc"], T)
    assert sync.host_syncs == 2 * len(infos) + sum(i["keyframe"] for i in infos)

    # the reference's engine on the same frames
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fitslam_tpu.models.slam import StereoSlam as JSlam
    from fitslam_tpu.utils.config import FitSlamConfig as JConfig

    ref = JSlam(_config(JConfig))
    for l, r in frames:
        ref.process_frame_async(jnp.asarray(l.numpy()), jnp.asarray(r.numpy()))
    ref.finalize()
    for a, b in zip(got.trajectory, ref.trajectory):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], rtol=0, atol=PARITY_TOL)
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], rtol=0, atol=PARITY_TOL)


def test_fresh_engine_reuses_the_slot_and_live_engines_do_not_share(frames):
    cfg = _config()
    jit.release_idle()                               # earlier tests' engines are gone
    a = StereoSlam(cfg, "cpu")
    a.process_frame_async(*frames[0])
    slot = a._slot_state.slot
    b = StereoSlam(cfg, "cpu")                       # a is alive: its own slot
    b.process_frame_async(*frames[3])
    assert b._slot_state.slot is not slot
    a.process_frame_async(*frames[1])
    assert not _equal_trees(a.map, b.map)
    del a
    c = StereoSlam(cfg, "cpu")                       # a's slot, with c's fresh state
    fresh = StereoSlam(cfg, "cpu", capture=False)
    got, want = c.process_frame_async(*frames[2]), fresh.process_frame_async(*frames[2])
    assert c._slot_state.slot is slot
    assert _equal_trees(got, want)
    assert _equal_trees(c.map, fresh.map) and _equal_trees(c.state, fresh.state)


# ---------------------------------------------------------------------------
# (c) writers outside the regions reach the next step
# ---------------------------------------------------------------------------


def _revisit():
    """tests/test_torch_loop_closing.py's drifted revisit (the reference's
    tests/test_loop_closing.py): keyframe 0 at the origin, seven far-away
    keyframes, keyframe 8 revisiting keyframe 0's view from a drifted pose."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from fitslam_tpu.models import slam_map as jsm
    from fitslam_tpu.models import tracking as jtr
    from fitslam_tpu.ops import lie as jlie
    from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
    from fitslam_tpu.ops.geometry import project_stereo
    from fitslam_tpu.ops.orb import FrameFeatures as JFeatures
    from fitslam_tpu.ops.place import signature_from_descriptors as jsignature

    n = 128
    K = JIntrinsics(*(jnp.float32(v) for v in (200.0, 200.0, 160.0, 120.0, 0.2)))

    def frame_from(key, pts_w, T_cw):
        p_c = (T_cw.R @ pts_w[..., None])[..., 0] + T_cw.t
        uvr, ok = project_stereo(K, p_c)
        desc = jnp.where(jax.random.bernoulli(key, 0.5, (n, 256)), 1.0,
                         -1.0).astype(jnp.bfloat16)
        feats = JFeatures(xy=uvr[:, :2], response=jnp.ones((n,)), angle=jnp.zeros((n,)),
                          level=jnp.zeros((n,), jnp.int32), desc=desc,
                          valid=ok & (p_c[..., 2] > 0.5))
        return jtr.StereoFrame(feats, p_c[..., 2] * feats.valid), desc

    kw = jax.random.PRNGKey(0)
    pts_w = jax.random.uniform(kw, (n, 3), minval=-4.0, maxval=4.0) + jnp.array([0, 0, 8.0])
    frame0, desc = frame_from(jax.random.fold_in(kw, 1), pts_w, jlie.SE3.identity())
    m = jsm.empty_map(16, 512, 2048)
    sig0 = jsignature(desc, frame0.feats.valid)
    m = jsm.insert_keyframe(m, K, jlie.SE3.identity(), frame0.feats, frame0.depth,
                            -jnp.ones((n,), jnp.int32), jnp.int32(0), sig0)
    for k in range(1, 8):
        fk, dk = frame_from(jax.random.fold_in(kw, 10 + k), pts_w + 100.0,
                            jlie.se3_exp(jnp.array([5.0 * k, 0, 0, 0, 0, 0])))
        m = jsm.insert_keyframe(m, K, jlie.se3_exp(jnp.array([5.0 * k, 0, 0, 0, 0, 0])),
                                fk.feats, fk.depth, -jnp.ones((n,), jnp.int32), jnp.int32(k),
                                jsignature(dk, fk.feats.valid))
    T_est = jlie.se3_exp(jnp.array([0.5, 0.2, 0.0, 0.0, 0.0, 0.05]))
    m = jsm.insert_keyframe(m, K, T_est, frame0.feats, frame0.depth,
                            -jnp.ones((n,), jnp.int32), jnp.int32(8), sig0)
    port = lambda tree: interop.to_torch(jax.tree.map(np.asarray, tree))  # noqa: E731
    return port(m), port(frame0), port(T_est), int(m.n_kf) - 1


def _revisit_engine(capture, m, frame, T_est):
    cfg = FitSlamConfig()
    R = dataclasses.replace
    cfg = R(cfg,
            camera=R(cfg.camera, width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                     baseline=0.2),
            mapping=R(cfg.mapping, max_keyframes=16, max_landmarks=512, max_observations=2048),
            loop=R(cfg.loop, min_gap_keyframes=3, min_score=0.1, min_matches=20,
                   consistency_threshold=1))
    slam = StereoSlam(cfg, "cpu", capture=capture)
    slam.map = m
    slam.state = ttr.mark_keyframe(ttr.init_track_state("cpu")._replace(T_cw=T_est),
                                   torch.zeros((), dtype=torch.int32))
    slam._track_initialized = slam._initialized = True
    slam.last_frame = frame
    return slam


def test_loop_correction_reaches_the_next_step():
    m, frame, T_est, kf = _revisit()
    outs = []
    for capture in (True, False):
        slam = _revisit_engine(capture, m, frame, T_est)
        before = slam.map.kf_T_cw.t.clone()
        info = slam.loop_closer.on_keyframe(slam, kf, cand_idx=0, score=1.0)
        assert info is not None and info["loop_to"] == 0
        assert not torch.equal(slam.map.kf_T_cw.t, before)      # the correction moved poses
        step = slam._step(frame)
        outs.append((slam.map, slam.state, step))
    (m_got, st_got, step_got), (m_want, st_want, step_want) = outs
    assert _equal_trees(m_got, m_want) and _equal_trees(st_got, st_want)
    assert _equal_trees(step_got, step_want)


def test_load_slam_reaches_the_next_step(frames, tmp_path):
    cfg = _config()
    src = StereoSlam(cfg, "cpu", capture=False)
    for l, r in frames[:6]:
        src.process_frame(l, r)
    path = str(tmp_path / "slam.npz")
    checkpoint.save_slam(path, src)
    infos = []
    for capture in (True, False):
        slam = StereoSlam(cfg, "cpu", capture=capture)
        slam.process_frame(*frames[0])                # buffers and regions in use first
        checkpoint.load_slam(path, slam)
        assert _equal_trees(slam.map, src.map) and _equal_trees(slam.state, src.state)
        infos.append([slam.process_frame(l, r) for l, r in frames[6:8]])
    for a, b in zip(*infos):
        np.testing.assert_array_equal(a["pose_wc"], b["pose_wc"])
        assert (a["n_inliers"], a["keyframe"]) == (b["n_inliers"], b["keyframe"])


# ---------------------------------------------------------------------------
# (d) launch counters
# ---------------------------------------------------------------------------


def test_replays_count_the_captured_launches(monkeypatch):
    """The counter change seen while a region is captured is undone, then
    added at every replay, so the counts read as the eager path's."""
    monkeypatch.setattr(orb.describe_keypoints, "launches", 5)
    monkeypatch.setattr(pallas_matching.hamming_top2, "launches", 7)
    slot = jit.Slot("cpu", {})
    step = jit.CapturedStep(lambda: ((), ()), "fake", slot)
    with jit.record_launches() as rec:             # what a capture's Python does
        orb.describe_keypoints.launches += 2
        pallas_matching.hamming_top2.launches += 3
    assert (orb.describe_keypoints.launches, pallas_matching.hamming_top2.launches) == (5, 7)
    assert rec.delta[:2] == (2, 3) and not any(rec.delta[2:])
    replays = []
    step.graph = SimpleNamespace(replay=lambda: replays.append(1))
    step.launch_delta = rec.delta
    for _ in range(4):
        step.replay()
    assert len(replays) == step.calls == 4
    assert (orb.describe_keypoints.launches, pallas_matching.hamming_top2.launches) == (13, 19)


def test_replays_count_the_ekf_window_launches(monkeypatch):
    """A DualEkf region's graph holds one EKF window kernel: the launch seen
    while it is captured is undone, then each replay counts one, so
    ``ekf_window.launches`` reads one a window fused, eager or replayed."""
    monkeypatch.setattr(ekf_window.ekf_window, "launches", 11)
    slot = jit.Slot("cpu", {})
    step = jit.CapturedStep(lambda: ((), ()), "ekf_map", slot)
    with jit.record_launches() as rec:
        ekf_window.ekf_window.launches += 1
    assert ekf_window.ekf_window.launches == 11 and sum(rec.delta) == 1
    step.graph = SimpleNamespace(replay=lambda: None)
    step.launch_delta = rec.delta
    for _ in range(3):
        step.replay()
    assert ekf_window.ekf_window.launches == 14


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_captured_equals_eager_on_the_card(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = _config()
    runs = []
    for capture in (False, True):
        slam = StereoSlam(cfg, dev, capture=capture)
        launches0 = orb.describe_keypoints.launches
        for l, r in frames[:8]:
            slam.process_frame_async(l.to(dev), r.to(dev))
        torch.cuda.synchronize()
        runs.append((slam, orb.describe_keypoints.launches - launches0))
        slam.finalize()
    (eager, n_eager), (captured, n_captured) = runs
    assert captured.capture_stats["track"]["captured"]
    assert n_eager == n_captured == 16
    for a, b in zip(eager.trajectory, captured.trajectory):
        np.testing.assert_array_equal(a, b)
    assert _equal_trees(eager.map, captured.map)
