"""The port's whole slice on the CPU: the committed corridor_seq golden replay
through ``StereoSlam``, the asynchronous path and its event polling, the
package's independence from jax, and the committed bench world.

Bounds: the golden replay is held to the reference's own golden bounds (ATE
<= 0.025 m, 10-30 keyframes; tests/test_dataset_golden.py). The async path
runs the same arithmetic as the sync path, so their poses are equal.
"""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.ops import geometry as jgeo
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.data.tum import read_pgm
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import evaluation as ev
from fitslam_tpu_torch.utils import interop
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SEQ = ROOT / "tests" / "data" / "corridor_seq"
ATE_BOUND_M = 0.025
KF_RANGE = (10, 30)


def _config(**tracking):
    W, H = 320, 240
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=200.0, fy=200.0,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=512, num_levels=2, fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                                     keyframe_translation=0.3,
                                     **{"reloc_enabled": False, **tracking}),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                                    max_observations=12288, local_window=4, ba_iters=3),
        loop=dataclasses.replace(cfg.loop, enabled=False),
    )


def _frames():
    lefts = sorted((SEQ / "left").glob("*.pgm"))
    rights = sorted((SEQ / "right").glob("*.pgm"))
    assert len(lefts) == len(rights) == 40
    return [(torch.tensor(read_pgm(l).astype(np.float32)), torch.tensor(read_pgm(r).astype(np.float32)))
            for l, r in zip(lefts, rights)]


@pytest.fixture(scope="module")
def golden():
    frames = _frames()
    slam = StereoSlam(_config(), "cpu")
    infos = [slam.process_frame(l, r) for l, r in frames]
    return frames, slam, infos


def test_golden_replay_ate(golden):
    _, slam, infos = golden
    gt = list(np.load(SEQ / "gt_poses.npy"))
    ate = ev.ate_rmse(slam.trajectory, gt)
    n_kf = int(slam.map.n_kf)
    assert ate <= ATE_BOUND_M, ate
    assert KF_RANGE[0] <= n_kf <= KF_RANGE[1], n_kf
    assert sum(i["keyframe"] for i in infos) == n_kf
    # one read of can_insert per frame, one of the recycle test per keyframe,
    # one packed pull of the frame's results per frame
    assert slam.host_syncs == 2 * len(infos) + n_kf
    assert slam.log.stats["frontend"].count == slam.log.stats["backend_step"].count == len(infos)


def test_async_path_matches_sync_and_polls_events(golden):
    frames, sync_slam, infos = golden
    n = 12
    slam = StereoSlam(_config(), "cpu")
    seen = []
    slam.keyframe_events.append(lambda s, kf: seen.append((s.last_keyframe_frame_id, kf)))
    events = []
    for i, (l, r) in enumerate(frames[:n]):
        slam.process_frame_async(l, r)
        if i % 3 == 2:
            events += slam.poll_keyframe_events(flush=False)   # delivered one poll late
    stats = slam.finalize()
    kf_frames = [i for i, info in enumerate(infos[:n]) if info["keyframe"]]
    assert [e["frame_id"] for e in events] + [f for f, _ in seen[len(events):]] == kf_frames
    assert [f for f, _ in seen] == kf_frames
    assert stats["keyframes"] == list(range(len(kf_frames)))
    for a, b in zip(slam.trajectory, sync_slam.trajectory[:n]):
        np.testing.assert_array_equal(a, b)


def test_interleaved_sync_frames_keep_event_frame_ids(golden):
    frames, _, infos = golden
    slam = StereoSlam(_config(), "cpu")
    slam.keyframe_events.append(lambda s, kf: None)
    slam.process_frame_async(*frames[0])
    slam.process_frame(*frames[1])                 # advances frame_id, not outs_log
    slam.process_frame_async(*frames[2])
    events = slam.poll_keyframe_events()
    assert [e["frame_id"] for e in events] == [0, 2]
    assert [e["kf_idx"] for e in events] == [0, 1]


@pytest.mark.parametrize("flag", ["loop", "reloc"])
def test_loop_closing_and_relocalization_construct(flag):
    """With loop closing or relocalization on, and with the default config
    (both on), the engine constructs on the CPU."""
    cfg = _config(reloc_enabled=(flag == "reloc"))
    if flag == "loop":
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=True))
    slam = StereoSlam(cfg, "cpu")
    assert (slam.loop_closer is not None) == (flag == "loop")
    assert slam.cfg.tracking.reloc_enabled == (flag == "reloc")
    default = StereoSlam(FitSlamConfig(), "cpu")
    assert default.loop_closer is not None and default.cfg.tracking.reloc_enabled


def test_tf32_is_disabled_by_the_engine():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    StereoSlam(_config(), "cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    """The whole port and chip_smoke.py load neither jax nor the reference,
    and no string in the port's code (docstrings aside) names a path under
    the reference package's folder, so the port reads none of its files."""
    naming = []
    for path in sorted((ROOT / "fitslam_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)}
        naming += [f"{path.name}:{node.lineno}" for node in ast.walk(tree)
                   if isinstance(node, ast.Constant) and isinstance(node.value, str)
                   and id(node) not in docs
                   and re.search(r"(^|[/\\])fitslam_tpu([/\\]|$)", node.value)]
    assert not naming, naming
    code = (
        "import importlib, pkgutil, sys\n"
        "import fitslam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fitslam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fitslam_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('fitslam_tpu_torch.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_fails_without_cuda():
    """No CPU path: without a card the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_bench_world_file_regenerates():
    """tests/data/bench_corridor_world.npz is bench.py's corridor world."""
    world = jsyn.corridor_world(jax.random.PRNGKey(42), num=3000, length=40.0, width=5.0)
    committed = np.load(ROOT / "tests" / "data" / "bench_corridor_world.npz")["landmarks"]
    np.testing.assert_array_equal(committed, np.asarray(world.landmarks))
    np.testing.assert_array_equal(tsyn.load_world(device="cpu").numpy(), committed)


def test_render_stereo_and_trajectory_match_reference():
    """The renderer the card uses for bench frames; scatter-add sums in
    another order, so pixels agree to 1e-3 grey levels."""
    cam = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.2)
    Kj = jgeo.Intrinsics(*(np.float32(v) for v in cam.values()))
    Kt = Intrinsics(*(torch.tensor(v, dtype=torch.float32) for v in cam.values()))
    world = np.load(ROOT / "tests" / "data" / "bench_corridor_world.npz")["landmarks"]
    Tj = jsyn.straight_trajectory(8, length=1.2, height=1.2, start_x=0.5)
    Tt = tsyn.straight_trajectory(8, length=1.2, height=1.2, start_x=0.5, device="cpu")
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-5)
    np.testing.assert_array_equal(Tt.R.numpy(), np.asarray(Tj.R))
    lj, rj = jsyn.render_stereo(Kj, jsyn.World(world), jlie.SE3(Tj.R[5], Tj.t[5]), width=320, height=240)
    lt, rt = tsyn.render_stereo(Kt, torch.tensor(world), tlie.SE3(Tt.R[5], Tt.t[5]), width=320, height=240)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    assert float(lt.max()) > 100.0


def test_interop_round_trip(golden):
    _, slam, _ = golden
    back = interop.to_torch(interop.to_numpy(slam.map))
    for a, b in zip(jax.tree.leaves(interop.to_numpy(back)), jax.tree.leaves(interop.to_numpy(slam.map))):
        np.testing.assert_array_equal(a, b)
