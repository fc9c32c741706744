"""The last of the port's sharded paths as captured programs
(``utils/jit.py``) on the CPU, where every region runs eagerly through the
same static input, state and output buffers a CUDA graph replays from, over
two gloo ranks (one launch serves every case):

- the stage pipeline (``parallel/dist_stages.stage_pipelined_slam``): rank
  0's ``frontend_stereo`` (its output the packed handoff), rank 1's backend
  regions (``track``, ``keyframe``, ``compact``, ``finish``, ...) on the
  received frame, the map and tracker state in the slot's buffers;
- sharded fusion (``fuse_shard`` -> sum, max, min -> ``fuse_grid``) and the
  sharded raycast (``arrival_shard`` -> all-gather);
- a mesh correction (``loop_correct+fuse+gba_dist+retri``, then
  ``slam_map.global_ba_dist``, then ``loop_rebase``) and a mesh
  ``refine_map`` (``refine_retri/1.0``, then ``global_ba_dist``, a cycle) on
  a ``StereoSlam`` engine whose loop closer has a 2-rank mesh, with
  ``loop_closing.EAGER_CALLS`` and ``slam.REFINE_EAGER_CYCLES`` set to 1.

Cases:

- (a) the pipeline at ``tests/test_stage_pipeline.py``'s case (320x240, 256
  features, 2 levels, 6 frames of the corridor world of seed 0 after a
  bootstrap keyframe), captured twice on one slot, bit-equal to
  ``capture=False`` in poses, keyframe flags, inliers, the final map and the
  tracker state; beside the reference's pipeline on a 2-device ``stage`` mesh
  within ``tests/test_torch_parallel_pipeline.py``'s tolerances (poses and
  the state within 1e-4; keyframes, their count and inliers exactly);
- (b) fusion of three seeded clouds of one shape (4096 points on a 64 x 64
  grid at 0.25 m) and the raycast of three seeded frontier sets (32 on a 64
  x 64 occupancy), each 3 calls in its slot's ``stats()``, bit-equal to
  ``capture=False``, and to one rank as ``test_torch_parallel_fusion.py``
  (counts, z extrema exact; elevation and slope 1e-5, roughness 1e-3, cost
  within 1) and ``test_torch_parallel_stages.py`` (exact) hold them;
- (c) the engine closes the drifted revisit (``tests/test_loop_closing.py``'s
  scene, built by ``tests/test_torch_jit_control.py``; GBA with
  re-triangulation) and refines two cycles of 4 GBA iterations through
  buffers, bit-equal to a ``capture=False`` engine; beside the reference
  within ``tests/test_torch_parallel_loop.py``'s tolerances: the closer's
  inliers exactly, its poses within 1e-3 and GBA chi2 within 1e-3 relative
  or absolute; refine_map from the same corrected map within the closer's
  1e-3 in poses and points, its chi2 within 1e-3 relative or 1e-5 absolute
  (that file's refine bounds). That file holds a refine to 1e-4 on a map
  whose chi2 is above round-off; on this exact revisit the GBA has converged
  to float32 round-off (chi2 ~1.4e-6), so the refine's steps follow the
  round-off of two summation orders (3.9e-4 m apart on the CPU);
- (d) capture safety: each new region, as ``tests/test_torch_jit_sim.py``'s
  recorder sees it, runs the same operations on every call, with no host
  read, no data-dependent shape and no upload after its first call.

The spawned ranks import this module: no JAX at its top level.

    python -m pytest tests/test_torch_jit_parallel.py -q
"""

import gc

import numpy as np
import pytest
import torch

from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import raycast as traycast
from fitslam_tpu_torch.parallel import mesh as mesh_mod
from fitslam_tpu_torch.utils import jit
from test_torch_parallel_mesh import in_background, launch

torch.set_num_threads(2)

SPEC = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
N_PTS, N_FR = 4096, 32
CALLS = 3                        # sharded fusion and raycast calls of one shape
REFINE_KW = dict(cycles=2, gba_iters=4)
DRIFTS = ((0.5, 0.2, 0.0, 0.0, 0.0, 0.05), (0.4, 0.1, 0.05, 0.0, 0.02, 0.0))
REGIONS = ("frontend_stereo", "fuse_shard", "fuse_grid", "arrival_shard",
           "loop_correct+fuse+gba_dist+retri", "loop_rebase", "refine_retri/1.0")
PIPE_TOL = 1e-4                  # tests/test_torch_parallel_pipeline.py
# tests/test_stage_pipeline.py's case (W, H, NF, NL, T_FRAMES, BACKEND_KW), which
# the fixture holds these to: the card test imports no JAX
W, H, NF, NL, T_FRAMES = 320, 240, 256, 2, 6
ORB_KW = dict(num_features=NF, num_levels=NL, scale_factor=1.4142135, fast_threshold=12.0)
BACKEND_KW = dict(
    search_radius=24.0, match_max_hamming=64, min_inliers=10,
    width=W, height=H, pose_iters=4, kf_min_interval=2,
    kf_translation=0.3, kf_rotation=0.2, kf_min_tracked_ratio=0.25,
    scale_factor=1.4142135, ba_window=4, ba_max_obs=1024,
    ba_iters=2, cull_min_obs=1,
)
LOOP_TOL, GBA_CHI2_TOL = 1e-3, 1e-3      # tests/test_torch_parallel_loop.py: the closer
REFINE_CHI2 = (1e-3, 1e-5)       # ... and refine_map's chi2 (rtol, atol)


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded)
# ---------------------------------------------------------------------------


def _clouds():
    """Three clouds as tests/test_torch_parallel_fusion.py's (seeds 0-2):
    points over the grid and beyond it, a tenth masked off, a tenth raised."""
    out = []
    for seed in range(CALLS):
        rng = np.random.RandomState(seed)
        xy = rng.uniform(-8.5, 8.5, (N_PTS, 2))
        z = 0.1 * np.sin(xy[:, 0]) + np.where(rng.rand(N_PTS) < 0.1,
                                              rng.uniform(0, 2, N_PTS), 0.0)
        pts = np.concatenate([xy, (z + rng.normal(0, 0.02, N_PTS))[:, None]], 1)
        out.append((torch.tensor(pts, dtype=torch.float32), torch.tensor(rng.rand(N_PTS) > 0.1)))
    return out


def _frontier_sets():
    """Three occupancies and frontier sets as
    tests/test_torch_parallel_stages.py's (seeds 0-2)."""
    out = []
    for seed in range(CALLS):
        rng = np.random.RandomState(seed)
        occ = rng.choice(np.array([tg.FREE, tg.LETHAL, tg.UNKNOWN], np.uint8), (64, 64),
                         p=[0.6, 0.1, 0.3])
        fxy = rng.uniform(-7, 7, (N_FR, 2)).astype(np.float32)
        out.append((torch.tensor(occ), torch.tensor(fxy), torch.tensor(rng.rand(N_FR) > 0.2)))
    return out


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------


def _engine(capture, drift, mesh):
    """A StereoSlam engine on the revisit (tests/test_torch_jit_control.py's
    scene) whose loop closer has ``mesh``, on the mesh's device."""
    from fitslam_tpu_torch.models.slam import StereoSlam
    from test_torch_jit_control import _loop_cfg, _revisit, _to

    scene = _revisit(drift=drift)
    dev = mesh.device
    slam = StereoSlam(_loop_cfg(), dev, capture=capture)
    slam.map, slam.state = _to(scene.m, dev), _to(scene.state, dev)
    slam._track_initialized = slam._initialized = True
    slam.last_frame = _to(scene.frame, dev)
    slam.loop_closer.mesh = mesh
    return slam, scene


def _closed(capture, drift, mesh):
    """The engine's correction at the revisit's keyframe (retrieved) and
    refine_map; what it left, copied, and the collectives of each."""
    slam, scene = _engine(capture, drift, mesh)
    c0 = mesh.stats["collectives"]
    info = slam.loop_closer.on_keyframe(slam, scene.kf)
    c1 = mesh.stats["collectives"]
    corrected = jit.clone(slam.map)
    chi2 = slam.refine_map(**REFINE_KW)
    out = dict(info=info, corrected=corrected, map=jit.clone(slam.map),
               state=jit.clone(slam.state), chi2=chi2,
               edges=[e[2] for e in slam.loop_closer.loop_edges], stats=slam.capture_stats,
               collectives=(c1 - c0, mesh.stats["collectives"] - c1))
    del slam
    gc.collect()                  # the engine's slot goes idle for the next one
    return out


def rank_jit_parallel(pipe_in, device="cpu", eager_calls=1):
    """On each of two ranks: (a) the stage pipeline with capture=False,
    then captured twice; (b) sharded fusion and raycast on the three inputs
    eager, then captured; (c) two engines' mesh correction and refine_map
    (one a drift) eager, then captured (one slot: the second engine takes
    the first one's), ``loop_closing.EAGER_CALLS`` and
    ``slam.REFINE_EAGER_CYCLES`` set to ``eager_calls``; (d) the captured
    calls under the capture-safety recorder."""
    from fitslam_tpu_torch.models import loop_closing
    from fitslam_tpu_torch.models import slam as slam_module
    from fitslam_tpu_torch.parallel import dist_stages as ds
    from test_torch_jit_solvers import _recording

    loop_closing.EAGER_CALLS = slam_module.REFINE_EAGER_CYCLES = eager_calls
    data = mesh_mod.make_mesh(2)
    stage = mesh_mod.make_mesh(2, axis_names=("stage",))
    to = lambda tree: mesh_mod.map_tree(lambda x: x.to(device), tree)
    K, m, state, frames = to(pipe_in)

    def pipeline(capture):
        c0 = stage.stats["collectives"]
        out = ds.stage_pipelined_slam(stage, K, m, state, frames, **ORB_KW,
                                      backend_kwargs=BACKEND_KW, capture=capture)
        return out, stage.stats["collectives"] - c0

    clouds, fronts = to(_clouds()), to(_frontier_sets())
    fuse = lambda c, cap: ds.sharded_fuse_clouds(data, SPEC, *c, capture=cap)
    ray = lambda f, cap: ds.sharded_arrival_information(data, SPEC, *f, capture=cap)
    eager = dict(pipeline=pipeline(False), fusion=[fuse(c, False) for c in clouds],
                 ray=[ray(f, False) for f in fronts],
                 loop=[_closed(False, d, data) for d in DRIFTS])

    def captured():
        return dict(pipeline=[pipeline(True) for _ in range(2)],
                    fusion=[fuse(c, True) for c in clouds], ray=[ray(f, True) for f in fronts],
                    loop=[_closed(True, d, data) for d in DRIFTS])

    got, ops = _recording(captured, REGIONS)
    stats = {name: data.solvers[name].state.stats()
             for name in ("sharded_fuse_clouds", "sharded_arrival_information")}
    stats["pipeline"] = stage.solvers["stage_pipelined_slam"].state.stats()
    return dict(rank=data.rank, eager=eager, captured=got, ops=ops, stats=stats)


# ---------------------------------------------------------------------------
# Fixtures: the ranks in the background, the reference meanwhile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """The ranks' results and the reference's pipeline and closer."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from fitslam_tpu.data import synthetic as jsyn
    from fitslam_tpu.models import loop_closing as jlc
    from fitslam_tpu.models import slam_map as jsm
    from fitslam_tpu.models import tracking as jtr
    from fitslam_tpu.ops import lie as jlie
    from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
    from fitslam_tpu.ops.orb import FrameFeatures as JFeatures
    from fitslam_tpu.parallel import dist_stages as jds
    from fitslam_tpu.parallel import mesh as jmesh
    from fitslam_tpu.utils.config import FitSlamConfig as JConfig
    from fitslam_tpu_torch.utils import interop
    from test_stage_pipeline import BACKEND_KW as BACKEND_REF
    from test_stage_pipeline import NF as NF_REF
    from test_stage_pipeline import NL as NL_REF
    from test_stage_pipeline import T_FRAMES as T_REF
    from test_stage_pipeline import H as H_REF
    from test_stage_pipeline import W as W_REF
    from test_torch_jit_control import _jax_leaf, _loop_cfg, _revisit

    orb_kw = ORB_KW
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    # tests/test_stage_pipeline.py's set-up, as test_torch_parallel_pipeline.py makes it
    cfg = JConfig()
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2, cy=H / 2,
        baseline=0.2))
    Kj = JIntrinsics.from_config(cfg.camera)
    world = jsyn.corridor_world(jax.random.PRNGKey(0), num=2000, length=20.0, width=5.0)
    T_gt = jsyn.straight_trajectory(T_FRAMES + 1, length=(T_FRAMES + 1) * 0.15, height=1.2,
                                    start_x=0.5)
    imgs = [jnp.stack(jsyn.render_stereo(Kj, world, jlie.SE3(T_gt.R[i], T_gt.t[i]), width=W,
                                         height=H)) for i in range(T_FRAMES + 1)]
    frame0 = jtr.process_stereo(Kj, imgs[0][0], imgs[0][1], **orb_kw)
    m = jsm.empty_map(8, 2048, 4096)
    m = jsm.insert_keyframe(m, Kj, jlie.SE3.identity(), frame0.feats, frame0.depth,
                            -jnp.ones((NF,), jnp.int32), jnp.int32(0), jnp.zeros((256,)))
    st = jtr.mark_keyframe(jtr.init_track_state(), jnp.int32(0))
    frames = jnp.stack(imgs[1:])
    pipe_in = (interop.to_torch(np_tree(Kj)), interop.to_torch(np_tree(m)),
               interop.to_torch(np_tree(st)), torch.tensor(np.asarray(frames)))
    assert (W, H, NF, NL, T_FRAMES, BACKEND_KW) == \
        (W_REF, H_REF, NF_REF, NL_REF, T_REF, BACKEND_REF)
    ranks = in_background(launch, rank_jit_parallel, 2, pipe_in)

    pipe = jax.jit(functools.partial(jds.stage_pipelined_slam,
                                     jmesh.make_mesh(2, axis_names=("stage",)), **orb_kw,
                                     backend_kwargs=BACKEND_KW))
    ref_pipe = np_tree(pipe(Kj, m, st, frames))

    # the reference's closer with a 2-device mesh on the same revisit
    scene = _revisit(drift=DRIFTS[0])
    jx = lambda tree, cls: cls(*(_jax_leaf(getattr(tree, f)) for f in cls._fields))
    slam_j = type("Slam", (), {})()
    slam_j.map = jx(scene.m, jsm.SlamMap)
    slam_j.last_frame = jtr.StereoFrame(jx(scene.frame.feats, JFeatures),
                                        _jax_leaf(scene.frame.depth))
    slam_j.state = jtr.mark_keyframe(jtr.init_track_state()._replace(
        T_cw=_jax_leaf(scene.T_est)), jnp.int32(0))
    closer = jlc.LoopCloser(_loop_cfg(JConfig), JIntrinsics(*(jnp.float32(float(v))
                                                              for v in scene.K)))
    closer.mesh = jmesh.make_mesh(2)
    info = closer.on_keyframe(slam_j, scene.kf)
    ref_loop = dict(info=info, map=np_tree(slam_j.map))
    ranks = ranks.result()

    # the reference's refine_map from the port's corrected map (rank 0's)
    from fitslam_tpu.models import slam as jslam

    got = ranks[0]["captured"]["loop"][0]
    engine = jslam.StereoSlam(_loop_cfg(JConfig))
    engine.map = type(engine.map)(*(_jax_leaf(getattr(got["corrected"], f))
                                    for f in engine.map._fields))
    engine.loop_closer.mesh = jmesh.make_mesh(2)
    chi2 = engine.refine_map(**REFINE_KW)
    ref_loop.update(refined=np_tree(engine.map), refine_chi2=float(chi2))
    return dict(ranks=ranks, pipe=ref_pipe, loop=ref_loop, T=T_FRAMES)


# ---------------------------------------------------------------------------
# (a) the stage pipeline
# ---------------------------------------------------------------------------


def test_pipeline_captured_equals_eager(runs):
    """Captured twice on one slot (the second call's map and state assigned
    into its buffers), bit-equal to ``capture=False``: every StepOutputs
    field, the final map and tracker state, on both ranks; the broadcasts a
    call unchanged (one a frame, one of the results); each rank's regions
    ran through the slot."""
    T = runs["T"]
    for r in runs["ranks"]:
        want, n_want = r["eager"]["pipeline"]
        assert n_want == T + 1
        for out, n in r["captured"]["pipeline"]:
            assert n == T + 1
            assert _equal(out, want)
        assert _equal(want, runs["ranks"][0]["eager"]["pipeline"][0])
    front = runs["ranks"][0]["stats"]["pipeline"]
    back = runs["ranks"][1]["stats"]["pipeline"]
    assert set(front) == {"frontend_stereo"} and front["frontend_stereo"]["calls"] == 2 * T
    assert back["track"]["calls"] + back.get("track_uninitialized", {"calls": 0})["calls"] \
        == 2 * T
    assert back["keyframe"]["calls"] == back["finish_keyframe"]["calls"] >= 2
    assert back["keyframe"]["calls"] + back["finish"]["calls"] == 2 * T


def test_pipeline_captured_matches_reference(runs):
    m_ref, st_ref, outs_ref = runs["pipe"]
    m_out, st_out, outs = runs["ranks"][1]["captured"]["pipeline"][-1][0]
    assert outs.pose_wc.shape == (runs["T"], 4, 4)
    np.testing.assert_allclose(outs.pose_wc.numpy(), outs_ref.pose_wc, atol=PIPE_TOL)
    assert outs.was_keyframe.tolist() == outs_ref.was_keyframe.tolist()
    np.testing.assert_array_equal(outs.n_inliers.numpy(), outs_ref.n_inliers)
    assert int(m_out.n_kf) == int(m_ref.n_kf)
    np.testing.assert_allclose(st_out.T_cw.t.numpy(), st_ref.T_cw.t, atol=PIPE_TOL)


# ---------------------------------------------------------------------------
# (b) sharded fusion and raycast
# ---------------------------------------------------------------------------


def test_sharded_fusion_captured_equals_eager_and_one_rank(runs):
    """Three calls of one shape in the slot, each grid bit-equal to
    ``capture=False`` (the first two kept across the later calls) and to
    one rank within test_torch_parallel_fusion.py's tolerances."""
    for r in runs["ranks"]:
        assert {k: v["calls"] for k, v in r["stats"]["sharded_fuse_clouds"].items()} == \
            {"fuse_shard": CALLS, "fuse_grid": CALLS}
        for got, want, (pts, ok) in zip(r["captured"]["fusion"], r["eager"]["fusion"],
                                        _clouds()):
            assert _equal(got, want)
            single = tg.stats_to_grid(SPEC, tg.cell_stats(SPEC, pts, ok))
            for name in ("count", "z_min", "z_max"):
                assert torch.equal(getattr(got, name), getattr(single, name)), name
            for name, tol in (("elevation", 1e-5), ("slope", 1e-5), ("roughness", 1e-3)):
                np.testing.assert_allclose(getattr(got, name).numpy(),
                                           getattr(single, name).numpy(), atol=tol, err_msg=name)
            assert (got.cost.int() - single.cost.int()).abs().max() <= 1
            assert int((got.count > 0).sum()) > 1000


def test_sharded_raycast_captured_equals_eager_and_one_rank(runs):
    for r in runs["ranks"]:
        assert {k: v["calls"] for k, v in r["stats"]["sharded_arrival_information"].items()} \
            == {"arrival_shard": CALLS}
        for got, want, (occ, fxy, valid) in zip(r["captured"]["ray"], r["eager"]["ray"],
                                                _frontier_sets()):
            assert _equal(got, want)
            assert _equal(got, traycast.arrival_information(SPEC, occ, fxy, valid))
            assert float(got[1].max()) > 0


# ---------------------------------------------------------------------------
# (c) a mesh correction and a mesh refine_map
# ---------------------------------------------------------------------------


def _same_closed(got, want):
    """Two engines' corrections and refines: the record, the corrected and
    refined maps, the tracker state, the loop edge, the refine chi2 and the
    collectives of each, bit for bit."""
    assert want["info"] is not None and got["info"] is not None
    plain = lambda info: {k: v for k, v in info.items() if not isinstance(v, torch.Tensor)}
    assert plain(got["info"]) == plain(want["info"])
    for k in ("pgo_chi2", "gba_chi2"):
        assert torch.equal(got["info"][k], want["info"][k]), k
    for k in ("corrected", "map", "state", "chi2", "edges"):
        assert _equal(got[k], want[k]), k
    assert got["collectives"] == want["collectives"]


def test_mesh_correction_and_refine_captured_equal_eager(runs):
    """Two captured engines' (one slot) corrections and refine_map bit-equal
    to eager engines' on the same drifted revisits, on both ranks; the GBA
    sharded (a refine cycle's 6 reductions an iteration and an all-gather);
    the split regions in the slot and not the one-card correction's."""
    for r in runs["ranks"]:
        for got, want in zip(r["captured"]["loop"], r["eager"]["loop"]):
            _same_closed(got, want)
            assert got["collectives"][0] > 0
            assert got["collectives"][1] == \
                REFINE_KW["cycles"] * (6 * REFINE_KW["gba_iters"] + 1)
            assert want["stats"] == {}
        assert not _equal(r["captured"]["loop"][0]["map"], r["captured"]["loop"][1]["map"])
        stats = r["captured"]["loop"][0]["stats"]
        assert {k for k in stats if k.startswith(("loop_correct", "loop_rebase", "refine"))} == \
            {"loop_correct+fuse+gba_dist+retri", "loop_rebase", "refine_retri/1.0"}
        assert stats["refine_retri/1.0"]["calls"] == REFINE_KW["cycles"]
        # the second engine took the first one's slot
        assert r["captured"]["loop"][1]["stats"]["loop_rebase"]["calls"] == 2
    a, b = (r["captured"]["loop"][0] for r in runs["ranks"])
    assert _equal((a["map"], a["state"]), (b["map"], b["state"]))


def test_mesh_correction_and_refine_match_reference(runs):
    ref = runs["loop"]
    got = runs["ranks"][0]["captured"]["loop"][0]
    info, info_j = got["info"], ref["info"]
    assert info["loop_to"] == info_j["loop_to"] == 0
    assert info["inliers"] == info_j["inliers"]
    for f in ("t", "R"):
        np.testing.assert_allclose(getattr(got["corrected"].kf_T_cw, f).numpy(),
                                   getattr(ref["map"].kf_T_cw, f), atol=LOOP_TOL)
    np.testing.assert_allclose(float(info["gba_chi2"]), float(info_j["gba_chi2"]),
                               rtol=GBA_CHI2_TOL, atol=GBA_CHI2_TOL)
    refined, val = ref["refined"], ref["refined"].lm_valid
    for f in ("t", "R"):
        np.testing.assert_allclose(getattr(got["map"].kf_T_cw, f).numpy(),
                                   getattr(refined.kf_T_cw, f), atol=LOOP_TOL)
    np.testing.assert_allclose(got["map"].lm_pos.numpy()[val], refined.lm_pos[val],
                               atol=LOOP_TOL)
    np.testing.assert_allclose(float(got["chi2"]), ref["refine_chi2"], rtol=REFINE_CHI2[0],
                               atol=REFINE_CHI2[1])


# ---------------------------------------------------------------------------
# (d) capture safety
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("region", REGIONS)
def test_regions_are_capture_safe(runs, region):
    """Each new region, on every call (frames, clouds, frontier sets,
    engines and cycles of different content), runs the same operations with
    the same output shapes and types, none of them a host read, a
    data-dependent shape or (after its first call) an upload."""
    from test_torch_jit_sim import FORBIDDEN, UPLOADS

    slots = [seqs for r in runs["ranks"] for seqs in r["ops"].get(region, [])]
    assert slots, region
    for seqs in slots:
        assert len(seqs) >= 2, (region, [len(q) for q in slots])
        assert all(q == seqs[0] for q in seqs), f"region {region}: operations differ between calls"
        bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
        assert not bad, f"region {region} holds {sorted(bad)}"
        uploads = {op[0] for seq in seqs[1:] for op in seq if op[0].startswith(UPLOADS)}
        assert not uploads, f"region {region} uploads host data at every call: {uploads}"


# ---------------------------------------------------------------------------
# (e) on the card: captured against eager
# ---------------------------------------------------------------------------


def _port_pipeline_inputs():
    """tests/test_stage_pipeline.py's set-up made by the port (no JAX): the
    corridor world of seed 0 (``utils/prng.py`` draws the reference's), the
    bootstrap keyframe, frames 1..T_FRAMES."""
    import dataclasses

    from fitslam_tpu_torch.data import synthetic as tsyn
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    cam = dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                              cx=W / 2, cy=H / 2, baseline=0.2)
    K = Intrinsics.from_config(cam, "cpu")
    world = tsyn.corridor_world(prng.prng_key(0), num=2000, length=20.0, width=5.0,
                                device="cpu")
    T_gt = tsyn.straight_trajectory(T_FRAMES + 1, length=(T_FRAMES + 1) * 0.15, height=1.2,
                                    start_x=0.5, device="cpu")
    imgs = [torch.stack(tsyn.render_stereo(K, world.landmarks, lie.SE3(T_gt.R[i], T_gt.t[i]),
                                           width=W, height=H)) for i in range(T_FRAMES + 1)]
    f0 = tr.process_stereo(K, imgs[0][0], imgs[0][1], **ORB_KW)
    zero = torch.zeros((), dtype=torch.int32)
    m = sm.empty_map(8, 2048, 4096, device="cpu")
    m = sm.insert_keyframe(m, K, lie.SE3.identity(device="cpu"), f0.feats, f0.depth,
                           torch.full((NF,), -1, dtype=torch.int32), zero, torch.zeros((256,)))
    return K, m, tr.mark_keyframe(tr.init_track_state("cpu"), zero), torch.stack(imgs[1:])


@pytest.mark.gpu
def test_captured_sharded_paths_equal_eager_on_the_card():
    """On two gloo ranks sharing cuda:0: the pipeline captured twice, fusion
    and raycast three times, two engines' mesh corrections and refines (eager
    counts 0: the first engine warms the regions up, the second captures and
    replays them) bit-equal to ``capture=False``; the regions captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = "cuda:0"
    ranks = mesh_mod.launch(rank_jit_parallel, 2, _port_pipeline_inputs(), dev, 0,
                            backend="gloo", device=dev, timeout=900)
    for r in ranks:
        want, _ = r["eager"]["pipeline"]
        assert all(_equal(out, want) for out, _ in r["captured"]["pipeline"])
        for what in ("fusion", "ray"):
            assert all(_equal(a, b) for a, b in zip(r["captured"][what], r["eager"][what]))
        for got, want in zip(r["captured"]["loop"], r["eager"]["loop"]):
            _same_closed(got, want)
        stats = dict(r["stats"]["pipeline"], **r["stats"]["sharded_fuse_clouds"],
                     **r["stats"]["sharded_arrival_information"],
                     **r["captured"]["loop"][1]["stats"])
        for name in REGIONS[1:] + ("frontend_stereo" if r["rank"] == 0 else "track",):
            assert stats[name]["captured"], (name, stats)
