"""General generator of stereo camera streams: a world and a camera path
drawn from the seed by the frozen generators, rendered on the card in
set-up, and handed frame by frame to ``StereoSlam.process_frame`` in
episodes, each a fresh engine over the whole path (one frame in flight, the
pose read back on the host before the next frame is handed in, as a ROS
wrapper publishes a TF a frame).

The mix's file sets: ``world`` (``corridor``: num, length, width),
``trajectory`` (``straight``: frames, length, height, start_x),
``render.max_depth``, ``warm_episodes`` run untimed in set-up,
``sample_frames`` of the window's first ``sample_within`` frames and
``sample_keyframes`` of its first ``keyframes_within`` keyframes that the
reference checks, and ``trace_slice`` (``skip`` window frames, then
``frames`` profiled). A world or a trajectory of another kind is a later
mix's, which brings its generator here with its cell.

The correctness comparison (after the window, on the sampled frames; the
program freed first): the reference frontend (``reference/frontend.py``) on
the benchmark's own images against the features the program tracked
(keypoints, descriptors, stereo disparity); the reference's refinement of
each reported pose against the map the program holds after the frame
(``reference/tracking.py``); and on the sampled keyframes the map's update:
each landmark the keyframe spawned against the reference's triangulation of
its pixel with the reference's own disparity, from the keyframe's pose in
the map. The trajectory of every episode of the window against the path it
was rendered from (ATE) is printed beside them.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import core
from benchmark.frozen import evaluation, worlds
from benchmark.reference import frontend as ref_front
from benchmark.reference import tracking as ref_track

KP_TOL_PX = 0.01      # a keypoint of the reference within this is the same keypoint


def make_stream(traffic: Dict[str, Any], cam, seed: int, dev):
    """(frames [(left, right)] on ``dev``, ground truth [4x4 float64 T_wc])."""
    w, tj = traffic["world"], traffic["trajectory"]
    if w["kind"] != "corridor" or tj["kind"] != "straight":
        raise core.Refused(f"unknown world {w['kind']!r} or trajectory {tj['kind']!r}")
    pts = worlds.corridor_world(seed, w["num"], w["length"], w["width"])
    R, t = worlds.straight_trajectory(tj["frames"], tj["length"], tj["height"], tj["start_x"],
                                      dev)
    landmarks = torch.as_tensor(pts, device=dev)
    frames = [worlds.render_stereo(cam, landmarks, R[i], t[i], cam.width, cam.height,
                                   max_depth=traffic["render"]["max_depth"])
              for i in range(R.shape[0])]
    T = np.tile(np.eye(4), (R.shape[0], 1, 1))
    T[:, :3, :3] = R.double().cpu().numpy()
    T[:, :3, 3] = t.double().cpu().numpy()
    return frames, list(T)


def camera(settings, dev):
    c = settings["camera"]
    cam = worlds.Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["baseline"], dev)
    cam.width, cam.height = c["width"], c["height"]
    return cam


def snapshot(slam, info, i: int) -> Dict[str, Any]:
    """What the check reads of one frame: the features the program tracked,
    its pose and its landmarks after the frame, and of a keyframe the map's
    keyframes and observations (copies: the step's buffers are overwritten
    by the next frame)."""
    f, m = slam.last_frame, slam.map
    snap = {"i": i, "pose_wc": info["pose_wc"].copy(),
            "xy": f.feats.xy.clone(), "level": f.feats.level.clone(),
            "desc": f.feats.desc > 0, "valid": f.feats.valid.clone(), "depth": f.depth.clone(),
            "lm_pos": m.lm_pos.clone(), "lm_desc": m.lm_desc > 0, "lm_valid": m.lm_valid.clone()}
    if info.get("keyframe"):
        snap.update(frame_id=info["frame_id"], kf_frame_id=m.kf_frame_id.clone(),
                    kf_valid=m.kf_valid.clone(), kf_R=m.kf_T_cw.R.clone(),
                    kf_t=m.kf_T_cw.t.clone(), lm_anchor=m.lm_anchor_kf.clone(),
                    obs_kf=m.obs_kf.clone(), obs_lm=m.obs_lm.clone(),
                    obs_uvr=m.obs_uvr.clone(), obs_valid=m.obs_valid.clone())
    return snap


class Sampler:
    """The frames the check reads, drawn from the seed: ``sample_frames`` of
    the first ``sample_within`` frames, and ``sample_keyframes`` of the first
    ``keyframes_within`` keyframes (counted over the episodes)."""

    def __init__(self, traffic, seed: int):
        rng = np.random.default_rng(seed)
        self.frames = set(rng.choice(traffic["sample_within"], traffic["sample_frames"],
                                     replace=False).tolist())
        self.keyframes = set(rng.choice(traffic["keyframes_within"], traffic["sample_keyframes"],
                                        replace=False).tolist())
        self.n_kf = 0

    def wants(self, k: int, info) -> bool:
        """Whether frame ``k`` of the window, with its ``info``, is checked."""
        hit = k in self.frames
        if info.get("keyframe"):
            hit = hit or self.n_kf in self.keyframes
            self.n_kf += 1
        return hit


def prepare(cell: core.Cell, seed: int, dev):
    """Set-up: the config, the stream rendered on ``dev`` and its ground
    truth, and the untimed warm-up episodes (every region captured)."""
    from fitslam_tpu_torch.models.slam import StereoSlam

    traffic, settings = cell.traffic, cell.config["settings"]
    cfg = core.fitslam_config(settings)
    frames, gt = make_stream(traffic, camera(settings, dev), seed, dev)
    for _ in range(traffic["warm_episodes"]):
        warm = StereoSlam(cfg, dev)
        for pair in frames:
            warm.process_frame(*pair)
        del warm
    return cfg, frames, gt


def run(cell: core.Cell, seed: int, seconds: float, tracer: core.Tracer, dev) -> Dict[str, Any]:
    from fitslam_tpu_torch.models.slam import StereoSlam

    traffic, settings = cell.traffic, cell.config["settings"]
    cfg, frames, gt = prepare(cell, seed, dev)
    n = len(frames)
    captured_before = _captures()
    sample = Sampler(traffic, seed)

    steps: List[Dict[str, Any]] = []
    snaps: List[Dict[str, Any]] = []
    trajectories: List[List[np.ndarray]] = []
    attempted = failed = 0
    slam, i = None, n
    core.sync(dev)
    t_window = time.perf_counter()
    k = 0
    while True:
        if i == n:
            slam = None
            slam = StereoSlam(cfg, dev)
            trajectories.append([])
            i = 0
        tracer.before_step(k)
        syncs = slam.host_syncs
        t0 = time.perf_counter()
        with tracer.label("frame"):
            try:
                info = slam.process_frame(*frames[i])
            except Exception as e:           # an answer that never comes
                info = {"error": repr(e)}
        t1 = time.perf_counter()
        tracer.after_step(k)
        attempted += 1
        bad = "error" in info or info["lost"]
        failed += bad
        steps.append({"s": t1 - t0, "keyframe": bool(info.get("keyframe")),
                      "loop": "loop" in info, "syncs": slam.host_syncs - syncs,
                      "traced": tracer.in_slice(k)})
        if "pose_wc" in info:
            trajectories[-1].append(info["pose_wc"])
            if sample.wants(k, info):
                snaps.append(snapshot(slam, info, i))
        if "error" in info:
            i = n - 1                         # the engine is spent: a fresh one
        k += 1
        i += 1
        if t1 - t_window >= seconds and (not tracer.enabled or tracer.done):
            break
    window_s = t1 - t_window
    core.sync(dev)
    recaptured = _captures() - captured_before
    peak = core.peak_bytes(dev)
    summary = None
    if tracer.enabled and tracer.prof is not None:
        from benchmark import profile

        summary = profile.summarize(tracer.prof, tracer.window_s, tracer.labels)
        tracer.prof = None

    del slam
    from fitslam_tpu_torch.utils import jit

    jit.release_idle()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, seen = compare(snaps, frames, trajectories, gt, settings)
    return {"attempted": attempted, "failed": failed, "window_s": window_s, "steps": steps,
            "checks": checks, "memory_peak_bytes": peak, "profile": summary,
            "launches": tracer.launches, "settings": settings, "t_window": t_window,
            "notes": {"captured_in_window": recaptured, "episodes": len(trajectories), **seen}}


def _captures() -> int:
    """Regions captured so far, over every slot: one captured inside the
    window would be a compile there."""
    from fitslam_tpu_torch.utils import jit

    return sum(r["captured"] for slots in jit._SLOTS.values() for s in slots
               for r in s.stats().values())


def frontend_gaps(snap, left, right, settings, dtype=torch.float32) -> Dict[str, Any]:
    """The program's features of one frame against the reference frontend
    on the same images: the share of keypoints without a counterpart, the
    share of descriptor bits that differ, and the median gap (px) between a
    feature's disparity and the reference's SSD parabola at the right pixel
    it points to (infinite where that pixel is no SSD minimum). Also
    returns the reference's features as [u, v, right-image u or -1] rows,
    the right column the reference's own disparity where the program found
    one."""
    o, c = settings["orb"], settings["camera"]
    ref = ref_front.extract(left, o["num_features"], o["num_levels"], o["scale_factor"],
                            o["fast_threshold"], dtype)
    valid = snap["valid"]
    pxy, plv = snap["xy"][valid], snap["level"][valid].long()
    rxy, rlv = ref.xy[ref.valid], ref.level[ref.valid]
    d = torch.cdist(pxy.double(), rxy.double())
    d = torch.where(plv[:, None] == rlv[None, :], d, torch.full_like(d, math.inf))
    near, j = d.min(1)
    hit = near <= KP_TOL_PX
    back = d.min(0).values <= KP_TOL_PX
    unmatched = max(1 - float(hit.double().mean()), 1 - float(back.double().mean()))
    bits = (snap["desc"][valid][hit] != ref.desc[ref.valid][j[hit]]).double().mean()
    # stereo: the reference's SSD parabola at the right pixel the reported
    # disparity points to (both roundings of it)
    depth = snap["depth"][valid]
    has = depth > 0
    bf = float(np.float32(c["baseline"]) * np.float32(c["fx"]))
    disp = bf / depth[has]
    x_l, y_l = pxy[has, 0], pxy[has, 1]
    xr = torch.round(x_l) - disp
    best_gap = torch.full_like(disp, math.inf)
    best_d = torch.zeros_like(disp)
    for k in (torch.floor(xr), torch.ceil(xr)):
        dr, lo = ref_front.ssd_disparity(left, right, x_l, y_l, k.long(), dtype)
        gap = torch.where(lo, (dr - disp).abs(), torch.full_like(dr, math.inf))
        better = gap < best_gap
        best_gap, best_d = torch.where(better, gap, best_gap), torch.where(better, dr, best_d)
    uvr = torch.cat([rxy, torch.full_like(rxy[:, :1], -1.0)], -1)
    idx = torch.nonzero(has).reshape(-1)
    use = hit[idx] & torch.isfinite(best_gap)
    rows = j[idx[use]]
    uvr[rows, 2] = rxy[rows, 0] - best_d[use].to(rxy.dtype)
    return {"kp_unmatched": unmatched, "desc_bits_off": float(bits),
            "depth_gap_px": float(best_gap.median()) if has.any() else 0.0,
            "ref_uvr": uvr, "ref_level": rlv, "ref_desc": ref.desc[ref.valid]}


def pose_gap(snap, g, settings, dtype=torch.float64):
    """(m, rad, matches) of the reference's refinement of the frame's pose."""
    c, o = settings["camera"], settings["orb"]
    K = (c["fx"], c["fy"], c["cx"], c["cy"])
    bf = float(np.float32(c["baseline"]) * np.float32(c["fx"]))
    return ref_track.pose_check(snap["pose_wc"], g["ref_uvr"], g["ref_level"], g["ref_desc"],
                                o["scale_factor"], snap["lm_pos"], snap["lm_desc"],
                                snap["lm_valid"], K, bf, c["width"], c["height"], dtype)


def spawned(snap, g, settings):
    """What the map check reads of a sampled keyframe: (the landmarks it
    spawned as the map holds them after the frame, the left pixels that
    spawned them, the reference's own disparity at each, the keyframe's
    camera-from-world pose in the map as (R, t)). A landmark whose pixel
    has no reference feature with a disparity is left out. None for a frame
    that is no keyframe."""
    if "obs_kf" not in snap:
        return None
    kf = torch.nonzero(snap["kf_valid"] & (snap["kf_frame_id"] == snap["frame_id"])).reshape(-1)
    if kf.numel() != 1:
        raise ValueError(f"{kf.numel()} keyframes of frame {snap['frame_id']} in the map")
    kf = kf[0]
    lm = snap["obs_lm"].long()
    own = (snap["obs_valid"] & (snap["obs_kf"] == kf) & (snap["lm_anchor"][lm] == kf)
           & snap["lm_valid"][lm])
    uv, lm = snap["obs_uvr"][own, :2].double(), lm[own]
    ref = g["ref_uvr"][g["ref_uvr"][:, 2] >= 0].double()
    if uv.shape[0] and ref.shape[0]:
        near, j = torch.cdist(uv, ref[:, :2]).min(1)
        hit = near <= KP_TOL_PX
    else:
        j = hit = torch.zeros((uv.shape[0],), dtype=torch.bool, device=uv.device)
    disp = ref[j[hit], 0] - ref[j[hit], 2] if hit.any() else uv[:0, 0]
    return (snap["lm_pos"][lm[hit]].double(), uv[hit], disp, snap["kf_R"][kf].double(),
            snap["kf_t"][kf].double())


def triangulated(sp, settings, dtype=torch.float64) -> torch.Tensor:
    """The reference's world points of ``spawned``'s pixels."""
    c = settings["camera"]
    K = (c["fx"], c["fy"], c["cx"], c["cy"])
    bf = float(np.float32(c["baseline"]) * np.float32(c["fx"]))
    _, uv, disp, R, t = sp
    return ref_track.triangulate(uv, disp, K, bf, R, t, dtype).double()


def map_gaps(snap, g, settings):
    """The gaps (mm) between a sampled keyframe's spawned landmarks and the
    reference's triangulation of them (``spawned``); None for a frame that
    is no keyframe."""
    sp = spawned(snap, g, settings)
    if sp is None:
        return None
    return torch.linalg.norm(sp[0] - triangulated(sp, settings), dim=-1) * 1e3


def compare(snaps, frames, trajectories, gt, settings) -> Dict[str, float]:
    """The numbers the cell's limits hold, over the sampled frames: the
    worst keypoint and descriptor shares, disparity gap and pose gap, the
    largest map gap of a sampled keyframe's spawned landmarks; and how many
    frames, keyframes and spawned landmarks were checked. The ATE of the
    window's episodes against the path they were rendered from is returned
    beside them, not judged: no control separates from it (PERF.md)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"kp_unmatched": 0.0, "desc_bits_off": 0.0, "depth_gap_px": 0.0, "pose_gap_mm": 0.0,
           "map_gap_mm": 0.0, "sampled_keyframes": 0, "sampled_landmarks": 0}
    rot = 0.0
    for snap in snaps:
        left, right = frames[snap["i"]]
        g = frontend_gaps(snap, left, right, settings)
        for key in ("kp_unmatched", "desc_bits_off", "depth_gap_px"):
            out[key] = max(out[key], g[key])
        dt, dr, _ = pose_gap(snap, g, settings)
        out["pose_gap_mm"] = max(out["pose_gap_mm"], dt * 1e3)
        rot = max(rot, dr * 1e3)
        gaps = map_gaps(snap, g, settings)
        if gaps is not None:
            out["sampled_keyframes"] += 1
            out["sampled_landmarks"] += int(gaps.numel())
            out["map_gap_mm"] = max([out["map_gap_mm"]] + gaps.tolist())
    out["sampled_frames"] = len(snaps)
    ate = max((evaluation.ate_rmse(tr, gt[:len(tr)]) for tr in trajectories if len(tr) >= 20),
              default=math.inf)
    gc.collect()
    return out, {"ate_m": ate, "pose_gap_mrad": rot}


def episode(cfg, frames, sample: Sampler, dev):
    """A fresh engine over the stream; snapshots at the sampled frames."""
    from fitslam_tpu_torch.models.slam import StereoSlam

    slam, snaps, traj = StereoSlam(cfg, dev), [], []
    for i, pair in enumerate(frames):
        info = slam.process_frame(*pair)
        traj.append(info["pose_wc"])
        if sample.wants(i, info):
            snaps.append(snapshot(slam, info, i))
    return snaps, traj


def control_frame(snap, left, right, settings) -> Dict[str, float]:
    """The control's readings on one sampled frame: the reference in the
    program's place computed in bfloat16 (its own ORB features, the SSD
    disparity of the program's features, the pose refined from the
    program's, a keyframe's landmarks triangulated), judged as the program
    is."""
    bf16 = torch.bfloat16
    o, c = settings["orb"], settings["camera"]
    ctl = ref_front.extract(left, o["num_features"], o["num_levels"], o["scale_factor"],
                            o["fast_threshold"], bf16)
    g = frontend_gaps(dict(snap, xy=ctl.xy, level=ctl.level, desc=ctl.desc, valid=ctl.valid,
                           depth=torch.zeros_like(ctl.xy[:, 0])), left, right, settings)
    out = {"kp_unmatched": g["kp_unmatched"], "desc_bits_off": g["desc_bits_off"]}
    v = snap["valid"] & (snap["depth"] > 0)
    bf = float(np.float32(c["baseline"]) * np.float32(c["fx"]))
    x_l, y_l, d = snap["xy"][v, 0], snap["xy"][v, 1], snap["depth"][v]
    xr = torch.round(torch.round(x_l) - bf / d).long()
    disp, _ = ref_front.ssd_disparity(left, right, x_l, y_l, xr, bf16)
    out["depth_gap_px"] = frontend_gaps(
        dict(snap, depth=torch.zeros_like(snap["depth"]).masked_scatter(v, bf / disp)),
        left, right, settings)["depth_gap_px"]
    g = frontend_gaps(snap, left, right, settings)
    K = (c["fx"], c["fy"], c["cx"], c["cy"])
    T = torch.as_tensor(snap["pose_wc"], dtype=torch.float64, device=left.device)
    R0, t0 = T[:3, :3].T.contiguous(), -(T[:3, :3].T @ T[:3, 3])
    f, l = ref_track.match(g["ref_uvr"][:, :2], g["ref_desc"], snap["lm_pos"], snap["lm_desc"],
                           snap["lm_valid"], R0, t0, K, c["width"], c["height"])
    sig = o["scale_factor"] ** g["ref_level"][f].double()
    R, t = ref_track.refine_pose(R0, t0, g["ref_uvr"][f], sig, snap["lm_pos"][l], K, bf,
                                 dtype=bf16)
    Tc = torch.eye(4, dtype=torch.float64, device=left.device)
    Tc[:3, :3] = R.double().T
    Tc[:3, 3] = -(R.double().T @ t.double())
    out["pose_gap_mm"] = pose_gap(dict(snap, pose_wc=Tc.cpu().numpy()), g, settings)[0] * 1e3
    sp = spawned(snap, g, settings)
    if sp is not None and sp[0].shape[0]:
        # the bfloat16 triangulation in the map's place
        gap = torch.linalg.norm(triangulated(sp, settings, bf16) - triangulated(sp, settings),
                                dim=-1)
        out["map_gap_mm"] = float(gap.max()) * 1e3
    return out


def control_readings(snaps, frames, settings) -> Dict[str, float]:
    """The control's worst readings over the sampled frames."""
    out: Dict[str, float] = {}
    for snap in snaps:
        for k, v in control_frame(snap, *frames[snap["i"]], settings).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def control_run(cell: core.Cell, seed: int, dev):
    """(the program's readings, the control's) on one seed: one episode at
    the cell's size with the frames a run samples."""
    cfg, frames, gt = prepare(cell, seed, dev)
    snaps, traj = episode(cfg, frames, Sampler(cell.traffic, seed), dev)
    judged, seen = compare(snaps, frames, [traj], gt, cell.config["settings"])
    return {**judged, **seen}, control_readings(snaps, frames, cell.config["settings"])
