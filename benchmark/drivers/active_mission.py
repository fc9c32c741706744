"""General generator of active-SLAM missions: a rover in a rooms arena, the
whole loop of the port driven step by step, each mission a fresh
``ActiveSlamSystem`` with its ``SimNavInterface`` from the same start.

One step (the harness's copy of ``bench_suite.active_loop``): the simulated
camera's frame and frustum cloud at the rover's true pose
(``SimCamera.frame``), ``ActiveSlamSystem.process_frame`` (the synchronous
SLAM step, a keyframe's cloud fused), ``tick_exploration`` every
``tick_every`` steps, the controller step (``SimNavInterface.step``: the
costmaps, a plan with K3, pure pursuit), and the robot's pose read from the
EKF (``estimated_robot_pose``); then the simulation's clock advances. A
step's latency runs from the camera to the pose read.

The mix's file sets: ``world`` (the seeds of the rooms layout and of its
wall and floor texture, the wall height and the texture's density),
``start`` (x, y, yaw), ``steps`` a mission, ``warm_missions`` run untimed
in set-up, the ``sample_*`` counts of the window's first ``sample_within``
steps (``Probe``), and ``trace_slice``. Every seed runs the same missions;
``--seed`` draws the steps the reference checks. The configuration's file
adds the grid, the robot's limits and the simulation's step.

The correctness comparison, after the window with the program freed: on
the sampled frames, the camera's images against the frozen renderer at the
rover's pose, and the reference frontend and pose check of the stereo cells
on them; on the sampled pose reads, the reference EKF over the rows the
flush fused, from the filters' states before it; on the sampled plans, the
K3 potential against the reference wavefront potential of the costmap,
robot and goal it was planned from; on the sampled fusions, the grid's
statistics after a keyframe's cloud against the reference's addition of
that cloud to the statistics before it, through the keyframe's pose in the
map; on the sampled grids, the thresholded grid against the reference's
grid of the statistics it was made from; on the sampled ticks, the FI
gate's value against the reference's information of the same query pose
over the landmark map. The fusion, the FI value and the plan start from the
program's own state (statistics, map, costmap), as the EKF's check starts
from its filters: each stage is checked from its input on.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import core
from benchmark.drivers import stereo_stream as st
from benchmark.frozen import rooms, worlds
from benchmark.reference import ekf as ref_ekf
from benchmark.reference import fisher as ref_fisher
from benchmark.reference import grid as ref_grid
from benchmark.reference import planner as ref_plan


def landmarks_for(cell: core.Cell, dev) -> torch.Tensor:
    g, w = cell.config["grid"], cell.traffic["world"]
    occ = rooms.rooms_occupancy(g["size"], w["rooms_seed"])
    pts = rooms.world_from_occupancy(occ, g["resolution"], g["origin_x"], g["origin_y"],
                                     w["texture_seed"], w["wall_height"],
                                     w["points_per_wall_cell"], w["floor_points"])
    return torch.as_tensor(pts, device=dev)


class Mission:
    """One mission: a fresh system, controller and robot at the start."""

    def __init__(self, cell: core.Cell, cfg, spec, camera, dev):
        from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem
        from fitslam_tpu_torch.models.localization import TwistMux
        from fitslam_tpu_torch.models.sim_nav import SimNavInterface
        from fitslam_tpu_torch.models.sim_robot import DiffDriveRobot
        from fitslam_tpu_torch.utils.profiling import SimClock

        sim, r = cell.config["sim"], cell.config["robot"]
        x, y, yaw = cell.traffic["start"]
        self.sim, self.dev, self.camera = sim, dev, camera
        self.robot = DiffDriveRobot(x=x, y=y, yaw=yaw, v_max=r["v_max"], w_max=r["w_max"])
        box = {}
        self.nav = SimNavInterface(cfg, spec, self.robot, lambda: box["s"].occupancy(),
                                   dt=sim["dt"], twist_mux=TwistMux() if sim["twist_mux"] else None,
                                   device=dev)
        self.system = ActiveSlamSystem(cfg, spec, self.nav, device=dev, event_logger=SimClock(),
                                       get_robot_pose=lambda: box["s"].estimated_robot_pose())
        box["s"] = self.system
        self.i = 0

    def step(self, timed, probe=None) -> Dict[str, Any]:
        """One step; ``timed(name, fn)`` runs each layer's call; ``probe``
        (or None) records what the check reads. Returns the frame's info."""
        from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot

        system, nav, robot, sim = self.system, self.nav, self.robot, self.sim
        cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, height=sim["camera_height"],
                                     device=self.dev)
        if self.i == 0:
            system.set_world_anchor(cam)
        left, right, cloud, cvalid = timed("camera", lambda: self.camera.frame(cam))
        if probe is not None:
            probe.before_frame(self)
        info = timed("frame", lambda: system.process_frame(left, right, cloud, cvalid))
        if probe is not None:
            probe.frame(self, info, cam, left, right, cloud, cvalid)
        if self.i % sim["tick_every"] == sim["tick_every"] - 1:
            timed("tick", system.tick_exploration)
            if probe is not None:
                probe.tick(self)
        before = (robot.xy.copy(), nav.plans, None if nav._goal is None else nav._goal.copy(),
                  nav._path)
        timed("ctrl", nav.step)
        if probe is not None:
            probe.plan(self, *before)
            probe.grid(self)
            probe.ekf_before(self)
        timed("ekf", system.estimated_robot_pose)
        if probe is not None:
            probe.ekf_after(self)
        system.log.sim_s += sim["dt"]
        self.i += 1
        return info


def install_potential_tap() -> Dict[str, Any]:
    """Keep a handle on the potential of the controller's ``plan`` region:
    ``nav.wavefront_potential``'s result, inside ``sim_nav.plan_region``,
    held in the returned tap's ``"pot"`` (``"on"`` while the region runs).
    No kernel is added: once the region is captured the handle is the
    graph's own tensor, which each replay rewrites. Run before the region's
    first call in the process; a later call returns the same tap."""
    from fitslam_tpu_torch.models import nav, sim_nav

    tap = getattr(sim_nav.plan_region, "bench_tap", None)
    if tap is not None:
        return tap
    tap = {"on": False, "pot": None}
    real_plan, real_potential = sim_nav.plan_region, nav.wavefront_potential

    def plan_region(*a, **k):
        tap["on"] = True
        try:
            return real_plan(*a, **k)
        finally:
            tap["on"] = False

    def wavefront_potential(*a, **k):
        pot = real_potential(*a, **k)
        if tap["on"]:
            tap["pot"] = pot
        return pot

    plan_region.bench_tap = tap
    sim_nav.plan_region, nav.wavefront_potential = plan_region, wavefront_potential
    return tap


class Probe:
    """Copies, at the steps the seed draws, of what the check reads: every
    copy a device clone or a host list copy, so the window never waits for
    it. ``sample_*`` of the mix count frames, pose reads, plans, ticks,
    fusions and grids among the window's first ``sample_within`` steps
    (ticks among its first ``ticks_within`` ticks; a fusion or a grid is
    read at the first step from the drawn one that has one)."""

    def __init__(self, tr, seed: int):
        self.tap = install_potential_tap()
        rng = np.random.default_rng(seed)
        draw = lambda key, within="sample_within": set(
            rng.choice(tr[within], tr[key], replace=False).tolist())
        self.want_frames, self.want_ekf = draw("sample_frames"), draw("sample_ekf")
        self.want_plans, self.want_ticks = draw("sample_ekf"), draw("sample_ticks", "ticks_within")
        self.want_fusions, self.want_grids = draw("sample_fusions"), draw("sample_grids")
        self.k = 0            # the window's step index
        self.n_plans = self.n_ticks = 0
        self.fusion_armed = self.grid_armed = 0
        self.frames: List[Dict] = []
        self.ekfs: List[Dict] = []
        self.plans: List[Dict] = []
        self.ticks: List[Dict] = []
        self.fusions: List[Dict] = []
        self.grids: List[Dict] = []
        self._ekf = self._tick = self._stats = None

    def attach(self, m: Mission) -> None:
        """Note each tick's query pose and packed scalars (the FI gate's
        value among them) as the mission's explorer hands them on."""
        ex = m.system.explorer
        real = ex._tick_device

        def tick_device(occ, robot_xy, robot_yaw):
            out = real(occ, robot_xy, robot_yaw)
            self._tick = (np.array(robot_xy, np.float64), float(robot_yaw), out[0])
            return out

        ex._tick_device = tick_device

    def before_frame(self, m: Mission):
        self.fusion_armed += self.k in self.want_fusions
        self.grid_armed += self.k in self.want_grids
        self._stats = [t.clone() for t in m.system._fstats] if self.fusion_armed else None

    def frame(self, m: Mission, info, cam, left, right, cloud, cvalid):
        system = m.system
        if self.k in self.want_frames and "pose_wc" in info:
            snap = st.snapshot(system.slam, info, 0)
            snap.update(left=left.clone(), right=right.clone(), R=cam.R.clone(), t=cam.t.clone())
            self.frames.append(snap)
        fused = (self._stats is not None and info.get("keyframe") and not info.get("loop")
                 and not system._restitch and system.T_anchor is not None)
        if fused:
            mp, a = system.slam.map, system.T_anchor
            self.fusions.append({"before": self._stats, "after": [t.clone() for t in system._fstats],
                                 "cloud": cloud.clone(), "valid": cvalid.clone(),
                                 "frame_id": info["frame_id"],
                                 "kf_frame_id": mp.kf_frame_id.clone(), "kf_valid": mp.kf_valid.clone(),
                                 "kf_R": mp.kf_T_cw.R.clone(), "kf_t": mp.kf_T_cw.t.clone(),
                                 "anchor": (a.R.clone(), a.t.clone())})
            self.fusion_armed -= 1

    def tick(self, m: Mission):
        if self._tick is None:
            return
        robot, yaw, vals = self._tick
        self._tick = None
        self.n_ticks += 1
        if self.n_ticks - 1 in self.want_ticks and m.system.T_anchor is not None:
            mp, a = m.system.slam.map, m.system.T_anchor
            self.ticks.append({"robot": robot, "yaw": yaw, "vals": vals.clone(),
                               "lm_pos": mp.lm_pos.clone(), "lm_valid": mp.lm_valid.clone(),
                               "anchor": (a.R.clone(), a.t.clone())})

    def plan(self, m: Mission, robot_xy, plans_before, goal, path_before):
        if m.nav.plans == plans_before or m.nav._path is None or m.nav._path is path_before:
            return                 # no plan this step, or one that found no path
        self.n_plans += 1
        if self.n_plans - 1 not in self.want_plans:
            return
        occ, spec = m.nav.global_costmap.grid()
        self.plans.append({"occ": occ.clone(), "spec": tuple(spec), "robot": robot_xy,
                           "goal": goal, "path": np.array(m.nav._path, np.float64),
                           "pot": None if self.tap["pot"] is None else self.tap["pot"].clone()})

    def grid(self, m: Mission):
        system = m.system
        if self.grid_armed and not system._grid_dirty:
            self.grids.append({"stats": [t.clone() for t in system._fstats],
                               "occ": system._slot_state["occ"].clone()})
            self.grid_armed -= 1

    def ekf_before(self, m: Mission):
        e = m.system.ekf
        if self.k not in self.want_ekf or not m.system._ekf_dirty:
            self._ekf = None
            return
        self._ekf = {"rows": (list(e._odom_rows), list(e._map_rows)),
                     "pre": [t.clone() for t in (e.odom_state.x, e.odom_state.P,
                                                 e.map_state.x, e.map_state.P)]}

    def ekf_after(self, m: Mission):
        if self._ekf is not None:
            e = m.system.ekf
            self._ekf["post"] = [e.odom_state.x.clone(), e.map_state.x.clone()]
            self.ekfs.append(self._ekf)
            self._ekf = None
        self.k += 1


def prepare(cell: core.Cell, dev):
    """Set-up: the config, the arena's landmarks, the simulated camera, the
    plan's potential tap, and the untimed warm-up missions (every region
    the window replays captured)."""
    from fitslam_tpu_torch.data.synthetic import SimCamera
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    install_potential_tap()
    cfg = core.fitslam_config(cell.config["settings"])
    g, sim = cell.config["grid"], cell.config["sim"]
    spec = GridSpec2D(g["size"], g["resolution"], g["origin_x"], g["origin_y"])
    landmarks = landmarks_for(cell, dev)
    camera = SimCamera(Intrinsics.from_config(cfg.camera, dev), landmarks, cfg.camera.width,
                       cfg.camera.height, max_depth=sim["camera_max_depth"],
                       cloud_points=cfg.traversability.max_points_per_cloud,
                       cloud_depth=sim["cloud_depth"])
    plain = lambda name, fn: fn()
    for _ in range(cell.traffic["warm_missions"]):
        m = Mission(cell, cfg, spec, camera, dev)
        for _ in range(cell.traffic["steps"]):
            m.step(plain)
        del m
    return cfg, spec, landmarks, camera


def run(cell: core.Cell, seed: int, seconds: float, tracer: core.Tracer, dev) -> Dict[str, Any]:
    cfg, spec, landmarks, camera = prepare(cell, dev)
    tr = cell.traffic
    captured_before = st._captures()
    probe = Probe(tr, seed)
    steps: List[Dict[str, Any]] = []
    attempted = failed = 0
    spans: Dict[str, float] = {}

    def plain(name, fn):
        return fn()

    def barriered(name, fn):
        core.sync(dev)
        t0 = time.perf_counter()
        out = fn()
        core.sync(dev)
        spans[name] = time.perf_counter() - t0
        return out

    def labelled(name, fn):
        with tracer.label(name):
            return fn()

    m = None
    k = 0
    core.sync(dev)
    t_window = time.perf_counter()
    while True:
        if m is None or m.i == tr["steps"]:
            m = None
            m = Mission(cell, cfg, spec, camera, dev)
            probe.attach(m)
        tracer.before_step(k)
        spans.clear()
        # the traced run's spans come from the steps outside the profiled
        # slice; inside it the steps run without barriers, as untraced ones
        # do, each layer's call labelled for the profile
        timed = (labelled if tracer.in_slice(k) else barriered) if tracer.enabled else plain
        t0 = time.perf_counter()
        try:
            info = m.step(timed, probe)
        except Exception as e:                # an answer that never comes
            info = {"error": repr(e)}
            m = None
            probe.k += 1
        t1 = time.perf_counter()
        tracer.after_step(k)
        attempted += 1
        failed += "error" in info or bool(info.get("lost"))
        steps.append({"s": t1 - t0, "traced": tracer.in_slice(k), "spans": dict(spans)})
        k += 1
        if t1 - t_window >= seconds and (not tracer.enabled or tracer.done):
            break
    window_s = t1 - t_window
    core.sync(dev)
    recaptured = st._captures() - captured_before
    peak = core.peak_bytes(dev)
    summary = None
    if tracer.enabled and tracer.prof is not None:
        from benchmark import profile

        summary = profile.summarize(tracer.prof, tracer.window_s, tracer.labels)
        tracer.prof = None
    del m, camera
    from fitslam_tpu_torch.utils import jit

    jit.release_idle()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, seen = compare(probe, landmarks, cell)
    return {"attempted": attempted, "failed": failed, "window_s": window_s, "steps": steps,
            "checks": checks, "memory_peak_bytes": peak, "profile": summary,
            "launches": tracer.launches, "settings": cell.config["settings"],
            "grid": cell.config["grid"], "t_window": t_window,
            "notes": {"captured_in_window": recaptured, **seen}}


def ekf_gaps(e, dtype=torch.float64):
    """(odom filter, map filter) gap (m) of the planar position after the
    flush between the program and the reference from the same start."""
    x0o, P0o, x0m, P0m = e["pre"]
    out = []
    for (x0, P0), rows, post in zip(((x0o, P0o), (x0m, P0m)), e["rows"], e["post"]):
        x, _ = ref_ekf.run_rows(x0.double(), P0.double(), rows, dtype)
        out.append(float(torch.linalg.norm(x.double()[:2] - post.double()[:2])))
    return out


def ref_potential(p, cell, dtype=torch.float64) -> torch.Tensor:
    """The reference potential of a sampled plan's costmap, robot and goal."""
    nav = cell.config["settings"]["nav"]
    size, res, ox, oy = p["spec"]
    return ref_plan.potential(p["occ"], res, ox, oy, p["robot"], p["goal"], nav["wavefront_iters"],
                              nav["allow_unknown"], dtype)


def potential_gap(pot, ref) -> float:
    """The largest gap (m) between two potentials over the cells either
    reaches; a cell one reaches and the other does not reads 1e9."""
    pot, ref = pot.double(), ref.double()
    far = ref_plan.BIG / 2
    reach = (pot < far) | (ref < far)
    if not bool(reach.any()):
        return 0.0
    return float((pot - ref).abs()[reach].max())


def plan_excess(p, cell, dtype=torch.float64) -> float:
    size, res, ox, oy = p["spec"]
    return ref_plan.descent_excess(ref_potential(p, cell, dtype), res, ox, oy,
                                   [p["robot"]] + list(p["path"]))


def world_kf_pose(f):
    """(R, t), float64, of the sampled fusion's keyframe in the world frame
    (its camera-from-SLAM pose composed with the world-to-SLAM anchor)."""
    kf = torch.nonzero(f["kf_valid"] & (f["kf_frame_id"] == f["frame_id"])).reshape(-1)
    if kf.numel() != 1:
        raise ValueError(f"{kf.numel()} keyframes of frame {f['frame_id']} in the map")
    R, t = f["kf_R"][kf[0]].double(), f["kf_t"][kf[0]].double()
    aR, at = (x.double() for x in f["anchor"])
    return R @ aR.T, t - R @ aR.T @ at


def fused_stats(f, cell, dtype=torch.float64):
    """The reference's statistics after a sampled fusion: the program's
    before it with the keyframe's cloud added through the keyframe's pose."""
    g = cell.config["grid"]
    R, t = world_kf_pose(f)
    add = ref_grid.cloud_stats(f["cloud"], f["valid"], R, t, g["size"], g["resolution"],
                               g["origin_x"], g["origin_y"], dtype)
    return ref_grid.merged(tuple(x.to(dtype) for x in f["before"]), add)


def stats_gaps(stats, ref):
    """(cells whose count differs, the largest gap in mm of a cell's mean,
    root mean square, largest or smallest z over the cells whose count
    agrees)."""
    cnt, rc = stats[0].double(), ref[0].double()
    same = (cnt == rc) & (rc > 0)
    off = int((cnt != rc).sum())
    if not bool(same.any()):
        return off, 0.0
    n = rc[same]
    a = [stats[1].double()[same] / n, (stats[2].double()[same] / n).clamp_min(0).sqrt(),
         stats[3].double()[same], stats[4].double()[same]]
    b = [ref[1].double()[same] / n, (ref[2].double()[same] / n).clamp_min(0).sqrt(),
         ref[3].double()[same], ref[4].double()[same]]
    return off, max(float((x - y).abs().max()) for x, y in zip(a, b)) * 1e3


def ref_occupancy(stats, cell, dtype=torch.float64):
    g, tcfg = cell.config["grid"], cell.config["settings"]["traversability"]
    return ref_grid.thresholded(stats, g["size"], g["resolution"], tcfg["max_slope"],
                                tcfg["ground_clearance"], tcfg["robot_height"],
                                tcfg["security_distance"], tcfg["lethal_threshold"], dtype)


def ref_fi(t, cell, dtype=torch.float64) -> float:
    """The reference's FI value of a sampled tick's query."""
    s = cell.config["settings"]
    c, fcfg = s["camera"], s["fisher_information"]
    dev = t["lm_pos"].device
    R, tt = ref_fisher.camera_pose(t["robot"][0], t["robot"][1], t["yaw"], device=dev)
    aR, at = (x.double() for x in t["anchor"])
    R, tt = aR.T @ R, aR.T @ (tt - at)           # into the SLAM frame
    return ref_fisher.information(t["lm_pos"].double(), t["lm_valid"], R, tt,
                                  (c["fx"], c["fy"], c["cx"], c["cy"]), c["width"], c["height"],
                                  fcfg["max_landmark_distance"], fcfg["measurement_noise"],
                                  fcfg["saturation_exponent"], dtype)


def fi_gap(value: float, ref: float, threshold: float) -> float:
    """A FI value's gap from the reference's, over the larger of the
    reference's and the gate's threshold."""
    return abs(value - ref) / max(abs(ref), threshold)


def compare(probe: Probe, landmarks, cell: core.Cell):
    """The numbers the cell's limits hold: the camera's largest pixel gap,
    the frontend checks' worst readings, the EKF's largest position gap,
    the largest potential gap of a sampled plan, the fusion's cells off and
    statistics gap, the grid's cells off, the FI gate's largest relative
    gap; and how many of each were sampled. Beside them, not judged, as the
    control does not separate from sound runs there (PERF.md): the worst
    pose gap of the stereo cells' check, and the largest descent excess of
    a sampled plan against the reference potential."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings, sim = cell.config["settings"], cell.config["sim"]
    cam = st.camera(settings, landmarks.device)
    out = {"camera_gap": 0.0, "kp_unmatched": 0.0, "desc_bits_off": 0.0, "depth_gap_px": 0.0,
           "ekf_gap_mm": 0.0, "pot_gap_m": 0.0, "fuse_cells_off": 0, "fuse_gap_mm": 0.0,
           "grid_cells_off": 0, "fi_gap": 0.0}
    excess = pose = 0.0
    for snap in probe.frames:
        left, right = worlds.render_stereo(cam, landmarks, snap["R"], snap["t"], cam.width,
                                           cam.height, max_depth=sim["camera_max_depth"])
        out["camera_gap"] = max(out["camera_gap"], float((snap["left"] - left).abs().max()),
                                float((snap["right"] - right).abs().max()))
        g = st.frontend_gaps(snap, left, right, settings)
        for key in ("kp_unmatched", "desc_bits_off", "depth_gap_px"):
            out[key] = max(out[key], g[key])
        pose = max(pose, st.pose_gap(snap, g, settings)[0] * 1e3)
    for e in probe.ekfs:
        out["ekf_gap_mm"] = max(out["ekf_gap_mm"], max(ekf_gaps(e)) * 1e3)
    n_pot = 0
    for p in probe.plans:
        excess = max(excess, plan_excess(p, cell))
        if p["pot"] is not None:
            n_pot += 1
            out["pot_gap_m"] = max(out["pot_gap_m"], potential_gap(p["pot"], ref_potential(p, cell)))
    for f in probe.fusions:
        off, gap = stats_gaps(f["after"], fused_stats(f, cell))
        out["fuse_cells_off"] = max(out["fuse_cells_off"], off)
        out["fuse_gap_mm"] = max(out["fuse_gap_mm"], gap)
    for gr in probe.grids:
        off = int((ref_occupancy(gr["stats"], cell) != gr["occ"]).sum())
        out["grid_cells_off"] = max(out["grid_cells_off"], off)
    thr = settings["fisher_information"]["threshold"]
    n_fi = 0
    for t in probe.ticks:
        v = float(t["vals"][7])
        if v > -1e29:                         # the tick asked the device oracle
            n_fi += 1
            out["fi_gap"] = max(out["fi_gap"], fi_gap(v, ref_fi(t, cell), thr))
    out.update(sampled_frames=len(probe.frames), sampled_ekf=len(probe.ekfs),
               sampled_plans=n_pot, sampled_fusions=len(probe.fusions),
               sampled_grids=len(probe.grids), sampled_fi=n_fi)
    gc.collect()
    return out, {"plans_in_window": probe.n_plans, "ticks_in_window": probe.n_ticks,
                 "plan_excess_m": excess, "pose_gap_mm": pose}


def control_run(cell: core.Cell, seed: int, dev):
    """(the program's readings, the control's) on one seed: one mission at
    the cell's size sampled as a run samples its window, and the reference
    computed in bfloat16 in the program's place."""
    cfg, spec, landmarks, camera = prepare(cell, dev)
    tr = cell.traffic
    probe = Probe(tr, seed)
    m = Mission(cell, cfg, spec, camera, dev)
    probe.attach(m)
    for _ in range(tr["steps"]):
        m.step(lambda name, fn: fn(), probe)
    del m
    prog, seen = compare(probe, landmarks, cell)
    bf16 = torch.bfloat16
    settings, sim = cell.config["settings"], cell.config["sim"]
    cam = st.camera(settings, landmarks.device)
    ctl: Dict[str, float] = {}

    def worst(k, v):
        ctl[k] = max(ctl.get(k, 0.0), v)

    for snap in probe.frames:
        left, right = worlds.render_stereo(cam, landmarks, snap["R"], snap["t"], cam.width,
                                           cam.height, max_depth=sim["camera_max_depth"])
        worst("camera_gap", float((left.to(bf16).float() - left).abs().max()))
        for k, v in st.control_frame(snap, left, right, settings).items():
            worst(k, v)
    for e in probe.ekfs:
        worst("ekf_gap_mm", 1e3 * max(
            float(torch.linalg.norm(ref_ekf.run_rows(x0.double(), P0.double(), rows, bf16)[0]
                                    .double()[:2] - ref_ekf.run_rows(x0.double(), P0.double(),
                                                                     rows)[0][:2]))
            for (x0, P0), rows in zip(((e["pre"][0], e["pre"][1]), (e["pre"][2], e["pre"][3])),
                                      e["rows"])))
    for p in probe.plans:
        size, res, ox, oy = p["spec"]
        low = ref_potential(p, cell, bf16)
        worst("pot_gap_m", potential_gap(low, ref_potential(p, cell)))
        path = ref_plan.descend(low, res, ox, oy, p["robot"])
        worst("plan_excess_m", plan_excess(dict(p, path=np.array(path).reshape(-1, 2)), cell))
    for f in probe.fusions:
        off, gap = stats_gaps(fused_stats(f, cell, bf16), fused_stats(f, cell))
        worst("fuse_cells_off", off)
        worst("fuse_gap_mm", gap)
    for gr in probe.grids:
        worst("grid_cells_off", int((ref_occupancy(gr["stats"], cell, bf16)
                                     != ref_occupancy(gr["stats"], cell)).sum()))
    thr = settings["fisher_information"]["threshold"]
    for t in probe.ticks:
        if float(t["vals"][7]) > -1e29:
            worst("fi_gap", fi_gap(ref_fi(t, cell, bf16), ref_fi(t, cell), thr))
    return {**prog, **seen}, ctl
