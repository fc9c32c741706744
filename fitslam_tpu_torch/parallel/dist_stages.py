"""Mesh-sharded variants of the non-BA stages (port of
``fitslam_tpu/parallel/dist_stages.py``):

- grid fusion: cloud points sharded over the ranks; per-cell aggregates are
  associative, so each rank reduces its shard and one sum (count, sum z, sum
  z^2 in one buffer), one max and one min fuse the global grid, whose
  classification tail runs replicated;
- arrival-information sweep: frontiers sharded; the (F, R, S) raycast is
  independent per frontier against the replicated occupancy, and one
  all-gather brings the (F,) results back (exact);
- pose-graph optimization: edges sharded; each rank assembles its edges'
  6x6 blocks in the reference's scatter order (``numerics.segment_sum_fixed``)
  and one reduction an iteration sums H and b, one more the current and
  candidate chi2; the (6K, 6K) solve runs replicated;
- the frontend | backend stage pipeline: rank 0 of a 2-rank ``stage`` axis
  runs the image frontend (K1 twice, K2 stereo) on frame t while rank 1 runs
  the map backend (K2 window) on frame t-1; each frame crosses as one
  broadcast of the ``StereoFrame`` packed into one byte buffer, and the
  backend's results come back to rank 0 in one more.

The reference compiles each of them into one program; here a rank's device
work between two collectives is a captured region (``utils/jit.py``) in a
slot kept on the mesh (``Mesh.solver_state``), replayed at every later call
of the same shapes, and the collectives run between the regions, outside
every graph (as ``parallel/dist_ba.py``): fusion ``fuse_shard`` -> sum, max,
min -> ``fuse_grid``; the raycast ``arrival_shard`` -> all-gather; PGO
``pgo_assemble`` -> sum -> ``pgo_solve`` -> sum; the pipeline's rank 0
``frontend_stereo`` (its output the packed handoff) -> broadcast, rank 1
``models/slam_step.py``'s regions (``track``, ``keyframe``, ``compact``,
``finish``, ...) on the received frame. The collectives are synchronous
(``async_op=False``): on the host for gloo, and on the current stream for
nccl, whose work the current stream waits for, so no replay overwrites a
buffer a collective still reads or writes. ``capture=False`` runs the same
region functions as plain PyTorch; the two are bit-equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops import pgo as pgo_mod
from fitslam_tpu_torch.ops import raycast as raycast_mod
from fitslam_tpu_torch.ops.grid import GridSpec2D, TraversabilityGrid, cell_stats, stats_to_grid
from fitslam_tpu_torch.ops.numerics import segment_plan, segment_sum_fixed
from fitslam_tpu_torch.parallel.mesh import Mesh, data_sharding, pack, pmax, pmin, psum, unpack
from fitslam_tpu_torch.utils import jit


def fuse_shard_region(pts_w, ok, *, spec: GridSpec2D):
    """Region ``fuse_shard``: this rank's point shard reduced into (G*G,)
    aggregates, count / sum / sum2 stacked for one sum across the ranks,
    the z-extrema for one max and one min. Returns (sums, z_max, z_min)."""
    cnt, s_z, s_z2, z_mx, z_mn = cell_stats(spec, pts_w, ok)
    return (), (torch.stack([cnt, s_z, s_z2]), z_mx, z_mn)


def fuse_grid_region(sums, z_mx, z_mn, *, spec: GridSpec2D, max_slope: float,
                     ground_clearance: float, robot_height: float, security_distance: float):
    """Region ``fuse_grid``: the stencil and classification tail on the
    fused aggregates (replicated). Returns the grid."""
    cnt, s_z, s_z2 = sums
    return (), stats_to_grid(spec, (cnt, s_z, s_z2, z_mx, z_mn), max_slope=max_slope,
                             ground_clearance=ground_clearance, robot_height=robot_height,
                             security_distance=security_distance)


def sharded_fuse_clouds(
    mesh: Mesh,
    spec: GridSpec2D,
    pts_w: torch.Tensor,   # (N, 3) world points, N divisible by the mesh axis
    ok: torch.Tensor,      # (N,) bool
    max_slope: float = 0.7,
    ground_clearance: float = 0.17,
    robot_height: float = 1.5,
    security_distance: float = 0.6,
    axis: str = "data",
    capture: bool = True,
) -> TraversabilityGrid:
    """Point-sharded traversability fusion: each rank reduces its point
    shard into (G*G,) aggregates (region ``fuse_shard``); count / sum / sum2
    combine by one sum, the z-extrema by a max and a min; the stencil and
    classification tail (region ``fuse_grid``) runs on every rank. The grid
    returned is a copy: a later call replays into the regions' buffers.
    ``capture=False`` runs the regions as plain PyTorch."""
    n_dev = mesh.shape[axis]
    N = pts_w.shape[0]
    assert N % n_dev == 0, f"point count {N} not divisible by mesh axis {n_dev}"
    pts_shard, ok_shard = data_sharding(mesh, axis)((pts_w, ok))
    kw = dict(max_slope=max_slope, ground_clearance=ground_clearance,
              robot_height=robot_height, security_distance=security_distance)
    st = mesh.solver_state("sharded_fuse_clouds", (spec, N, *kw.values()), axis, {}, capture)
    _, (sums, z_mx, z_mn) = st.run("fuse_shard", functools.partial(fuse_shard_region, spec=spec),
                                   pts_shard, ok_shard)
    sums = psum(mesh, sums, axis)
    z_mx, z_mn = pmax(mesh, z_mx, axis), pmin(mesh, z_mn, axis)
    _, grid = st.run("fuse_grid", functools.partial(fuse_grid_region, spec=spec, **kw),
                     sums, z_mx, z_mn)
    return st.snapshot(grid)


def arrival_shard_region(occ, points_xy, valid, *, spec: GridSpec2D, depth_m: float,
                         n_rays: int, n_steps: int, fov_rad: float):
    """Region ``arrival_shard``: the raycast of this rank's frontier shard
    against the replicated occupancy, (F/n, 2) heading and information
    stacked for one all-gather."""
    heading, info = raycast_mod.arrival_information(
        spec, occ, points_xy, valid, depth_m=depth_m, n_rays=n_rays, n_steps=n_steps,
        fov_rad=fov_rad)
    return (), torch.stack([heading, info], dim=1)


def sharded_arrival_information(
    mesh: Mesh,
    spec: GridSpec2D,
    occ: torch.Tensor,          # (G, G) occupancy, replicated
    points_xy: torch.Tensor,    # (F, 2) frontier goals, F divisible by the axis
    valid: torch.Tensor,        # (F,) bool
    depth_m: float = 2.0,
    n_rays: int = 64,
    n_steps: int = 16,
    fov_rad: float = 1.04,
    axis: str = "data",
    capture: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frontier-sharded 360° arrival-information sweep: each rank raycasts
    its frontier shard against the replicated occupancy (region
    ``arrival_shard``); one all-gather returns the full (F,) headings and
    information on every rank (fresh tensors). ``capture=False`` runs the
    region as plain PyTorch."""
    n_dev = mesh.shape[axis]
    F = points_xy.shape[0]
    assert F % n_dev == 0, f"frontier count {F} not divisible by mesh axis {n_dev}"
    xy_shard, valid_shard = data_sharding(mesh, axis)((points_xy, valid))
    kw = dict(depth_m=depth_m, n_rays=n_rays, n_steps=n_steps, fov_rad=fov_rad)
    st = mesh.solver_state("sharded_arrival_information", (spec, F, *kw.values()), axis, {},
                           capture)
    _, both = st.run("arrival_shard", functools.partial(arrival_shard_region, spec=spec, **kw),
                     occ, xy_shard, valid_shard)
    both = mesh.all_gather(both, axis)
    return both[:, 0], both[:, 1]


def _robust_edges(T: lie.SE3, e: pgo_mod.PoseGraphEdges, i, j, valid_f, huber_delta: float):
    """Each edge's poses, residual, robust weight and squared residual at T."""
    Ti, Tj = lie.SE3(T.R[i], T.t[i]), lie.SE3(T.R[j], T.t[j])
    r = pgo_mod.edge_residual(Ti, Tj, e.T_ij)
    r2 = torch.sum(r * r, dim=-1)
    w_rob = torch.where(r2 > huber_delta ** 2,
                        huber_delta / torch.sqrt(torch.clamp(r2, min=1e-12)),
                        torch.ones_like(r2))
    return Ti, Tj, r, e.weight * w_rob * valid_f, r2


def _pgo_accept(chi2, T_new, T):
    """T_new where its chi2 (``chi2[1]``) is finite and below T's
    (``chi2[0]``), else T."""
    accept = torch.isfinite(chi2[1]) & (chi2[1] < chi2[0])
    return lie.SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))


def pgo_assemble_region(T, cand_T, chi2, e, i, j, valid_f, h_plan, b_plan, *,
                        huber_delta: float):
    """Region ``pgo_assemble``: the previous step accepted or not, then this
    rank's edges' 6x6 blocks summed in the reference's scatter order, H and
    b flat for one reduction. Writes T."""
    K_n = T.t.shape[0]
    T = _pgo_accept(chi2, cand_T, T)
    Ti, Tj, r, w, _ = _robust_edges(T, e, i, j, valid_f, huber_delta)
    Ji, Jj = pgo_mod.edge_jacobians(Ti, Tj, e.T_ij)
    Hii = torch.einsum("e,eri,erj->eij", w, Ji, Ji)
    Hjj = torch.einsum("e,eri,erj->eij", w, Jj, Jj)
    Hij = torch.einsum("e,eri,erj->eij", w, Ji, Jj)
    bi = -torch.einsum("e,eri,er->ei", w, Ji, r)
    bj = -torch.einsum("e,eri,er->ei", w, Jj, r)
    H = segment_sum_fixed(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), None,
                          K_n * K_n, h_plan)
    b = segment_sum_fixed(torch.cat([bi, bj]), None, K_n, b_plan)
    return (T,), torch.cat([H.reshape(-1), b.reshape(-1)])


def pgo_solve_region(T, cand_T, Hb, free, diag, eye6, e, i, j, valid_f, *, damping: float,
                     huber_delta: float):
    """Region ``pgo_solve``: the gauge and damping on the summed system, the
    replicated (6K, 6K) solve, the step clamp, the candidate and the local
    chi2 of T and of the candidate (one more reduction). Writes the
    candidate."""
    K_n = T.t.shape[0]
    H = Hb[:K_n * K_n * 36].reshape(K_n, K_n, 6, 6)
    b = Hb[K_n * K_n * 36:].reshape(K_n, 6)
    H = H * free[:, None, None, None] * free[None, :, None, None]
    H[diag, diag] = H[diag, diag] + eye6 * torch.where(free > 0, damping, 1.0)[:, None, None]
    b = b * free[:, None]
    H_mat = H.permute(0, 2, 1, 3).reshape(K_n * 6, K_n * 6)
    dx = torch.linalg.solve_ex(H_mat, b.reshape(-1))[0].reshape(K_n, 6)
    dx = dx * free[:, None]
    n = torch.linalg.norm(dx, dim=-1, keepdim=True)
    dx = dx * torch.clamp(1.0 / torch.clamp(n, min=1e-12), max=1.0)

    T_new = lie.compose(lie.se3_exp(dx), T)
    local = torch.stack([torch.sum(w * r2) for _, _, _, w, r2 in (
        _robust_edges(T, e, i, j, valid_f, huber_delta),
        _robust_edges(T_new, e, i, j, valid_f, huber_delta))])
    return (None, T_new), local


def distributed_pose_graph(
    mesh: Mesh,
    T_cw: lie.SE3,                  # (K,) poses, replicated
    kf_valid: torch.Tensor,         # (K,) bool
    edges: pgo_mod.PoseGraphEdges,  # edge table, E divisible by the axis
    fixed: torch.Tensor,            # (K,) bool gauge
    iters: int = 8,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
    axis: str = "data",
    capture: bool = True,
) -> Tuple[lie.SE3, torch.Tensor]:
    """Edge-sharded pose-graph Gauss-Newton: each edge's residual and
    Jacobians (``pgo.edge_jacobians``, forward mode in float64) stay on the
    rank owning the edge; the dense (K, K, 6, 6) Hessian and b cross in one
    reduction an iteration and the two chi2 in one more; the (6K, 6K) solve
    is replicated. Returns (poses, chi2 history) on every rank.

    The device work between the reductions runs as two captured regions,
    ``pgo_assemble`` and ``pgo_solve``, whose slot lives on the mesh (as the
    sharded BA's, ``parallel/dist_ba.py``); the first accept is a no-op and
    the last runs eagerly. ``capture=False`` runs the regions as plain
    PyTorch."""
    n_dev = mesh.shape[axis]
    E = edges.valid.shape[0]
    assert E % n_dev == 0, f"edge capacity {E} not divisible by mesh axis {n_dev}"
    K_n = T_cw.t.shape[0]
    dev = T_cw.t.device
    e = data_sharding(mesh, axis)(edges)
    i, j = e.i.long(), e.j.long()
    # this rank's edges are fixed across iterations, so are its sums' orders:
    # the reference's scatters ii, jj, ij, ji, then i, j
    h_ids = torch.cat([i * K_n + i, j * K_n + j, i * K_n + j, j * K_n + i])
    st = mesh.solver_state(
        "distributed_pose_graph", (K_n, E, damping, huber_delta), axis,
        dict(T=T_cw, cand_T=T_cw, chi2=torch.full((2,), float("inf"), device=dev), edges=e,
             i=i, j=j, valid_f=e.valid.to(torch.float32), h_plan=segment_plan(h_ids, K_n * K_n),
             b_plan=segment_plan(torch.cat([i, j]), K_n),
             free=(torch.logical_not(fixed) & kf_valid).to(torch.float32),
             diag=torch.arange(K_n, device=dev),
             eye6=torch.eye(6, dtype=torch.float32, device=dev)), capture)
    assemble = functools.partial(pgo_assemble_region, huber_delta=huber_delta)
    solve = functools.partial(pgo_solve_region, damping=damping, huber_delta=huber_delta)
    edge_args = lambda: (st["edges"], st["i"], st["j"], st["valid_f"])
    pairs = []
    for _ in range(iters):
        (st["T"], *_), Hb = st.run("pgo_assemble", assemble, st["T"], st["cand_T"], st["chi2"],
                                   *edge_args(), st["h_plan"], st["b_plan"])
        # the one cross-rank reduction of the assembly: edge terms -> global H, b
        Hb = psum(mesh, Hb, axis)
        args, local = st.run("pgo_solve", solve, st["T"], st["cand_T"], Hb, st["free"],
                             st["diag"], st["eye6"], *edge_args())
        st["cand_T"] = args[1]
        pair = psum(mesh, local, axis)
        st["chi2"] = pair
        pairs.append(pair)
    T = _pgo_accept(st["chi2"], st["cand_T"], st["T"])
    # each iteration's chi2: the candidate's where accepted, else the current's
    c_old, c_new = torch.stack(pairs).unbind(-1)
    accept = torch.isfinite(c_new) & (c_new < c_old)
    return T, torch.where(accept, c_new, c_old)


# ---------------------------------------------------------------------------
# Cross-device frontend | backend stage pipeline
# ---------------------------------------------------------------------------


def _zero_frame(num_features: int, device):
    """A StereoFrame of zeros: the layout of the handoff's byte buffer."""
    from fitslam_tpu_torch.models.tracking import StereoFrame
    from fitslam_tpu_torch.ops.orb import FrameFeatures

    N = num_features
    f32 = dict(dtype=torch.float32, device=device)
    return StereoFrame(
        feats=FrameFeatures(xy=torch.zeros((N, 2), **f32), response=torch.zeros((N,), **f32),
                            angle=torch.zeros((N,), **f32),
                            level=torch.zeros((N,), dtype=torch.int32, device=device),
                            desc=torch.zeros((N, 256), dtype=torch.bfloat16, device=device),
                            valid=torch.zeros((N,), dtype=torch.bool, device=device)),
        depth=torch.zeros((N,), **f32))


def _zero_outputs(T: int, device):
    """(T,) stacked StepOutputs of zeros: the layout of the results' buffer."""
    from fitslam_tpu_torch.models.slam_step import StepOutputs

    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return StepOutputs(
        n_inliers=torch.zeros((T,), **i32), was_keyframe=torch.zeros((T,), dtype=torch.bool,
                                                                    device=device),
        kf_idx=torch.zeros((T,), **i32), pose_wc=torch.zeros((T, 4, 4), **f32),
        ref_kf=torch.zeros((T,), **i32), ref_T_cw_R=torch.zeros((T, 3, 3), **f32),
        ref_T_cw_t=torch.zeros((T, 3), **f32), loop_cand=torch.zeros((T,), **i32),
        loop_score=torch.zeros((T,), **f32))


def _like(tree, like):
    """``tree`` with each tensor cast to the dtype of its counterpart in ``like``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(like.dtype)
    return type(tree)(*(_like(a, b) for a, b in zip(tree, like)))


def frontend_stereo_region(K, left, right, *, frame_like, num_features: int, num_levels: int,
                           scale_factor: float, fast_threshold: float):
    """Region ``frontend_stereo`` of the pipeline's rank 0: the image
    frontend (``tracking.process_stereo``, as ``StereoSlam``'s region of that
    name) on one stereo pair, its ``StereoFrame`` packed into the handoff's
    byte buffer (the dtypes of ``frame_like``): the region's output is what
    the broadcast sends."""
    from fitslam_tpu_torch.models import tracking as tr_mod

    f = tr_mod.process_stereo(K, left, right, num_features=num_features,
                              num_levels=num_levels, scale_factor=scale_factor,
                              fast_threshold=fast_threshold)
    return (), pack(_like(f, frame_like))


def stage_pipelined_slam(
    mesh: Mesh,
    K,                             # Intrinsics (replicated)
    m,                             # SlamMap initial state
    state,                         # TrackState initial
    frames_lr: torch.Tensor,       # (T, 2, H, W) stereo image stream
    *,
    num_features: int,
    num_levels: int,
    scale_factor: float,
    fast_threshold: float,
    backend_kwargs: dict,
    axis: str = "stage",
    capture: bool = True,
):
    """Two-stage SLAM pipeline over the two ranks of the ``axis`` mesh.

    Rank 0 (stage 0) runs the image frontend on frame t while rank 1 (stage
    1) runs the map backend on frame t-1's features; the map never leaves
    rank 1 and the images are not needed there. T + 1 steps: step 0 is the
    fill (backend idle), step T the drain (frontend idle). In steady state a
    step takes max(frontend, backend) instead of their sum.

    Captured, each rank's work between the broadcasts replays regions of a
    slot on the mesh: rank 0 ``frontend_stereo``, whose packed output is
    the broadcast's buffer; rank 1 the backend step's regions
    (``slam_step.backend_step``) on the received frame, the map, tracker
    state and frame id in the slot's buffers, its host reads the step's
    own. ``capture=False`` runs the same functions as plain PyTorch.

    Returns (final map, final tracker state, StepOutputs for frames 0..T-1
    stacked along a leading axis) as the backend saw them, on both ranks."""
    from fitslam_tpu_torch.models import slam_step as step_mod

    assert mesh.shape[axis] == 2, f"stage pipeline needs a 2-wide '{axis}' axis"
    T = frames_lr.shape[0]
    dev = frames_lr.device
    frame_like = _zero_frame(num_features, dev)
    outs_like = _zero_outputs(T, dev)
    frame_buf = torch.empty_like(pack(frame_like))
    orb_kw = dict(num_features=num_features, num_levels=num_levels, scale_factor=scale_factor,
                  fast_threshold=fast_threshold)
    # the regions' shapes and the settings they bake in
    key = (tuple(frames_lr.shape[1:]), tuple(orb_kw.values()), m.capacity,
           tuple(m.kf_signature.shape), tuple(sorted(backend_kwargs.items())))
    if mesh.axis_index(axis) == 0:
        st = mesh.solver_state("stage_pipelined_slam", key, axis, dict(K=K), capture)
        if capture:
            st.claim()                   # the regions read K where it lies
        frontend = functools.partial(frontend_stereo_region, frame_like=frame_like, **orb_kw)
        for t in range(T):
            _, buf = st.run("frontend_stereo", frontend, st["K"], frames_lr[t, 0],
                            frames_lr[t, 1])
            if buf.numel() != frame_buf.numel():
                raise ValueError(f"the frontend's frame packs to {buf.numel()} bytes, the "
                                 f"handoff holds {frame_buf.numel()}")
            # the handoff: stage 0's fresh features -> stage 1's next turn
            mesh.broadcast(buf, 0, axis)
        result_like = (m, state, outs_like)
        buf = mesh.broadcast(torch.empty_like(pack(result_like)), 1, axis)
        return unpack(buf, result_like)

    st = mesh.solver_state(
        "stage_pipelined_slam", key, axis,
        dict(K=K, map=m, state=state, frame_id=torch.zeros((), dtype=torch.int32, device=dev)),
        capture)
    fid_buf = st.claim().buffers["frame_id"] if capture else None
    # the tracker's initialized flag, mirrored on the host as StereoSlam does
    initialized = bool(state.initialized.item())
    feat_prev, outs = None, []
    for t in range(T + 1):
        if t >= 1:
            m_c, st_c, o, _, inserted, _ = step_mod.backend_step(
                st.run, st["K"], st["map"], st["state"], feat_prev, t - 1,
                initialized=initialized, frame_id_buf=fid_buf, **backend_kwargs)
            st["map"], st["state"] = m_c, st_c
            initialized = initialized or inserted
            # kept: the next frame's regions overwrite their outputs
            outs.append(st.snapshot(o))
        if t < T:
            feat_prev = unpack(mesh.broadcast(frame_buf, 0, axis), frame_like)
    stacked = type(outs_like)(*(torch.stack(v) for v in zip(*outs)))
    keep = jit.clone if capture else (lambda tree: tree)
    result = (keep(st["map"]), keep(st["state"]), _like(stacked, outs_like))
    mesh.broadcast(pack(result), 1, axis)
    return result
