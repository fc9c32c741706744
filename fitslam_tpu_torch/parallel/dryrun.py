"""The multi-device dry run on N ranks (port of ``__graft_entry__.dryrun_multichip``):

    python -m fitslam_tpu_torch.parallel.dryrun N [--cpu] [--backend gloo|nccl] [--device DEV]

Every rank runs the same nine stages at tiny shapes, and the run holds them
to the reference's asserts:

1. observation-sharded BA and 2. landmark-sharded BA on the same problem;
3. the frame-batch ORB frontend, one frame a rank (K1);
4. point-sharded grid fusion; 5. frontier-sharded arrival raycast;
6. edge-sharded pose-graph optimization;
7. one SLAM backend step, replicated on every rank;
8. the frontend | backend stage pipeline on the first two ranks;
9. the live loop-closing GBA (``slam_map.global_ba_dist``) over all ranks.

The ranks run as spawned processes (``mesh.launch``). ``--cpu`` puts them
on the CPU with gloo; by default they share card 0 with gloo (NCCL refuses
two ranks on one card); ``--device cuda --backend nccl`` gives each its own
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

BACKEND_KW = dict(
    search_radius=24.0, match_max_hamming=64, min_inliers=8, width=128, height=96,
    pose_iters=4, kf_min_interval=1, kf_translation=0.1, kf_rotation=0.1,
    kf_min_tracked_ratio=0.25, ba_window=4, ba_max_obs=1024, ba_iters=2, cull_min_obs=1,
)


def small_setup(width: int, height: int, device):
    """``__graft_entry__._small_setup``: the config, intrinsics and one
    rendered stereo pair of the corridor world of seed 0."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=width, height=height, fx=0.625 * width,
                                   fy=0.625 * width, cx=width / 2, cy=height / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=512, num_levels=2, fast_threshold=12.0),
    )
    K = Intrinsics.from_config(cfg.camera, device)
    world = synthetic.corridor_world(prng.prng_key(0), num=1200, length=25.0, width=5.0,
                                     device=device)
    T = synthetic.straight_trajectory(2, length=0.3, height=1.2, start_x=0.5, device=device)
    left, right = synthetic.render_dense(K, world.landmarks, lie.SE3(T.R[0], T.t[0]),
                                         width=width, height=height, splat_sigma=1.2,
                                         max_depth=18.0)
    return cfg, K, left, right


def run_stages(n: int) -> dict:
    """The nine stages on this rank of an ``n``-rank process group; returns
    their figures and this rank's kernel launches."""
    import torch.distributed as dist

    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.models.slam_step import _backend_body
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops import lie, orb, pallas_matching
    from fitslam_tpu_torch.ops import pgo as pgo_mod
    from fitslam_tpu_torch.parallel import dist_ba, dist_stages as ds, mesh as mesh_mod
    from fitslam_tpu_torch.parallel.multihost import build_problem
    from fitslam_tpu_torch.utils import prng

    mesh = mesh_mod.make_mesh(n, axis_names=("data",))
    dev, rank = mesh.device, mesh.rank
    orb.describe_keypoints.launches = 0
    pallas_matching.hamming_top2.launches = 0
    up = lambda a, **kw: torch.as_tensor(a, device=dev, **kw)

    # 1-2. a tiny BA problem, observations sharded, then landmarks sharded
    K, prob = build_problem(0, n_kf=4, n_lm=64, n_obs=64 * n, device=dev, focal=100.0)
    _, chis = dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=3)
    packed = dist_ba.shard_problem_by_landmark(prob, n)
    _, chis_lm = dist_ba.landmark_sharded_bundle_adjust(mesh, K, packed, iters=3)

    # 3. frame-batch data-parallel ORB frontend: one frame a rank
    key = prng.prng_key(0)
    imgs = prng.uniform(prng.fold_in(key, 5), (n, 96, 128), 0.0, 255.0)
    feats = orb.extract_orb(up(imgs[rank]), num_features=64, num_levels=1)
    desc = mesh.all_gather(feats.desc.float()[None])

    # 4. point-sharded grid fusion
    spec = gr.GridSpec2D(size=32, resolution=0.25, origin_x=-4.0, origin_y=-4.0)
    pts_w = up(prng.uniform(prng.fold_in(key, 6), (128 * n, 3), -3.0, 3.0))
    grid_out = ds.sharded_fuse_clouds(mesh, spec, pts_w,
                                      torch.ones((128 * n,), dtype=torch.bool, device=dev))
    grid_known = int((grid_out.cost != gr.UNKNOWN).sum())

    # 5. frontier-sharded arrival-information raycast
    occ = up(np.where(prng.bernoulli(prng.fold_in(key, 7), 0.1, (32, 32)),
                      np.uint8(gr.LETHAL), np.uint8(gr.FREE)))
    n_frontiers = 8 * n
    fxy = up(prng.uniform(prng.fold_in(key, 8), (n_frontiers, 2), -3.0, 3.0))
    _, arrival = ds.sharded_arrival_information(
        mesh, spec, occ, fxy, torch.ones((n_frontiers,), dtype=torch.bool, device=dev))

    # 6. edge-sharded pose-graph optimization
    K_pgo = 8
    T_pgo_gt = lie.se3_exp(up(np.float32(0.3) * prng.normal(prng.fold_in(key, 9), (K_pgo, 6))))
    T_pgo0 = lie.compose(lie.se3_exp(up(np.float32(0.05) * prng.normal(
        prng.fold_in(key, 10), (K_pgo, 6)))), T_pgo_gt)
    pgo_edges = pgo_mod.odometry_edges(T_pgo_gt, up(K_pgo, dtype=torch.int32), 2 * n)
    _, chis_pgo = ds.distributed_pose_graph(
        mesh, T_pgo0, torch.ones((K_pgo,), dtype=torch.bool, device=dev), pgo_edges,
        torch.arange(K_pgo, device=dev) == 0, iters=4)

    # 7. one SLAM backend step, the map replicated on every rank
    cfg_s, K_s, left_s, right_s = small_setup(128, 96, dev)
    o = cfg_s.orb
    frame_s = tr.process_stereo(K_s, left_s, right_s, num_features=128, num_levels=1,
                                scale_factor=o.scale_factor, fast_threshold=o.fast_threshold)
    zero_i32 = torch.zeros((), dtype=torch.int32, device=dev)
    m_s = sm.empty_map(8, 512, 1024, device=dev)
    m_s = sm.insert_keyframe(m_s, K_s, lie.SE3.identity(device=dev), frame_s.feats,
                             frame_s.depth, torch.full((128,), -1, dtype=torch.int32, device=dev),
                             zero_i32, torch.zeros((256,), device=dev))
    st_s = tr.mark_keyframe(tr.init_track_state(dev), zero_i32)
    backend_kw = dict(BACKEND_KW, scale_factor=o.scale_factor)
    m2_s, _, outs_s, _, _ = _backend_body(K_s, m_s, st_s, frame_s, 1, initialized=True,
                                          **backend_kw)

    # 8. the frontend | backend stage pipeline on the first two ranks
    stage_mesh = mesh_mod.make_mesh(2, axis_names=("stage",))
    pipe_inl = None
    if stage_mesh.rank >= 0:
        frames_lr = torch.stack([torch.stack([left_s, right_s])] * 3)
        _, _, outs_pipe = ds.stage_pipelined_slam(
            stage_mesh, K_s, m_s, st_s, frames_lr, num_features=128, num_levels=1,
            scale_factor=o.scale_factor, fast_threshold=o.fast_threshold,
            backend_kwargs=backend_kw)
        pipe_inl = int(outs_pipe.n_inliers[-1])

    # 9. the live loop-closing GBA, landmark-sharded over every rank
    _, gba_chis = sm.global_ba_dist(m2_s, K_s, mesh, iters=3)
    dist.barrier()
    f = lambda c: [float(v) for v in c.cpu()]
    return dict(rank=rank, n=n, chis=f(chis), chis_lm=f(chis_lm), desc=desc.cpu(),
                grid_known=grid_known, arrival=f(arrival), chis_pgo=f(chis_pgo),
                backend_inliers=int(outs_s.n_inliers), pipe_inliers=pipe_inl,
                pipe_frames=3, gba_chis=f(gba_chis),
                launches={"describe": orb.describe_keypoints.launches,
                          "top2": pallas_matching.hamming_top2.launches})


def check(results: list) -> str:
    """The reference's asserts on rank 0's figures (every rank's must agree
    where the reference's are replicated); returns the summary line."""
    r = results[0]
    for other in results[1:]:
        for k in ("chis", "chis_lm", "grid_known", "arrival", "chis_pgo", "gba_chis"):
            if other[k] != r[k]:
                raise AssertionError(f"rank {other['rank']}'s {k} differs from rank 0's")
    c, c_lm, c_pgo, c_gba = r["chis"], r["chis_lm"], r["chis_pgo"], r["gba_chis"]
    line = (f"[dryrun] mesh=(('data', {r['n']}),) BA(obs-sharded) chi2 {c[0]:.1f} -> "
            f"{c[-1]:.1f} ok; BA(landmark-sharded) chi2 {c_lm[0]:.1f} -> {c_lm[-1]:.1f} ok; "
            f"ORB batch {tuple(r['desc'].shape)} ok; grid-fusion(point-sharded) "
            f"known={r['grid_known']} ok; frontier-raycast(frontier-sharded) "
            f"F={len(r['arrival'])} ok; PGO(edge-sharded) chi2 {c_pgo[0]:.2e} -> "
            f"{c_pgo[-1]:.2e} ok; backend-step(replicated) inliers={r['backend_inliers']} ok; "
            f"stage-pipeline(frontend|backend over 2 ranks, broadcast handoff) "
            f"frames={r['pipe_frames']} inliers={r['pipe_inliers']} ok; GBA(live, "
            f"landmark-sharded) chi2 {c_gba[0]:.1f} -> {c_gba[-1]:.1f} ok")
    assert c[-1] <= c[0]
    assert c_gba[-1] <= c_gba[0] or c_gba[-1] < 1.0
    assert c_lm[-1] <= c_lm[0]
    assert c_pgo[-1] <= c_pgo[0]
    assert r["grid_known"] > 0
    assert r["pipe_inliers"] > 0
    return line


def dryrun(n: int, backend: str = "gloo", device: str = "cuda:0", timeout: float = 600.0):
    """Run the nine stages on ``n`` spawned ranks, check them, print the
    summary line; returns every rank's figures. By default every rank shares
    card 0 over gloo, as the command line does; ``device="cpu"`` for the CPU."""
    from fitslam_tpu_torch.parallel import mesh as mesh_mod

    if n < 2:
        raise ValueError("the dry run needs at least 2 ranks (the stage pipeline takes 2)")
    results = mesh_mod.launch(run_stages, n, n, backend=backend, device=device,
                              timeout=timeout)
    print(check(results), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The multi-device dry run on N ranks.")
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (at least 2)")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU (gloo)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="cuda:0 (default: every rank on card 0), cuda (card r for rank r, "
                         "with nccl) or cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cpu" if args.cpu else "cuda:0")
    if args.cpu and device != "cpu":
        ap.error("--cpu goes with --device cpu")
    dryrun(args.n, backend=args.backend, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
