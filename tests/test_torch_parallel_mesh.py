"""The port's meshes of ranks (``fitslam_tpu_torch/parallel/mesh.py``) on the
CPU, and the rank-side functions of the other ``test_torch_parallel_*.py``
files.

This file imports no jax: the spawned ranks import it to find the functions
below, and an import of jax in each of them would cost seconds and memory.
Ranks run on the CPU with gloo, one thread each (tier-1 runs six pytest
workers side by side), and meet through a file store in a fresh temporary
directory, so parallel workers never share a port. Inputs cross to the
ranks as port NamedTuples of CPU tensors; results come back on the CPU.
"""

from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fitslam_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(2)


def launch(fn, n, *args):
    """``fn(*args)`` on ``n`` gloo ranks on the CPU."""
    return mesh_mod.launch(fn, n, *args, backend="gloo", device="cpu", timeout=300)


def in_background(fn, *args) -> Future:
    """``fn(*args)`` in a thread, so the ranks a launch spawns run while the
    test computes the reference's side; ``.result()`` waits and re-raises."""
    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args)
    finally:
        pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Rank-side functions (each runs on every rank of a launch)
# ---------------------------------------------------------------------------


def rank_collectives(sizes):
    """Every collective on the first n ranks for each n of ``sizes``."""
    out = {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        r = mesh.rank
        if r < 0:
            continue
        x = torch.arange(3, dtype=torch.float32) + 10 * r
        flags = torch.tensor([r % 2 == 0, True, False])
        tree = (torch.tensor(r, dtype=torch.int32), torch.full((2, 3), r, dtype=torch.bfloat16),
                torch.tensor([True, r == 1]), torch.full((5,), 0.5 * r))
        got = mesh_mod.unpack(mesh.broadcast(mesh_mod.pack(tree), 1), tree)
        out[n] = dict(rank=r, size=mesh.size, sum=mesh_mod.psum(mesh, x),
                      max=mesh_mod.pmax(mesh, x), min=mesh_mod.pmin(mesh, x),
                      gather=mesh.all_gather(x[None]), gather_bool=mesh.all_gather(flags),
                      tree=got, shard=mesh_mod.data_sharding(mesh)(torch.arange(4 * n)),
                      kept=mesh_mod.replicated(mesh)(torch.arange(3)),
                      collectives=mesh.stats["collectives"])
    return out


def rank_fail(n):
    mesh = mesh_mod.make_mesh(n)
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here")
    return mesh.rank


def rank_ba(sizes, K, prob, K_map, m_map, iters):
    """For each n of ``sizes``, on the first n ranks: the observation-sharded
    BA on ``prob`` and, below 8 ranks, the landmark-sharded BA on it and
    ``global_ba_dist`` on ``m_map``, each with its collectives counted.
    Returns {n: results} for the meshes this rank is a member of."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.parallel import dist_ba

    out = {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        if mesh.rank < 0:
            continue
        sol, chis = dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=iters)
        res = dict(obs=(sol.T_cw, sol.points, chis), obs_collectives=mesh.stats["collectives"])
        if n < 8:
            c0 = mesh.stats["collectives"]
            packed = dist_ba.shard_problem_by_landmark(prob, n)
            sol_l, chis_l = dist_ba.landmark_sharded_bundle_adjust(mesh, K, packed, iters=iters)
            res.update(lm=(sol_l.T_cw, sol_l.points, chis_l),
                       lm_collectives=mesh.stats["collectives"] - c0)
            m_d, chis_g = sm.global_ba_dist(m_map, K_map, mesh, iters=iters)
            res.update(gba=(m_d, chis_g))
        out[n] = res
    return out


def rank_fusion(sizes, spec, pts_w, ok):
    """``sharded_fuse_clouds`` on the first n ranks for each n of ``sizes``."""
    from fitslam_tpu_torch.parallel import dist_stages as ds

    out = {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        if mesh.rank >= 0:
            out[n] = ds.sharded_fuse_clouds(mesh, spec, pts_w, ok)
    return out


def rank_stages(sizes, spec, occ, fxy, f_valid, T0, kf_valid, edges, fixed, iters):
    """The frontier-sharded raycast and edge-sharded PGO on the first n ranks
    for each n of ``sizes``."""
    from fitslam_tpu_torch.parallel import dist_stages as ds

    out = {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        if mesh.rank < 0:
            continue
        ray = ds.sharded_arrival_information(mesh, spec, occ, fxy, f_valid)
        c0 = mesh.stats["collectives"]
        T, chis = ds.distributed_pose_graph(mesh, T0, kf_valid, edges, fixed, iters=iters)
        out[n] = dict(ray=ray, pgo=(T, chis), pgo_collectives=mesh.stats["collectives"] - c0)
    return out


def rank_pipeline(K, m, state, frames, kw, backend_kw):
    from fitslam_tpu_torch.parallel import dist_stages as ds

    mesh = mesh_mod.make_mesh(2, axis_names=("stage",))
    out = ds.stage_pipelined_slam(mesh, K, m, state, frames, backend_kwargs=backend_kw, **kw)
    return dict(out=out, broadcasts=mesh.stats["collectives"])


def rank_loop(cfg, K, m, frame, T_est, kf, K_refine, refine_map, refine_kw):
    """The loop closer with a 2-rank mesh on the drifted revisit (its GBA
    landmark-sharded), then ``StereoSlam.refine_map`` with the mesh on
    ``refine_map``; the collectives each issued."""
    from fitslam_tpu_torch.models import loop_closing as lc
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.models.slam import StereoSlam

    mesh = mesh_mod.make_mesh(2)
    closer = lc.LoopCloser(cfg, K)
    closer.mesh = mesh
    state = tr.mark_keyframe(tr.init_track_state("cpu")._replace(T_cw=T_est),
                             torch.zeros((), dtype=torch.int32))
    slam = SimpleNamespace(map=m, last_frame=frame, state=state)
    info = closer.on_keyframe(slam, kf)
    closer_collectives = mesh.stats["collectives"]
    engine = StereoSlam(cfg, "cpu")
    engine.K = K_refine
    engine.map = refine_map
    engine.loop_closer.mesh = mesh
    chi2 = engine.refine_map(**refine_kw)
    return dict(info={k: v for k, v in info.items() if k in ("loop_to", "inliers", "gba_chi2")},
                map=slam.map, state_t=slam.state.T_cw.t, closer_collectives=closer_collectives,
                refined=engine.map, refine_chi2=chi2,
                refine_collectives=mesh.stats["collectives"] - closer_collectives)


# ---------------------------------------------------------------------------
# Tests of the mesh itself
# ---------------------------------------------------------------------------


_collective_runs = []


@pytest.mark.parametrize("n", [2, 4])
def test_collectives(n):
    """all_reduce (sum, max, min), all_gather, broadcast of a packed tree,
    data_sharding and replicated: exact. One launch of 4 ranks serves both
    n, each mesh the first n of them (the 2-rank mesh a subgroup)."""
    if not _collective_runs:
        _collective_runs.extend(launch(rank_collectives, 4, (4, 2)))
    xs = [torch.arange(3, dtype=torch.float32) + 10 * r for r in range(n)]
    for r, got in enumerate(res[n] for res in _collective_runs[:n]):
        assert got["rank"] == r and got["size"] == n
        assert torch.equal(got["sum"], sum(xs))
        assert torch.equal(got["max"], xs[-1]) and torch.equal(got["min"], xs[0])
        assert torch.equal(got["gather"], torch.stack(xs))
        assert torch.equal(got["gather_bool"],
                           torch.tensor([[k % 2 == 0, True, False] for k in range(n)]).reshape(-1))
        i32, bf16, flags, half = got["tree"]
        assert i32.dtype == torch.int32 and int(i32) == 1
        assert bf16.dtype == torch.bfloat16 and torch.equal(bf16.float(), torch.ones(2, 3))
        assert torch.equal(flags, torch.tensor([True, True]))
        assert torch.equal(half, torch.full((5,), 0.5))
        assert torch.equal(got["shard"], torch.arange(4 * r, 4 * r + 4))
        assert torch.equal(got["kept"], torch.arange(3))
        assert got["collectives"] == 6


def test_launch_reports_a_failed_rank():
    """A rank that raises fails the launch with its traceback; the others,
    blocked or not, are stopped."""
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        launch(rank_fail, 2, 2)


def test_make_mesh_single_process_and_backend_checks():
    """make_mesh(1) without a process group makes a one-rank gloo group
    whose collectives return their input; larger meshes, a backend other
    than the group's, and nccl ranks on the CPU or sharing one card raise."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_mod.make_mesh(2)
    try:
        mesh = mesh_mod.make_mesh(1)
        assert mesh.size == 1 and mesh.shape == {"data": 1} and mesh.backend == "gloo"
        x = torch.tensor([1.5, -2.0])
        assert torch.equal(mesh_mod.psum(mesh, x), x)
        assert torch.equal(mesh.all_gather(x), x)
        with pytest.raises(ValueError, match="asked for the nccl backend"):
            mesh_mod.make_mesh(1, backend="nccl")
        with pytest.raises(ValueError, match="need 2 ranks"):
            mesh_mod.make_mesh(2)
        grid = mesh_mod.make_mesh(1, axis_names=("data", "model"))
        assert grid.shape == {"data": 1, "model": 1} and grid.axis_index("model") == 0
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="CUDA device"):
        mesh_mod.rank_devices(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="NCCL refuses"):
        mesh_mod.rank_devices(2, "nccl", "cuda:0")
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.rank_devices(2, "mpi", "cpu")
    assert mesh_mod.rank_devices(3, "gloo", "cpu") == ["cpu"] * 3


def test_pack_round_trip_keeps_dtypes_and_shapes():
    rng = np.random.RandomState(0)
    tree = [torch.tensor(rng.randn(4, 3), dtype=torch.float32),
            (torch.tensor(7, dtype=torch.int32), torch.tensor(rng.rand(5) > 0.5)),
            torch.tensor(rng.randn(2, 256)).to(torch.bfloat16)]
    buf = mesh_mod.pack(tree)
    assert buf.dtype == torch.uint8
    assert buf.numel() == sum(x.numel() * x.element_size() for x in mesh_mod.leaves(tree))
    back = mesh_mod.unpack(buf, tree)
    for a, b in zip(mesh_mod.leaves(back), mesh_mod.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="bytes"):
        mesh_mod.unpack(buf[:-1], tree)
