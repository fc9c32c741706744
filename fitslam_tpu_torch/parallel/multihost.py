"""Multi-process distribution: process-group bring-up and observation-sharded
BA over every rank (port of ``fitslam_tpu/parallel/multihost.py``).

The reference joins processes with ``jax.distributed`` and lets each add its
local devices to one global mesh. Here each process is one rank that owns
one device (PyTorch's idiom), joined by ``torch.distributed`` over TCP; the
observation-sharded BA of ``parallel/dist_ba.py`` runs with its reductions
crossing the process boundary. Run one process a rank:

    python -m fitslam_tpu_torch.parallel.multihost --num-processes 2 --process-id 0 --cpu &
    python -m fitslam_tpu_torch.parallel.multihost --num-processes 2 --process-id 1 --cpu

Without ``--cpu`` a rank runs on a card: ``--backend nccl`` (the default)
with one card a rank (``cuda:<process-id>``), or ``--backend gloo --device
cuda:0`` for ranks that share one card. Each process prints one line,
``MULTIHOST_RESULT {json}``, with the chi2 trajectory and the solve's time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo", device: str = "cuda") -> None:
    """Join the process group at ``coordinator`` (host:port) as rank
    ``process_id`` of ``num_processes``, on ``device``: ``cuda`` is card
    ``process_id`` (one card a rank), ``cuda:N`` card N, ``cpu`` the CPU."""
    from fitslam_tpu_torch.parallel import mesh as mesh_mod

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id)
    mesh_mod.init_rank(backend, f"tcp://{coordinator}", num_processes, process_id, dev)


def build_problem(key_seed: int = 0, n_kf: int = 6, n_lm: int = 96, n_obs: int = 512,
                  device="cuda", focal: float = 120.0):
    """The reference's synthetic BA problem, identical on every process: its
    random draws are ``jax.random``'s, bit for bit (``utils/prng.py``). The
    multi-chip dry run's problem is the same with a focal length of 100."""
    from fitslam_tpu_torch.ops import ba, lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    K = Intrinsics(fx=f32(focal), fy=f32(focal), cx=f32(64.0), cy=f32(48.0), baseline=f32(0.1))
    key = prng.prng_key(key_seed)
    pts = prng.uniform(key, (n_lm, 3), -3.0, 3.0) + np.array([0, 0, 6.0], np.float32)
    xi = np.float32(0.05) * prng.normal(prng.fold_in(key, 1), (n_kf, 6))
    T_cw = lie.se3_exp(torch.from_numpy(xi).to(device))
    kf_idx = torch.from_numpy(prng.randint(prng.fold_in(key, 2), (n_obs,), 0, n_kf)).to(device)
    lm_idx = torch.from_numpy(prng.randint(prng.fold_in(key, 3), (n_obs,), 0, n_lm)).to(device)
    pts_t = torch.from_numpy(pts).to(device)
    kf, lm = kf_idx.long(), lm_idx.long()
    p_c = (T_cw.R[kf] @ pts_t[lm][..., None])[..., 0] + T_cw.t[kf]
    z = torch.clamp(p_c[:, 2], min=0.5)
    uvr = torch.stack([K.fx * p_c[:, 0] / z + K.cx, K.fy * p_c[:, 1] / z + K.cy,
                       K.fx * p_c[:, 0] / z + K.cx - K.bf / z], dim=-1)
    obs = ba.Observations(kf=kf_idx.to(torch.int32), lm=lm_idx.to(torch.int32), uvr=uvr,
                          sigma2=torch.ones((n_obs,), device=device),
                          valid=torch.ones((n_obs,), dtype=torch.bool, device=device))
    noise = np.float32(0.05) * prng.normal(prng.fold_in(key, 4), pts.shape)
    prob = ba.BAProblem(T_cw=T_cw, points=torch.from_numpy(pts + noise).to(device), obs=obs,
                        fixed_kf=torch.arange(n_kf, device=device) == 0,
                        fixed_lm=torch.zeros((n_lm,), dtype=torch.bool, device=device))
    return K, prob


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_global_ba(iters: int = 5, n_obs: int = 512, timing_reps: int = 3):
    """Observation-sharded BA over every rank of the process group; returns
    the result dict. A rank owns one device, so ``n_devices`` is the world
    size."""
    import torch.distributed as dist

    from fitslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod

    mesh = mesh_mod.make_mesh(axis_names=("data",))
    device = mesh.device
    K, prob = build_problem(n_obs=n_obs, device=device)
    out, chis = dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=iters)
    _sync(device)
    # steady-state timing
    t0 = time.perf_counter()
    for _ in range(timing_reps):
        dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=iters)
        _sync(device)
    dt = (time.perf_counter() - t0) / timing_reps
    chis = [float(c) for c in chis.cpu()]
    return {
        "process_id": dist.get_rank(),
        "n_devices": mesh.size,
        "n_processes": dist.get_world_size(),
        "device": str(device),
        "chi2_first": chis[0],
        "chi2_last": chis[-1],
        "ba_solve_s": dt,
        "ba_iters_per_s": iters / dt,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Observation-sharded BA over processes joined by torch.distributed. A "
                    "rank owns one device, so n_devices in the result is the number of "
                    "processes.")
    ap.add_argument("--coordinator", default="127.0.0.1:9277", help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--obs", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="gloo with --cpu or for ranks that share a card; nccl (the "
                         "default on the card) for one card a rank")
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: cpu with --cpu, else cuda:<process-id>)")
    args = ap.parse_args(argv)

    backend = args.backend or ("gloo" if args.cpu else "nccl")
    device = args.device or ("cpu" if args.cpu else f"cuda:{args.process_id}")
    if args.cpu and torch.device(device).type != "cpu":
        ap.error("--cpu goes with a CPU device")
    initialize(args.coordinator, args.num_processes, args.process_id, backend, device)
    try:
        res = run_global_ba(iters=args.iters, n_obs=args.obs)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    print("MULTIHOST_RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
