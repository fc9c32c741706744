"""The BA modes eager against captured on the card, in turns: ``--mode ba``
(``bench_suite.bench_ba``: local 8 / 2048 / 8192 and global 256 / 8192 /
32768, 8 iterations a solve) and ``--mode scaling`` (``bench_scaling``: the
landmark-sharded BA over 1, 2 and 8 ranks, or as many as the host has
cards with nccl), a pass a mode of ``--passes``; then each BA size's
kernels by name over one eager iteration (torch.profiler). One line a pass
(``AB {json}``), the kernels, then the card's name and power limit.
``--modes scaling_profile`` instead profiles one solve of the scaling
problem on rank 0 of ``--ranks`` ranks a mode (the solver warmed up and
captured first): host ms, the device's kernel ms and the top kernels, the
collectives' ms.

    python3 tools/solvers_ab.py [--backend gloo|nccl] [--modes ba,scaling]
                                [--passes eager,captured,captured,eager]
    python3 tools/solvers_ab.py --modes scaling_profile [--ranks 2]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from fitslam_tpu_torch import bench_suite  # noqa: E402
from fitslam_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402


def _scaling(dev, backend, capture):
    """bench_scaling's record, with the regions' stats a rank the record
    leaves out (from the launch's results)."""
    from chip_smoke import _launch_results

    with _launch_results() as got:
        rec = bench_suite.bench_scaling(False, dev, backend=backend, capture=capture)
    e = rec["extra"]
    keys = ("t1_s", "t2_s", "efficiency_2dev", "collectives_per_iter", "collectives_ms_per_iter",
            "backend", "ranks_share_card")
    return dict({k: e[k] for k in keys}, chi2={k: v for k, v in e.items() if k.startswith("chi2_")},
                regions={n: r["regions"] for n, r in got[0][0].items()})


def _ba_kernels(dev, top=8):
    """{size: (device us an eager iteration, the top kernels by device time)}."""
    from fitslam_tpu_torch.ops import ba
    from fitslam_tpu_torch.utils import prng

    K = bench_suite.ba_intrinsics(dev)
    out = {}
    for name, sz in bench_suite.BA_SIZES.items():
        prob, _, _ = bench_suite.make_ba_problem(prng.prng_key(7), **sz, device=dev)
        ba.bundle_adjust(K, prob, iters=2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ba.bundle_adjust(K, prob, iters=2)
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / 2, e.count // 2, e.key[:80])
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_time_total > 0), reverse=True)
        out[name] = (sum(r[0] for r in rows), rows[:top])
    return out


def profile_rank(passes, top=8):
    """On every rank: the landmark-sharded BA at the scaling size, two
    solves a mode of ``passes``, then one under torch.profiler on rank 0
    and one with ``Mesh.timed`` set. Returns rank 0's {mode: figures}."""
    from fitslam_tpu_torch.parallel import dist_ba
    from fitslam_tpu_torch.utils import prng

    mesh = mesh_mod.make_mesh()
    dev, iters = mesh.device, bench_suite.SCALING_ITERS
    K = bench_suite.ba_intrinsics(dev)
    prob, _, _ = bench_suite.make_ba_problem(prng.prng_key(7), 256, 8192, 32768, device=dev)
    packed = dist_ba.shard_problem_by_landmark(prob, mesh.size)
    out = {}
    for p in passes:
        capture = p == "captured"
        solve = lambda: dist_ba.landmark_sharded_bundle_adjust(mesh, K, packed, iters=iters,
                                                               capture=capture)
        for _ in range(2):
            solve()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mesh.rank == 0:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                solve()
                torch.cuda.synchronize(dev)
        else:
            solve()
            torch.cuda.synchronize(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        mesh.timed, mesh.stats = True, {"collectives": 0, "seconds": 0.0}
        solve()
        mesh.timed = False
        if mesh.rank == 0:
            rows = sorted(((e.device_time_total, e.count, e.key[:70])
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.device_time_total > 0), reverse=True)
            out.setdefault(p, []).append(dict(
                host_ms=host_ms, kernel_ms=sum(r[0] for r in rows) / 1e3,
                collectives_ms=mesh.stats["seconds"] * 1e3,
                top=[(round(us / 1e3, 3), n, k) for us, n, k in rows[:top]]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--modes", default="ba,scaling")
    ap.add_argument("--passes", default="eager,captured,captured,eager")
    ap.add_argument("--ranks", type=int, default=2, help="ranks of scaling_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solvers_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    modes, passes = args.modes.split(","), args.passes.split(",")
    if modes == ["scaling_profile"]:
        devices = "cuda" if args.backend == "nccl" else "cuda:0"
        res = mesh_mod.launch(profile_rank, args.ranks, passes, backend=args.backend,
                              device=devices, timeout=1200)[0]
        for p, runs in res.items():
            for r in runs:
                print("PROFILE " + json.dumps(dict(pass_=p, ranks=args.ranks, **r)), flush=True)
    else:
        for p in passes:
            capture = {"eager": False, "captured": True}[p]
            for mode in modes:
                t0 = time.monotonic()
                if mode == "ba":
                    rec = bench_suite.bench_ba(False, dev, capture=capture)
                    figures = {k: v for k, v in rec["extra"].items() if k in ("local", "global")}
                else:
                    figures = _scaling(dev, args.backend, capture)
                print("AB " + json.dumps(dict(mode=mode, pass_=p, seconds=time.monotonic() - t0,
                                              **figures)), flush=True)
        if "ba" in modes:
            for name, (total, rows) in _ba_kernels(dev).items():
                print(f"BA KERNELS {name}: {total:.1f} device us an eager iteration; "
                      + "; ".join(f"{us:.1f} us x{n} {k}" for us, n, k in rows), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
