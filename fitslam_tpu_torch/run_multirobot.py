"""Multi-robot shared-map exploration (the port's counterpart of the
reference's ``examples/run_multirobot.py``).

Usage:
    python -m fitslam_tpu_torch.run_multirobot [--robots N] [--steps S]
        [--allocator hungarian|minpos] [--seed K] [--record DIR] [--cpu]

One ``MultiRobotCoordinator`` runs ONE frontier search, ONE cost matrix (a
wavefront potential per robot, K3) and ONE assignment per tick on the
shared map; each rover follows its goal with the simulated nav stack. The
protocol is the reference's: a 64 x 64 grid at 0.25 m over
``make_rooms_world(seed)``, the rovers at the four corners' starts, a
3 m reveal a step, a tick every 2 steps and 3 controller steps per rover a
step. Prints the fleet's coverage curve and each rover's path length, and
with ``--record DIR`` renders the final world to ``DIR/fleet.ppm``. The run
is on the card unless ``--cpu`` is given; it exits 0 when the final
coverage is above 0.3. The auction solver is reached through the config
(``multi_robot.allocator = "auction"``), which ``run`` sets from its
``allocator``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from fitslam_tpu_torch.models import allocation as al
from fitslam_tpu_torch.models import sim_robot as sim
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.evaluation import path_length
from fitslam_tpu_torch.utils.transfer import upload

SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
STARTS = ((-5.0, -5.0, 0.0), (5.0, 5.0, 3.0), (-5.0, 5.0, -1.5), (5.0, -5.0, 1.5))
TICK_EVERY = 2
NAV_STEPS = 3


def fleet_config(allocator: str = "hungarian") -> FitSlamConfig:
    """The reference's configuration: wavefronts of 192 sweeps, 1 m/s."""
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        nav=dataclasses.replace(cfg.nav, wavefront_iters=192, desired_speed=1.0),
        multi_robot=dataclasses.replace(cfg.multi_robot, allocator=allocator),
    )


def run(n_robots: int = 2, steps: int = 150, allocator: str = "hungarian", seed: int = 2,
        device="cuda", timer=None, verbose: bool = True) -> dict:
    """Drive the fleet for ``steps`` steps (or until the coordinator finds
    no frontier) with ``fleet_config(allocator)``; ``"auction"`` is one of
    the allocators here, as in the config. ``timer(window)``, if given,
    returns a context manager wrapped around each coordinator tick
    (``"tick"``) and each step's controller steps (``"ctrl"``). Returns the
    coverage curve (host numpy, read once at the end), the steps run, the
    rovers, their navs, the coordinator, the explored grid and the loop's
    wall seconds."""
    device = torch.device(device)
    cfg = fleet_config(allocator)
    timer = timer or (lambda window: nullcontext())
    gt = upload(sim.make_rooms_world(SPEC, seed=seed), device)
    state = {"explored": torch.full((SPEC.size, SPEC.size), gr.UNKNOWN, dtype=torch.uint8,
                                    device=device)}
    robots = [sim.DiffDriveRobot(x=x, y=y, yaw=a, v_max=1.2, w_max=2.5)
              for x, y, a in STARTS[:n_robots]]
    navs = [SimNavInterface(cfg, SPEC, r, lambda: state["explored"], dt=0.15, device=device)
            for r in robots]
    for n in navs:
        n.controller.max_omega = 2.0
    coord = al.MultiRobotCoordinator(
        cfg, SPEC, lambda: state["explored"], navs,
        get_poses=lambda: [(r.xy, r.yaw) for r in robots], device=device)

    if verbose:
        print(f"[multirobot] {len(robots)} rovers, allocator={cfg.multi_robot.allocator}, "
              f"world seed {seed}, on {device}")
    coverage = torch.zeros(steps, device=device)
    t0 = time.monotonic()
    n = 0
    for step in range(steps):
        for r in robots:
            state["explored"] = sim.reveal_sensor(
                SPEC, gt, state["explored"], upload(np.asarray(r.xy, np.float32), device),
                range_m=3.0)
        if step % TICK_EVERY == 0:
            with timer("tick"):
                coord.tick()
        with timer("ctrl"):
            for _ in range(NAV_STEPS):
                for nv in navs:
                    nv.step()
        coverage[step] = (state["explored"] != gr.UNKNOWN).to(torch.float32).mean()
        n = step + 1
        if verbose and step % 20 == 0:
            print(f"  step {step:4d} coverage={float(coverage[step]):.3f} done={coord.done}")
        if coord.done:
            break
    cov = coverage[:n].cpu().numpy().astype(np.float64)
    return {"coverage": cov, "robots": robots, "navs": navs, "coord": coord,
            "explored": state["explored"].cpu().numpy(), "wall_s": time.monotonic() - t0,
            "steps": n}


def render(out_dir: Path, explored: np.ndarray, robots) -> Path:
    """The final shared map with rover 0 in yellow and the others in green."""
    from fitslam_tpu_torch.utils import viz

    cells = [SPEC.world_to_cell(torch.tensor(r.xy, dtype=torch.float32))[0].tolist()
             for r in robots]
    path = Path(out_dir) / "fleet.ppm"
    viz.render_world_ppm(
        explored, str(path), robot_cell=(int(cells[0][0]), int(cells[0][1])),
        roadmap_cells=np.array(cells[1:]) if len(cells) > 1 else None)
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=2, choices=range(1, len(STARTS) + 1))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--allocator", default="hungarian", choices=["hungarian", "minpos"])
    ap.add_argument("--record", type=str, default="")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args.robots, args.steps, args.allocator, args.seed,
            device="cpu" if args.cpu else "cuda")
    cov = r["coverage"]
    print(f"\n[multirobot] coverage curve (every 10 steps): "
          f"{[round(float(c), 3) for c in cov[::10]]}")
    print(f"[multirobot] final coverage = {cov[-1] if len(cov) else 0.0:.3f} "
          f"in {len(cov)} steps ({r['wall_s']:.1f} s wall)")
    for i, rb in enumerate(r["robots"]):
        traj = [(x, y, 0.0) for x, y, _ in rb.trajectory]
        print(f"[multirobot] rover {i}: path length = {path_length(np.array(traj)):.1f} m")
    if args.record:
        print(f"[multirobot] artifacts -> {render(Path(args.record), r['explored'], r['robots'])}")
    return 0 if len(cov) and cov[-1] > 0.3 else 1


if __name__ == "__main__":
    sys.exit(main())
