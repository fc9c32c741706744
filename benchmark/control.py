"""The readings that the limits of a stereo cell are set from: on each seed,
one episode of the program at the cell's own size with the frames the run
samples, compared with the reference as a run compares them (the lower
readings), and the control, the reference put in the program's place and
computed in bfloat16, the precision below the configuration's float32 (the
upper readings): its own ORB features, the stereo disparity of the
program's features, and the pose refined from the program's.

    python3 benchmark/control.py --workload stereo_slam_640.corridor \\
        --seeds 11 12 13 [--out chiprun_out/control.jsonl]

One JSON line a seed; each mix's driver holds its ``control_run``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the tests' tiny size)")
    args = ap.parse_args(argv)
    import torch

    from benchmark import core

    dev = torch.device("cpu" if args.cpu else "cuda")
    cell = core.resolve(args.workload)
    return readings(cell, args.seeds, dev, args.out)


def readings(cell, seeds, dev, out_path=None) -> int:
    from benchmark import core

    drv = core.driver(cell)
    for seed in seeds:
        prog, ctl = drv.control_run(cell, seed, dev)
        rec = json.dumps({"seed": seed, "program": prog, "control": ctl})
        print(rec, flush=True)
        if out_path:
            with open(out_path, "a") as fh:
                fh.write(rec + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
