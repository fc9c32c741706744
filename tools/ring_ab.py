"""Phase 10's ring (``bench_suite.ring_run``: seed 1, 150 + 6 frames at
640x480, loop closing on, refine_map 10 cycles) with the package of another
checkout, three engines in one process: the first kept alive while the
second runs (as ``chip_smoke.py`` phase 10 keeps its engines, so each one
captures its own loop regions), then a third after both are dropped (it
takes a dropped engine's captured regions). Prints one line ``RING {json}``
with each run's frames/s, refine seconds, ATE and loops.

    python3 tools/ring_ab.py TREE      # TREE: a checkout's root, e.g. `.`

To hold two commits side by side on one card, unpack the other with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one call.
"""

import json
import sys

tree = sys.argv[1]
sys.path.insert(0, tree)

import torch  # noqa: E402

from fitslam_tpu_torch.bench_suite import loop_config, ring_run  # noqa: E402
from fitslam_tpu_torch.data import synthetic  # noqa: E402
from fitslam_tpu_torch.models.slam import StereoSlam  # noqa: E402
from fitslam_tpu_torch.ops import lie  # noqa: E402
from fitslam_tpu_torch.ops.geometry import Intrinsics  # noqa: E402
from fitslam_tpu_torch.utils import prng  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = loop_config(False)
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    ring = synthetic.loop_trajectory(150, radius=8.0, device=dev)
    T = lie.SE3(torch.cat([ring.R, ring.R[:6]]), torch.cat([ring.t, ring.t[:6]]))
    gt = list(T.matrix().cpu().numpy().astype("float64"))
    world = synthetic.ring_world(prng.prng_key(1), num=5000, radius=8.0, width=5.0,
                                 device=dev).landmarks
    frames = [synthetic.render_stereo(K, world, lie.SE3(T.R[i], T.t[i]), width=W, height=H,
                                      max_depth=14.0) for i in range(T.t.shape[0])]
    torch.cuda.synchronize()
    out, keep = [], []
    for run in range(3):
        if run == 2:
            keep.clear()                    # both engines gone: the next one reuses a slot
        slam = StereoSlam(cfg, dev)
        r = ring_run(slam, frames, gt, dev, refine_cycles=10)
        out.append(dict(fps=r["fps"], refine_s=r["refine_s"], ate=r["ate"],
                        loops=len(slam.loop_events)))
        keep.append(slam)
    print("RING " + json.dumps({"tree": tree, "runs": out}))


if __name__ == "__main__":
    main()
