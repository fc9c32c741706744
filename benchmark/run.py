"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``fitslam_tpu_torch``)
on a machine with an NVIDIA card. ``--trace 0`` measures the cell's
end-to-end metrics; ``--trace 1`` is a separate run that profiles a slice of
its window and reports the per-layer metrics. Every run checks what its
window produced against the plain reference and prints each number compared
beside its limit, last on standard error and last in the result line. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``.

Exits non-zero with no result line when there is no card (or fewer than the
cell asks for), when a file the cell needs is missing, or when the process
has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
# every build and kernel cache in the checkout, at fixed paths (the port
# builds its own kernels into build/kernels/ beside this)
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import core, report

    try:
        cell = core.resolve(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise core.Refused(f"needs {cell.chips} CUDA device(s), found "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        import fitslam_tpu_torch  # noqa: F401  (the system under test)

        result = report.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except core.Refused as e:
        print(f"[benchmark] refused: {e}", file=sys.stderr)
        return 3
    print(report.line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
