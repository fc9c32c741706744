"""What the harness loads: no module whose top-level name is jax, jaxlib,
flax or fitslam_tpu (compared as whole names: the port's own name begins
with the last), and nothing of the port in the reference or the frozen
copies. A directory that holds only the benchmark gives no result."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

RUN_TINY = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from pathlib import Path
from benchmark import core, report
cell = core.resolve("tiny_stereo.tiny_corridor", root=Path({tiny!r}))
r = report.run_cell(cell, 7, 1.0, False, 0.0, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax(tiny_root):
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(
        root=str(ROOT), tests=str(ROOT / "benchmark/tests"), tiny=str(tiny_root))],
        capture_output=True, text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "fitslam_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "fitslam_tpu"}


def test_reference_and_frozen_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "import benchmark.reference.frontend, benchmark.reference.tracking\n"
            + "import benchmark.reference.ekf, benchmark.reference.planner\n"
            + "import benchmark.reference.grid, benchmark.reference.fisher\n"
            + "import benchmark.frozen.worlds, benchmark.frozen.evaluation\n"
            + "import benchmark.frozen.kernel_counts, benchmark.stats, benchmark.profile\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"fitslam_tpu_torch", "fitslam_tpu", "jax", "jaxlib", "flax"}


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
