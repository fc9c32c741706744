"""On the card: one short run of every cell gives a result line whose
comparison comes out correct. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


def cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483647", "--seconds", "8", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
