"""Every cell of BENCHMARK.json resolves to its files by name, the file keeps
to the benchmark's contract, and a cell added as files and entries alone
runs through the harness (on the CPU, at a tiny size)."""

import json
import re

import pytest

from benchmark import core, report
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:       # the cell reports the metric it moves
            assert core._applies(e2e[m["moves"]], c)
    for w in s["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_resolves(cell):
    c = core.resolve(cell)
    core.fitslam_config(c.config["settings"])       # every key is the port's
    core.driver(c)
    for m in c.end_to_end + c.per_layer:
        assert callable(core.reader(c, m["name"]).read)
    assert c.limits and all(set(v) <= {"max", "min"} for v in c.limits.values())


def test_added_cell_runs(tiny_root):
    cell = core.resolve("tiny_stereo.tiny_corridor", root=tiny_root)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "frame_ms_p95", "setup_s"]
    r = report.run_cell(cell, 2**31 + 5, 5.0, False, 0.0, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 4 and set(r["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                                           "setup_s"}
    assert list(r)[-1] == "checks"
    assert json.loads(report.line(r))["metrics"]["frames_per_s"]["unit"] == "frames/s"
