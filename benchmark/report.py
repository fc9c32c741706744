"""One run of a cell: set-up and window by the mix's driver, then the
metrics by their readers, the verdict on the comparison against the
reference, and the result line."""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Dict

from benchmark import core


def judge(checks: Dict[str, float], limits: Dict[str, Dict[str, float]]) -> Dict[str, Dict]:
    """Each compared number beside its limit (``max``: at most, ``min``: at
    least); a number with no limit, or a limit with no number, fails."""
    out = {}
    for name in sorted(set(checks) | set(limits)):
        lim = limits.get(name, {})
        v = checks.get(name)
        if "max" in lim:
            ok = v is not None and v <= lim["max"]
            out[name] = {"value": v, "limit": lim["max"], "bound": "max", "ok": ok}
        elif "min" in lim:
            ok = v is not None and v >= lim["min"]
            out[name] = {"value": v, "limit": lim["min"], "bound": "min", "ok": ok}
        else:
            out[name] = {"value": v, "limit": None, "bound": None, "ok": False}
    return out


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda"):
    """One run; ``device="cpu"`` is for the tests' tiny cells."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    ts = cell.traffic.get("trace_slice", {})
    tracer = core.Tracer(trace, ts.get("skip", 0), ts.get("frames", 0), dev)
    run = core.driver(cell).run(cell, seed, seconds, tracer, dev)
    run["setup_s"] = run["t_window"] - t_start
    run["trace"] = trace
    loaded = core.forbidden_modules()
    if loaded:
        raise core.Refused(f"the process has loaded {', '.join(loaded)}")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = core.reader(cell, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    verdict = judge(run["checks"], cell.limits)
    correct = run["attempted"] > 0 and all(c["ok"] for c in verdict.values())
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result: Dict[str, Any] = {"correct": correct, "attempted": run["attempted"],
                              "failed": run["failed"], "metrics": metrics, "device": device}
    prof = run.get("profile")
    if trace:
        device["busy_s"] = prof["busy_s"] if prof else 0.0
        device["window_s"] = prof["window_s"] if prof else 0.0
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    result["notes"] = run.get("notes", {})
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"], "bound": c["bound"]}
                        for n, c in verdict.items()}
    for n, c in verdict.items():
        print(f"[check] {n} {c['value']} {c['bound']} {c['limit']} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    return result


def line(result: Dict[str, Any]) -> str:
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        return x

    return json.dumps(clean(result))
