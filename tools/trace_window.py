"""What the program's span recorder (``fitslam_tpu_torch.utils.profiling``)
sees of a benchmark cell's window, and what it costs.

    python3 tools/trace_window.py cell CELL [--seed N] [--seconds S] [--trace 0|1]
    python3 tools/trace_window.py probe [--n N]

``cell`` runs one cell of ``BENCHMARK.json`` as ``benchmark/run.py`` does
and prints one line ``WINDOW {json}``: the run's metrics (the per-layer ones
with ``--trace 1``, the end-to-end ones without), the spans a second in the
window, whether the ring dropped any of them, the recorder's counters over
the window, the EKF window kernel's launches a flush over the run, the host
wait of each read site, the device ms of each region's replays a step, and
the window's host time outside the replays on the card by innermost host
span (the device idle or running eager work under it), the profiled slice
left out. Run from the root of a checkout.

``probe`` prints ``PROBE {json}``: the seconds the first timed span takes
to make the event pool, the host cost of a region's span (two events), of
a layer's span and of a counted read (one anchor event) with spans on and
off; and, 0.5 ms to 1 s after a read, a region's span on the idle card,
its device start mapped through the read's anchor less the host's start
(the card's start latency after idling, with the mapping's error), then
the same right after a second read, when the card is awake (the mapping's
error alone, against the first read's anchor).
"""

import argparse
import bisect
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _innermost(spans, t):
    """The name of the innermost host span around host time ``t``."""
    best = None
    for s in spans:
        if s.t0 <= t <= s.t1 and (best is None or s.t1 - s.t0 < best.t1 - best.t0):
            best = s
    return best.name if best is not None else "host"


def outside_by_span(w, top=12):
    """Host seconds of the window outside every replay's device interval,
    by the innermost host span at the middle of each stretch."""
    from benchmark import profile

    busy = profile.merged(w.outside_cut([(s.d0, s.d1) for s in w.spans if s.kind == "replay"]))
    host = [s for s in w.spans if s.kind in ("layer", "sync", "eager", "warm_up", "capture")]
    host.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in host]
    cuts = [w.cut] if w.cut else []
    gaps, t = [], w.t0
    for s, e in sorted(busy + cuts):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w.t1 > t:
        gaps.append((t, w.t1))
    gaps = [g for g in gaps if not (w.cut and w.cut[0] <= g[0] and g[1] <= w.cut[1])]
    out = collections.Counter()
    for s, e in gaps:
        mid = (s + e) / 2
        k = bisect.bisect_right(starts, mid)
        out[_innermost(host[max(0, k - 400):k], mid)] += e - s
    return [(n, round(v, 6)) for n, v in out.most_common(top)]


def cell_main(args):
    import torch

    from benchmark import core, report
    from benchmark.metrics import _program_spans as ps
    from fitslam_tpu_torch.ops import ekf_window
    from fitslam_tpu_torch.utils import profiling

    cell = core.resolve(args.cell)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ts = cell.traffic.get("trace_slice", {})
    tracer = core.Tracer(bool(args.trace), ts.get("skip", 0), ts.get("frames", 0), dev)
    rec = profiling.RECORDER
    launches0 = ekf_window.ekf_window.launches
    flushes0 = rec.counters()["reads"].get("DualEkf.flush", 0)
    run = core.driver(cell).run(cell, args.seed, args.seconds, tracer, dev)
    flushes = rec.counters()["reads"].get("DualEkf.flush", 0) - flushes0
    metrics = {}
    t0 = time.perf_counter()
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = core.reader(cell, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = v
    read_s = time.perf_counter() - t0
    checks = report.judge(run["checks"], cell.limits)
    out = {"cell": args.cell, "seed": args.seed, "trace": args.trace,
           "card": torch.cuda.get_device_name(dev), "enabled": rec.enabled,
           "correct": all(c["ok"] for c in checks.values()), "attempted": run["attempted"],
           "window_s": run["window_s"], "metrics": metrics, "readers_s": read_s,
           "counters": rec.counters(),
           "ekf_window_launches_per_flush":
               (ekf_window.ekf_window.launches - launches0) / flushes if flushes else None}
    w = ps.window(run)
    if w is not None:
        n_steps = len(run["steps"]) - sum(s.get("traced", False) for s in run["steps"])
        kinds = collections.Counter(s.kind for s in w.spans)
        regions = collections.defaultdict(float)
        for s in w.spans:
            if s.kind == "replay" and s.d0 is not None:
                regions[s.name] += (s.d1 - s.d0) * 1e3 / n_steps
        waits = collections.defaultdict(float)
        for s in w.spans:
            if s.kind == "sync":
                waits[s.name] += (s.t1 - s.t0) * 1e3 / n_steps
        out.update({
            "spans_per_s": len(w.spans) / w.host_s, "spans_in_window": len(w.spans),
            "dropped_in_window": int(rec.last_dropped_t0 >= run["t_window"]),
            "kinds": dict(kinds), "steps_outside_slice": n_steps,
            "replay_device_ms_per_step": dict(sorted(regions.items(), key=lambda kv: -kv[1])),
            "sync_wait_ms_per_step": dict(sorted(waits.items(), key=lambda kv: -kv[1])),
            "outside_graphs_by_span_s": outside_by_span(w),
            "host_s": w.host_s})
    print("WINDOW " + json.dumps(out), flush=True)


def probe_main(args):
    import torch

    from fitslam_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rec = profiling.RECORDER
    x = torch.ones(4, device=dev)
    out = {"card": torch.cuda.get_device_name(dev)}

    def per_call(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def replay_span():
        with profiling.span("probe.replay", "replay", dev):
            pass

    def layer_span():
        with profiling.span("probe.layer", device=dev):
            pass

    def read():
        with profiling.host_read("probe.read", dev):
            x.cpu()

    def bare_read():
        x.cpu()

    t0 = time.perf_counter()
    replay_span()                            # the first timed span makes the pool
    out["event_pool_s"] = time.perf_counter() - t0
    out["replay_span_us"] = per_call(replay_span, args.n)
    out["layer_span_us"] = per_call(layer_span, args.n)
    out["read_us"] = per_call(read, args.n // 10)
    out["bare_read_us"] = per_call(bare_read, args.n // 10)
    rec.enabled = False
    out["replay_span_off_us"] = per_call(replay_span, args.n)
    out["layer_span_off_us"] = per_call(layer_span, args.n)
    out["read_off_us"] = per_call(read, args.n // 10)
    rec.enabled = True
    t0 = time.perf_counter()
    n_spans = len(profiling.spans())
    out["spans_read_s"] = [time.perf_counter() - t0, n_spans]
    torch.cuda.synchronize()
    errors = {}
    latency = {}
    for gap in (0.0005, 0.005, 0.05, 1.0):
        since = time.perf_counter()
        for _ in range(20 if gap >= 1.0 else 200):
            with profiling.host_read("probe.a", dev):
                x.cpu()
            time.sleep(gap)
            # a region's span on the idle card: its start mapped through the
            # read's anchor, less the host's reading just before its event
            with profiling.span("probe.mark", "replay", dev):
                pass
            # and one right after a second read, itself no anchor: the card
            # just ran the copy, so the event runs when recorded, and the
            # difference is the error of the first read's anchor
            with profiling.host_read("probe.b", dev, drained=False):
                x.cpu()
            with profiling.span("probe.after_read", "replay", dev):
                pass
        got = profiling.spans(since)
        for name, into in (("probe.after_read", errors), ("probe.mark", latency)):
            d = [(s.d0 - s.t0) * 1e6 for s in got if s.name == name]
            into[str(gap)] = {"median_us": statistics.median(d), "min_us": min(d),
                              "max_us": max(d), "n": len(d)}
    out["anchor_error"] = errors
    out["idle_start_latency"] = latency
    print("PROBE " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cell")
    c.add_argument("cell")
    c.add_argument("--seed", type=int, default=2147483001)
    c.add_argument("--seconds", type=float, default=51.0)
    c.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p = sub.add_parser("probe")
    p.add_argument("--n", type=int, default=20000)
    args = ap.parse_args()
    (cell_main if args.what == "cell" else probe_main)(args)


if __name__ == "__main__":
    main()
