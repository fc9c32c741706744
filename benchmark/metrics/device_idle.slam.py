"""Share (%) of the profiled slice's wall time in which no operation ran on
the card: 1 - the union of the device operations' intervals over the
slice's host time, the stretches in which the profiler's own host
activities (its buffer requests and flushes) held the device idle left out
of both."""


def read(run):
    p = run.get("profile")
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / (p["window_s"] - p["profiler_idle_s"]))
