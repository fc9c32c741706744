"""Device-to-host waits a frame: the change of ``StereoSlam.host_syncs``
over the window's frames, over their count."""


def read(run):
    steps = run["steps"]
    return sum(s["syncs"] for s in steps) / len(steps) if steps else None
