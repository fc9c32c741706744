"""95th percentile of a frame's latency over every frame of the window: the
host clock from the pair being handed to ``StereoSlam.process_frame`` to
its pose on the host."""

from benchmark import stats


def read(run):
    return stats.percentile([s["s"] * 1e3 for s in run["steps"]], 95)
