"""95th percentile of a step's latency over every step of the window: the
host clock from the camera's frame to the pose read from the EKF."""

from benchmark import stats


def read(run):
    return stats.percentile([s["s"] * 1e3 for s in run["steps"]], 95)
