"""Steps of the active-SLAM loop a second: every step handed in during the
window (a frame with its cloud, a tick every few steps, a controller step,
the EKF's pose read) over the window's host time, mission starts
included."""

from benchmark import stats


def read(run):
    return stats.rate(len(run["steps"]), run["window_s"])
