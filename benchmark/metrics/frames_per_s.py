"""Frames tracked a second: every frame handed in during the window over
the window's host time (engine starts between episodes included)."""

from benchmark import stats


def read(run):
    return stats.rate(len(run["steps"]), run["window_s"])
