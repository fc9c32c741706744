"""Median latency (ms) of the window's frames that inserted a keyframe
(``info["keyframe"]``: insertion, local BA, culling, compaction), the
profiled slice left out."""

from benchmark import stats


def read(run):
    v = [s["s"] * 1e3 for s in run["steps"] if s["keyframe"] and not s["traced"]]
    return stats.median(v) if v else None
