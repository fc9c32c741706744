"""Mean host ms of one layer's call over the traced run's window (the
profiled slice left out), each call between two barriers. The simulation: ``SimCamera.frame`` (both images and the frustum cloud at the rover's pose)."""

SPAN = "camera"


def read(run):
    v = [s["spans"][SPAN] * 1e3 for s in run["steps"] if SPAN in s["spans"] and not s["traced"]]
    return sum(v) / len(v) if v else None
