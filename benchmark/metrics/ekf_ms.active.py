"""Mean host ms of one layer's call over the traced run's window (the
profiled slice left out), each call between two barriers. State estimation: ``ActiveSlamSystem.estimated_robot_pose``, the dual EKF's flush and its read."""

SPAN = "ekf"


def read(run):
    v = [s["spans"][SPAN] * 1e3 for s in run["steps"] if SPAN in s["spans"] and not s["traced"]]
    return sum(v) / len(v) if v else None
