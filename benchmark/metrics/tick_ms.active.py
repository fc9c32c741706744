"""Mean host ms of one layer's call over the traced run's window (the
profiled slice left out), each call between two barriers. The exploration tick: ``ActiveSlamSystem.tick_exploration`` (frontiers, roadmap, costs with K3, the FI gate), over the steps that run one."""

SPAN = "tick"


def read(run):
    v = [s["spans"][SPAN] * 1e3 for s in run["steps"] if SPAN in s["spans"] and not s["traced"]]
    return sum(v) / len(v) if v else None
