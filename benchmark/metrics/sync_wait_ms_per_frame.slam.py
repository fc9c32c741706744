"""Host ms a frame spent in counted device->host reads: the host time of
the program's ``sync`` spans over its ``StereoSlam.process_frame`` spans,
both in the run's window and outside the profiled slice
(``_program_spans``)."""

from benchmark.metrics import _program_spans as ps

FRAME = "StereoSlam.process_frame"


def read(run):
    w = ps.window(run)
    if w is None:
        return None
    wait = sum(s.t1 - s.t0 for s in w.spans if s.kind == "sync")
    return ps.per(w, 1e3 * wait, FRAME)
