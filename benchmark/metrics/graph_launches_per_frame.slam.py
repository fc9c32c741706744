"""Graph launches a frame: the program's ``replay`` spans (one launch of a
captured region's CUDA graph from the host each) over its
``StereoSlam.process_frame`` spans, both in the run's window and outside
the profiled slice (``_program_spans``)."""

from benchmark.metrics import _program_spans as ps

FRAME = "StereoSlam.process_frame"


def read(run):
    w = ps.window(run)
    return None if w is None else ps.per(w, ps.count(w, "replay"), FRAME)
