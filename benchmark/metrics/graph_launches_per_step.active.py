"""Graph launches a mission step: the program's ``replay`` spans (one
launch of a captured region's CUDA graph from the host each) over its
``SimCamera.frame`` spans (one a step), both in the run's window and
outside the profiled slice (``_program_spans``). The steps outside the
slice run with the harness's barriers between layers, which launch
nothing."""

from benchmark.metrics import _program_spans as ps

STEP = "SimCamera.frame"


def read(run):
    w = ps.window(run)
    return None if w is None else ps.per(w, ps.count(w, "replay"), STEP)
