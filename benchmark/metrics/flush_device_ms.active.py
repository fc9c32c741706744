"""Device ms of an EKF flush: the mean, over the window's ``DualEkf.flush``
spans outside the profiled slice (``_program_spans``), of the union of the
device intervals of the replays below each (the filters' windows). The
mission steps outside the slice run with the harness's barriers between
layers, so a flush finds the device idle when it starts."""

from benchmark.metrics import _program_spans as ps


def read(run):
    return ps.mean_device_ms_under(ps.window(run), "DualEkf.flush")
