"""Device ms of an exploration tick: the mean, over the window's
``exploration.tick`` spans outside the profiled slice (``_program_spans``),
of the union of the device intervals of the replays below each: the
tick's program (roadmap upkeep, frontiers, costs with K3, the FI gate) up
to its packed read; the overlay and the grid's fusion before it, and the
published path after it, lie outside the span. The mission steps
outside the slice run with the harness's barriers between layers, so a
tick finds the device idle when it starts."""

from benchmark.metrics import _program_spans as ps


def read(run):
    return ps.mean_device_ms_under(ps.window(run), "exploration.tick")
