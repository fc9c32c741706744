"""The share of the window's host time in which no captured region ran on
the card: 1 - the union of the program's ``replay`` spans' device intervals
(mapped to the host's clock) over the window's host time, the profiled
slice left out of both (``_program_spans``), in %. It is the device's idle
time plus its eager work outside the graphs. The mission steps outside the
profiled slice run with the harness's barriers between layers: the device
idles at each, and that idle time counts here."""

from benchmark.metrics import _program_spans as ps


def read(run):
    return ps.outside_graphs_pct(ps.window(run))
