"""Device ms of a keyframe's map update: over the window's frames
(``StereoSlam.process_frame`` spans outside the profiled slice,
``_program_spans``) that replayed the ``keyframe`` region, the median of
the union of the device intervals of their ``keyframe``, ``compact`` and
``finish_keyframe`` replays (insertion, local BA, culling, recycling and
the frame's outputs)."""

import statistics

from benchmark.metrics import _program_spans as ps

FRAME = "StereoSlam.process_frame"
REGIONS = ("keyframe", "compact", "finish_keyframe")


def read(run):
    w = ps.window(run)
    if w is None:
        return None
    got = []
    for replays in ps.replays_under(w, FRAME).values():
        mine = [r for r in replays if r.name in REGIONS]
        if any(r.name == "keyframe" for r in mine):
            got.append(ps.device_ms(mine))
    if not got or None in got:
        return None
    return statistics.median(got)
