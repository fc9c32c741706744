"""K1's share (%) of its roofline on the path: the least time of the
profiled slice's launches of the fused ORB describe (each one eye at the
configuration's pyramid, bytes and operations by the frozen count) over the
device time of the kernels named ``orb_describe_kernel`` in the slice."""

from benchmark import profile
from benchmark.frozen import kernel_counts as kc
from benchmark.reference.frontend import level_counts, pyramid_shapes


def read(run):
    p, n = run.get("profile"), run.get("launches", {}).get("K1", 0)
    if not p or not n:
        return None
    t, _ = profile.kernel_seconds(p, "orb_describe_kernel")
    if not t:
        return None
    c, o = run["settings"]["camera"], run["settings"]["orb"]
    shapes = pyramid_shapes(c["height"], c["width"], o["num_levels"], o["scale_factor"])
    counts = level_counts(o["num_features"], o["num_levels"], o["scale_factor"])
    levels = list(zip(shapes, counts))
    return 100.0 * n * kc.k1_bound_s(levels, o["num_features"]) / t
