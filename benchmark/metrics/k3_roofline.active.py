"""K3's share (%) of its roofline on the path: the least time of the
profiled slice's wavefront launches (each ``wavefront_iters`` Jacobi
min-plus sweeps of the configuration's grid, by the frozen count: one a
tick, one a plan) over the device time of the kernels named
``wavefront_resident_kernel`` or ``wavefront_tile_kernel`` in the slice."""

from benchmark import profile
from benchmark.frozen import kernel_counts as kc


def read(run):
    p, n = run.get("profile"), run.get("launches", {}).get("K3", 0)
    if not p or not n:
        return None
    t, _ = profile.kernel_seconds(p, "wavefront_resident_kernel", "wavefront_tile_kernel")
    if not t:
        return None
    G = run["grid"]["size"]
    return 100.0 * n * kc.k3_bound_s(G, G, run["settings"]["nav"]["wavefront_iters"]) / t
